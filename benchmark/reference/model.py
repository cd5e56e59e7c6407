"""What the harness asks of a configuration's reference (``reference/<config>.py``
builds one): a state, one step of it, its fields by name, and a state made
from the program's tensors of the same names."""

from __future__ import annotations

import dataclasses

import torch


def fields_of(state, prefix=""):
    """A state's tensors by name, dict and dataclass fields flattened to
    "field/name"."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if torch.is_tensor(v):
            out[prefix + f.name] = v
        elif isinstance(v, dict):
            out.update({f"{prefix}{f.name}/{k}": t for k, t in v.items()})
        elif dataclasses.is_dataclass(v):
            out.update(fields_of(v, f"{prefix}{f.name}/"))
    return out


def with_fields(state, tensors, iteration, prefix=""):
    """``state`` with each tensor replaced by ``tensors``' of the same name,
    cast to the state's dtype and device, and its clock's ``iteration``."""
    kw = {"iteration": iteration} if "iteration" in {f.name for f in dataclasses.fields(state)} \
        else {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if torch.is_tensor(v):
            kw[f.name] = tensors[prefix + f.name].to(v.device, v.dtype)
        elif isinstance(v, dict):
            kw[f.name] = {k: tensors[f"{prefix}{f.name}/{k}"].to(t.device, t.dtype)
                          for k, t in v.items()}
        elif dataclasses.is_dataclass(v):
            kw[f.name] = with_fields(v, tensors, iteration, f"{prefix}{f.name}/")
    return dataclasses.replace(state, **kw)


@dataclasses.dataclass
class Model:
    """A reference model: ``initial`` its state at rest, ``advance`` one
    step of a state, ``prognostic`` the names of the fields the comparison
    reads, ``velocity`` the names of u and v."""

    initial: object
    advance: object
    prognostic: tuple
    velocity: tuple = ("u", "v")

    def with_velocity(self, u, v):
        """The initial state with the velocities ``u`` and ``v`` (the
        benchmark's noise), in the state's dtype."""
        return self.from_fields({**fields_of(self.initial), **dict(zip(self.velocity, (u, v)))}, 0)

    def from_fields(self, tensors, iteration):
        """A state of the program's tensors, by name, at ``iteration``."""
        return with_fields(self.initial, tensors, iteration)

    def steps(self, state, n):
        for _ in range(n):
            state = self.advance(state)
        return state

    def fields(self, state):
        """The prognostic fields of ``state``, by name."""
        tensors = fields_of(state)
        return {k: tensors[k] for k in self.prognostic}
