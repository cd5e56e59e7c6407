"""State conversion between the port and the JAX package's layout.

A state crosses as a flat dict of numpy arrays named like the JAX state's
leaves ("u", "v", "eta", "tracers/T", ..., "Gtracers/S", "time",
"time_lo", "iteration"), with 3-D fields in JAX's (X, Y, Z) and 2-D fields
in (X, Y). The port stores (Z, Y, X) and (Y, X), so 3-D and 2-D arrays are
transposed on the way in and out.
"""

from __future__ import annotations

import numpy as np
import torch

from gb25_tpu_torch.models.state import HydrostaticState


def _to_port(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(np.transpose(a))  # reverses the axes; a writable copy
    return torch.as_tensor(a, device=device)


def _to_jax(t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return np.ascontiguousarray(np.transpose(a)) if a.ndim >= 2 else a


def state_from_numpy(arrays: dict, device) -> HydrostaticState:
    """Build the port's state on ``device`` from JAX-layout numpy arrays."""
    tracers = sorted(k.split("/", 1)[1] for k in arrays if k.startswith("tracers/"))
    return HydrostaticState(
        u=_to_port(arrays["u"], device),
        v=_to_port(arrays["v"], device),
        eta=_to_port(arrays["eta"], device),
        tracers={k: _to_port(arrays[f"tracers/{k}"], device) for k in tracers},
        Gu=_to_port(arrays["Gu"], device),
        Gv=_to_port(arrays["Gv"], device),
        Geta=_to_port(arrays["Geta"], device),
        Gtracers={k: _to_port(arrays[f"Gtracers/{k}"], device) for k in tracers},
        time=_to_port(arrays["time"], device),
        time_lo=_to_port(arrays["time_lo"], device),
        iteration=int(arrays["iteration"]),
    )


def state_to_numpy(state: HydrostaticState) -> dict:
    """The port's state as JAX-layout numpy arrays, in the JAX leaf order."""
    out = {"u": _to_jax(state.u), "v": _to_jax(state.v), "eta": _to_jax(state.eta)}
    out.update({f"tracers/{k}": _to_jax(state.tracers[k]) for k in sorted(state.tracers)})
    out.update({"Gu": _to_jax(state.Gu), "Gv": _to_jax(state.Gv), "Geta": _to_jax(state.Geta)})
    out.update({f"Gtracers/{k}": _to_jax(state.Gtracers[k]) for k in sorted(state.Gtracers)})
    out.update({"time": _to_jax(state.time), "time_lo": _to_jax(state.time_lo),
                "iteration": np.asarray(state.iteration, np.int32)})
    return out
