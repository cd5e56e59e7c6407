"""The comparison that decides ``correct``: the program's fields against the
plain reference's, each field on its own, every number against its own
limit in the cell's workload file.

Each field gives one reading, ``<point>.<field>``, at each of two points
of the run: the widest gap as a share of the reference field's largest
magnitude, where ``<point>`` is
  - ``euler``: the program's state after its first (Euler) step, taken in
    set-up, against the reference's Euler step from the reference's own
    initial state (its own grid, masks, climatology, restoring targets and
    atmosphere) and the same velocity noise: the start and the step that
    the window skips;
  - ``step``: the program's state at the end of the window's last call
    against the reference's steps from that call's input, which the run
    copied just before the call (the program's own state: the reference
    follows it step by step).
The workload's ``limits`` name the readings that are compared.
"""

from __future__ import annotations

import math

import torch


def short(name):
    """A field's short name: "ocean/tracers/T" -> "T", "ice/v" -> "ice_v"."""
    return name.replace("ocean/", "").replace("tracers/", "").replace("ice/", "ice_")


def gap(got, want):
    """max |got - want| / max |want| in float64 (0 where the two are equal;
    inf where ``got`` is not finite, or ``want`` is 0 and ``got`` is not)."""
    got, want = got.double(), want.to(got.device).double()
    if not bool(torch.isfinite(got).all()):
        return math.inf
    err = float((got - want).abs().max())
    if err == 0.0:
        return 0.0
    scale = float(want.abs().max())
    return err / scale if scale > 0.0 else math.inf


def readings(point, got, want, names):
    """{"<point>.<field>": gap} over ``names`` of two dicts of tensors."""
    return {f"{point}.{short(k)}": gap(got[k], want[k]) for k in names}
