"""Prognostic model states (port of ``gb25_tpu.models.state`` and of the
state of ``gb25_tpu.models.shallow_water``).

3-D fields are ``(Nz, Ny, Nx)`` and the free surface ``(Ny, Nx)``; the
clock is a pair of 0-d tensors in the state's dtype (the shallow-water
model's a single one, uncompensated, as the JAX package's) and the
iteration a Python int (the step branches on it without reading the
device).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class HydrostaticState:
    u: torch.Tensor        # zonal velocity at (f, c, c)
    v: torch.Tensor        # meridional velocity at (c, f, c)
    eta: torch.Tensor      # free surface at (c, c)
    tracers: dict          # name -> (Nz, Ny, Nx) at (c, c, c)
    Gu: torch.Tensor       # previous tendencies (AB2 history)
    Gv: torch.Tensor
    Geta: torch.Tensor     # zero under the split-explicit free surface
    Gtracers: dict
    time: torch.Tensor     # seconds (compensated: see ``time_lo``)
    time_lo: torch.Tensor  # Kahan compensation of the clock
    iteration: int

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def advance_clock(time, time_lo, dt):
    """Compensated (Kahan) clock accumulation: the rounding error of
    ``time + dt`` is carried in ``time_lo``, so a float32 clock keeps
    advancing when dt falls below one ulp of time."""
    y = dt - time_lo
    t = time + y
    lo = (t - time) - y
    return t, lo


def initial_state(grid, tracers=("T", "S")) -> HydrostaticState:
    """All-zero state with ``tracers`` on ``grid``'s device and dtype."""
    dtype = grid.dtype

    def z3():
        return torch.zeros(grid.shape, dtype=dtype, device=grid.device)

    def z2():
        return torch.zeros(grid.shape[1:], dtype=dtype, device=grid.device)

    def z0():
        return torch.zeros((), dtype=dtype, device=grid.device)

    return HydrostaticState(
        u=z3(), v=z3(), eta=z2(), tracers={name: z3() for name in tracers},
        Gu=z3(), Gv=z3(), Geta=z2(), Gtracers={name: z3() for name in tracers},
        time=z0(), time_lo=z0(), iteration=0,
    )


@dataclasses.dataclass(frozen=True)
class ShallowWaterState:
    u: torch.Tensor     # (Ny, Nx) at (f, c)
    v: torch.Tensor     # (Ny, Nx) at (c, f)
    h: torch.Tensor     # (Ny, Nx) thickness at centres
    Gu: torch.Tensor    # previous tendencies (AB2 history)
    Gv: torch.Tensor
    Gh: torch.Tensor
    time: torch.Tensor  # seconds, 0-d
    iteration: int

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)
