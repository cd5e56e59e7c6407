"""The rotating shallow-water model (port of
``gb25_tpu.models.shallow_water``), the JAX package's second model family:
``bench.py --config atmosphere``.

    du/dt = +(zeta + f) vbar - d/dx (K + g h)
    dv/dt = -(zeta + f) ubar - d/dy (K + g h)
    dh/dt = -div(h u)

with h the fluid thickness, on the C grid of a lat-lon (or tripolar) grid
of one level: (Ny, Nx) planes, x contiguous, the named-axis stencils of
``ops.stencils`` on planes extended by W = min(hx, hy) ghosts, quasi-AB2 in
time with an Euler first step. The clock is a plain ``time + dt`` (no
compensation), as the JAX package's. There is no kernel here, as there is
no Pallas kernel in the JAX package: a step is ~80 small torch launches,
which ``sw_loop`` replays on the card from a captured CUDA graph
(``models.device_loop``). With a ``comm`` (a tile of the decomposed path,
``parallel.sharded.run_decomposed_sw``) the ghosts come from the
neighbouring tiles; the loop runs from the host where the mesh spans
several ranks.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from gb25_tpu_torch.grids import simple_latitude_longitude_grid
from gb25_tpu_torch.models.config import EARTH_ROTATION_RATE
from gb25_tpu_torch.models.device_loop import run_loop
from gb25_tpu_torch.models.hydrostatic import (
    _ab2_coeffs,
    _scalar_type,
    mask_v_wall,
    owns_south_wall,
)
from gb25_tpu_torch.models.state import ShallowWaterState
from gb25_tpu_torch.ops.halos import extend2
from gb25_tpu_torch.ops.operators import coriolis_ff
from gb25_tpu_torch.ops.stencils import axis_order, dx_c, dx_f, dy_c, dy_f, ix_c, ix_f, iy_c, iy_f

MOMENTUM_ADVECTION = ("vector_invariant", "none")


@dataclasses.dataclass(frozen=True)
class ShallowWaterConfig:
    gravitational_acceleration: float = 9.80665
    coriolis: float = EARTH_ROTATION_RATE  # Omega; 0 disables rotation
    momentum_advection: str = "vector_invariant"  # or "none": no zeta, no K
    chi: float = 0.1  # quasi-AB2 parameter (Euler first step)

    def __post_init__(self):
        if self.momentum_advection not in MOMENTUM_ADVECTION:
            raise ValueError(f"momentum_advection must be one of {MOMENTUM_ADVECTION}, got "
                             f"{self.momentum_advection!r}")


def shallow_water_state(grid, h0=1000.0, dtype=None) -> ShallowWaterState:
    """At rest with thickness ``h0`` on ``grid``'s device."""
    dtype = dtype or grid.dtype

    def z2():
        return torch.zeros((grid.Ny, grid.Nx), dtype=dtype, device=grid.device)

    return ShallowWaterState(
        u=z2(), v=z2(), h=torch.full((grid.Ny, grid.Nx), h0, dtype=dtype, device=grid.device),
        Gu=z2(), Gv=z2(), Gh=z2(),
        time=torch.zeros((), dtype=dtype, device=grid.device), iteration=0,
    )


def _metrics2w(grid, W):
    """dxc, dxf, dyc, dyf, azc, azf extended by W: (Ny + 2W, 1) columns or,
    on the tripolar grid, (Ny + 2W, Nx + 2W) planes."""
    hx, hy = grid.hx, grid.hy
    ys = slice(hy - W, hy + grid.Ny + W)

    def sl(m):  # (1, Ny+2hy, 1) profile or (1, Ny+2hy, Nx+2hx) plane
        xs = slice(hx - W, hx + grid.Nx + W) if m.shape[2] > 1 else slice(None)
        return m[0, ys, xs]

    return tuple(sl(getattr(grid, n)) for n in ("dxc", "dxf", "dyc", "dyf", "azc", "azf"))


def sw_tendencies(cfg, grid, state, comm=None):
    """(Gu, Gv, Gh) on the interior; Gv 0 on the south wall row where this
    tile owns it."""
    W = min(grid.hx, grid.hy)
    ue = extend2(grid, state.u, "u", h=W, comm=comm)
    ve = extend2(grid, state.v, "v", h=W, comm=comm)
    he = extend2(grid, state.h, "c", h=W, comm=comm)
    dxc, dxf, dyc, dyf, azc, azf = _metrics2w(grid, W)
    f_ff = coriolis_ff(grid, cfg.coriolis)[0]  # (Ny+2hy, 1) or (Ny+2hy, Nx+2hx)
    xs = slice(grid.hx - W, grid.hx + grid.Nx + W) if f_ff.shape[1] > 1 else slice(None)
    f2 = f_ff[grid.hy - W : grid.hy + grid.Ny + W, xs]

    g = cfg.gravitational_acceleration
    with axis_order(x=1, y=0, z=2):
        if cfg.momentum_advection == "vector_invariant":
            q = f2 + (dx_f(ve * dyf) - dy_f(ue * dxc)) / azf
            K = 0.5 * (ix_c(ue * ue) + iy_c(ve * ve))
        else:
            q = f2.expand(ue.shape)
            K = torch.zeros_like(ue)
        vbar_fc = iy_c(ix_f(ve))
        ubar_cf = ix_c(iy_f(ue))
        phi = K + g * he  # Bernoulli potential (h = thickness; flat-bottom form)
        Gu = iy_c(q) * vbar_fc - dx_f(phi) / dxc
        Gv = -ix_c(q) * ubar_cf - dy_f(phi) / dyf
        # mass: -div(h u) with the thickness interpolated to the faces
        Gh = -(dx_c(ix_f(he) * ue * dyc) + dy_c(iy_f(he) * ve * dxf)) / azc

    def crop(a):
        return a[W : W + grid.Ny, W : W + grid.Nx].contiguous()

    return crop(Gu), mask_v_wall(crop(Gv), owns_south_wall(comm)), crop(Gh)


def sw_time_step(cfg, grid, state, dt, comm=None) -> ShallowWaterState:
    """One quasi-AB2 step (Euler at iteration 0); with ``comm``, of the tile
    ``grid``."""
    dtype = state.u.dtype
    Gu, Gv, Gh = sw_tendencies(cfg, grid, state, comm)
    c1, c2 = _ab2_coeffs(cfg, state, dtype)
    a, b, h = float(c1), float(c2), float(_scalar_type(dtype)(dt))
    u = state.u + h * (a * Gu + b * state.Gu)
    v = mask_v_wall(state.v + h * (a * Gv + b * state.Gv), owns_south_wall(comm))
    thickness = state.h + h * (a * Gh + b * state.Gh)
    return state.replace(u=u, v=v, h=thickness, Gu=Gu, Gv=Gv, Gh=Gh, time=state.time + h,
                         iteration=state.iteration + 1)


def sw_loop(cfg, grid, state, dt, n, comm=None) -> ShallowWaterState:
    """``n`` steps: on the card replayed from a captured CUDA graph
    (``device_loop``), also with a ``comm`` whose mesh is the one card; on
    the CPU and with a ``comm`` of several ranks from the host."""
    step = functools.partial(sw_time_step, cfg, grid, dt=dt, comm=comm)
    return run_loop(step, state, n, comm, grid.cache)


def shallow_water_model(Nx, Ny, *, device="cuda", dtype=torch.float32):
    """Config, grid (Nz = 1) and state of ``bench.py --config atmosphere``:
    at rest, h = 1000 m plus the zonal ridge 2 exp(-((phi - 40)^2 / 50)), from
    which a geostrophic jet develops, so the advection terms carry
    physically scaled values."""
    grid = simple_latitude_longitude_grid(Nx, Ny, 1, device=device, dtype=dtype)
    state = shallow_water_state(grid, h0=1000.0)
    phi = grid.phi_c_i.reshape(-1, 1).to(dtype)
    ridge = (2.0 * torch.exp(-((phi - 40.0) ** 2) / 50.0)).expand(Ny, Nx)
    return ShallowWaterConfig(), grid, state.replace(h=(state.h + ridge).contiguous())
