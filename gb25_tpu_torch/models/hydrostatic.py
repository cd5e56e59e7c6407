"""The hydrostatic free-surface time step (port of
``gb25_tpu.models.hydrostatic``: the serial, closure-free, non-immersed
flagship path).

One step, in the fused form the JAX package runs on its kernels:
  1. halo fill of u, v, T, S;
  2. kernel K1: continuity w, TEOS-10 buoyancy (a torch op), hydrostatic
     pressure, WENO vector-invariant momentum and WENO-5 tracer tendencies,
     the quasi-AB2 update, the south-wall row and the depth integrals;
  3. kernel K2: the 30-substep split-explicit free surface, then the
     barotropic correction;
  4. the south-wall mask and the clock.
"""

from __future__ import annotations

import numpy as np

from gb25_tpu_torch.models.free_surface import barotropic_substep
from gb25_tpu_torch.models.state import HydrostaticState, advance_clock
from gb25_tpu_torch.ops.halos import extend_field
from gb25_tpu_torch.ops.operators import (
    diagnose_w,
    hydrostatic_pressure,
    kinetic_energy,
    vertical_vorticity,
)
from gb25_tpu_torch.ops.pallas_zslab import zslab_tendencies
from gb25_tpu_torch.ops.stencils import dx_c, dx_f, dy_c, dy_f, dz_c, dz_f, ix_c, ix_f, iy_c, iy_f, iz_c
from gb25_tpu_torch.ops.weno import weno5_upwind


def mask_v_wall(v):
    """Zero v on the southern wall face (row 0; the north wall is the
    virtual face Ny). Writes the row in place and returns ``v``."""
    v[..., 0, :] = 0.0
    return v


def buoyancy_field(cfg, grid, tr_e):
    """Buoyancy on extended tensors from the configured EOS."""
    return cfg.eos.buoyancy(tr_e["T"], tr_e["S"], grid.z_c)


def tendency_math(cfg, grid, f_ff, ue, ve, tr_e):
    """Momentum and tracer tendencies on halo-extended tensors."""
    we = diagnose_w(grid, ue, ve)
    pe = hydrostatic_pressure(grid, buoyancy_field(cfg, grid, tr_e))
    Gu, Gv = momentum_tendency_math(cfg, grid, f_ff, ue, ve, we, pe)
    return Gu, Gv, tracer_tendency_math(cfg, grid, ue, ve, we, tr_e)


def momentum_tendency_math(cfg, grid, f_ff, ue, ve, we, pe):
    """Upwinded vector-invariant momentum tendencies plus the hydrostatic
    pressure gradient."""
    eps = cfg.weno_eps
    q = f_ff + vertical_vorticity(grid, ue, ve)
    vbar_fc = iy_c(ix_f(ve))  # v at u-points (f, c)
    ubar_cf = ix_c(iy_f(ue))  # u at v-points (c, f)
    q_u = weno5_upwind(q, vbar_fc, "y", align="center", eps=eps)
    q_v = weno5_upwind(q, ubar_cf, "x", align="center", eps=eps)
    Gu = q_u * vbar_fc
    Gv = -q_v * ubar_cf

    r_dxc = 1.0 / grid.dxc
    r_dyf = 1.0 / grid.dyf
    K = kinetic_energy(ue, ve)
    Gu = Gu - dx_f(K) * r_dxc
    Gv = Gv - dy_f(K) * r_dyf
    # vertical advection in advective form, -w du/dz at velocity points
    r_dz_f = 1.0 / grid.dz_f
    Gu = Gu - iz_c(ix_f(we) * (dz_f(ue) * r_dz_f))
    Gv = Gv - iz_c(iy_f(we) * (dz_f(ve) * r_dz_f))

    Gu = Gu - dx_f(pe) * r_dxc
    Gv = Gv - dy_f(pe) * r_dyf
    return Gu, Gv


def tracer_tendency_math(cfg, grid, ue, ve, we, tr_e):
    """Flux-form WENO-5 tracer advection tendencies."""
    eps = cfg.weno_eps
    r_azc = 1.0 / grid.azc
    r_dz_c = 1.0 / grid.dz_c
    Gtr = {}
    for name, ce in tr_e.items():
        cx = weno5_upwind(ce, ue, "x", eps=eps)
        cy = weno5_upwind(ce, ve, "y", eps=eps)
        cz = weno5_upwind(ce, we, "z", eps=eps)
        Gc = -(dx_c(ue * grid.dyc * cx) + dy_c(ve * grid.dxf * cy)) * r_azc
        Gtr[name] = Gc - dz_c(we * cz) * r_dz_c
    return Gtr


def _scalar_type(dtype):
    """The numpy scalar type of a torch float dtype: host-side scalar
    arithmetic rounds as the JAX package's traced scalars do."""
    return np.dtype(str(dtype).removeprefix("torch.")).type


def _ab2_coeffs(cfg, state, dtype):
    """(c1, c2) of the quasi-AB2 step in the state's precision (Euler on
    the first step)."""
    ft = _scalar_type(dtype)
    if state.iteration == 0:
        return ft(1.0), ft(0.0)
    return ft(1.5 + cfg.chi), ft(-(0.5 + cfg.chi))


def compute_tendencies(cfg, grid, state, ab):
    """Halo fill and kernel K1. Returns (Gu, Gv, Gtr, updated, integrals)
    with updated = (u*, v*, tracers*)."""
    ue = extend_field(grid, state.u, "u")
    ve = extend_field(grid, state.v, "v")
    tr_e = {k: extend_field(grid, c, "c") for k, c in state.tracers.items()}
    Gu, Gv, Gtr, u_new, v_new, tr_new, ints = zslab_tendencies(
        cfg, grid, ue, ve, tr_e, (state.Gu, state.Gv, state.Gtracers), ab)
    return Gu, Gv, Gtr, (u_new, v_new, tr_new), ints


def time_step(cfg, grid, state: HydrostaticState, dt) -> HydrostaticState:
    """One quasi-AB2 hydrostatic step with the split-explicit free surface."""
    dtype = state.u.dtype
    dt_t = _scalar_type(dtype)(dt)
    c1, c2 = _ab2_coeffs(cfg, state, dtype)
    ab = (float(dt_t * c1), float(dt_t * c2))
    Gu, Gv, Gtr, (u_star, v_star, tracers), ints = compute_tendencies(cfg, grid, state, ab)
    v_star = mask_v_wall(v_star)
    eta, u_new, v_new = barotropic_substep(cfg, grid, state, u_star, v_star, float(dt_t), ints)
    v_new = mask_v_wall(v_new)
    t_new, t_lo = advance_clock(state.time, state.time_lo, float(dt_t))
    return state.replace(
        u=u_new, v=v_new, eta=eta, tracers=tracers,
        Gu=Gu, Gv=Gv, Gtracers=Gtr,
        time=t_new, time_lo=t_lo, iteration=state.iteration + 1,
    )


def loop(cfg, grid, state, dt, n):
    """``n`` time steps."""
    for _ in range(n):
        state = time_step(cfg, grid, state, dt)
    return state
