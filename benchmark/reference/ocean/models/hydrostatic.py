"""The hydrostatic free-surface time step as plain PyTorch (a frozen copy of
the port's ``models/hydrostatic.py`` on its plain path, serial only): halo
fill and immersed masks, the buoyancy, CATKE's diffusivities, the tendency
stage with the AB2 update fused in (the "auto" and "torch" routes) or
unfused around the one-pass stage (the "pallas" route), the increments
(closure sources, T/S restoring, surface fluxes, re-masks, the wall row),
the split-explicit free surface (the serial loop of substeps, or blocks of
W substeps on the "pallas" route), the north-fold projection, the
vertically implicit solves and the clock.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.ocean.grids.immersed import face_bottom_planes, face_masks, interior_masks
from benchmark.reference.ocean.grids.tripolar import north_fold_projection
from benchmark.reference.ocean.models.catke import CATKEVerticalDiffusivity
from benchmark.reference.ocean.models.free_surface import barotropic_substep
from benchmark.reference.ocean.models.state import HydrostaticState, advance_clock
from benchmark.reference.ocean.ops.halos import extend_field
from benchmark.reference.ocean.ops.operators import (
    coriolis_ff,
    diagnose_w,
    hydrostatic_pressure,
    kinetic_energy,
    vertical_vorticity,
)
from benchmark.reference.ocean.ops.pallas_catke import catke_diffusivities_kernel
from benchmark.reference.ocean.ops.pallas_tendency import pallas_tendencies
from benchmark.reference.ocean.ops.pallas_tridiag import grid_coefficients, implicit_solve
from benchmark.reference.ocean.ops.pallas_zslab import column_buoyancy, zslab_tendencies
from benchmark.reference.ocean.ops.stencils import dx_c, dx_f, dy_c, dy_f, dz_c, dz_f, ix_c, ix_f, iy_c, iy_f, iz_c
from benchmark.reference.ocean.ops.weno import centered2, upwind1, weno5_upwind


def mask_v_wall(v, wall=True):
    """Zero v on the southern wall face (row 0; the north wall is the
    virtual face Ny) where ``wall``. Writes the row in place and returns
    ``v``."""
    if wall:
        v[..., 0, :] = 0.0
    return v


def buoyancy_field(cfg, grid, tr_e):
    """Buoyancy on extended tensors: the b tracer itself where the state
    carries one, else the configured equation of state of T and S."""
    if "b" in tr_e:
        return tr_e["b"]
    return cfg.eos.buoyancy(tr_e["T"], tr_e["S"], grid.z_c)


def plain_tracers(tracers):
    """The tracers that the closures diffuse with kappa_c: all but e and
    eps, in the state's order."""
    return tuple(k for k in tracers if k not in ("e", "eps"))


def tendency_math(cfg, grid, f_ff, ue, ve, tr_e, be=None):
    """Momentum and tracer tendencies on halo-extended tensors; ``be`` is
    the extended buoyancy where the caller has it already."""
    we = diagnose_w(grid, ue, ve)
    if be is None:
        be = buoyancy_field(cfg, grid, tr_e)
    pe = hydrostatic_pressure(grid, be)
    Gu, Gv = momentum_tendency_math(cfg, grid, f_ff, ue, ve, we, pe)
    return Gu, Gv, tracer_tendency_math(cfg, grid, ue, ve, we, tr_e)


def momentum_tendency_math(cfg, grid, f_ff, ue, ve, we, pe):
    """Vector-invariant momentum tendencies plus the hydrostatic pressure
    gradient: the vorticity flux q (v, -u) with q = f + zeta upwinded by
    WENO ("weno_vector_invariant") or interpolated ("vector_invariant"),
    the Bernoulli gradient and the vertical advection; under "none" q = f
    interpolated, and no kinetic energy and no vertical advection."""
    eps = cfg.weno_eps
    advect = cfg.momentum_advection != "none"
    q = f_ff + vertical_vorticity(grid, ue, ve) if advect else f_ff
    vbar_fc = iy_c(ix_f(ve))  # v at u-points (f, c)
    ubar_cf = ix_c(iy_f(ue))  # u at v-points (c, f)
    if cfg.momentum_advection == "weno_vector_invariant":
        q_u = weno5_upwind(q, vbar_fc, "y", align="center", eps=eps)
        q_v = weno5_upwind(q, ubar_cf, "x", align="center", eps=eps)
    else:
        q_u = iy_c(q)
        q_v = ix_c(q)
    Gu = q_u * vbar_fc
    Gv = -q_v * ubar_cf

    r_dxc = 1.0 / grid.dxc
    r_dyf = 1.0 / grid.dyf
    if advect:
        K = kinetic_energy(ue, ve, cfg.ke_scheme)
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
    """Flux-form tracer advection tendencies in the configured scheme
    (WENO-5, centred second order or first-order upwind); 0 under
    "none"."""
    eps = cfg.weno_eps
    scheme = cfg.tracer_advection
    r_azc = 1.0 / grid.azc
    r_dz_c = 1.0 / grid.dz_c
    Gtr = {}
    for name, ce in tr_e.items():
        if scheme == "none":
            Gtr[name] = torch.zeros_like(ce)
            continue
        if scheme == "weno5":
            cx = weno5_upwind(ce, ue, "x", eps=eps)
            cy = weno5_upwind(ce, ve, "y", eps=eps)
            cz = weno5_upwind(ce, we, "z", eps=eps)
        elif scheme == "centered2":
            cx, cy, cz = centered2(ce, "x"), centered2(ce, "y"), centered2(ce, "z")
        else:
            cx, cy, cz = upwind1(ce, ue, "x"), upwind1(ce, ve, "y"), upwind1(ce, we, "z")
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


def compute_tendencies(cfg, grid, state, ab, surface_fluxes=None, restoring=None):
    """Halo fill, the closure's diffusivities, the tendency stage (fused
    with the AB2 update off the "pallas" route, the one-pass stage on it),
    then the increments after the stage. Returns (Gu, Gv, Gtr, updated,
    integrals, diffusivities) with updated = (u*, v*, tracers*); updated
    and integrals are None unless the stage is fused (``cfg.fused``),
    diffusivities None without CATKE.

    ``surface_fluxes``: optional dict of (Ny, Nx) kinematic fluxes
    {"u", "v", "T", "S", "e"} (field units times m/s, positive into the
    ocean), deposited into the top cell. ``restoring``: optional dict
    tracer name -> (target, rate), G_c += rate (target - c), with the
    target an interior (Nz, Ny, Nx) field and the rate (1, Ny, Nx)."""
    ue = extend_field(grid, state.u, "u")
    ve = extend_field(grid, state.v, "v")
    tr_e = {k: extend_field(grid, c, "c") for k, c in state.tracers.items()}
    face_bottoms = None
    if grid.immersed:
        # zero the face velocities on solid faces, so every flux through
        # the bathymetry vanishes
        um_e, vm_e = face_masks(grid)
        ue = ue * um_e
        ve = ve * vm_e
        face_bottoms = face_bottom_planes(grid)
    be = b_total = None
    if cfg.fused:
        be, b_total = column_buoyancy(cfg, grid, tr_e)
    diffusivities = None
    if isinstance(cfg.closure, CATKEVerticalDiffusivity):
        be_c = be if be is not None else buoyancy_field(cfg, grid, tr_e)
        ku, kc, ke, G_e, lam_e = catke_diffusivities_kernel(cfg, grid, ue, ve, be_c, tr_e["e"])
        diffusivities = {"kappa_u": ku, "kappa_c": kc, "kappa_e": ke, "lam_e": lam_e,
                         "G_e": G_e}

    updated = ints = None
    if cfg.fused:
        Gu, Gv, Gtr, u_new, v_new, tr_new, ints = zslab_tendencies(
            cfg, grid, ue, ve, tr_e, (state.Gu, state.Gv, state.Gtracers), ab,
            buoyancy=(be, b_total), face_bottoms=face_bottoms)
        updated = (u_new, v_new, tr_new)
    else:
        f_ff = coriolis_ff(grid, cfg.coriolis).to(ue.dtype)
        Gu, Gv, Gtr = pallas_tendencies(cfg, grid, f_ff, ue, ve, tr_e)
    outs = _increments(grid, (Gu, Gv, Gtr), updated, ints, ab[0], diffusivities,
                       surface_fluxes, True, restoring, state.tracers)
    return (*outs, diffusivities)


def _increments(grid, tendencies, updated, ints, dtc1, diffusivities, surface_fluxes, wall=True,
                restoring=None, tracers=None):
    """The increments after the tendency kernel, in the JAX package's
    order: the closure's sources (of e, then of eps), the restoring of
    ``tracers`` (the state's) toward its targets, the surface-flux
    deposits, the immersed re-mask, the wall row (``wall``: this tile owns
    it). After K1 each G -> G + inc also moves the fused update ``updated``
    = (u*, v*, tracers*), x* -> x* + dt c1 inc, and the integrals ``ints``
    (the previous step's increments sit in G_prev, which K1 consumed);
    after K6 both are None."""
    Gu, Gv, Gtr = tendencies
    u_new, v_new, tr_new = updated if updated is not None else (None, None, None)
    for name in ("e", "eps"):
        if diffusivities is not None and "G_" + name in diffusivities:
            src = diffusivities["G_" + name]
            Gtr[name] += src
            if updated is not None:
                tr_new[name] += dtc1 * src

    for name, (target, rate) in (restoring or {}).items():
        inc = rate * (target - tracers[name])
        Gtr[name] += inc
        if updated is not None:
            tr_new[name] += dtc1 * inc

    if surface_fluxes is not None and updated is None:
        dz_top = grid.dz_c[grid.hz + grid.Nz - 1, 0, 0]
        for name, flux in surface_fluxes.items():
            target = Gu if name == "u" else Gv if name == "v" else Gtr[name]
            target[-1] += flux / dz_top
    elif surface_fluxes is not None:
        U0, V0, Us, Vs = ints
        dz_top = grid.dz_c[grid.hz + grid.Nz - 1, 0, 0]
        if grid.immersed:
            # the deposits land before the immersed re-mask, so their share
            # of the u*, v* integrals carries the top-plane face masks
            um, vm = interior_masks(grid)
            um_top, vm_top = um[-1], vm[-1]
        else:
            um_top = vm_top = 1.0
        for name, flux in surface_fluxes.items():
            fa = flux / dz_top
            if name == "u":
                Gu[-1] += fa
                u_new[-1] += dtc1 * fa
                # the top-cell deposit integrates to exactly the flux
                Us = Us + dtc1 * fa * dz_top * um_top
            elif name == "v":
                Gv[-1] += fa
                v_new[-1] += dtc1 * fa
                # the wall row is excluded: v* is wall-masked after this
                inc_v = mask_v_wall(fa * dz_top * vm_top, wall)
                Vs = Vs + dtc1 * inc_v
            else:
                Gtr[name][-1] += fa
                tr_new[name][-1] += dtc1 * fa
        ints = (U0, V0, Us, Vs)

    if grid.immersed:
        # the stored G feeds next step's dt c2 term masked, and the fused
        # update lands at 0 on solid faces
        um, vm = interior_masks(grid)
        Gu = Gu * um
        Gv = Gv * vm
        if updated is not None:
            updated = (u_new * um, v_new * vm, tr_new)
    # a v deposit can re-add wall-row values (K6 writes the row: it has no
    # wall logic)
    Gv = mask_v_wall(Gv, wall)
    return Gu, Gv, Gtr, updated, ints


def premask_state(grid, state):
    """Zero u and v on solid faces once; the steps keep it so (each re-masks
    after the barotropic correction), and pass ``premasked``."""
    if not grid.immersed:
        return state
    u_mask, v_mask = interior_masks(grid)
    return state.replace(u=state.u * u_mask, v=state.v * v_mask)


def time_step(cfg, grid, state: HydrostaticState, dt, surface_fluxes=None,
              premasked=False, restoring=None) -> HydrostaticState:
    """One quasi-AB2 hydrostatic step with the split-explicit free surface
    and, with a closure, the vertically implicit solves; with
    ``restoring``, T/S relaxed toward targets (``compute_tendencies``)."""
    if not premasked:
        state = premask_state(grid, state)
    dtype = state.u.dtype
    dt_t = _scalar_type(dtype)(dt)
    c1, c2 = _ab2_coeffs(cfg, state, dtype)
    ab = (float(dt_t * c1), float(dt_t * c2))
    Gu, Gv, Gtr, updated, ints, diffusivities = compute_tendencies(
        cfg, grid, state, ab, surface_fluxes, restoring)
    G_ab = None
    a, b, h = float(c1), float(c2), float(dt_t)
    if updated is None:
        # the unfused update, in the JAX package's association:
        # x* = x + dt (c1 G + c2 G_prev)
        G_ab = (a * Gu + b * state.Gu, a * Gv + b * state.Gv)
        u_star = state.u + h * G_ab[0]
        v_star = state.v + h * G_ab[1]
        tracers = {k: state.tracers[k] + h * (a * Gtr[k] + b * state.Gtracers[k])
                   for k in state.tracers}
    else:
        u_star, v_star, tracers = updated
        v_star = mask_v_wall(v_star)
    eta, u_new, v_new = barotropic_substep(cfg, grid, state, u_star, v_star, h, ints, G_ab)
    v_new = mask_v_wall(v_new)
    if grid.north_fold:
        # the seam row its own mirror image (in place: every field here is
        # this step's own)
        north_fold_projection(grid, u_new, eta, tracers)
    if grid.immersed:
        # the barotropic correction touched full columns
        u_mask, v_mask = interior_masks(grid)
        u_new = u_new * u_mask
        v_new = v_new * v_mask

    if diffusivities is not None:
        u_new, v_new, tracers = _implicit_solves(cfg, grid, u_new, v_new, tracers,
                                                 diffusivities, h)

    t_new, t_lo = advance_clock(state.time, state.time_lo, h)
    return state.replace(
        u=u_new, v=v_new, eta=eta, tracers=tracers,
        Gu=Gu, Gv=Gv, Gtracers=Gtr,
        time=t_new, time_lo=t_lo, iteration=state.iteration + 1,
    )


def _implicit_solves(cfg, grid, u, v, tracers, d, dt):
    """Backward-Euler vertical diffusion with the closure's diffusivities:
    (u, v) with kappa_u, (T, S) or b with kappa_c, e with kappa_e (and
    CATKE's dissipation rate lam_e), eps with kappa_eps; then e, eps >= 0."""
    coef = grid_coefficients(grid, dt)
    u, v = implicit_solve(cfg, (u, v), d["kappa_u"], dt, *coef)
    names = plain_tracers(tracers)
    solved = implicit_solve(cfg, tuple(tracers[k] for k in names), d["kappa_c"], dt, *coef)
    out = {**tracers, **dict(zip(names, solved))}
    for name in ("e", "eps"):
        if name in tracers:
            (x,) = implicit_solve(cfg, (tracers[name],), d["kappa_" + name], dt, *coef,
                                  damping=d.get("lam_" + name))
            out[name] = torch.clamp(x, min=0.0)
    return u, v, out
