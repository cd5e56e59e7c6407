"""The hydrostatic free-surface time step (port of
``gb25_tpu.models.hydrostatic``, with or without a closure (CATKE,
k-epsilon or a constant vertical diffusivity), immersed bathymetry,
surface fluxes and the tripolar north fold), on the whole domain or,
given a ``parallel.halo.MeshComm`` (``comm``), on one tile of the
decomposed path.

One step, in the fused form the JAX package runs on its kernels
(``kernels="auto"`` and ``"torch"``):
  1. halo fill of u, v and the tracers (the fold rows on the tripolar
     grid; on a tile, exchanged with the neighbours); on immersed grids the
     extended velocities are masked on solid faces;
  2. the buoyancy (the equation of state, TEOS-10 or linear, of T and S,
     or the b tracer itself) and its column total (torch ops,
     ``step/teos10``), once per step: with a closure that reads b (CATKE,
     k-epsilon), for K4 and K1, which must read the same b; without one,
     only where K1's CUDA kernel does not make b itself
     (``pallas_zslab.makes_b``);
  3. with a closure, kernel K4: CATKE's diffusivities, TKE source and
     dissipation rate, or k-epsilon's diffusivities and the sources of e
     and eps, from the same extended fields;
  4. kernel K1: continuity w, hydrostatic pressure, vector-invariant
     momentum and flux-form tracer tendencies in the configured schemes
     (WENO by default), the quasi-AB2 update, the south-wall row and the
     depth integrals; without step 2's b, the buoyancy and its column
     totals inside;
  5. the increments after the kernel, each also folded into the fused
     update as dt c1 inc: the closure's sources, the T/S restoring
     (G_c += rate (target - c)), the surface fluxes into the top cell, the
     immersed re-mask, the wall row;
  6. kernel K2: the 30-substep split-explicit free surface (on a tile,
     blocks of W substeps in kernel K5, each after a width-W exchange),
     then the barotropic correction, on the tripolar grid the seam-row
     projection, and the immersed re-mask;
  7. with a closure, kernel K3 once per diffusivity: (u, v) with kappa_u,
     (T, S) or b with kappa_c, e with kappa_e (and CATKE's dissipation
     rate), eps with kappa_eps; then e, eps >= 0;
  8. the clock.

The JAX package fuses the AB2 update into the tendency stage only without
a ``compute_dtype`` and under the split-explicit free surface
(``HydrostaticConfig.fused``). Otherwise the stage writes the tendencies
alone and the step forms x* = x + dt (c1 G + c2 G_prev) itself
(unfused), through one of three tendency routes:
  - K1 unfused: ``compute_dtype`` None (the explicit free surface) or
    "float32" in float32, or "bf16s" on bfloat16 operands
    (``pallas_zslab``); on a state of another dtype "float32" and "bf16s"
    hand K1 float32 copies of the extended fields and the grid and cast the
    tendencies back (``k1_operand_dtype``); the serial free surface is
    still K2, forced by the depth integral of c1 G + c2 G_prev (on a tile,
    the blocked solve K5);
  - the array path (``step/tendency_array``): "bfloat16", "float64" or
    "f32x2" (native float64), ``tendency_math`` on copies of the extended
    fields, f and the grid in that dtype, the tendencies cast back; or
    "bf16x2", ``tendency_math`` on paired-bfloat16 limbs of them
    (``ops.multifloat``), the tendencies' float32 value cast back;
  - the ``kernels="pallas"`` route, the JAX package's unfused form around
    kernel K6 (under "float32", "bfloat16" or "float64" on a state of
    another dtype, on copies of the fields, f and the grid in that dtype:
    ``k6_operand_dtype``; "f32x2" and "bf16x2" take the array path): the
    buoyancy runs eagerly only for K4 (step 2 without a closure is gone);
    K6 computes the tendencies, the buoyancy inside, in place of K1
    (step 4); the increments of step 5 touch the tendencies alone; the free
    surface integrates u, u* and c1 G + c2 G_prev over depth and runs the
    blocked solve (blocks of W substeps in K5; serially on a 1x1 tile of its
    own, on a tile of the decomposed path on the exchanged extension; K6 has
    no wall logic, so only a tile that owns the south wall masks its row).
Under ``ExplicitFreeSurface`` the barotropic pressure gradient -g grad eta
joins the momentum tendencies, G_eta = -div(U, V) of the extended
velocities is stored, eta steps with the AB2 coefficients, and step 6 is
gone. ``VerticalScalarDiffusivity`` solves (u, v) with nu and (T, S) with
kappa in two constant-kappa K3 launches after step 6 (b alone: one K3
launch with kappa as a field). On a tile the
explicit free surface reads eta's exchanged ghosts, the scalar closure runs
on the tile's columns as it is, and the cast array path casts the tile's
grid.

Under a ``compute_dtype`` the closure (K4) reads the state-precision
fields and a buoyancy of its own, as the JAX package's closure does: on a
float64 state under "float32" K1's float32 b would move N^2 by an ulp of
float32, which can flip its sign.

Which kernel a step launches follows its operands' dtype
(``utils.cuda_build.kernel_route``): float32 operands on the card launch
them, a float64 or float16 state takes every plain version under "auto"
(the JAX package's gates send it to the array path), except K1 under
"float32" and "bf16s", whose operands are the float32 copies; K6 also
launches on bfloat16 and float64 operands, so under "pallas" a float64
state runs K6's float64 instance and the plain versions of K2-K5.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from gb25_tpu_torch.grids.immersed import face_bottom_planes, face_masks, interior_masks
from gb25_tpu_torch.grids.tripolar import north_fold_projection
from gb25_tpu_torch.parallel.fold import north_fold_projection_dist
from gb25_tpu_torch.models.catke import CATKEVerticalDiffusivity
from gb25_tpu_torch.models.config import (
    K6_COMPUTE_DTYPES,
    ExplicitFreeSurface,
    VerticalScalarDiffusivity,
)
from gb25_tpu_torch.models.device_loop import run_loop
from gb25_tpu_torch.models.free_surface import (
    barotropic_substep,
    explicit_eta_tendency,
    explicit_pressure_gradient,
)
from gb25_tpu_torch.models.keps import TKEDissipationVerticalDiffusivity
from gb25_tpu_torch.models.state import HydrostaticState, advance_clock
from gb25_tpu_torch.ops.halos import extend_field
from gb25_tpu_torch.ops.multifloat import wrap_compute
from gb25_tpu_torch.ops.operators import (
    coriolis_ff,
    diagnose_w,
    hydrostatic_pressure,
    kinetic_energy,
    vertical_vorticity,
)
from gb25_tpu_torch.ops.pallas_catke import catke_diffusivities_kernel, keps_diffusivities_kernel
from gb25_tpu_torch.ops.pallas_tendency import pallas_tendencies
from gb25_tpu_torch.ops.pallas_tridiag import grid_coefficients, implicit_solve
from gb25_tpu_torch.ops.pallas_zslab import column_buoyancy, makes_b, zslab_tendencies
from gb25_tpu_torch.ops.stencils import dx_c, dx_f, dy_c, dy_f, dz_c, dz_f, ix_c, ix_f, iy_c, iy_f, iz_c
from gb25_tpu_torch.ops.weno import centered2, upwind1, weno5_upwind
from gb25_tpu_torch.utils.cuda_build import uses_kernel
from gb25_tpu_torch.utils.tracing import span


def owns_south_wall(comm) -> bool:
    """Whether local row 0 is the southern wall face: serially, and on the
    south-most tiles of the decomposed path; elsewhere it is an interior
    row."""
    return comm is None or comm.iy == 0


def mask_v_wall(v, wall=True):
    """Zero v on the southern wall face (row 0; the north wall is the
    virtual face Ny) where ``wall`` (see ``owns_south_wall``). Writes the
    row in place and returns ``v``."""
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


def tendency_math(cfg, grid, f_ff, ue, ve, tr_e, be=None, pressure=hydrostatic_pressure):
    """Momentum and tracer tendencies on halo-extended tensors; ``be`` is
    the extended buoyancy where the caller has it already; ``pressure``
    makes the hydrostatic pressure of it."""
    we = diagnose_w(grid, ue, ve)
    if be is None:
        be = buoyancy_field(cfg, grid, tr_e)
    pe = pressure(grid, be)
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


def compute_tendencies(cfg, grid, state, ab, surface_fluxes=None, comm=None, restoring=None):
    """Halo fill, the closure (K4), the tendency stage (K1 fused or
    unfused, the cast array path, or K6 on the "pallas" route), the
    explicit free surface's terms, then the increments after the stage.
    Returns (Gu, Gv, Gtr, updated, integrals, diffusivities, Geta) with
    updated = (u*, v*, tracers*); updated and integrals are None unless the
    stage is fused (``cfg.fused``), diffusivities None without CATKE or
    k-epsilon, Geta None without the explicit free surface.

    ``surface_fluxes``: optional dict of (Ny, Nx) kinematic fluxes
    {"u", "v", "T", "S", "e"} (field units times m/s, positive into the
    ocean), deposited into the top cell. ``comm``: this tile's halo
    exchange on the decomposed path. ``restoring``: optional dict tracer
    name -> (target, rate), G_c += rate (target - c), with the target an
    interior (Nz, Ny, Nx) field and the rate (1, Ny, Nx) or a field (on a
    tile, both cut to the tile)."""
    with span("step/halo_fill_and_mask"):
        ue = extend_field(grid, state.u, "u", comm)
        ve = extend_field(grid, state.v, "v", comm)
        tr_e = {k: extend_field(grid, c, "c", comm) for k, c in state.tracers.items()}
        face_bottoms = None
        if grid.immersed:
            # zero the face velocities on solid faces, so every flux through
            # the bathymetry vanishes
            um_e, vm_e = face_masks(grid)
            ue = ue * um_e
            ve = ve * vm_e
            face_bottoms = face_bottom_planes(grid)
    cast = cfg.array_dtype
    k1 = cfg.kernels != "pallas" and cast is None  # the K1 routes
    bf16s = cfg.compute_dtype == "bf16s"
    dtype = state.u.dtype
    kdt = (k1_operand_dtype if k1 else k6_operand_dtype)(cfg, dtype)
    grid_k, ue_k, ve_k, tr_k = grid, ue, ve, tr_e  # the tendency kernel's operands
    if kdt is not None:
        def copy(x):  # bf16s rounds the state itself, as the JAX package does
            return (x.to(torch.bfloat16) if bf16s else x).to(kdt)

        grid_k, ue_k, ve_k = grid.cast(kdt), copy(ue), copy(ve)
        tr_k = {k: copy(c) for k, c in tr_e.items()}
    reads_b = isinstance(cfg.closure, (CATKEVerticalDiffusivity, TKEDissipationVerticalDiffusivity))
    k1_b = be_c = None  # K1's buoyancy operands and the closure's b
    if k1 and not bf16s and (reads_b or not (uses_kernel(cfg, ue_k) and makes_b(cfg, tr_k))):
        with span("step/teos10"):
            k1_b = column_buoyancy(cfg, grid_k, tr_k)
    if reads_b:
        if k1_b is not None and grid_k is grid:
            be_c = k1_b[0]  # once per step: K4 and K1 both read it
        else:
            with span("step/teos10"):  # of the state-precision fields, as in the JAX package
                be_c = buoyancy_field(cfg, grid, tr_e)

    diffusivities = None
    if isinstance(cfg.closure, CATKEVerticalDiffusivity):
        with span("step/K4_catke"):
            ku, kc, ke, G_e, lam_e = catke_diffusivities_kernel(cfg, grid, ue, ve, be_c,
                                                                tr_e["e"])
        diffusivities = {"kappa_u": ku, "kappa_c": kc, "kappa_e": ke, "lam_e": lam_e,
                         "G_e": G_e}
    elif isinstance(cfg.closure, TKEDissipationVerticalDiffusivity):
        with span("step/K4_keps"):
            ku, kc, ke, keps, G_e, G_eps = keps_diffusivities_kernel(
                cfg, grid, ue, ve, be_c, tr_e["e"], tr_e["eps"])
        diffusivities = {"kappa_u": ku, "kappa_c": kc, "kappa_e": ke, "kappa_eps": keps,
                         "G_e": G_e, "G_eps": G_eps}

    updated = ints = None
    wall = owns_south_wall(comm)
    if cfg.fused:
        with span("step/K1_tendencies"):
            Gu, Gv, Gtr, u_new, v_new, tr_new, ints = zslab_tendencies(
                cfg, grid, ue, ve, tr_e, (state.Gu, state.Gv, state.Gtracers), ab,
                buoyancy=k1_b, face_bottoms=face_bottoms, wall_v=wall)
        updated = (u_new, v_new, tr_new)
    elif k1:
        with span("step/K1_tendencies"):
            Gu, Gv, Gtr = zslab_tendencies(
                cfg, grid_k, ue_k, ve_k, tr_k, buoyancy=k1_b,
                wall_v=wall, storage=torch.bfloat16 if bf16s else None)
        if kdt is not None:
            Gu, Gv, Gtr = Gu.to(dtype), Gv.to(dtype), {k: g.to(dtype) for k, g in Gtr.items()}
    elif cast is not None:
        with span("step/tendency_array"):
            Gu, Gv, Gtr = array_tendencies(cfg, grid, ue, ve, tr_e, cast)
    else:
        with span("step/K6_tendencies"):
            f_ff = coriolis_ff(grid, cfg.coriolis).to(dtype).to(ue_k.dtype)
            Gu, Gv, Gtr = pallas_tendencies(cfg, grid_k, f_ff, ue_k, ve_k, tr_k)
        if kdt is not None:
            Gu, Gv, Gtr = Gu.to(dtype), Gv.to(dtype), {k: g.to(dtype) for k, g in Gtr.items()}
    Geta = None
    if isinstance(cfg.free_surface, ExplicitFreeSurface):
        with span("step/explicit_free_surface"):
            # the barotropic pressure gradient joins the slow tendencies; the
            # free surface's tendency comes from the extended (storage) fields
            gu, gv = explicit_pressure_gradient(cfg, grid, state.eta, comm)
            Gu = Gu + gu
            Gv = Gv + gv
            Geta = explicit_eta_tendency(grid, ue, ve)
    with span("step/increments"):
        outs = _increments(grid, (Gu, Gv, Gtr), updated, ints, ab[0], diffusivities,
                           surface_fluxes, wall, restoring, state.tracers)
    return (*outs, diffusivities, Geta)


def k1_operand_dtype(cfg, dtype):
    """The dtype of the copies K1's unfused instances read for a ``dtype``
    state, or None (K1 reads the fields themselves): float32 under
    "float32" and "bf16s" on a state of another dtype. The JAX package casts
    the fields to float32 for both modes (bf16s rounded to bfloat16 first)
    and the grid for "float32", so its kernel gate sees float32 operands
    and runs K1 on them; so does the port (with the grid cast for both: K1
    reads float32 metrics), where a float64 state's own fields would take
    the plain versions."""
    if cfg.compute_dtype in ("float32", "bf16s") and dtype != torch.float32:
        return torch.float32
    return None


def k6_operand_dtype(cfg, dtype):
    """The dtype of the copies K6 reads on the "pallas" route for a
    ``dtype`` state, or None (K6 reads the fields themselves): float32
    under "float32" on a state of another dtype, bfloat16 under
    "bfloat16" (K6's bfloat16 instance), float64 under "float64" on a
    state of another dtype (K6's float64 instance). The JAX package casts
    the fields, f and the grid to the compute dtype and hands them to its
    kernel; so does the port."""
    cdt = K6_COMPUTE_DTYPES.get(cfg.compute_dtype)
    return cdt if cdt is not None and cdt != dtype else None


def array_tendencies(cfg, grid, ue, ve, tr_e, cdt):
    """The tendency stage in ``cdt`` (the JAX package's precision-lowered
    array path): ``tendency_math`` on the extended fields, f and the grid
    cast to that dtype (``grid.cast``, kept per dtype; on a tile, the
    tile's grid), interior tendencies cast back to the fields' dtype. For
    ``cdt="bf16x2"`` each of them is wrapped into bfloat16 limbs
    (``ops.multifloat.wrap_compute``, the grid by ``grid.cast``) and the
    tendencies come back through their float32 value, as the JAX
    package's ``to_array``."""
    dtype = ue.dtype
    grid_c = grid.cast(cdt)
    f = coriolis_ff(grid, cfg.coriolis).to(dtype)
    if cdt == "bf16x2":
        def wrap(x):
            return wrap_compute(x, cdt)
    else:
        def wrap(x):
            return x.to(cdt)
    Gu_e, Gv_e, Gtr_e = tendency_math(cfg, grid_c, wrap(f), wrap(ue), wrap(ve),
                                      {k: wrap(c) for k, c in tr_e.items()})
    return (grid.interior(Gu_e).to(dtype), grid.interior(Gv_e).to(dtype),
            {k: grid.interior(g).to(dtype) for k, g in Gtr_e.items()})


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
    """Zero u and v on solid faces once; a loop's steps keep it so (each
    re-masks after the barotropic correction), and pass ``premasked``. A
    tile's masks come from its own geometry, which ``parallel.localize``
    built from the exchanged bottom, so no exchange is needed here."""
    if not grid.immersed:
        return state
    u_mask, v_mask = interior_masks(grid)
    return state.replace(u=state.u * u_mask, v=state.v * v_mask)


def time_step(cfg, grid, state: HydrostaticState, dt, surface_fluxes=None,
              premasked=False, comm=None, restoring=None) -> HydrostaticState:
    """One quasi-AB2 hydrostatic step with the split-explicit or the
    explicit free surface and, with a closure, the vertically implicit
    solves; with ``comm``, of the tile ``grid`` (see ``parallel.sharded``);
    with ``restoring``, T/S relaxed toward targets (``compute_tendencies``).
    The step's root span, ``step``, holds its stages' ``step/*`` spans."""
    with span("step"):
        return ocean_step(cfg, grid, state, dt, surface_fluxes, premasked, comm, restoring)


def ocean_step(cfg, grid, state: HydrostaticState, dt, surface_fluxes=None,
               premasked=False, comm=None, restoring=None) -> HydrostaticState:
    """``time_step`` without the root span: the coupled steps run it inside
    their own."""
    if not premasked:
        state = premask_state(grid, state)
    dtype = state.u.dtype
    dt_t = _scalar_type(dtype)(dt)
    c1, c2 = _ab2_coeffs(cfg, state, dtype)
    ab = (float(dt_t * c1), float(dt_t * c2))
    Gu, Gv, Gtr, updated, ints, diffusivities, Geta = compute_tendencies(
        cfg, grid, state, ab, surface_fluxes, comm, restoring)
    wall = owns_south_wall(comm)
    G_ab = None
    a, b, h = float(c1), float(c2), float(dt_t)
    if updated is None:
        with span("step/ab2_update"):
            # the unfused update, in the JAX package's association:
            # x* = x + dt (c1 G + c2 G_prev)
            G_ab = (a * Gu + b * state.Gu, a * Gv + b * state.Gv)
            u_star = state.u + h * G_ab[0]
            v_star = state.v + h * G_ab[1]
            tracers = {k: state.tracers[k] + h * (a * Gtr[k] + b * state.Gtracers[k])
                       for k in state.tracers}
    else:
        u_star, v_star, tracers = updated
        v_star = mask_v_wall(v_star, wall)
    if Geta is not None:
        stage = "step/explicit_free_surface"
    else:
        blocked = comm is not None or cfg.kernels == "pallas"
        stage = "step/K5_barotropic" if blocked else "step/K2_barotropic"
    with span(stage):
        if Geta is not None:
            eta = state.eta + h * (a * Geta + b * state.Geta)
            u_new, v_new = u_star, v_star
        else:
            eta, u_new, v_new = barotropic_substep(cfg, grid, state, u_star, v_star, h, ints,
                                                   comm, G_ab)
            Geta = state.Geta
        v_new = mask_v_wall(v_new, wall)
        if grid.north_fold:
            with span("step/north_fold"):
                # the seam row its own mirror image (in place: every field
                # here is this step's own); on a tile, the top rank row's
                if comm is None:
                    north_fold_projection(grid, u_new, eta, tracers)
                else:
                    north_fold_projection_dist(comm, grid, u_new, eta, tracers)
        if grid.immersed:
            # the barotropic correction touched full columns
            u_mask, v_mask = interior_masks(grid)
            u_new = u_new * u_mask
            v_new = v_new * v_mask

    if isinstance(cfg.closure, VerticalScalarDiffusivity):
        with span("step/K3_implicit"):
            u_new, v_new, tracers = _scalar_solves(cfg, grid, u_new, v_new, tracers, h)
    elif diffusivities is not None:
        with span("step/K3_implicit"):
            u_new, v_new, tracers = _implicit_solves(cfg, grid, u_new, v_new, tracers,
                                                     diffusivities, h)

    t_new, t_lo = advance_clock(state.time, state.time_lo, h)
    return state.replace(
        u=u_new, v=v_new, eta=eta, tracers=tracers,
        Gu=Gu, Gv=Gv, Geta=Geta, Gtracers=Gtr,
        time=t_new, time_lo=t_lo, iteration=state.iteration + 1,
    )


def _scalar_solves(cfg, grid, u, v, tracers, dt):
    """``VerticalScalarDiffusivity``'s backward-Euler solves: (u, v) with
    nu, (T, S) with kappa, K3's constant-kappa pair twice; a lone b tracer
    with kappa as a field (K3's constant-kappa instance solves a pair)."""
    coef = grid_coefficients(grid, dt)
    nu, kappa = float(cfg.closure.nu), float(cfg.closure.kappa)
    u, v = implicit_solve(cfg, (u, v), nu, dt, *coef)
    names = plain_tracers(tracers)
    fields = tuple(tracers[k] for k in names)
    if len(fields) == 1:
        kappa = torch.full_like(fields[0], kappa)
    solved = implicit_solve(cfg, fields, kappa, dt, *coef)
    return u, v, {**tracers, **dict(zip(names, solved))}


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


def loop(cfg, grid, state, dt, n, comm=None, restoring=None, chunk=None):
    """``n`` time steps (the immersed mask applied once, before the first):
    on the card replayed from a captured CUDA graph (``device_loop``), also
    on a tile of the decomposed path whose mesh is the one card
    (``comm.mesh.size == 1``); on the CPU and on a tile of a mesh of several
    ranks launched step by step from the host (``host_loop``). ``chunk``: the
    call is one chunk of a driver that runs chunks of that many steps
    (``simulation.Simulation``), replayed whole (``device_loop``'s
    ``lead``)."""
    state = premask_state(grid, state)
    return run_loop(loop_step(cfg, grid, dt, comm, restoring), state, n, comm, grid.cache, chunk)


def loop_step(cfg, grid, dt, comm=None, restoring=None):
    """The step ``loop`` runs on its premasked state, as the
    ``functools.partial`` that keys its captured graph
    (``device_loop.warm`` and ``prepare`` capture that graph ahead of the
    loop)."""
    return functools.partial(time_step, cfg, grid, dt=dt, premasked=True, comm=comm,
                             restoring=restoring)
