"""Split-explicit free surface (port of ``gb25_tpu.models.free_surface``).

The barotropic system
    d eta / d tau = -div(U, V)
    d (U, V) / d tau = -g H grad(eta) + (GU, GV)
is integrated with ``substeps`` forward-backward substeps over
[t, t + 2 dt], forced by the depth-integrated AB2 tendency. The free
surface and the barotropic part of the updated velocities are replaced by
the filtered averages (weights sum to 1, centroid at t + dt). On immersed
grids the face depths are the discrete fluid depths and solid faces carry
no transport.

Serially the whole loop runs in kernel K2, which re-imposes the boundary
conditions every substep. On a tile of the decomposed path (``comm``) the
solve is blocked: eta, U and V are extended by W ghost rings from the
neighbours (W = ``exchange_width``), and kernel K5 advances W substeps on
the extended planes, each substep spoiling one outer ring, before the next
exchange. The wall ghosts then evolve within a block instead of being
re-mirrored, a round-off drift that each exchange resets; serial and
decomposed blocked runs at the same W agree. The ``kernels="pallas"``
route runs the blocked solve serially too, as the JAX package does there:
on a 1x1 tile of its own, whose ghosts come from the boundary conditions.

The explicit free surface (``ExplicitFreeSurface``) has no barotropic
solve: the step adds ``explicit_pressure_gradient`` to the momentum
tendencies and steps eta with ``explicit_eta_tendency``.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from gb25_tpu_torch.ops.halos import extend2, extend_field_xy
from gb25_tpu_torch.ops.pallas_barotropic import barotropic_block, barotropic_loop
from gb25_tpu_torch.ops.stencils import dx_c, dx_f, dy_c, dy_f
from gb25_tpu_torch.parallel.halo import make_comm
from gb25_tpu_torch.parallel.mesh import Mesh
from gb25_tpu_torch.utils.tracing import span


def averaging_weights(substeps: int, kind: str = "parabolic") -> np.ndarray:
    """Normalized filter weights over the [0, 2 dt] barotropic window."""
    tau = 2.0 * (np.arange(substeps, dtype=np.float64) + 1.0) / substeps
    if kind == "flat":
        w = np.ones(substeps)
    elif kind == "parabolic":
        w = np.maximum(tau * (2.0 - tau), 0.0)
    else:
        raise ValueError(f"unknown averaging kind {kind}")
    return w / w.sum()


def face_depths(grid):
    """Static column depth at u and v faces, (Ny, Nx) each. Flat grids:
    the mean of the two adjacent columns (ghosts from the "c" boundary
    conditions). Immersed grids: the sum of dz over the cells above the
    face bottom max(b, b_neighbour), so a solid face has depth 0 and the
    correction divides by exactly the depth the face mask spans (built
    once with the grid's geometry)."""
    if grid.immersed:
        return grid.geometry.Hu, grid.geometry.Hv
    He = extend2(grid, -grid.bottom_height, "c", h=1)
    Hc = He[1:-1, 1:-1]
    return 0.5 * (Hc + He[1:-1, :-2]), 0.5 * (Hc + He[:-2, 1:-1])


def barotropic_substep(cfg, grid, state, u_star, v_star, dt, integrals, comm=None, G_ab=None):
    """The split-explicit solve of one step; returns (eta_new, u_new, v_new).

    integrals: (U0, V0, Us, Vs), the depth integrals of (u, v, u*, v*) that
    K1 accumulates. The forcing is derived, GU = (Us - U0) / dt: u* was
    updated as u + dt G_ab, so no G_ab field exists. With ``comm`` (a tile
    of the decomposed path) the solve is blocked (K5).

    Unfused (the "pallas" route, a ``compute_dtype``) ``integrals`` is None
    and ``G_ab`` holds the AB2-combined tendencies (c1 Gu + c2 Gu_prev,
    c1 Gv + c2 Gv_prev): the integrals and the forcing GU = zint(Gu_ab) are
    taken here. The route decides the solve, as in the JAX package: K2 on
    the K1 routes, the blocked solve on the "pallas" route's own 1x1 tile
    unless ``comm`` is given."""
    if integrals is None:
        U0, V0, Us, Vs = (zint(grid, f) for f in (state.u, state.v, u_star, v_star))
        GU, GV = zint(grid, G_ab[0]), zint(grid, G_ab[1])
    else:
        U0, V0, Us, Vs = integrals
        GU = (Us - U0) / dt
        GV = (Vs - V0) / dt
    if comm is None and cfg.kernels == "pallas":
        comm = serial_comm(grid)
    if comm is not None:
        eta_b, U_b, V_b, Hu, Hv = _blocked_solve(cfg, grid, state.eta, U0, V0, GU, GV, dt, comm)
        return _finish(eta_b, u_star, v_star, U_b, V_b, Hu, Hv, Us, Vs)
    Hu, Hv = face_depths(grid)
    mu = mv = None
    if grid.immersed:
        mu, mv = grid.geometry.mu, grid.geometry.mv
        GU = GU * mu
        GV = GV * mv
    eta_b, U_b, V_b = barotropic_loop(cfg, grid, state.eta, U0, V0, GU, GV, Hu, Hv, dt,
                                      mu=mu, mv=mv)
    return _finish(eta_b, u_star, v_star, U_b, V_b, Hu, Hv, Us, Vs)


def explicit_pressure_gradient(cfg, grid, eta, comm=None):
    """The explicit free surface's barotropic pressure gradient, (Ny, Nx)
    planes added to Gu and Gv at every level: -g dx_f(eta) / dxc and
    -g dy_f(eta) / dyf on eta extended by the grid's halo."""
    hx, hy, Nx, Ny = grid.hx, grid.hy, grid.Nx, grid.Ny
    g = cfg.free_surface.gravitational_acceleration
    etae = extend_field_xy(grid, eta, "c", comm)[None]
    gu = -g * dx_f(etae) / grid.dxc
    gv = -g * dy_f(etae) / grid.dyf
    return gu[0, hy : hy + Ny, hx : hx + Nx], gv[0, hy : hy + Ny, hx : hx + Nx]


def explicit_eta_tendency(grid, ue, ve):
    """G_eta = -div(U, V) of the depth-integrated extended velocities
    (``ue``, ``ve``, in their own precision); the interior (Ny, Nx)."""
    hx, hy, hz, Nx, Ny, Nz = *grid.halo, grid.Nx, grid.Ny, grid.Nz
    dz = grid.dz_c[hz : hz + Nz]
    U = (ue[hz : hz + Nz] * dz).sum(dim=0, keepdim=True)
    V = (ve[hz : hz + Nz] * dz).sum(dim=0, keepdim=True)
    G = -(dx_c(U * grid.dyc) + dy_c(V * grid.dxf)) / grid.azc
    return G[0, hy : hy + Ny, hx : hx + Nx]


def zint(grid, f):
    """The depth integral sum_k f dz_c of an interior (Nz, Ny, Nx) field."""
    return (f * grid.dz_c[grid.hz : grid.hz + grid.Nz]).sum(dim=0)


def serial_comm(grid):
    """The 1x1 "local" tile of ``grid``'s serial blocked solve: no exchange,
    ghosts from the boundary conditions (the fold on the tripolar grid).
    Built once and kept in ``grid.cache``, its blocked statics with it."""
    comm = grid.cache.get("serial_comm")
    if comm is None:
        comm = grid.cache["serial_comm"] = make_comm(Mesh(1, 1), grid)
    return comm


def _finish(eta_b, u_star, v_star, U_b, V_b, Hu, Hv, Us, Vs):
    """Barotropic correction: replace the depth mean of (u*, v*) by the
    filtered transport."""
    du = (U_b - Us) / torch.clamp(Hu, min=1e-30)
    dv = (V_b - Vs) / torch.clamp(Hv, min=1e-30)
    return eta_b, u_star + du, v_star + dv


def exchange_width(fs, grid) -> int:
    """W of the blocked solve: ``fs.exchange_width`` or the grid halo,
    within the tile (a width-W exchange needs W rows of the neighbour)."""
    W = fs.exchange_width or min(grid.hx, grid.hy)
    return max(min(W, grid.Nx - 1, grid.Ny - 1), 1)


def blocked_statics(grid, comm, W):
    """The constant operands of the blocked solve at width W, built once
    per tile (kept by ``comm``): the metrics dxc, dxf, dyc, dyf, azc as
    (Ye, 1) columns or (Ye, Xe) planes, the face depths Hu, Hv and, on
    immersed grids, the solid-face masks mu, mv (else None), all extended
    by W rings. Ghost rules as the JAX package's: a metric's ghosts past
    the stored halo come from the exchange, zero-gradient at the y walls
    for the lat-lon columns, the "c" kind (mirror south, fold north) for 2-D
    planes; the face depths from the bottom extended by W + 1."""
    key = (id(grid), W)
    hit = comm.cache.get(key)
    if hit is not None and hit[0]() is grid:
        return hit[1]
    hx, hy, hz, Nx, Ny, Nz = *grid.halo, grid.Nx, grid.Ny, grid.Nz

    def metric(m):  # (1, Ny+2hy, 1) profile or (1, Ny+2hy, Nx+2hx) plane
        plane = m.shape[2] > 1
        if W <= min(hx, hy):
            xs = slice(hx - W, hx + Nx + W) if plane else slice(None)
            return m[0, hy - W : hy + Ny + W, xs].contiguous()
        if plane:
            return extend2(grid, m[0, hy : hy + Ny, hx : hx + Nx], "c", W, comm)
        return comm.extend_xy(m[0, hy : hy + Ny], 0, W, ("wrap", "wrap"),
                              ("zerograd", "zerograd"))

    metrics = tuple(metric(getattr(grid, n)) for n in ("dxc", "dxf", "dyc", "dyf", "azc"))
    if grid.immersed:
        bhe = extend2(grid, grid.bottom_height, "c", W + 1, comm)
        zc, dzc = grid.z_c[hz : hz + Nz], grid.dz_c[hz : hz + Nz]
        zero = torch.zeros((), dtype=dzc.dtype, device=dzc.device)
        c = bhe[1:-1, 1:-1]
        Hu = torch.where(zc > torch.maximum(c, bhe[1:-1, :-2]), dzc, zero).sum(dim=0)
        Hv = torch.where(zc > torch.maximum(c, bhe[:-2, 1:-1]), dzc, zero).sum(dim=0)
        mu, mv = (Hu > 0).to(grid.dtype), (Hv > 0).to(grid.dtype)
    else:
        He = extend2(grid, -grid.bottom_height, "c", W + 1, comm)
        Hu = 0.5 * (He[1:-1, 1:-1] + He[1:-1, :-2])
        Hv = 0.5 * (He[1:-1, 1:-1] + He[:-2, 1:-1])
        mu = mv = None
    statics = (*metrics, Hu, Hv, mu, mv)
    # the grid by weak reference: the serial tile's comm lives in the grid's
    # own cache, and a strong one would make a cycle that only the garbage
    # collector frees (with the device memory of the grid's captured loop)
    comm.cache[key] = (weakref.ref(grid), statics)
    return statics


def _blocked_solve(cfg, grid, eta, U0, V0, GU, GV, dt, comm):
    """The blocked split-explicit solve on a tile: blocks of W substeps
    (K5), each after a width-W exchange of eta, U and V. Returns the
    filtered (eta_b, U_b, V_b) and the interior face depths."""
    fs = cfg.free_surface
    M = fs.substeps
    weights = averaging_weights(M, fs.averaging)
    W = exchange_width(fs, grid)
    dxc, dxf, dyc, dyf, azc, Hu_e, Hv_e, mu, mv = blocked_statics(grid, comm, W)

    GU_e = extend2(grid, GU, "u", W, comm)
    GV_e = extend2(grid, GV, "v", W, comm)
    if mu is not None:
        GU_e = GU_e * mu
        GV_e = GV_e * mv
    # constant planes with dtau folded in, dtau in the working precision
    dtau = torch.tensor(2.0 * dt / M, dtype=eta.dtype)
    dtau_g = dtau * fs.gravitational_acceleration
    pu = dtau_g * Hu_e / dxc
    pv = dtau_g * Hv_e / dyf
    fu = dtau * GU_e
    fv = dtau * GV_e
    rz = dtau / azc

    def interior(a):
        return a[W:-W, W:-W]

    U, V = U0, V0
    eta_b = torch.zeros_like(eta)
    U_b = torch.zeros_like(U0)
    V_b = torch.zeros_like(V0)
    m = 0
    while m < M:
        block = min(W, M - m)
        with span("step/K5_exchange"):
            ext = [extend2(grid, a, k, W, comm) for a, k in ((eta, "c"), (U, "u"), (V, "v"))]
        eta_e, U_e, V_e, pe, pU, pV = barotropic_block(
            cfg, weights[m : m + block], *ext, pu, pv, fu, fv, dyc, dxf, rz, mu, mv)
        eta_b = eta_b + interior(pe)
        U_b = U_b + interior(pU)
        V_b = V_b + interior(pV)
        eta, U, V = interior(eta_e), interior(U_e), interior(V_e)
        m += block
    return eta_b, U_b, V_b, interior(Hu_e), interior(Hv_e)
