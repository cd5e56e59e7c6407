"""Split-explicit free surface as plain PyTorch (a frozen copy of the port's
``models/free_surface.py``, serial only).

The barotropic system
    d eta / d tau = -div(U, V)
    d (U, V) / d tau = -g H grad(eta) + (GU, GV)
is integrated with ``substeps`` forward-backward substeps over
[t, t + 2 dt], forced by the depth-integrated AB2 tendency. The free
surface and the barotropic part of the updated velocities are replaced by
the filtered averages (weights sum to 1, centroid at t + dt). On immersed
grids the face depths are the discrete fluid depths and solid faces carry
no transport.

Off the "pallas" route the loop of substeps re-imposes the boundary
conditions every substep (what kernel K2 computes). On the "pallas" route
the solve is blocked: eta, U and V are extended by W ghost rings from the
boundary conditions (W = ``exchange_width``), and W substeps advance on
the extended planes (what kernel K5 computes), each spoiling one outer
ring, before the next extension.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.ocean.ops.halos import extend2, extend_axis
from benchmark.reference.ocean.ops.pallas_barotropic import barotropic_block, barotropic_loop


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


def barotropic_substep(cfg, grid, state, u_star, v_star, dt, integrals, G_ab=None):
    """The split-explicit solve of one step; returns (eta_new, u_new, v_new).

    integrals: (U0, V0, Us, Vs), the depth integrals of (u, v, u*, v*) of
    the fused stage. The forcing is derived, GU = (Us - U0) / dt: u* was
    updated as u + dt G_ab, so no G_ab field exists. Unfused (the "pallas"
    route) ``integrals`` is None and ``G_ab`` holds the AB2-combined
    tendencies (c1 Gu + c2 Gu_prev, c1 Gv + c2 Gv_prev): the integrals and
    the forcing GU = zint(Gu_ab) are taken here, and the solve is
    blocked."""
    if integrals is None:
        U0, V0, Us, Vs = (zint(grid, f) for f in (state.u, state.v, u_star, v_star))
        GU, GV = zint(grid, G_ab[0]), zint(grid, G_ab[1])
    else:
        U0, V0, Us, Vs = integrals
        GU = (Us - U0) / dt
        GV = (Vs - V0) / dt
    if cfg.kernels == "pallas":
        eta_b, U_b, V_b, Hu, Hv = _blocked_solve(cfg, grid, state.eta, U0, V0, GU, GV, dt)
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


def zint(grid, f):
    """The depth integral sum_k f dz_c of an interior (Nz, Ny, Nx) field."""
    return (f * grid.dz_c[grid.hz : grid.hz + grid.Nz]).sum(dim=0)


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


def blocked_statics(grid, W):
    """The constant operands of the blocked solve at width W, built once
    per grid and W (kept in ``grid.cache``): the metrics dxc, dxf, dyc, dyf,
    azc as (Ye, 1) columns or (Ye, Xe) planes, the face depths Hu, Hv and,
    on immersed grids, the solid-face masks mu, mv (else None), all
    extended by W rings: a metric's ghosts past the stored halo
    zero-gradient at the y walls for the lat-lon columns, the "c" kind
    (mirror south, fold north) for 2-D planes; the face depths from the
    bottom extended by W + 1."""
    key = ("blocked_statics", W)
    hit = grid.cache.get(key)
    if hit is not None:
        return hit
    hx, hy, hz, Nx, Ny, Nz = *grid.halo, grid.Nx, grid.Ny, grid.Nz

    def metric(m):  # (1, Ny+2hy, 1) profile or (1, Ny+2hy, Nx+2hx) plane
        plane = m.shape[2] > 1
        if W <= min(hx, hy):
            xs = slice(hx - W, hx + Nx + W) if plane else slice(None)
            return m[0, hy - W : hy + Ny + W, xs].contiguous()
        if plane:
            return extend2(grid, m[0, hy : hy + Ny, hx : hx + Nx], "c", W)
        return extend_axis(m[0, hy : hy + Ny], W, 0, "zerograd", "zerograd")

    metrics = tuple(metric(getattr(grid, n)) for n in ("dxc", "dxf", "dyc", "dyf", "azc"))
    if grid.immersed:
        bhe = extend2(grid, grid.bottom_height, "c", W + 1)
        zc, dzc = grid.z_c[hz : hz + Nz], grid.dz_c[hz : hz + Nz]
        zero = torch.zeros((), dtype=dzc.dtype, device=dzc.device)
        c = bhe[1:-1, 1:-1]
        Hu = torch.where(zc > torch.maximum(c, bhe[1:-1, :-2]), dzc, zero).sum(dim=0)
        Hv = torch.where(zc > torch.maximum(c, bhe[:-2, 1:-1]), dzc, zero).sum(dim=0)
        mu, mv = (Hu > 0).to(grid.dtype), (Hv > 0).to(grid.dtype)
    else:
        He = extend2(grid, -grid.bottom_height, "c", W + 1)
        Hu = 0.5 * (He[1:-1, 1:-1] + He[1:-1, :-2])
        Hv = 0.5 * (He[1:-1, 1:-1] + He[:-2, 1:-1])
        mu = mv = None
    statics = grid.cache[key] = (*metrics, Hu, Hv, mu, mv)
    return statics


def _blocked_solve(cfg, grid, eta, U0, V0, GU, GV, dt):
    """The blocked split-explicit solve: blocks of W substeps, each after a
    width-W extension of eta, U and V. Returns the filtered (eta_b, U_b,
    V_b) and the interior face depths."""
    fs = cfg.free_surface
    M = fs.substeps
    weights = averaging_weights(M, fs.averaging)
    W = exchange_width(fs, grid)
    dxc, dxf, dyc, dyf, azc, Hu_e, Hv_e, mu, mv = blocked_statics(grid, W)

    GU_e = extend2(grid, GU, "u", W)
    GV_e = extend2(grid, GV, "v", W)
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
        ext = [extend2(grid, a, k, W) for a, k in ((eta, "c"), (U, "u"), (V, "v"))]
        eta_e, U_e, V_e, pe, pU, pV = barotropic_block(
            cfg, weights[m : m + block], *ext, pu, pv, fu, fv, dyc, dxf, rz, mu, mv)
        eta_b = eta_b + interior(pe)
        U_b = U_b + interior(pU)
        V_b = V_b + interior(pV)
        eta, U, V = interior(eta_e), interior(U_e), interior(V_e)
        m += block
    return eta_b, U_b, V_b, interior(Hu_e), interior(Hv_e)
