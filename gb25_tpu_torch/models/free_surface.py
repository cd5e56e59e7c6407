"""Split-explicit free surface (port of ``gb25_tpu.models.free_surface``,
serial, non-immersed).

The barotropic system
    d eta / d tau = -div(U, V)
    d (U, V) / d tau = -g H grad(eta) + (GU, GV)
is integrated with ``substeps`` forward-backward substeps over
[t, t + 2 dt], forced by the depth-integrated AB2 tendency. The free
surface and the barotropic part of the updated velocities are replaced by
the filtered averages (weights sum to 1, centroid at t + dt).
"""

from __future__ import annotations

import numpy as np
import torch

from gb25_tpu_torch.ops.halos import extend2
from gb25_tpu_torch.ops.pallas_barotropic import barotropic_loop


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
    """Static column depth at u and v faces, (Ny, Nx) each: the mean of
    the two adjacent columns (ghosts from the "c" boundary conditions)."""
    He = extend2(grid, -grid.bottom_height, "c", h=1)
    Hc = He[1:-1, 1:-1]
    return 0.5 * (Hc + He[1:-1, :-2]), 0.5 * (Hc + He[:-2, 1:-1])


def barotropic_substep(cfg, grid, state, u_star, v_star, dt, integrals):
    """The split-explicit solve of one step; returns (eta_new, u_new, v_new).

    integrals: (U0, V0, Us, Vs), the depth integrals of (u, v, u*, v*) that
    K1 accumulates. The forcing is derived, GU = (Us - U0) / dt: u* was
    updated as u + dt G_ab, so no G_ab field exists."""
    U0, V0, Us, Vs = integrals
    GU = (Us - U0) / dt
    GV = (Vs - V0) / dt
    Hu, Hv = face_depths(grid)
    eta_b, U_b, V_b = barotropic_loop(cfg, grid, state.eta, U0, V0, GU, GV, Hu, Hv, dt)
    return _finish(eta_b, u_star, v_star, U_b, V_b, Hu, Hv, Us, Vs)


def _finish(eta_b, u_star, v_star, U_b, V_b, Hu, Hv, Us, Vs):
    """Barotropic correction: replace the depth mean of (u*, v*) by the
    filtered transport."""
    du = (U_b - Us) / torch.clamp(Hu, min=1e-30)
    dv = (V_b - Vs) / torch.clamp(Hv, min=1e-30)
    return eta_b, u_star + du, v_star + dv
