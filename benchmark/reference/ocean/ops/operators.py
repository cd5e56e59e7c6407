"""Finite-volume operators on the staggered C grid (port of
``gb25_tpu.ops.operators``): horizontal divergence, vertical vorticity,
kinetic energy, continuity w, hydrostatic pressure and the Coriolis
parameter. Inputs and outputs are halo-extended ``(Z, Y, X)`` tensors;
each difference or interpolation consumes one cell of halo validity.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.ocean.ops.stencils import dx_c, dx_f, dy_c, dy_f, ix_c, iy_c, sm, sp


def horizontal_divergence(grid, u, v):
    """del_h . (u, v) at cell centers: (dx_c(u dy) + dy_c(v dx)) / Az."""
    return (dx_c(u * grid.dyc) + dy_c(v * grid.dxf)) * (1.0 / grid.azc)


def vertical_vorticity(grid, u, v):
    """zeta at corners (f, f): (dx_f(v dyf) - dy_f(u dxc)) / azf."""
    return (dx_f(v * grid.dyf) - dy_f(u * grid.dxc)) * (1.0 / grid.azf)


def kinetic_energy(u, v, scheme="hollingsworth"):
    """K at cell centers: "standard", the plain C-grid K; "hollingsworth"
    (the JAX package's default), 2/3 of the plain K plus 1/3 of the K of
    the transverse two-point averages."""
    Ks = 0.5 * (ix_c(u * u) + iy_c(v * v))
    if scheme == "standard":
        return Ks
    ubar = 0.5 * (sp(u, "y") + sm(u, "y"))
    vbar = 0.5 * (sp(v, "x") + sm(v, "x"))
    Kb = 0.5 * (ix_c(ubar * ubar) + iy_c(vbar * vbar))
    third = 1.0 / 3.0
    return (2.0 * third) * Ks + third * Kb


def cumsum_z(x):
    """``torch.cumsum`` along z, summed in float32 for a bfloat16 or
    float16 ``x`` and rounded once per output. PyTorch's CPU scan sums
    reduced precision in float32, its CUDA scan in the input's dtype: a
    bfloat16 running sum rounded at every level loses the hydrostatic
    pressure (p ~ 300 m^2/s^2, where a bfloat16 ulp is 2), and the
    "bfloat16" compute mode then parts from float32 on the card alone. A
    ``TwoFloat`` takes its own float32 cumsum of the limbs."""
    if isinstance(x, torch.Tensor) and x.dtype in (torch.bfloat16, torch.float16):
        return torch.cumsum(x, dim=0, dtype=torch.float32).to(x.dtype)
    return torch.cumsum(x, dim=0)


def diagnose_w(grid, u, v):
    """Vertical velocity at z faces from continuity, integrated up from
    w = 0 at the sea floor. z ghosts: zero below the bottom, the surface
    value repeated above it."""
    hz, Nz = grid.hz, grid.Nz
    div = horizontal_divergence(grid, u, v)
    div_int = div[hz : hz + Nz] * grid.dz_c[hz : hz + Nz]
    wcum = cumsum_z(div_int)
    zero = torch.zeros_like(wcum[:1])
    w_top = -wcum[-1:]
    return torch.cat([zero] * (hz + 1) + [-wcum[:-1]] + [w_top] * hz, dim=0)


def hydrostatic_pressure(grid, b):
    """Hydrostatic pressure anomaly p/rho0 at cell centers, dp/dz = b
    integrated down from p(surface) = 0:
    p[k] = csum[k] - total - b[k] dz[k] / 2. z ghosts copy the end rows."""
    hz, Nz = grid.hz, grid.Nz
    bdz = b[hz : hz + Nz] * grid.dz_c[hz : hz + Nz]
    total = bdz.sum(dim=0, keepdim=True)
    p_int = cumsum_z(bdz) - total - 0.5 * bdz
    return torch.cat([p_int[:1]] * hz + [p_int] + [p_int[-1:]] * hz, dim=0)


def coriolis_ff(grid, omega):
    """Planetary vorticity f = 2 Omega sin(phi) at corners (f, f), shaped
    (1, Ny+2hy, 1), or (1, Ny+2hy, Nx+2hx) from the tripolar grid's
    extended corner latitude."""
    if grid.north_fold:
        return (2.0 * omega * torch.sin(grid.phi2_ff * (math.pi / 180.0))).to(grid.dtype)
    f = 2.0 * omega * torch.sin(grid.phi_f * (math.pi / 180.0))
    return f.reshape(1, -1, 1).to(grid.dtype)
