"""CATKE vertical mixing closure (port of ``gb25_tpu.models.catke``).

Diffusivities kappa_phi = ell_phi sqrt(e) at z faces for momentum (u),
tracers (c) and TKE (e); mixing lengths from Richardson-number-dependent
stability functions, limited by the boundary distance, with a convective
length where N^2 <= 0; TKE sources (shear production, buoyancy flux) and
the linearized dissipation rate lam_e = C_D sqrt(e) / ell applied
implicitly in the vertical solve. The constants are the JAX package's.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.ocean.ops.stencils import dz_f as d_zf
from benchmark.reference.ocean.ops.stencils import i_f, ix_c, iy_c, iz_c


@dataclasses.dataclass(frozen=True)
class CATKEVerticalDiffusivity:
    """CATKE closure. Adds tracer ``e`` [m^2/s^2]."""

    # stability-function asymptotes sigma_phi(Ri): low-Ri -> high-Ri
    C_lo_u: float = 0.76
    C_hi_u: float = 0.73
    C_lo_c: float = 0.84
    C_hi_c: float = 0.42
    C_lo_e: float = 3.6
    C_hi_e: float = 1.0
    Ri_0: float = 0.25      # stability-function step center
    Ri_delta: float = 0.50  # stability-function step width
    # convective (N^2 < 0) mixing-length multipliers of the boundary distance
    C_conv_c: float = 1.0
    C_conv_u: float = 0.5
    C_conv_e: float = 1.0
    # boundary-distance coefficients (surface / bottom)
    C_surf: float = 1.13
    C_bot: float = 0.28
    # dissipation eps = C_D(Ri) e^(3/2) / ell_e
    C_D_lo: float = 1.18
    C_D_hi: float = 0.37
    # surface TKE flux J_e = C_w_ustar * u_star^3
    C_w_ustar: float = 3.1
    # floors / caps
    ell_min: float = 1e-2     # mixing-length floor [m]
    e_min: float = 1e-7       # TKE floor [m^2/s^2]
    N2_min: float = 1e-12     # stratification floor in the stable length
    S2_min: float = 1e-14     # shear floor in Ri
    kappa_max: float = 10.0   # diffusivity cap [m^2/s]

    @property
    def tracer_names(self):
        return ("e",)


def _smooth_step(x):
    """0 -> 1 smooth step (scaled tanh)."""
    return 0.5 * (1.0 + torch.tanh(x))


def bottom_plane(grid):
    """The bottom depth that ``catke_math`` measures d_bot from: the
    extended bathymetry ``(1, Ny+2hy, Nx+2hx)`` on immersed grids, the
    domain's bottom face ``(1, 1, 1)`` otherwise."""
    if grid.immersed:
        return grid.geometry.bottom_e
    return grid.z_f[grid.hz].reshape(1, 1, 1)


def catke_diffusivities(closure, grid, ue, ve, be, ee):
    """Diffusivities and TKE sources from extended ``(Z, Y, X)`` fields;
    returns extended (kappa_u, kappa_c, kappa_e, G_e, lam_e)."""
    return catke_math(closure, ue, ve, be, ee, grid.dz_f, grid.z_f, bottom_plane(grid))


def catke_math(closure, ue, ve, be, ee, dzf, z_f, bot):
    """The CATKE formulation on extended tensors (shape preserving; the
    outermost ring of each axis is garbage, as with every stencil here).
    Kappas sit at the bottom face of each cell, G_e and lam_e at centers."""
    # stratification N^2 and shear S^2 at z faces (bottom face of cell k)
    N2 = d_zf(be) / dzf
    dudz = d_zf(ue) / dzf
    dvdz = d_zf(ve) / dzf
    S2 = ix_c(dudz * dudz) + iy_c(dvdz * dvdz)
    Ri = N2 / torch.clamp(S2, min=closure.S2_min)

    e_pos = torch.clamp(ee, min=closure.e_min)
    sqrt_e = torch.sqrt(e_pos)
    sqrt_e_face = i_f(sqrt_e, "z")

    # boundary distance: d = min(C_surf d_surf, C_bot d_bot)
    d_surf = torch.clamp(-z_f, min=closure.ell_min)
    d_bot = torch.clamp(z_f - bot, min=closure.ell_min)
    d_bdy = torch.minimum(closure.C_surf * d_surf, closure.C_bot * d_bot)
    d_bdy = torch.clamp(d_bdy, min=closure.ell_min)

    step = _smooth_step((Ri - closure.Ri_0) / closure.Ri_delta)

    def sigma(lo, hi):
        return lo + (hi - lo) * step

    N_stable = torch.sqrt(torch.clamp(N2, min=closure.N2_min))

    def mixing_length(lo, hi, c_conv):
        ell_stable = sigma(lo, hi) * sqrt_e_face / N_stable
        ell_st = torch.minimum(ell_stable, d_bdy)
        ell_cv = torch.minimum(c_conv * d_bdy, d_bdy)
        ell = torch.where(N2 > 0.0, ell_st, ell_cv)
        return torch.clamp(ell, min=closure.ell_min)

    ell_u = mixing_length(closure.C_lo_u, closure.C_hi_u, closure.C_conv_u)
    ell_c = mixing_length(closure.C_lo_c, closure.C_hi_c, closure.C_conv_c)
    ell_e = mixing_length(closure.C_lo_e, closure.C_hi_e, closure.C_conv_e)

    kap_u = torch.clamp(ell_u * sqrt_e_face, max=closure.kappa_max)
    kap_c = torch.clamp(ell_c * sqrt_e_face, max=closure.kappa_max)
    kap_e = torch.clamp(ell_e * sqrt_e_face, max=closure.kappa_max)

    # TKE sources at centers; the dissipation is returned as the implicit
    # decay rate lam_e = C_D sqrt(e) / ell
    P = iz_c(kap_u * S2)
    B = -iz_c(kap_c * N2)
    C_D = iz_c(sigma(closure.C_D_lo, closure.C_D_hi))
    ell_e_c = torch.clamp(iz_c(ell_e), min=closure.ell_min)
    lam_e = C_D * sqrt_e / ell_e_c
    G_e = P + B
    return kap_u, kap_c, kap_e, G_e, lam_e


def surface_tke_flux(closure, tau_x, tau_y):
    """Surface TKE injection J_e = C_w u*^3, u*^2 = |tau| / rho given as the
    kinematic stress magnitude."""
    ustar2 = torch.sqrt(tau_x**2 + tau_y**2)
    return closure.C_w_ustar * ustar2**1.5
