"""k-epsilon vertical mixing closure (port of ``gb25_tpu.models.keps``).

Prognostic TKE ``e`` and dissipation ``eps`` with the standard
two-equation closure (Rodi 1987 constants):

    de/dt   = P + B - eps
    deps/dt = (eps / e) (C1 P + C3 B - C2 eps)
    kappa_u = C_mu e^2 / eps;  kappa_c = kappa_u / sigma_c; ...

all pointwise per column (z stencil radius 1). The implicit diffusion
reuses kernel K3. The constants are the JAX package's.
"""

from __future__ import annotations

import dataclasses

import torch

from gb25_tpu_torch.ops.stencils import dz_f as d_zf
from gb25_tpu_torch.ops.stencils import i_f, ix_c, iy_c, iz_c


@dataclasses.dataclass(frozen=True)
class TKEDissipationVerticalDiffusivity:
    """k-epsilon closure. Adds tracers ``e`` [m^2/s^2] and ``eps`` [m^2/s^3]."""

    C_mu: float = 0.09
    C_eps1: float = 1.44
    C_eps2: float = 1.92
    C_eps3_stable: float = -0.63
    C_eps3_unstable: float = 1.0
    sigma_c: float = 1.0     # Prandtl number for tracers
    sigma_k: float = 1.0     # Schmidt number for e
    sigma_eps: float = 1.3   # Schmidt number for eps
    e_min: float = 1e-7
    eps_min: float = 1e-10
    kappa_max: float = 10.0

    @property
    def tracer_names(self):
        return ("e", "eps")


def keps_diffusivities(closure, grid, ue, ve, be, ee, epse):
    """Diffusivities and sources from extended ``(Z, Y, X)`` fields;
    returns extended (kappa_u, kappa_c, kappa_e, kappa_eps, G_e, G_eps)."""
    return keps_math(closure, ue, ve, be, ee, epse, grid.dz_f)


def keps_math(closure, ue, ve, be, ee, epse, dzf):
    """The k-epsilon formulation on extended tensors (shape preserving; the
    outermost ring of each axis is garbage). Kappas sit at the bottom face
    of each cell, the sources at centers.

    The Prandtl and Schmidt divisions are products with the reciprocals,
    taken in double before they meet a tensor: PyTorch divides a CUDA
    tensor by a Python number that way, so written out the CPU, the card
    and kernel K4 round alike (the JAX package divides; the two differ by
    at most an ulp)."""
    N2 = d_zf(be) / dzf
    dudz = d_zf(ue) / dzf
    dvdz = d_zf(ve) / dzf
    S2 = ix_c(dudz * dudz) + iy_c(dvdz * dvdz)  # at z faces of the tracer columns

    e_pos = torch.clamp(ee, min=closure.e_min)
    eps_pos = torch.clamp(epse, min=closure.eps_min)

    kap_u_c = torch.clamp(closure.C_mu * e_pos * e_pos / eps_pos, max=closure.kappa_max)
    kap_u = i_f(kap_u_c, "z")
    kap_c = kap_u * (1.0 / closure.sigma_c)
    kap_e = kap_u * (1.0 / closure.sigma_k)
    kap_eps = kap_u * (1.0 / closure.sigma_eps)

    P = iz_c(kap_u * S2)   # shear production at centers
    B = -iz_c(kap_c * N2)  # buoyancy flux at centers
    G_e = P + B - eps_pos

    # C3 B: the unstable constant where the buoyancy flux is positive
    C3B = torch.where(B > 0.0, closure.C_eps3_unstable * B, closure.C_eps3_stable * B)
    G_eps = (eps_pos / e_pos) * (closure.C_eps1 * P + C3B - closure.C_eps2 * eps_pos)
    return kap_u, kap_c, kap_e, kap_eps, G_e, G_eps
