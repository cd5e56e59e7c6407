"""The column closures' diffusivities as plain PyTorch (a frozen copy of the
port's ``ops/pallas_catke.py`` plain versions; kernel K4 computes them on
the card): CATKE's kappa_u, kappa_c, kappa_e, the TKE source G_e and the
dissipation rate lam_e, the interior crops of ``models.catke``.
"""

from __future__ import annotations

from benchmark.reference.ocean.models.catke import catke_diffusivities


def catke_diffusivities_kernel(cfg, grid, ue, ve, be, ee):
    """Interior (kappa_u, kappa_c, kappa_e, G_e, lam_e) of ``cfg.closure``
    from extended ``(Nz+2hz, Ny+2hy, Nx+2hx)`` u, v, b, e."""
    return catke_diffusivities_plain(cfg.closure, grid, ue, ve, be, ee)


def catke_diffusivities_plain(closure, grid, ue, ve, be, ee):
    """The plain PyTorch version of K4: ``catke_math`` on the extended
    tensors, cropped to the interior (any dtype, any device)."""
    return tuple(grid.interior(a).contiguous()
                 for a in catke_diffusivities(closure, grid, ue, ve, be, ee))
