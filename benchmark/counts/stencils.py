"""Operations per cell of the tendency stencils (a hand count of the
kernels' source, ``csrc/tendency_tile.cuh``)."""

from __future__ import annotations

# operations of one reconstruction and its upwind selection, by tracer
# scheme (WENO-5's ~50)
RECON_OPS = {"weno5": 50, "centered2": 2, "upwind1": 1, "none": 0}


def stencil_ops(shape, ntr):
    """Operations per cell of the stencils under ``shape``'s schemes (600
    for the flagship's with two tracers): 120 for continuity, the pressure
    sums and gradient, the Coriolis products, the AB2 update and the
    integrals; the momentum advection (two reconstructions of q, WENO-5's
    or two operations each, 30 for the corner PV, the Bernoulli gradient
    and the vertical advection, the kinetic energy's 20 (Hollingsworth) or
    8 (standard); none under "none"); per tracer three reconstructions and
    15 for the fluxes and their divergence (none under "none")."""
    ops = 120
    if shape.momentum_advection != "none":
        q = RECON_OPS["weno5"] if shape.momentum_advection == "weno_vector_invariant" else 2
        ops += 2 * q + 30 + (20 if shape.ke_scheme == "hollingsworth" else 8)
    if shape.tracer_advection != "none":
        ops += ntr * (3 * RECON_OPS[shape.tracer_advection] + 15)
    return ops


# the buoyancy's operations per cell: TEOS-10's 48 multiply-add pairs of
# its Horner scheme, the reduced variables and b; the linear law's 6
EOS_OPS = {"teos10": 120, "linear": 6}
