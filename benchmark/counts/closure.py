"""K3, the vertically implicit solves (``csrc/implicit_diffusion.cu``), and
K4, CATKE's diffusivities (``csrc/catke_diffusivities.cu``)."""

from __future__ import annotations

from benchmark.counts.shape import bound, sizes

K4_OPS = 110  # per cell, square roots and the tanh counted as one each


def k3_ops(nf, damped=False):
    """Operations per cell of one solve of ``nf`` right-hand sides."""
    return 6 + 4 * nf + 2 * int(damped)


def k3_bound(shape, nf, damped, const_kappa=False):
    """Each solve reads its fields, kappa (a field unless constant) and the
    decay rate and writes the solutions; ``k3_ops`` per cell."""
    n, _, _, _ = sizes(shape)
    return bound((2 * nf + int(not const_kappa) + int(damped)) * n,
                 k3_ops(nf, damped) * shape.cells)


def k4_bound(shape):
    """K4 reads u, v, b, e and the bottom plane extended and writes five
    interior fields; ``K4_OPS`` per cell."""
    n, ext, _, ext_plane = sizes(shape)
    return bound(4 * ext + ext_plane + 5 * n, K4_OPS * shape.cells)
