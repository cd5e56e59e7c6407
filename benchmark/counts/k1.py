"""K1, the fused tendency stage (``csrc/zslab_tendencies.cu``)."""

from __future__ import annotations

from benchmark.counts.shape import bound, sizes
from benchmark.counts.stencils import stencil_ops


def k1_bound(shape, fused=True, value_bytes=4):
    """K1 with the shape's tracers: it reads u, v, b and the tracers
    extended (b once where it is the "b" tracer) and the column total of b.
    Fused, it reads the previous G of every field, (immersed) two
    face-bottom planes and (tripolar) the six metrics and f as extended
    planes, and writes the new G and the updated field of each and four
    integral planes; unfused (a value of ``value_bytes``: 4, or 2 stored as
    bfloat16), it writes the interior tendencies (and reads the tripolar
    planes too). Operations: ``stencil_ops``. Returns (ms, bound_by)."""
    ntr = len(shape.tracers)
    n, ext, plane, ext_plane = sizes(shape)
    nprog = 2 + ntr
    nread = 2 + ntr + int("b" not in shape.tracers)
    if fused:
        nbytes = nread * ext + ext_plane + 3 * nprog * n + 4 * plane
        nbytes += 2 * plane if shape.immersed else 0
    else:
        nbytes = nread * ext * value_bytes // 4 + ext_plane + nprog * n
    nbytes += 7 * ext_plane if shape.north_fold else 0
    return bound(nbytes, stencil_ops(shape, ntr) * shape.cells)
