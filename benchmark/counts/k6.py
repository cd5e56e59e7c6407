"""K6, the one-pass tendency stage with the buoyancy inside
(``csrc/tendencies.cu``)."""

from __future__ import annotations

from benchmark.counts.shape import F64_FLOP_PER_S, bound, sizes
from benchmark.counts.stencils import EOS_OPS, stencil_ops


def k6_bound(shape, value_bytes=4):
    """K6 with the shape's tracers: it reads u, v and the tracers extended
    (a value of ``value_bytes``: 4, 2 in the bfloat16 instances, which also
    write bfloat16, or 8 in the float64 instance, whose metric planes are
    float64 too and whose operations run at the FP64 rate) and (tripolar)
    the six metrics and f as extended planes, and writes the interior G of
    each. Operations: ``stencil_ops`` less the AB2 update and integrals K6
    does not do (20), plus the buoyancy's (``EOS_OPS``; the b tracer 0) and
    the pre-pass's column sums (10). Returns (ms, bound_by)."""
    ntr = len(shape.tracers)
    n, ext, _, ext_plane = sizes(shape)
    nprog = 2 + ntr
    nbytes = (nprog * ext + nprog * n) * value_bytes // 4
    f64 = value_bytes == 8
    nbytes += (7 * ext_plane * (2 if f64 else 1)) if shape.north_fold else 0
    eos_ops = 0 if "b" in shape.tracers else EOS_OPS[shape.eos]
    ops = stencil_ops(shape, ntr) - 20 + eos_ops + 10
    return bound(nbytes, ops * shape.cells, F64_FLOP_PER_S if f64 else None)
