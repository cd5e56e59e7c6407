"""WENO-5 (Jiang & Shu) upwind reconstruction on halo-extended tensors
(port of ``gb25_tpu.ops.weno``, the factored division-free form that the
JAX package uses by default), and the second-order centred and first-order
upwind reconstructions of its other tracer schemes.

Two alignments cover the staggered grid:
  - ``align="face"``  : reconstruct at face ``i`` (between cells i-1 and i)
                        from cell-centered data (tracer fluxes);
  - ``align="center"``: reconstruct at center ``j`` (between faces j and
                        j+1) from face data (vorticity in the
                        vector-invariant momentum scheme).
"""

from __future__ import annotations

import torch

from benchmark.reference.ocean.ops.stencils import sm, sp

# optimal linear weights of the three candidate stencils
_G0, _G1, _G2 = 0.1, 0.6, 0.3
_C13 = 13.0 / 12.0


def _weno5_from_shifts(m2, m1, s0, p1, p2, eps):
    """WENO-5 reconstruction half a cell right of ``s0`` from the five
    upwind-ordered samples (``m2`` farthest upwind).

    Candidate polynomials and smoothness indicators are rebuilt from the
    first differences d1..d4, and the nonlinear weights are multiplied
    through by t0 t1 t2 (t_i = (beta_i + eps)^2), leaving one division.
    In float32 the pairwise products overflow once a sample jump exceeds
    ~6e4 field units; ocean fields sit orders of magnitude below that."""
    sixth = 1.0 / 6.0
    d1 = m1 - m2
    d2 = s0 - m1
    d3 = p1 - s0
    d4 = p2 - p1
    q0 = s0 + (5.0 * d2 - 2.0 * d1) * sixth
    q1 = s0 + (d2 + 2.0 * d3) * sixth
    q2 = s0 + (4.0 * d3 - d4) * sixth
    x0 = d2 - d1
    x1 = d3 - d2
    x2 = d4 - d3
    y1 = d2 + d3
    b0 = _C13 * x0 * x0 + 0.25 * (x0 + 2.0 * d2) ** 2
    b1 = _C13 * x1 * x1 + 0.25 * y1 * y1
    b2 = _C13 * x2 * x2 + 0.25 * (x2 - 2.0 * d3) ** 2
    t0 = (b0 + eps) ** 2
    t1 = (b1 + eps) ** 2
    t2 = (b2 + eps) ** 2
    w0 = _G0 * (t1 * t2)
    w1 = _G1 * (t0 * t2)
    w2 = _G2 * (t0 * t1)
    return (w0 * q0 + w1 * q1 + w2 * q2) / (w0 + w1 + w2)


def weno5_upwind(a, vel, axis: str, align: str = "face", eps: float = 1e-6):
    """Upwind WENO-5 reconstruction of ``a`` at the points of ``vel``.

    The five samples are selected by the wind first and one reconstruction
    runs. The test is strict (``vel > 0``): a zero velocity, as on the
    v = 0 wall faces, takes the from-above stencil, as in the JAX package.
    """
    lo = 1 if align == "face" else 0

    def at(off):
        k = off - lo
        return sp(a, axis, k) if k >= 0 else sm(a, axis, -k)

    pos = vel > 0.0
    m2 = torch.where(pos, at(-2), at(3))
    m1 = torch.where(pos, at(-1), at(2))
    s0 = torch.where(pos, at(0), at(1))
    p1 = torch.where(pos, at(1), at(0))
    p2 = torch.where(pos, at(2), at(-1))
    return _weno5_from_shifts(m2, m1, s0, p1, p2, eps)


def centered2(a, axis: str, align: str = "face"):
    """Second-order centred reconstruction, with ``weno5_upwind``'s
    alignments: 0.5 (a + a[i - 1]) at faces, 0.5 (a + a[i + 1]) at
    centres."""
    if align == "face":
        return 0.5 * (a + sm(a, axis))
    return 0.5 * (a + sp(a, axis))


def upwind1(a, vel, axis: str, align: str = "face"):
    """First-order upwind (donor cell) reconstruction: the value below the
    point where ``vel > 0`` (strict, as ``weno5_upwind``), else the value
    above."""
    if align == "face":
        below, above = sm(a, axis), a
    else:
        below, above = a, sp(a, axis)
    return torch.where(vel > 0.0, below, above)
