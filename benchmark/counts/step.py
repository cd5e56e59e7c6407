"""The whole step's least work, the same whichever route or kernels run it:
what ``step_mfu_pct`` divides by the measured time of a step."""

from __future__ import annotations

from benchmark.counts.closure import K4_OPS, k3_ops
from benchmark.counts.shape import bound, sizes
from benchmark.counts.stencils import EOS_OPS, stencil_ops


def step_terms(shape):
    """(bytes, operations) of one step, term by term, as two lists of
    (name, amount). Bytes: each prognostic 3-D field (u, v and the
    tracers) and its AB2 tendency read once and written once; the free
    surface read and written; the grid's planes (the metric and Coriolis
    planes of a tripolar grid, the face-bottom planes of an immersed one)
    and the atmosphere's planes read once; the sea ice's planes read and
    written; each restoring target read once and its rate plane.
    Operations per cell: the stencils (``stencil_ops``), the buoyancy, and
    with CATKE K4's hand count and K3's solves of (u, v), the plain tracers
    and the damped e."""
    n, _, plane, ext_plane = sizes(shape)
    nprog = 2 + len(shape.tracers)
    nbytes = [("prognostic fields and tendencies, read and written", 4 * nprog * n),
              ("free surface, read and written", 2 * plane)]
    if shape.north_fold:
        nbytes.append(("tripolar metric and Coriolis planes", 7 * ext_plane))
    if shape.immersed:
        nbytes.append(("face-bottom planes", 2 * plane))
    if shape.atmosphere_planes:
        nbytes.append(("atmosphere planes", shape.atmosphere_planes * plane))
    if shape.ice_planes:
        nbytes.append(("sea-ice planes, read and written", 2 * shape.ice_planes * plane))
    if shape.restored:
        nbytes.append(("restoring targets and rate", len(shape.restored) * n + plane))
    ops = [("stencils", stencil_ops(shape, len(shape.tracers)))]
    if "b" not in shape.tracers:
        ops.append(("buoyancy", EOS_OPS[shape.eos]))
    if shape.closure == "catke":
        plain = [k for k in shape.tracers if k not in ("e", "eps")]
        ops += [("CATKE diffusivities (K4)", K4_OPS),
                ("vertical solves (K3)", k3_ops(2) + k3_ops(len(plain)) + k3_ops(1, True))]
    return nbytes, [(name, per_cell * shape.cells) for name, per_cell in ops]


def step_bound(shape):
    """(ms, bound_by): the least time of one step, the larger of its
    operations at the float32 peak and its bytes at the memory peak."""
    nbytes, ops = step_terms(shape)
    return bound(sum(b for _, b in nbytes), sum(o for _, o in ops))
