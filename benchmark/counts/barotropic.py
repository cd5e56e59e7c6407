"""K2, the serial loop of barotropic substeps (``csrc/barotropic_loop.cu``),
and K5, a block of them on extended planes (``csrc/barotropic_block.cu``)."""

from __future__ import annotations

from benchmark.counts.shape import bound, sizes


def k2_bound(shape, masked=None):
    """The loop reads eta, U, V, GU, GV, Hu and Hv (two mask planes; on the
    tripolar grid the five metric planes, else five columns) and writes
    three filtered planes; 14 (16 masked) operations per cell and substep.
    ``masked``: the immersed masks (the shape's by default)."""
    masked = shape.immersed if masked is None else masked
    _, _, plane, _ = sizes(shape)
    nbytes = (7 + (2 if masked else 0) + 5 * int(shape.north_fold) + 3) * plane
    return bound(nbytes, (16 if masked else 14) * shape.substeps * shape.Nx * shape.Ny)


def k5_bound(Ye, Xe, substeps, metric2d, masked):
    """One block on (Ye, Xe) planes reads eta, U, V, the four forcing
    planes, dyc, dxf and dtau / area (planes on the tripolar grid, columns
    otherwise) and the two masks, and writes six planes; 14 (16 masked)
    operations per cell and substep."""
    plane = Ye * Xe * 4
    nbytes = (7 + 6 + (3 if metric2d else 0) + (2 if masked else 0)) * plane
    nbytes += 0 if metric2d else 3 * Ye * 4
    return bound(nbytes, (16 if masked else 14) * substeps * Ye * Xe)
