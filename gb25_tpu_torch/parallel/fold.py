"""The tripolar north fold across tiles (port of
``gb25_tpu.parallel.fold``), in the port's (..., Y, X) layout.

The T-pivot fold maps global centre column x to (2p - x) mod Nx and x-face
column x to (2p + 1 - x) mod Nx. The tile [ix nxl, (ix + 1) nxl) of the top
rank row therefore needs a reversed contiguous range of source columns,
starting at (2p + 1 + face - (ix + 1) nxl) mod Nx, which straddles at most
two tiles s0, s1 = s0 + 1 with the constant split r = (2p + 1 + face) mod
nxl. Only the top rank row takes part: each of its tiles sends its top
rows to the (at most two) tiles that need them, then stitches, reverses
and signs what it received. A tile that is its own source copies.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from gb25_tpu_torch.parallel.mesh import post

_TAG = {("c", 0): 11, ("c", 1): 12, ("u", 0): 13, ("u", 1): 14}


def _fold_sources(Rx, nxl, p, face):
    """(s0, s1, r): the source tiles of each destination tile's fold
    range, and the split offset."""
    Nx = Rx * nxl
    shift = 2 * p + (2 if face else 1)  # start(ix) + nxl = shift - ix nxl
    s0 = [((shift - (ix + 1) * nxl) % Nx) // nxl for ix in range(Rx)]
    return s0, [(s + 1) % Rx for s in s0], shift % nxl


def fold_exchange_strips(comm, a, h, faces=("c", "u")):
    """{face: strip}: the top ``h`` + 1 rows of the global field, gathered
    along x into this tile's fold order (column xl holds the source column
    of destination xg = ix nxl + xl), for centre-folded ("c") and/or
    face-folded ("u") quantities. Top rank row only."""
    nyl, nxl = a.shape[-2:]
    if nyl < h + 1:
        # the strip would have to come partly from the rank row below
        raise ValueError(f"tripolar north fold needs ny_local >= halo+1 ({h + 1}), got {nyl}: "
                         "reduce Ry (or the halo) so the top rank row holds the fold strip")
    strip = a[..., nyl - 1 - h :, :].contiguous()
    mesh = comm.mesh
    Rx, me = mesh.Rx, mesh.ix

    def rank(ix):
        return mesh.global_rank(mesh.rank_of(ix, mesh.Ry - 1))

    out = {}
    for key in faces:
        s0, s1, r = _fold_sources(Rx, nxl, comm.pole_index, key == "u")
        slots = ((0, s0), (1, s1)) if r else ((0, s0),)
        got, ops = {}, []
        for slot, src in slots:
            for dst in range(Rx):  # my strip to every tile it is a source of
                if src[dst] == me and dst != me:
                    ops.append(dist.P2POp(dist.isend, strip, rank(dst), mesh.group,
                                          _TAG[key, slot]))
            if src[me] == me:
                got[slot] = strip
            else:
                got[slot] = torch.empty_like(strip)
                ops.append(dist.P2POp(dist.irecv, got[slot], rank(src[me]), mesh.group,
                                      _TAG[key, slot]))
        post(ops, comm.traffic)
        # ascending source columns: [r, nxl) of s0, then [0, r) of s1
        stitched = torch.cat([got[0][..., r:], got[1][..., :r]], dim=-1) if r else got[0]
        out[key] = stitched.flip(-1)
    return out


def fold_ghosts_north_dist(comm, a, h, kind):
    """The ``h`` ghost rows beyond the seam of ``a`` (``(..., ny_local,
    nx_local)``) on a top-row tile, in ghost order, as
    ``grids.tripolar.fold_ghosts_north`` gives them serially: centres
    +a(fold, P - m), u -a(fold_u, P - m), v -a(fold, P + 1 - m), m = 1..h."""
    face = "u" if kind == "u" else "c"
    src = fold_exchange_strips(comm, a, h, (face,))[face]  # row t: source row P - h + t
    rows = src[..., 1:, :] if kind == "v" else src[..., :h, :]
    g = rows.flip(-2)
    return -g if kind in ("u", "v") else g


def north_fold_projection_dist(comm, grid, u, eta, tracers):
    """The seam-row projection of ``grids.tripolar.north_fold_projection``
    on the top rank row (the seam is its local last row): u takes the
    antisymmetric, the centre fields the symmetric part of the row and its
    fold. Writes in place; the other tiles have no seam."""
    if comm.iy != comm.Ry - 1:
        return
    P = grid.Ny - 1
    mirror = fold_exchange_strips(comm, u, 0, ("u",))["u"][..., 0, :]
    u[..., P, :] = 0.5 * (u[..., P, :] - mirror)
    for c in (eta, *tracers.values()):
        mirror = fold_exchange_strips(comm, c, 0, ("c",))["c"][..., 0, :]
        c[..., P, :] = 0.5 * (c[..., P, :] + mirror)
