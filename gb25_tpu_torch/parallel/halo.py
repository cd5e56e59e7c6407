"""Halo exchange between neighbouring tiles (port of
``gb25_tpu.parallel.halo``).

Each extension along a mesh axis sends this tile's two edge strips to the
neighbours below and above and installs the strips they send back, with
``torch.distributed.batch_isend_irecv``; a tile on a global edge of a
bounded axis installs its own boundary-condition ghosts instead. Fields
are ``(..., Y, X)``: x is the last dimension, y the one before.

The rank is known on the host, so which tile takes the boundary condition
is a Python ``if``. A tile whose neighbour is itself (an axis of one rank
under ``force_ring``) copies its own strips on the device: gloo refuses a
rank that sends to itself, and a JAX identity permute is a copy too. The
up and down messages carry distinct tags and are posted in one fixed
order, so two ranks that are each other's neighbour on both sides (a
periodic axis of two ranks) match them.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from gb25_tpu_torch.ops.halos import FIELD_BCS, ghost_blocks
from gb25_tpu_torch.parallel.fold import fold_ghosts_north_dist
from gb25_tpu_torch.parallel.mesh import Mesh, Traffic, post

_DIM = {"x": -1, "y": -2}
_TAG = {("x", "up"): 1, ("x", "dn"): 2, ("y", "up"): 3, ("y", "dn"): 4}


@dataclasses.dataclass(frozen=True)
class MeshComm:
    """The halo-exchange context of one tile of ``mesh``.

    ``force_ring`` keeps the exchange structure on axes of one rank (the
    tile is its own neighbour: a device copy; boundary ghosts still at the
    walls): the decomposed program measured on one device. Without it an
    axis of one rank fills its ghosts from the boundary conditions alone."""

    mesh: Mesh
    x_periodic: bool = True
    y_periodic: bool = False
    north_fold: bool = False  # the tripolar fold across the top rank row
    pole_index: int = 0       # the fold's pole column (global)
    force_ring: bool = False
    # per-tile constants built once (models.free_surface.blocked_statics)
    cache: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)
    # the exchanges posted and the bytes sent (analysis.comm)
    traffic: Traffic = dataclasses.field(default_factory=Traffic, compare=False, repr=False)

    @property
    def Rx(self) -> int:
        return self.mesh.Rx

    @property
    def Ry(self) -> int:
        return self.mesh.Ry

    @property
    def ix(self) -> int:
        return self.mesh.ix

    @property
    def iy(self) -> int:
        return self.mesh.iy

    def _along(self, axis):
        """(R, index) of this tile along ``axis``."""
        return (self.Rx, self.ix) if axis == "x" else (self.Ry, self.iy)

    def _neighbour(self, axis, step):
        """The global rank of the tile ``step`` away along ``axis`` (mod R)."""
        m = self.mesh
        if axis == "x":
            r = m.rank_of((m.ix + step) % m.Rx, m.iy)
        else:
            r = m.rank_of(m.ix, (m.iy + step) % m.Ry)
        return m.global_rank(r)

    def exchange_strips(self, send_dn, send_up, axis, periodic, bc_lo, bc_hi):
        """The (lo, hi) ghost blocks of this tile along ``axis``: the
        neighbour below's top strip and the neighbour above's bottom strip,
        given this tile's bottom (``send_dn``) and top (``send_up``) strips;
        ``bc_lo``/``bc_hi`` where this tile is on the global edge of a
        bounded axis (they may be None elsewhere)."""
        R, idx = self._along(axis)
        if R == 1:
            if periodic and self.force_ring:  # the tile is its own neighbour
                return send_up.clone(), send_dn.clone()
            return bc_lo, bc_hi
        lo, hi = bc_lo, bc_hi  # replaced below where a neighbour sends
        has_lo = periodic or idx > 0
        has_hi = periodic or idx < R - 1
        group = self.mesh.group
        above, below = self._neighbour(axis, 1), self._neighbour(axis, -1)
        ops = []
        if has_hi:
            ops.append(dist.P2POp(dist.isend, send_up.contiguous(), above, group,
                                  _TAG[axis, "up"]))
        if has_lo:
            ops.append(dist.P2POp(dist.isend, send_dn.contiguous(), below, group,
                                  _TAG[axis, "dn"]))
            lo = torch.empty_like(send_up, memory_format=torch.contiguous_format)
            ops.append(dist.P2POp(dist.irecv, lo, below, group, _TAG[axis, "up"]))
        if has_hi:
            hi = torch.empty_like(send_dn, memory_format=torch.contiguous_format)
            ops.append(dist.P2POp(dist.irecv, hi, above, group, _TAG[axis, "dn"]))
        post(ops, self.traffic)
        return lo, hi

    def fill_axis(self, e, h, axis, modes, periodic):
        """Write the ``h`` ghosts on both sides of ``e`` along ``axis``
        (its interior in place): exchanged from the neighbours, or from the
        boundary conditions ``modes`` on a global edge."""
        dim = _DIM[axis]
        n = e.shape[dim] - 2 * h
        R, idx = self._along(axis)
        if R > 1 and h > n:
            raise ValueError(f"halo width {h} exceeds the local tile extent {n} along {axis}: "
                             "use a smaller halo or fewer ranks")
        inner = e.narrow(dim, h, n)
        local = R == 1 and not self.force_ring
        bc_lo = bc_hi = None
        if local or (not periodic and idx in (0, R - 1)):
            bc_lo, bc_hi = ghost_blocks(inner, h, e.dim() + dim, *modes)
        lo, hi = self.exchange_strips(inner.narrow(dim, 0, h), inner.narrow(dim, n - h, h),
                                      axis, periodic, bc_lo, bc_hi)
        e.narrow(dim, 0, h).copy_(lo)
        e.narrow(dim, h + n, h).copy_(hi)

    def fill_xy(self, e, hx, hy, xmodes, ymodes):
        """Write the x, then the y ghosts of ``e`` (``(..., Ny+2hy,
        Nx+2hx)``, its interior in place), as the serial fill orders them:
        the y strips carry their x ghosts, so the corners agree."""
        if hx:
            self.fill_axis(e.narrow(-2, hy, e.shape[-2] - 2 * hy), hx, "x", xmodes,
                           self.x_periodic)
        if hy:
            self.fill_axis(e, hy, "y", ymodes, self.y_periodic)
        return e

    def fill_xy_fold(self, e, hx, hy, kind):
        """The tripolar fill of ``e``: the south wall, the neighbours' rows
        or, on the top rank row, the fold rows in y; then the periodic x
        ring over whole columns (the serial order: fold, south, x wrap)."""
        (xlo, xhi), (ylo, _), _ = FIELD_BCS[kind]
        Ny, Nx = e.shape[-2] - 2 * hy, e.shape[-1] - 2 * hx
        if hy:
            a = e[..., hy : hy + Ny, hx : hx + Nx]
            bc_lo = ghost_blocks(a, hy, a.dim() - 2, ylo, "zerograd")[0] if self.iy == 0 else None
            bc_hi = fold_ghosts_north_dist(self, a, hy, kind) if self.iy == self.Ry - 1 else None
            lo, hi = self.exchange_strips(a[..., :hy, :], a[..., Ny - hy :, :], "y", False,
                                          bc_lo, bc_hi)
            e[..., :hy, hx : hx + Nx] = lo
            e[..., hy + Ny :, hx : hx + Nx] = hi
        if hx:
            self.fill_axis(e, hx, "x", (xlo, xhi), True)
        return e

    def extend_xy(self, a, hx, hy, xmodes, ymodes):
        """``a`` (``(..., Ny, Nx)``) extended by ``hx``, ``hy`` ghosts."""
        return self.fill_xy(_padded(a, hx, hy), hx, hy, xmodes, ymodes)

    def extend_xy_fold(self, a, hx, hy, kind):
        """``a`` extended by ``hx``, ``hy`` ghosts on the tripolar grid."""
        return self.fill_xy_fold(_padded(a, hx, hy), hx, hy, kind)


def make_comm(mesh, grid=None, force_ring: bool = False) -> MeshComm:
    """The halo-exchange context of this rank's tile (the fold's pole
    column from a tripolar ``grid``)."""
    kw = {}
    if grid is not None and grid.north_fold:
        kw = dict(north_fold=True, pole_index=grid.pole_index)
    return MeshComm(mesh, force_ring=force_ring, **kw)


def _padded(a, hx, hy):
    """A new ``(..., Ny+2hy, Nx+2hx)`` tensor with ``a`` as its interior."""
    Ny, Nx = a.shape[-2:]
    e = a.new_empty((*a.shape[:-2], Ny + 2 * hy, Nx + 2 * hx))
    e[..., hy : hy + Ny, hx : hx + Nx] = a
    return e
