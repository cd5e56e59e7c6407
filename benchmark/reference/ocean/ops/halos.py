"""Halo extension (port of ``gb25_tpu.ops.halos``, single device).

Fields are stored interior-only; each stage extends them with ``h`` ghost
cells per side from their boundary conditions:

  - ``wrap``            periodic
  - ``mirror``          reflection about a boundary lying between samples
                        (free-slip tangential velocity, no-flux tracer)
  - ``antimirror_face`` antisymmetric reflection for a wall-normal velocity
                        whose first / virtual last sample sits on the wall
  - ``zerograd``        replicate the edge value
  - ``zero``            zeros

On the tripolar grid (``grid.north_fold``) the north ghosts are the fold
rows of ``grids.tripolar`` instead, filled before the south boundary and
the x wrap, as in the JAX package. (A frozen copy of the port's
``ops/halos.py``, serial only.)
"""

from __future__ import annotations

import torch

# (x_lo, x_hi), (y_lo, y_hi), (z_lo, z_hi) for a periodic-x, bounded-y,
# bounded-z domain
FIELD_BCS = {
    # tracers and other cell-centered scalars: no-flux walls
    "c": (("wrap", "wrap"), ("mirror", "mirror"), ("zerograd", "zerograd")),
    # zonal velocity (x-face, y-center): free-slip at the y walls
    "u": (("wrap", "wrap"), ("mirror", "mirror"), ("zerograd", "zerograd")),
    # meridional velocity (y-face): impenetrable walls
    "v": (("wrap", "wrap"), ("antimirror_face", "antimirror_face"), ("zerograd", "zerograd")),
    # vertical velocity (z-face): w = 0 below the bottom, zero gradient above
    "w": (("wrap", "wrap"), ("mirror", "mirror"), ("zero", "zerograd")),
}

# named axis -> dimension of a (Z, Y, X) tensor / of a (Y, X) plane
_DIM3 = {"x": 2, "y": 1, "z": 0}
_DIM2 = {"x": 1, "y": 0}


def ghost_blocks(a, h: int, dim: int, lo_mode: str, hi_mode: str):
    """Return the (lo, hi) ghost slabs of width ``h`` along ``dim``."""
    n = a.shape[dim]
    if lo_mode == "wrap":
        lo = a.narrow(dim, n - h, h)
    elif lo_mode == "mirror":
        lo = a.narrow(dim, 0, h).flip(dim)
    elif lo_mode == "antimirror_face":
        lo = -a.narrow(dim, 1, h).flip(dim)  # a[0] is on the wall
    elif lo_mode == "zerograd":
        lo = a.narrow(dim, 0, 1).repeat_interleave(h, dim)
    elif lo_mode == "zero":
        lo = torch.zeros_like(a.narrow(dim, 0, h))
    else:
        raise ValueError(f"unknown lo_mode {lo_mode}")

    if hi_mode == "wrap":
        hi = a.narrow(dim, 0, h)
    elif hi_mode == "mirror":
        hi = a.narrow(dim, n - h, h).flip(dim)
    elif hi_mode == "antimirror_face":
        # the wall is the virtual face n: ghosts are [0, -a[n-1], -a[n-2], ...]
        wall = torch.zeros_like(a.narrow(dim, 0, 1))
        tail = -a.narrow(dim, n - (h - 1), h - 1).flip(dim)
        hi = torch.cat([wall, tail], dim=dim)
    elif hi_mode == "zerograd":
        hi = a.narrow(dim, n - 1, 1).repeat_interleave(h, dim)
    elif hi_mode == "zero":
        hi = torch.zeros_like(a.narrow(dim, 0, h))
    else:
        raise ValueError(f"unknown hi_mode {hi_mode}")
    return lo, hi


def extend_axis(a, h: int, dim: int, lo_mode: str, hi_mode: str):
    if h == 0:
        return a
    lo, hi = ghost_blocks(a, h, dim, lo_mode, hi_mode)
    return torch.cat([lo, a, hi], dim=dim)


def extend_field(grid, a, kind: str):
    """Extend an interior ``(Nz, Ny, Nx)`` field to
    ``(Nz+2hz, Ny+2hy, Nx+2hx)``: one allocation, the interior copied in,
    then the ghost slabs written axis by axis (x, then y, then z), each
    from the slabs already filled. Every mode acts within its own axis, so
    the corners agree with the JAX package's fill. On the tripolar grid the
    x and y ghosts are the fold's (fold, south, x wrap), then z."""
    hx, hy, hz = grid.halo
    Nz, Ny, Nx = a.shape
    e = a.new_empty((Nz + 2 * hz, Ny + 2 * hy, Nx + 2 * hx))
    e[hz : hz + Nz, hy : hy + Ny, hx : hx + Nx] = a
    axes = (("x", hx, Nx), ("y", hy, Ny), ("z", hz, Nz))
    if grid.north_fold:
        from benchmark.reference.ocean.grids.tripolar import fill_fold_halos

        fill_fold_halos(grid, e[hz : hz + Nz], kind, hx, hy)
        axes = axes[2:]
    for axis, h, n in axes:
        if h == 0:
            continue
        dim = _DIM3[axis]
        lo_mode, hi_mode = FIELD_BCS[kind]["xyz".index(axis)]
        lo, hi = ghost_blocks(e.narrow(dim, h, n), h, dim, lo_mode, hi_mode)
        e.narrow(dim, 0, h).copy_(lo)
        e.narrow(dim, h + n, h).copy_(hi)
    return e


def extend2(grid, a, kind: str, h: int = 1):
    """Extend a ``(Ny, Nx)`` plane by ``h`` ghosts in x and y."""
    return _extend_plane(grid, a, kind, h, h)


def extend_field_xy(grid, a, kind: str):
    """Extend a ``(Ny, Nx)`` plane by the grid's halo (hx in x, hy in y)."""
    return _extend_plane(grid, a, kind, grid.hx, grid.hy)


def _extend_plane(grid, a, kind, hx, hy):
    if grid.north_fold:
        from benchmark.reference.ocean.grids.tripolar import extend_field_tripolar

        return extend_field_tripolar(grid, a, kind, hx, hy)
    (xlo, xhi), (ylo, yhi), _ = FIELD_BCS[kind]
    a = extend_axis(a, hx, _DIM2["x"], xlo, xhi)
    return extend_axis(a, hy, _DIM2["y"], ylo, yhi)
