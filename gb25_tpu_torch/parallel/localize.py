"""A tile's own grid and atmosphere (port of ``gb25_tpu.parallel.localize``).

Every rank builds the global grid; each then slices out the window of its
tile plus halos from the global metrics (host-side slices: the tile's
offsets are Python ints), so the same physics code runs on a tile as on
the whole domain. The immersed geometry of a tile is built from its
exchanged bottom, as the step's masks are in the JAX package.
"""

from __future__ import annotations

import dataclasses

from gb25_tpu_torch.grids.immersed import build_geometry


def localize_grid(grid, comm, nx_local: int, ny_local: int):
    """The grid of ``comm``'s tile (``nx_local`` x ``ny_local`` cells)."""
    hx, hy = grid.hx, grid.hy
    x0, y0 = comm.ix * nx_local, comm.iy * ny_local
    xs = slice(x0, x0 + nx_local + 2 * hx)
    ys = slice(y0, y0 + ny_local + 2 * hy)

    def metric(m):  # (1, Ny+2hy, 1) profile or (1, Ny+2hy, Nx+2hx) plane
        return m[:, ys, xs if m.shape[2] > 1 else slice(None)].contiguous()

    def plane(a):  # (Ny, Nx) interior
        return a[y0 : y0 + ny_local, x0 : x0 + nx_local].contiguous()

    kw = dict(
        Nx=nx_local, Ny=ny_local,
        lam_c=grid.lam_c[xs], lam_f=grid.lam_f[xs], phi_c=grid.phi_c[ys], phi_f=grid.phi_f[ys],
        **{name: metric(getattr(grid, name)) for name in ("dxc", "dxf", "dyc", "dyf", "azc",
                                                          "azf")},
        bottom_height=plane(grid.bottom_height), geometry=None,
    )
    if grid.north_fold:
        kw.update(lam2_c=plane(grid.lam2_c), phi2_c=plane(grid.phi2_c),
                  phi2_ff=metric(grid.phi2_ff))
    tile = dataclasses.replace(grid, **kw)
    if grid.immersed:
        tile = dataclasses.replace(tile, geometry=build_geometry(tile, comm))
    return tile


def localize_atmosphere(atmos, comm, nx_local: int, ny_local: int):
    """The atmosphere of ``comm``'s tile: a pre-regridded one's (Nt, Ny, Nx)
    records sliced like any other ocean plane; a gather form's index and
    weight planes sliced so, its record on the atmosphere's grid kept
    whole."""
    x0, y0 = comm.ix * nx_local, comm.iy * ny_local

    def plane(f):
        return f[..., y0 : y0 + ny_local, x0 : x0 + nx_local].contiguous()

    if atmos.gather is not None:
        return dataclasses.replace(atmos, gather=tuple(map(plane, atmos.gather)))
    return dataclasses.replace(atmos, fields={k: plane(f) for k, f in atmos.fields.items()})
