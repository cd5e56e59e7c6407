"""The port's decomposition machinery: the process-grid policy, the halo
exchange on gloo meshes of spawned CPU ranks, and the per-tile grid and
atmosphere.

Each halo case spawns one gloo group (``parallel.spawn``) whose ranks run
``parallel.sharded.tile_snapshot``: random fields of every kind (3-D,
planes at the grid halo, planes at widths 1 and 3) cut to the tile and
extended through the exchange, and the tile's grid. Each must equal, bit
for bit, the window around the tile of the serially extended global field
(the serial fill is held against the JAX package's in
tests/test_torch_ops.py and tests/test_torch_tripolar.py), the tripolar
fold across the top rank row included; an immersed tile's geometry must
equal the window of the global geometry (its masks away from the outer
ring, where the face shift wraps within the extended tile in both
packages).
"""

import dataclasses

import numpy as np
import pytest
import torch

from gb25_tpu.parallel.mesh import factors as jax_factors
from gb25_tpu_torch.grids import simple_latitude_longitude_grid, tripolar_grid
from gb25_tpu_torch.grids.immersed import gaussian_islands_bottom
from gb25_tpu_torch.models.atmosphere import data_free_atmosphere
from gb25_tpu_torch.ops.halos import extend2, extend_field, extend_field_xy
from gb25_tpu_torch.parallel import Mesh, MeshComm, factors, localize_atmosphere, localize_grid
from gb25_tpu_torch.parallel import spawn
from gb25_tpu_torch.parallel.sharded import tile_snapshot


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: beside other busy
    test processes, torch's default of one OpenMP thread per core made the
    plain versions' many small launches ~100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_factors_policy():
    """tests/test_sharded.py's cases, and the JAX policy on every N to 64."""
    assert factors(4) == (2, 2)
    assert factors(16) == (4, 4)
    assert factors(8) == (4, 2)
    assert factors(2) == (2, 1)
    assert factors(512) == (32, 16)
    assert factors(6136) == (104, 59)
    assert factors(9152) == (143, 64)
    assert factors(9180) == (135, 68)
    rx, ry = factors(24)
    assert rx * ry == 24
    for n in range(1, 65):
        assert factors(n) == jax_factors(n), n


def test_mesh_rank_order():
    """Rank r holds tile (r // Ry, r % Ry), np.reshape(devices, (Rx, Ry))'s
    order."""
    order = np.arange(6).reshape(3, 2)
    for r in range(6):
        m = Mesh(3, 2, r)
        assert order[m.ix, m.iy] == r and m.rank_of(m.ix, m.iy) == r


def _grid(kind):
    if kind == "latlon":
        return simple_latitude_longitude_grid(32, 16, 4, device="cpu", dtype=torch.float64)
    return gaussian_islands_bottom(tripolar_grid(48, 32, 4, device="cpu", dtype=torch.float64))


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
@pytest.mark.parametrize("kind", ["latlon", "tripolar"])
def test_comm_halos_equal_serial_fill(kind, shape):
    grid = _grid(kind)
    Nz, Ny, Nx = grid.shape
    rng = np.random.default_rng(3)
    fields = {}
    for k in "cuvw":
        fields[k + "/3d"] = (k, rng.standard_normal((Nz, Ny, Nx)), None)
        fields[k + "/xy"] = (k, rng.standard_normal((Ny, Nx)), None)
        for h in (1, 3):
            fields[f"{k}/h{h}"] = (k, rng.standard_normal((Ny, Nx)), h)
    tiles = spawn(tile_snapshot, shape[0] * shape[1], grid, fields, shape=shape)

    Rx, Ry = shape
    nxl, nyl = Nx // Rx, Ny // Ry
    hx, hy = grid.hx, grid.hy
    for r, tile in enumerate(tiles):
        ix, iy = r // Ry, r % Ry

        def window(e, wx, wy, ring=0):
            return e[..., iy * nyl + ring : iy * nyl + nyl + 2 * wy,
                     ix * nxl + ring : ix * nxl + nxl + 2 * wx]

        for name, (k, a, h) in fields.items():
            a = torch.from_numpy(a)
            if a.dim() == 3:
                e, w = extend_field(grid, a, k), (hx, hy)
            elif h is None:
                e, w = extend_field_xy(grid, a, k), (hx, hy)
            else:
                e, w = extend2(grid, a, k, h), (h, h)
            np.testing.assert_array_equal(tile["halo/" + name], window(e, *w).numpy(),
                                          err_msg=f"rank {r}: {name}")
        for name in ("dxc", "dxf", "dyc", "dyf", "azc", "azf"):
            m = getattr(grid, name)
            want = m[:, iy * nyl : iy * nyl + nyl + 2 * hy]
            if m.shape[2] > 1:
                want = want[..., ix * nxl : ix * nxl + nxl + 2 * hx]
            np.testing.assert_array_equal(tile["grid/" + name], want.numpy(), err_msg=name)
        if grid.immersed:
            geo = grid.geometry
            np.testing.assert_array_equal(tile["grid/bottom_e"],
                                          window(geo.bottom_e, hx, hy).numpy())
            for name in ("u_mask", "v_mask"):
                np.testing.assert_array_equal(tile["grid/" + name][..., 1:, 1:],
                                              window(getattr(geo, name), hx, hy, 1).numpy(),
                                              err_msg=name)
            for name in ("bu", "bv", "Hu", "Hv"):
                want = getattr(geo, name)[iy * nyl : iy * nyl + nyl, ix * nxl : ix * nxl + nxl]
                np.testing.assert_array_equal(tile["grid/" + name], want.numpy(), err_msg=name)


def test_fold_needs_the_strip_on_the_top_row():
    """A top-row tile must hold W + 1 rows to source the fold strip."""
    grid = tripolar_grid(16, 8, 2, device="cpu", dtype=torch.float64, halo=(2, 2, 2))
    comm = MeshComm(Mesh(1, 4, 3), north_fold=True, pole_index=grid.pole_index)
    with pytest.raises(ValueError, match="ny_local >= halo"):
        extend2(localize_grid(grid, comm, 16, 2), torch.zeros(2, 16, dtype=torch.float64),
                "c", 2, comm)


@pytest.mark.parametrize("kind", ["latlon", "tripolar"])
def test_localize_slices(kind):
    """A tile's metrics, coordinates, bottom and atmosphere are the global
    ones' windows (no exchange: a flat grid, the tripolar grid without its
    bathymetry)."""
    if kind == "latlon":
        grid = simple_latitude_longitude_grid(32, 16, 4, device="cpu", dtype=torch.float64)
    else:
        grid = dataclasses.replace(tripolar_grid(48, 32, 4, device="cpu", dtype=torch.float64),
                                   geometry=None)
    atmos = data_free_atmosphere(grid)
    Rx, Ry = 2, 2
    nxl, nyl = grid.Nx // Rx, grid.Ny // Ry
    hx, hy = grid.hx, grid.hy
    for r in range(Rx * Ry):
        comm = MeshComm(Mesh(Rx, Ry, r))
        x0, y0 = comm.ix * nxl, comm.iy * nyl
        tile = localize_grid(grid, comm, nxl, nyl)
        assert (tile.Nx, tile.Ny, tile.Nz) == (nxl, nyl, grid.Nz)
        assert torch.equal(tile.lam_c, grid.lam_c[x0 : x0 + nxl + 2 * hx])
        assert torch.equal(tile.phi_f, grid.phi_f[y0 : y0 + nyl + 2 * hy])
        assert torch.equal(tile.bottom_height, grid.bottom_height[y0 : y0 + nyl, x0 : x0 + nxl])
        assert torch.equal(tile.z_c, grid.z_c)
        for name in ("dxc", "dyf", "azc", "azf"):
            m = getattr(grid, name)[:, y0 : y0 + nyl + 2 * hy]
            m = m[..., x0 : x0 + nxl + 2 * hx] if m.shape[2] > 1 else m
            assert torch.equal(getattr(tile, name), m), name
        if grid.north_fold:
            assert torch.equal(tile.phi2_c, grid.phi2_c[y0 : y0 + nyl, x0 : x0 + nxl])
            assert torch.equal(tile.phi2_ff,
                               grid.phi2_ff[:, y0 : y0 + nyl + 2 * hy, x0 : x0 + nxl + 2 * hx])
        la = localize_atmosphere(atmos, comm, nxl, nyl)
        for k, f in atmos.fields.items():
            assert torch.equal(la.fields[k], f[:, y0 : y0 + nyl, x0 : x0 + nxl]), k
        assert torch.equal(la.times, atmos.times)
