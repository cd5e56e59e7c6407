"""The port's grids against the JAX package's.

Both sides build the metrics in float64 numpy with the same arithmetic and
cast at the end, so the comparison is bit for bit, in float64 and float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gb25_tpu.grids import latitude_longitude_grid as jax_grid
from gb25_tpu.grids.vertical import exponential_z_faces as jax_z_faces
from gb25_tpu_torch.grids import latitude_longitude_grid, exponential_z_faces

PAIRS = {torch.float64: jnp.float64, torch.float32: jnp.float32}
PROFILES = ("dxc", "dxf", "dyc", "dyf", "azc", "azf")  # (1, Y, 1) on both sides
ZROWS = ("z_c", "z_f", "dz_c", "dz_f")  # JAX (1, 1, Z), port (Z, 1, 1)
COORDS = ("lam_c", "lam_f", "phi_c", "phi_f")

GRID_ARGS = [
    dict(Nx=24, Ny=12, Nz=8),
    dict(Nx=16, Ny=10, Nz=6, halo=(3, 5, 4), surface_dz=None),
    dict(Nx=20, Ny=8, Nz=5, latitude=(-60.0, 70.0), longitude=(10.0, 130.0), depth=3000.0),
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: beside other busy
    test processes, torch's default of one OpenMP thread per core made the
    plain versions' many small launches ~100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("args", GRID_ARGS, ids=["simple", "uniform_z", "bounded_x"])
def test_latlon_metrics_bitwise(args, dtype):
    args = dict(args)
    Nx, Ny, Nz = args.pop("Nx"), args.pop("Ny"), args.pop("Nz")
    gj = jax_grid(Nx, Ny, Nz, dtype=PAIRS[dtype], **args)
    gt = latitude_longitude_grid(Nx, Ny, Nz, device="cpu", dtype=dtype, **args)
    assert (gt.Nx, gt.Ny, gt.Nz, gt.halo, gt.x_periodic) == (
        gj.Nx, gj.Ny, gj.Nz, gj.halo, gj.x_periodic)
    for name in PROFILES + COORDS:
        a = np.asarray(getattr(gj, name))
        b = getattr(gt, name).numpy()
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    for name in ZROWS:
        np.testing.assert_array_equal(
            getattr(gt, name).numpy().reshape(-1), np.asarray(getattr(gj, name)).reshape(-1),
            err_msg=name)
    np.testing.assert_array_equal(gt.bottom_height.numpy().T, np.asarray(gj.bottom_height))
    assert gt.dtype == dtype


@pytest.mark.parametrize("Nz,depth,h", [(64, 4000.0, 30.0), (8, 4000.0, 30.0), (4, 100.0, 50.0)])
def test_exponential_z_faces_bitwise(Nz, depth, h):
    np.testing.assert_array_equal(exponential_z_faces(Nz, depth, h), jax_z_faces(Nz, depth, h))
