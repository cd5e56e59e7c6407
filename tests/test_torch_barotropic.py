"""K2's plain version and the port's barotropic solve against the JAX
package.

float32: ``barotropic_loop`` (plain on the CPU) against the JAX whole-loop
kernel ``pallas_barotropic_loop`` in interpret mode at rtol 1e-5, the
tolerance of tests/test_barotropic_kernel.py, with an atol of 1e-6 of each
output's largest value: the same substeps in the same flux-weighted form,
so only rounding of the precomputed planes differs. The same on the
tripolar grid with masks at a size that no tile plan divides (100 x 22,
the pole column 19).

K2's tile plan (``loop_plan``): every cell owned by exactly one tile, no
tile above the largest the kernel holds, no more tiles than blocks; its
check that masks are 0 or 1.

float64: the port's ``barotropic_substep`` against the JAX array path with
GB25_BAROTROPIC_BLOCK=1, which re-imposes the wall conditions every
substep as K2 does; the array path updates U, V where K2 updates U dyc,
V dxf, so only reassociation differs: 1e-12 of each field's largest value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gb25_tpu.grids import simple_latitude_longitude_grid as jax_grid
from gb25_tpu.grids import tripolar_grid as jax_tripolar_grid
from gb25_tpu.models import baroclinic_instability_config as jax_config
from gb25_tpu.models import baroclinic_instability_state as jax_state
from gb25_tpu.models.free_surface import barotropic_substep as jax_barotropic_substep
from gb25_tpu.ops.pallas_barotropic import pallas_barotropic_loop
from gb25_tpu_torch.convert import state_from_numpy
from gb25_tpu_torch.grids import simple_latitude_longitude_grid, tripolar_grid
from gb25_tpu_torch.models import baroclinic_instability_config
from gb25_tpu_torch.models.free_surface import barotropic_substep, face_depths
from gb25_tpu_torch.ops.pallas_barotropic import _zero_one, barotropic_loop, loop_plan
from gb25_tpu.utils.correctness import _leaf_names

DT = 60.0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: beside other busy
    test processes, torch's default of one OpenMP thread per core made the
    plain versions' many small launches ~100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t2(a):
    return torch.from_numpy(np.array(np.transpose(np.asarray(a))))


def back(t):
    return np.transpose(t.numpy())


def test_plain_k2_matches_jax_kernel_f32():
    Nx, Ny = 128, 32
    gj = jax_grid(Nx, Ny, 8, dtype=jnp.float32)
    gt = simple_latitude_longitude_grid(Nx, Ny, 8, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(21)
    eta0, U0, V0 = (rng.standard_normal((Nx, Ny)).astype(np.float32) * s
                    for s in (1e-2, 1.0, 1.0))
    GU, GV = (rng.standard_normal((Nx, Ny)).astype(np.float32) * 1e-4 for _ in range(2))
    V0[:, 0] = 0.0
    GV[:, 0] = 0.0
    Hu = Hv = np.full((Nx, Ny), 4000.0, np.float32)
    ref = pallas_barotropic_loop(
        jax_config(), gj, *(jnp.asarray(a) for a in (eta0, U0, V0, GU, GV, Hu, Hv)),
        jnp.float32(DT), interpret=True)
    out = barotropic_loop(baroclinic_instability_config(), gt,
                          *(t2(a) for a in (eta0, U0, V0, GU, GV, Hu, Hv)), DT)
    for got, want in zip(out, ref):
        # atol: a few float32 ulps of the largest value, for the elements
        # that cancel to near zero
        want = np.asarray(want)
        np.testing.assert_allclose(back(got), want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_plain_k2_fold_ragged_matches_jax_kernel_f32():
    """The plain K2 on the tripolar grid, with the immersed masks, against
    the JAX kernel in interpret mode at 100 x 22: no tile divides it and the
    pole column (19) lies inside a tile. dt = 10 s as the JAX fold test."""
    Nx, Ny = 100, 22
    gj = jax_tripolar_grid(Nx, Ny, 4, dtype=jnp.float32)
    gt = tripolar_grid(Nx, Ny, 4, device="cpu", dtype=torch.float32)
    assert gt.pole_index == gj.pole_index == 19
    rng = np.random.default_rng(23)
    eta0, U0, V0 = (rng.standard_normal((Nx, Ny)).astype(np.float32) * s
                    for s in (1e-3, 1.0, 1.0))
    GU, GV = (rng.standard_normal((Nx, Ny)).astype(np.float32) * 1e-4 for _ in range(2))
    V0[:, 0] = 0.0
    GV[:, 0] = 0.0
    Hu, Hv = (back(h) for h in face_depths(gt))
    mu, mv = (Hu > 0).astype(np.float32), (Hv > 0).astype(np.float32)
    assert 0 < mu.sum() < mu.size
    GU, GV = GU * mu, GV * mv
    ref = pallas_barotropic_loop(
        jax_config(), gj, *(jnp.asarray(a) for a in (eta0, U0, V0, GU, GV, Hu, Hv)),
        jnp.float32(10.0), jnp.asarray(mu), jnp.asarray(mv), interpret=True)
    out = barotropic_loop(baroclinic_instability_config(), gt,
                          *(t2(a) for a in (eta0, U0, V0, GU, GV, Hu, Hv)), 10.0, t2(mu), t2(mv))
    for got, want in zip(out, ref):
        want = np.asarray(want)
        assert np.isfinite(want).all()
        np.testing.assert_allclose(back(got), want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("Nx,Ny,blocks", [(1536, 768, 132), (768, 384, 132), (100, 20, 132),
                                          (37, 13, 6), (7, 5, 24), (9, 1, 5), (1536, 768, 128),
                                          (128, 64, 1)])
def test_k2_loop_plan_owns_every_cell_once(Nx, Ny, blocks):
    max_tile = (128, 80)
    plan = loop_plan(Nx, Ny, blocks, max_tile)
    assert plan is not None
    tx, ty, gx, gy = plan
    assert tx <= max_tile[0] and ty <= max_tile[1] and gx * gy <= blocks
    owner = np.zeros((Ny, Nx), np.int64)
    for b in range(gx * gy):
        x0, y0 = (b % gx) * tx, (b // gx) * ty
        assert x0 < Nx and y0 < Ny  # no empty tile
        owner[y0 : y0 + ty, x0 : x0 + tx] += 1
    assert (owner == 1).all()
    if (Nx, Ny, blocks) == (1536, 768, 132):
        assert plan == (128, 70, 12, 11)


def test_k2_loop_plan_none_beyond_capacity():
    """A grid that the co-resident tiles cannot hold takes the L2 instance."""
    assert loop_plan(3072, 1536, 132, (128, 80)) is None
    assert loop_plan(129, 81, 1, (128, 80)) is None
    assert loop_plan(128, 80, 1, (128, 80)) == (128, 80, 1, 1)


def test_k2_mask_check():
    """K2's kernel takes masks of 1 and +0 only (one bit a cell); the check
    is made once per mask tensor and made again after an in-place change."""
    mask = (torch.rand(6, 9, generator=torch.Generator().manual_seed(3)) > 0.3).float()
    assert _zero_one(mask) and _zero_one(mask)
    mask[2, 4] = 0.5
    assert not _zero_one(mask)
    mask[2, 4] = -0.0
    assert not _zero_one(mask)
    mask[2, 4] = 1.0
    assert _zero_one(mask)


def test_face_depths_flat_bottom():
    gt = simple_latitude_longitude_grid(16, 8, 4, device="cpu", dtype=torch.float64)
    Hu, Hv = face_depths(gt)
    assert Hu.shape == Hv.shape == (8, 16)
    assert float(Hu.min()) == float(Hu.max()) == float(Hv.min()) == 4000.0


def test_barotropic_substep_matches_jax_array_path_f64(monkeypatch):
    shape = (24, 12, 6)
    monkeypatch.setenv("GB25_BAROTROPIC_BLOCK", "1")
    monkeypatch.delenv("GB25_ZSLAB_INTERPRET", raising=False)
    gj = jax_grid(*shape, dtype=jnp.float64)
    gt = simple_latitude_longitude_grid(*shape, device="cpu", dtype=torch.float64)
    rng = np.random.default_rng(22)
    sj = jax_state(gj, noise_velocity=1e-3)
    sj = sj.replace(eta=jnp.asarray(rng.standard_normal(shape[:2]) * 1e-2))
    u_star = np.asarray(sj.u) + rng.standard_normal(shape) * 1e-4
    v_star = np.asarray(sj.v) + rng.standard_normal(shape) * 1e-4
    v_star[:, 0, :] = 0.0  # the wall row, as K1 leaves it
    dz = np.asarray(gj.dz_c)[:, :, 4:-4]
    ints = [np.sum(f * dz, axis=2) for f in (np.asarray(sj.u), np.asarray(sj.v), u_star, v_star)]

    ref = jax_barotropic_substep(
        jax_config(), gj, sj, jnp.asarray(u_star), jnp.asarray(v_star), None, None,
        jnp.float64(DT), integrals=[jnp.asarray(a) for a in ints])

    st = state_from_numpy({n: np.asarray(x) for n, x in _leaf_names(sj)}, "cpu")
    out = barotropic_substep(
        baroclinic_instability_config(), gt, st, t2(u_star), t2(v_star), DT,
        tuple(t2(a) for a in ints))
    for name, got, want in zip(("eta", "u", "v"), out, ref):
        want = np.asarray(want)
        np.testing.assert_allclose(back(got), want, rtol=0,
                                   atol=1e-12 * np.abs(want).max(), err_msg=name)
