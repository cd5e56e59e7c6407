"""K2's plain version and the port's barotropic solve against the JAX
package.

float32: ``barotropic_loop`` (plain on the CPU) against the JAX whole-loop
kernel ``pallas_barotropic_loop`` in interpret mode at rtol 1e-5, the
tolerance of tests/test_barotropic_kernel.py, with an atol of 1e-6 of each
output's largest value: the same substeps in the same flux-weighted form,
so only rounding of the precomputed planes differs.

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
from gb25_tpu.models import baroclinic_instability_config as jax_config
from gb25_tpu.models import baroclinic_instability_state as jax_state
from gb25_tpu.models.free_surface import barotropic_substep as jax_barotropic_substep
from gb25_tpu.ops.pallas_barotropic import pallas_barotropic_loop
from gb25_tpu_torch.convert import state_from_numpy
from gb25_tpu_torch.grids import simple_latitude_longitude_grid
from gb25_tpu_torch.models import baroclinic_instability_config
from gb25_tpu_torch.models.free_surface import barotropic_substep, face_depths
from gb25_tpu_torch.ops.pallas_barotropic import barotropic_loop
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
