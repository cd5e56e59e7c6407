"""Kernel K3's plain version (``implicit_diffusion_plain``) against the JAX
package's implicit vertical solves.

float32: against the JAX Pallas kernel ``pallas_implicit_diffusion`` in
interpret mode at 128x16x16 (x a multiple of the kernel's 128-lane tile),
two right-hand sides sharing kappa, and one with the decay term. The plain
version follows the Pallas kernel's recurrence term by term, so the two
agree to a few float32 ulps: rtol 1e-5, atol 1e-6 of the largest value.

float64: against the JAX array path ``ops.tridiagonal.
implicit_vertical_diffusion`` (a different coefficient order) at 1e-12,
and the port's own ``ops.tridiagonal`` reference against it at 1e-14.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gb25_tpu.grids import simple_latitude_longitude_grid as jax_grid
from gb25_tpu.ops.pallas_tridiag import pallas_implicit_diffusion
from gb25_tpu.ops.tridiagonal import implicit_vertical_diffusion as jax_implicit_vertical_diffusion
from gb25_tpu_torch.grids import simple_latitude_longitude_grid
from gb25_tpu_torch.models import baroclinic_instability_config
from gb25_tpu_torch.models import baroclinic_instability_model, time_step
from gb25_tpu_torch.models.keps import TKEDissipationVerticalDiffusivity
from gb25_tpu_torch.ops import pallas_tridiag
from gb25_tpu_torch.ops.pallas_tridiag import (
    grid_coefficients,
    implicit_diffusion,
    implicit_diffusion_plain,
    vertical_coefficients,
)
from gb25_tpu_torch.ops.tridiagonal import implicit_vertical_diffusion

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
    return torch.as_tensor(np.ascontiguousarray(np.transpose(a)))


def back(t):
    return np.transpose(t.numpy())


def _inputs(shape, np_dtype, seed=13):
    """Two fields, a face diffusivity spanning 1e-5..10 m^2/s and a decay
    rate, (X, Y, Z), from a numpy seed."""
    rng = np.random.default_rng(seed)
    f0 = rng.standard_normal(shape)
    f1 = 20.0 + rng.standard_normal(shape)
    kappa = 10.0 ** rng.uniform(-5.0, 1.0, shape)
    damp = 1e-3 * rng.random(shape)
    return [a.astype(np_dtype) for a in (f0, f1, kappa, damp)]


def _profiles(shape, jdtype, tdtype):
    gj = jax_grid(*shape, dtype=jdtype)
    gt = simple_latitude_longitude_grid(*shape, device="cpu", dtype=tdtype)
    hz, Nz = gj.hz, gj.Nz
    jz = (gj.dz_c[:, :, hz : hz + Nz], gj.dz_f[:, :, hz : hz + Nz])
    tz = (gt.dz_c[hz : hz + Nz], gt.dz_f[hz : hz + Nz])
    return jz, tz


@pytest.mark.parametrize("case", ["pair", "damped"])
def test_plain_k3_matches_jax_kernel_f32(case):
    shape = (128, 16, 16)
    f0, f1, kappa, damp = _inputs(shape, np.float32)
    (jdzc, jdzf), (tdzc, tdzf) = _profiles(shape, jnp.float32, torch.float32)
    if case == "pair":
        fields, damping = (f0, f1), None
    else:
        fields, damping = (f0,), damp
    ref = pallas_implicit_diffusion(
        tuple(jnp.asarray(f) for f in fields), jnp.asarray(kappa), DT, jdzc, jdzf,
        damping=None if damping is None else jnp.asarray(damping), interpret=True)
    a_lam, a_mu = vertical_coefficients(DT, tdzc, tdzf)
    got = implicit_diffusion_plain(tuple(t2(f) for f in fields), t2(kappa), DT, a_lam, a_mu,
                                   None if damping is None else t2(damping))
    assert len(got) == len(fields)
    for g, w in zip(got, ref):
        w = np.asarray(w)
        np.testing.assert_allclose(back(g), w, rtol=1e-5, atol=1e-6 * np.abs(w).max())


@pytest.mark.parametrize("damped", [False, True])
def test_plain_k3_matches_jax_array_path_f64(damped):
    shape = (24, 12, 20)
    f0, _, kappa, damp = _inputs(shape, np.float64, seed=14)
    (jdzc, jdzf), (tdzc, tdzf) = _profiles(shape, jnp.float64, torch.float64)
    damping = damp if damped else None
    want = np.asarray(jax_implicit_vertical_diffusion(
        jnp.asarray(f0), jnp.asarray(kappa), DT, jdzc, jdzf,
        damping=None if damping is None else jnp.asarray(damping)))
    tdamp = None if damping is None else t2(damping)
    cfg = baroclinic_instability_config()
    (got,) = implicit_diffusion(cfg, (t2(f0),), t2(kappa), DT, tdzc, tdzf, damping=tdamp)
    np.testing.assert_allclose(back(got), want, rtol=0, atol=1e-12 * np.abs(want).max())
    ref = implicit_vertical_diffusion(t2(f0), t2(kappa), DT, tdzc, tdzf, damping=tdamp)
    np.testing.assert_allclose(back(ref), want, rtol=0, atol=1e-14 * np.abs(want).max())


def test_solve_conserves_the_column_integral_f64():
    """Zero-flux ends: the solve leaves each column's sum of f dz
    unchanged (without decay), while it smooths the profile."""
    shape = (8, 4, 16)
    f0, _, kappa, _ = _inputs(shape, np.float64, seed=15)
    _, (tdzc, tdzf) = _profiles(shape, jnp.float64, torch.float64)
    a_lam, a_mu = vertical_coefficients(3600.0, tdzc, tdzf)
    (x,) = implicit_diffusion_plain((t2(f0),), t2(kappa), 3600.0, a_lam, a_mu)
    before = (t2(f0) * tdzc).sum(0)
    after = (x * tdzc).sum(0)
    torch.testing.assert_close(after, before, rtol=1e-12, atol=1e-12)
    assert float(x.std(0).mean()) < float(t2(f0).std(0).mean())


def test_dispatch_and_arguments_on_cpu():
    cfg = baroclinic_instability_config()
    shape = (16, 8, 6)
    f0, f1, kappa, _ = _inputs(shape, np.float32)
    _, (tdzc, tdzf) = _profiles(shape, jnp.float32, torch.float32)
    outs = [implicit_diffusion(dataclasses.replace(cfg, kernels=k), (t2(f0), t2(f1)), t2(kappa),
                               DT, tdzc, tdzf) for k in ("auto", "torch")]
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="one or two"):
        implicit_diffusion(cfg, (t2(f0),) * 3, t2(kappa), DT, tdzc, tdzf)


def test_coefficients_built_once_per_grid_and_dt(monkeypatch):
    """The step's (dt c_lam, dt c_mu) come from the grid's cache: equal to
    a fresh ``vertical_coefficients`` pair, reused by a second step with
    the same dt, built anew for a new dt."""
    cfg, grid, state = baroclinic_instability_model(
        16, 8, 6, device="cpu", closure=TKEDissipationVerticalDiffusivity())
    built = []
    fresh = pallas_tridiag.vertical_coefficients
    monkeypatch.setattr(pallas_tridiag, "vertical_coefficients",
                        lambda *a: built.append(a[0]) or fresh(*a))
    hz, Nz = grid.hz, grid.Nz
    state = time_step(cfg, grid, state, DT)
    pair = grid_coefficients(grid, DT)
    for got, want in zip(pair, fresh(DT, grid.dz_c[hz : hz + Nz], grid.dz_f[hz : hz + Nz])):
        assert torch.equal(got, want)
    state = time_step(cfg, grid, state, DT)
    assert built == [DT] and grid_coefficients(grid, DT) is pair
    time_step(cfg, grid, state, 2 * DT)
    assert built == [DT, 2 * DT]
    for got, want in zip(grid_coefficients(grid, 2 * DT),
                         fresh(2 * DT, grid.dz_c[hz : hz + Nz], grid.dz_f[hz : hz + Nz])):
        assert torch.equal(got, want)
