"""The port's k-epsilon closure against the JAX package's.

K4's k-epsilon function: its plain version ``keps_diffusivities_plain`` in
float32 against the JAX Pallas kernel ``keps_diffusivities_kernel`` in
interpret mode at the kernel-vs-array tolerance of
tests/test_pallas_catke.py (rtol 1e-6, atol 1e-12), both handed the same
buoyancy (a float32 ulp of TEOS-10 could flip the B > 0 branch); in float64
against the JAX array function ``keps_diffusivities`` at 1e-12.

The flagship step with the closure (tracers T, S, e, eps, started from the
JAX tests' e = 1e-5, eps = 1e-8): 3 steps in float64 against JAX
``kernels="jnp"`` with GB25_BAROTROPIC_BLOCK=1 at 1e-10 of each field's
largest value, and one step in float32 against the JAX interpret-mode
kernels (z-slab with four tracers, k-epsilon, barotropic, Thomas) at rtol
1e-3 / atol 5e-6, as tests/test_pallas_catke.py holds its own kernel step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gb25_tpu.grids import simple_latitude_longitude_grid as jax_grid
from gb25_tpu.models import baroclinic_instability_config as jax_config
from gb25_tpu.models import baroclinic_instability_state as jax_state
from gb25_tpu.models import time_step as jax_time_step
from gb25_tpu.models.config import HydrostaticConfig as JaxConfig
from gb25_tpu.models.hydrostatic import buoyancy_field as jax_buoyancy_field
from gb25_tpu.models.keps import TKEDissipationVerticalDiffusivity as JaxKEps
from gb25_tpu.models.keps import keps_diffusivities as jax_keps_diffusivities
from gb25_tpu.ops.halos import extend_field as jax_extend_field
from gb25_tpu.ops.pallas_catke import keps_diffusivities_kernel as jax_keps_kernel
from gb25_tpu.utils.correctness import _leaf_names
from gb25_tpu_torch.convert import state_from_numpy, state_to_numpy
from gb25_tpu_torch.grids import simple_latitude_longitude_grid
from gb25_tpu_torch.models import (
    HydrostaticConfig,
    baroclinic_instability_config,
    baroclinic_instability_model,
    loop,
    time_step,
)
from gb25_tpu_torch.models.keps import TKEDissipationVerticalDiffusivity
from gb25_tpu_torch.ops import pallas_catke
from gb25_tpu_torch.ops.halos import extend_field
from gb25_tpu_torch.utils.correctness import compare_states

NAMES = ("kappa_u", "kappa_c", "kappa_e", "kappa_eps", "G_e", "G_eps")
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


def t(a):
    return torch.from_numpy(np.array(np.transpose(np.asarray(a))))


def back(x):
    return np.transpose(x.numpy())


def _operands(shape, np_dtype, seed=9):
    """Extended u, v, e, eps and the JAX buoyancy of a stratified T, S with
    noise (both signs of N^2 and of the buoyancy flux), on both sides."""
    Nx, Ny, Nz = shape
    rng = np.random.default_rng(seed)
    z = np.linspace(-3900.0, -10.0, Nz)
    phi = np.linspace(-70.0, 70.0, Ny)
    a = {
        "u": 0.05 * rng.standard_normal(shape),
        "v": 0.05 * rng.standard_normal(shape),
        "T": (20.0 + 5e-3 * z)[None, None, :] * np.cos(np.deg2rad(phi))[None, :, None]
        + 0.5 * rng.standard_normal(shape),
        "S": 35.0 - 1e-4 * z[None, None, :] + 0.1 * rng.standard_normal(shape),
        "e": 1e-5 * (1.0 + rng.random(shape)),
        "eps": 1e-8 * (1.0 + rng.random(shape)),
    }
    a["v"][:, 0, :] = 0.0
    a = {k: x.astype(np_dtype) for k, x in a.items()}
    gj = jax_grid(*shape, dtype=jnp.dtype(np_dtype))
    gt = simple_latitude_longitude_grid(*shape, device="cpu",
                                        dtype=torch.float32 if np_dtype == np.float32
                                        else torch.float64)
    kinds = {"u": "u", "v": "v", "T": "c", "S": "c", "e": "c", "eps": "c"}
    je = {k: jax_extend_field(gj, jnp.asarray(x), kinds[k], None) for k, x in a.items()}
    te = {k: extend_field(gt, t(x), kinds[k]) for k, x in a.items()}
    jb = jax_buoyancy_field(JaxConfig(), gj, {"T": je["T"], "S": je["S"]})
    return gj, gt, je, te, jb, t(jb)


def test_closure_constants_are_the_jax_packages():
    assert dataclasses.asdict(TKEDissipationVerticalDiffusivity()) == dataclasses.asdict(JaxKEps())
    assert TKEDissipationVerticalDiffusivity().tracer_names == JaxKEps().tracer_names


def test_plain_keps_matches_jax_kernel_f32():
    gj, gt, je, te, jb, tb = _operands((64, 32, 16), np.float32)

    def t3(a):
        return jnp.transpose(a, (2, 1, 0))

    ref = jax_keps_kernel(JaxKEps(), gj, t3(je["u"]), t3(je["v"]), t3(jb), t3(je["e"]),
                          t3(je["eps"]), interpret=True)
    got = pallas_catke.keps_diffusivities_plain(TKEDissipationVerticalDiffusivity(), gt,
                                                te["u"], te["v"], tb, te["e"], te["eps"])
    # N^2 of both signs, so the buoyancy flux takes both branches of C3
    N2 = np.diff(np.asarray(jb)[4:-4, 4:-4, 4:-4], axis=2)
    assert N2.max() > 0.0 > N2.min()
    for name, g, w in zip(NAMES, got, ref):
        np.testing.assert_allclose(back(g), np.asarray(w), rtol=1e-6, atol=1e-12, err_msg=name)


def test_plain_keps_matches_jax_array_f64():
    gj, gt, je, te, jb, tb = _operands((32, 16, 12), np.float64)
    ref = jax_keps_diffusivities(JaxKEps(), gj, je["u"], je["v"], jb, je["e"], je["eps"])
    got = pallas_catke.keps_diffusivities_plain(TKEDissipationVerticalDiffusivity(), gt,
                                                te["u"], te["v"], tb, te["e"], te["eps"])
    for name, g, w in zip(NAMES, got, ref):
        w = np.asarray(gj.interior(w))
        np.testing.assert_allclose(back(g), w, rtol=1e-12, atol=1e-12 * np.abs(w).max(),
                                   err_msg=name)


def _keps_states(shape, jdtype):
    """The JAX k-epsilon state (the JAX tests' e = 1e-5, eps = 1e-8, zero G)
    and the port's, carried across."""
    gj = jax_grid(*shape, dtype=jdtype)
    cj = jax_config(closure=JaxKEps())
    sj = jax_state(gj, noise_velocity=1e-3, tracers=cj.tracers)
    tr = {**sj.tracers, "e": jnp.full(gj.shape, 1e-5, jdtype),
          "eps": jnp.full(gj.shape, 1e-8, jdtype)}
    sj = sj.replace(tracers=tr)
    st = state_from_numpy({n: np.asarray(x) for n, x in _leaf_names(sj)}, "cpu")
    gt = simple_latitude_longitude_grid(*shape, device="cpu",
                                        dtype=torch.float32 if jdtype == jnp.float32
                                        else torch.float64)
    return cj, gj, sj, gt, st


def test_three_keps_steps_match_jax_array_path_f64(monkeypatch):
    monkeypatch.setenv("GB25_BAROTROPIC_BLOCK", "1")
    monkeypatch.delenv("GB25_ZSLAB_INTERPRET", raising=False)
    cj, gj, sj, gt, st = _keps_states((32, 16, 8), jnp.float64)
    cj = dataclasses.replace(cj, kernels="jnp")
    step = jax.jit(jax_time_step)
    for _ in range(3):
        sj = step(cj, gj, sj, DT)
    st = loop(baroclinic_instability_config(closure=TKEDissipationVerticalDiffusivity()),
              gt, st, DT, 3)
    ref = {n: np.asarray(x) for n, x in _leaf_names(sj)}
    port = state_to_numpy(st)
    assert list(port) == list(ref)
    compare_states(ref, port, rtol=1e-10, verbose=False)
    assert port["tracers/e"].min() >= 0.0 and port["tracers/eps"].min() >= 0.0
    assert np.abs(port["Gtracers/eps"]).max() > 0.0


def test_keps_step_matches_jax_kernels_f32(monkeypatch):
    monkeypatch.setenv("GB25_ZSLAB_INTERPRET", "1")
    cj, gj, sj, gt, st = _keps_states((128, 32, 8), jnp.float32)
    ref = jax.jit(jax_time_step)(dataclasses.replace(cj, kernels="zslab"), gj, sj, DT)
    ref = {n: np.asarray(x) for n, x in _leaf_names(ref)}
    port = state_to_numpy(time_step(
        baroclinic_instability_config(closure=TKEDissipationVerticalDiffusivity()), gt, st, DT))
    assert list(port) == list(ref)
    for name in ref:
        np.testing.assert_allclose(port[name], ref[name], rtol=1e-3, atol=5e-6, err_msg=name)


def test_keps_model_runs_on_cpu():
    """The entry point with the k-epsilon closure: its tracers, its start
    state, a few steps on CPU tensors through the plain versions (no
    launch), e and eps >= 0 and finite after them."""
    cfg, grid, state = baroclinic_instability_model(
        32, 16, 6, device="cpu", closure=TKEDissipationVerticalDiffusivity())
    assert cfg.tracers == ("T", "S", "e", "eps")
    assert float(state.tracers["e"].min()) == float(state.tracers["e"].max()) == \
        float(torch.tensor(1e-5))
    assert float(state.tracers["eps"].max()) == float(torch.tensor(1e-8))
    assert all(float(g.abs().max()) == 0.0 for g in state.Gtracers.values())
    before = pallas_catke.KEPS_KERNEL.launches
    s = loop(cfg, grid, state, DT, 3)
    assert pallas_catke.KEPS_KERNEL.launches == before
    for name, f in {"u": s.u, **s.tracers}.items():
        assert bool(torch.isfinite(f).all()), name
    assert float(s.tracers["e"].min()) >= 0.0 and float(s.tracers["eps"].min()) >= 0.0
    with pytest.raises(ValueError, match="tracers"):
        HydrostaticConfig(tracers=("T", "S", "e"), closure=TKEDissipationVerticalDiffusivity())
