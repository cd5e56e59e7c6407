"""Kernel K6 (the one-pass tendency stage, TEOS-10 inside) and the port's
``kernels="pallas"`` route against the JAX package's.

``pallas_tendencies_plain`` against the JAX Pallas kernel
``pallas_tendencies`` in interpret mode, on the same numpy inputs: the
lat-lon flagship (T, S, metric columns), the tripolar grid with the
Gaussian islands (T, S, e, 2-D metric planes, u and v masked on solid
faces) and four tracers (T, S, e, eps); the JAX kernel on two tiles along
x (its interpret mode costs ~1 s a tile). float64 at 1e-10 of each
output's largest value (only the kernel's matrix-product cumsum against
``torch.cumsum`` differs); float32 at tests/test_pallas.py's rtol 2e-4,
atol 1e-9 (momentum) and 1e-7 (tracers). On the tripolar grid the momentum
is compared on fluid faces (on the faces of the pole cells, land whose
spacings are floored at 1e-3 of the largest, an ulp of the pressure summed
in another order is ~1e-7) with an atol of 1e-4 of the largest of Gu and
Gv: there Gu is a small remainder (~3e-7) of larger terms, and next to the
seam, at the bottom level, p = csum - total cancels two column sums of
~300 m^2/s^2 that the two programs take in other orders (~2e-9 there).

The route: 3 float64 steps of the port's ``loop`` with kernels="pallas"
(K6 and K5 run their plain versions on the CPU) against JAX ``time_step``
with kernels="jnp" and GB25_BAROTROPIC_BLOCK unset, JAX's unfused route
with ``tendency_math`` on the whole domain and the blocked free surface at
W = the halo, at 1e-10 of each field's largest value: the flagship, the
coupled tripolar climate and the k-epsilon flagship. One float32 flagship
step against JAX's own kernels="pallas" step, its K6 in interpret mode, at
tests/test_torch_step.py's rtol 1e-3, atol 5e-6.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gb25_tpu.ops.pallas_tendency as jax_pallas_tendency
from gb25_tpu.grids import simple_latitude_longitude_grid as jax_latlon
from gb25_tpu.grids import tripolar_grid as jax_tripolar
from gb25_tpu.models import baroclinic_instability_config as jax_config
from gb25_tpu.models import baroclinic_instability_state as jax_state
from gb25_tpu.models import time_step as jax_time_step
from gb25_tpu.models.catke import CATKEVerticalDiffusivity as JaxCATKE
from gb25_tpu.models.coupled import coupled_time_step as jax_coupled_time_step
from gb25_tpu.models.keps import TKEDissipationVerticalDiffusivity as JaxKEps
from gb25_tpu_torch.convert import state_from_numpy, state_to_numpy
from gb25_tpu_torch.grids import simple_latitude_longitude_grid, tripolar_grid
from gb25_tpu_torch.grids.immersed import face_masks, gaussian_islands_bottom, interior_masks
from gb25_tpu_torch.models import (
    HydrostaticConfig,
    baroclinic_instability_config,
    baroclinic_instability_model,
    baroclinic_instability_state,
    coupled_loop,
    hydrostatic,
    loop,
)
from gb25_tpu_torch.models import free_surface
from gb25_tpu_torch.models.catke import CATKEVerticalDiffusivity
from gb25_tpu_torch.models.keps import TKEDissipationVerticalDiffusivity
from gb25_tpu_torch.ops.halos import extend_field
from gb25_tpu_torch.ops.operators import coriolis_ff
from gb25_tpu_torch.ops.pallas_tendency import pallas_tendencies, pallas_tendencies_plain
from gb25_tpu_torch.utils.correctness import compare_states
from gb25_tpu_torch.utils.cuda_build import uses_kernel
from test_torch_climate import _jax_arrays, _models
from test_torch_keps import _keps_states

DT = 60.0
CASES = ("flagship", "tripolar", "four_tracers")


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
    """A JAX-layout array as a port tensor (axes reversed)."""
    return torch.from_numpy(np.array(np.transpose(np.asarray(a))))


def back(x):
    return np.transpose(x.detach().numpy())


@functools.lru_cache(maxsize=None)
def _k6_inputs(case, np_dtype, seed=5):
    """The JAX config and grid, the port's, and the extended K6 operands in
    JAX's layout. The operands are made in the port and handed to both
    packages as the same values: the analytic T and S of its initial
    state, u and v noise of 1e-3 and TKE around 1e-5 and eps around 1e-8
    from numpy with ``seed``, its halo fill (bit for bit with JAX's, see
    test_torch_ops and test_torch_tripolar), u and v masked on solid faces
    on the islands grid, and its f."""
    jdt = jnp.float64 if np_dtype == np.float64 else jnp.float32
    tdt = torch.float64 if np_dtype == np.float64 else torch.float32
    rng = np.random.default_rng(seed)
    if case == "tripolar":
        shape = (64, 32, 8)
        gj = jax_tripolar(*shape, dtype=jdt)
        gt = gaussian_islands_bottom(tripolar_grid(*shape, device="cpu", dtype=tdt))
        cfg_j = jax_config(closure=JaxCATKE())
        cfg_t = baroclinic_instability_config(closure=CATKEVerticalDiffusivity())
    else:
        shape = (128, 16, 8)
        gj = jax_latlon(*shape, dtype=jdt)
        gt = simple_latitude_longitude_grid(*shape, device="cpu", dtype=tdt)
        closure = case == "four_tracers"
        cfg_j = jax_config(closure=JaxKEps() if closure else None)
        cfg_t = baroclinic_instability_config(
            closure=TKEDissipationVerticalDiffusivity() if closure else None)
    zyx = shape[::-1]

    def noise(scale, offset=0.0):
        return torch.from_numpy((offset + scale * rng.standard_normal(zyx)).astype(np_dtype))

    state = baroclinic_instability_state(gt, tracers=("T", "S"))
    tr = {"T": state.tracers["T"], "S": state.tracers["S"]}
    for name, scale in (("e", 1e-5), ("eps", 1e-8)):
        if name in cfg_t.tracers:
            tr[name] = torch.from_numpy((scale * (1.0 + rng.random(zyx))).astype(np_dtype))
    ue = extend_field(gt, noise(1e-3), "u")
    ve = extend_field(gt, noise(1e-3), "v")
    if gt.immersed:
        um, vm = face_masks(gt)
        ue, ve = ue * um, ve * vm
    tr_e = {k: extend_field(gt, c, "c") for k, c in tr.items()}
    f_ff = coriolis_ff(gt, cfg_t.coriolis).to(tdt)

    def j(x):
        return jnp.asarray(back(x))

    return (cfg_j, gj), (cfg_t, gt), (j(f_ff), j(ue), j(ve), {k: j(c) for k, c in tr_e.items()})


@pytest.mark.parametrize("np_dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", CASES)
def test_plain_k6_matches_jax_kernel(case, np_dtype):
    (cfg_j, gj), (cfg_t, gt), (f_ff, ue, ve, tr_e) = _k6_inputs(case, np_dtype)
    ref = jax_pallas_tendency.pallas_tendencies(cfg_j, gj, f_ff, ue, ve, tr_e, bx=gj.Nx // 2,
                                                by=gj.Ny, interpret=True)
    got = pallas_tendencies_plain(cfg_t, gt, t(f_ff), t(ue), t(ve),
                                  {k: t(c) for k, c in tr_e.items()})
    assert set(got[2]) == set(ref[2]) == set(tr_e)
    fluid = {"Gu": True, "Gv": True}
    if gt.immersed and np_dtype == np.float32:
        um, vm = interior_masks(gt)
        fluid = {"Gu": back(um) > 0, "Gv": back(vm) > 0}
        assert not fluid["Gu"].all() and fluid["Gu"].mean() > 0.9
    pairs = [("Gu", got[0], ref[0]), ("Gv", got[1], ref[1])]
    pairs += [("G" + k, got[2][k], ref[2][k]) for k in tr_e]
    momentum_scale = max(float(np.abs(np.asarray(w)).max()) for w in ref[:2])
    for name, g, w in pairs:
        w = np.asarray(w)
        keep = fluid.get(name, True)
        g, w = np.where(keep, back(g), 0.0), np.where(keep, w, 0.0)
        assert np.isfinite(w).all() and np.abs(w).max() > 0.0
        if np_dtype == np.float64:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-10 * np.abs(w).max(), err_msg=name)
        else:
            atol = 1e-9 if name in ("Gu", "Gv") else 1e-7
            if gt.immersed and name in ("Gu", "Gv"):
                atol = 1e-4 * momentum_scale
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=atol, err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_split_equals_monolithic(case):
    """split=True (momentum, then tracers, each with its own w) gives the
    monolithic outputs bit for bit."""
    _, (cfg_t, gt), (f_ff, ue, ve, tr_e) = _k6_inputs(case, np.float32)
    args = (cfg_t, gt, t(f_ff), t(ue), t(ve), {k: t(c) for k, c in tr_e.items()})
    one = pallas_tendencies(*args)
    two = pallas_tendencies(*args, split=True)
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])
    assert list(one[2]) == list(two[2]) == list(tr_e)
    for k in tr_e:
        assert torch.equal(one[2][k], two[2][k]), k


def _pallas(cfg):
    return dataclasses.replace(cfg, kernels="pallas")


def test_three_flagship_steps_match_jax_unfused_route_f64(monkeypatch):
    monkeypatch.delenv("GB25_BAROTROPIC_BLOCK", raising=False)
    shape = (32, 16, 8)
    gj = jax_latlon(*shape, dtype=jnp.float64)
    sj = jax_state(gj, noise_velocity=1e-3)
    gt = simple_latitude_longitude_grid(*shape, device="cpu", dtype=torch.float64)
    st = state_from_numpy(_jax_arrays(sj), "cpu")
    cfg_j = dataclasses.replace(jax_config(), kernels="jnp")
    step = jax.jit(jax_time_step)
    for _ in range(3):
        sj = step(cfg_j, gj, sj, DT)
    st = loop(_pallas(baroclinic_instability_config()), gt, st, DT, 3)
    ref, port = _jax_arrays(sj), state_to_numpy(st)
    assert list(port) == list(ref)
    compare_states(ref, port, rtol=1e-10, verbose=False)
    assert int(port["iteration"]) == 3


def test_three_tripolar_coupled_steps_match_jax_unfused_route_f64(monkeypatch):
    monkeypatch.delenv("GB25_BAROTROPIC_BLOCK", raising=False)
    (cj, gj, aj, sj), (ct, gt, at, st) = _models(8.0, 8, torch.float64,
                                                 grid_type="gaussian_islands_tripolar")
    assert gt.north_fold and gt.immersed
    cj = dataclasses.replace(cj, ocean=dataclasses.replace(cj.ocean, kernels="jnp"))
    ct = dataclasses.replace(ct, ocean=_pallas(ct.ocean))
    step = jax.jit(jax_coupled_time_step)
    for _ in range(3):
        sj = step(cj, gj, aj, sj, DT)
    st = coupled_loop(ct, gt, at, st, DT, 3)
    ref, port = _jax_arrays(sj), state_to_numpy(st)
    assert list(port) == list(ref)
    compare_states(ref, port, rtol=1e-10, verbose=False)
    land = np.asarray(gj.bottom_height) == 0.0
    assert land.any() and np.all(port["eta"][land] == 0.0)


def test_three_keps_steps_match_jax_unfused_route_f64(monkeypatch):
    monkeypatch.delenv("GB25_BAROTROPIC_BLOCK", raising=False)
    cj, gj, sj, gt, st = _keps_states((32, 16, 8), jnp.float64)
    step = jax.jit(jax_time_step)
    for _ in range(3):
        sj = step(dataclasses.replace(cj, kernels="jnp"), gj, sj, DT)
    st = loop(_pallas(baroclinic_instability_config(closure=TKEDissipationVerticalDiffusivity())),
              gt, st, DT, 3)
    ref, port = _jax_arrays(sj), state_to_numpy(st)
    assert list(port) == list(ref)
    compare_states(ref, port, rtol=1e-10, verbose=False)
    assert port["tracers/e"].min() >= 0.0 and port["tracers/eps"].min() >= 0.0


def test_flagship_step_matches_jax_pallas_route_f32(monkeypatch):
    """JAX's own kernels="pallas" step: its K6 in interpret mode (the step
    imports ``pallas_tendencies`` when it runs), its blocked free surface."""
    monkeypatch.delenv("GB25_BAROTROPIC_BLOCK", raising=False)
    monkeypatch.setattr(jax_pallas_tendency, "pallas_tendencies",
                        functools.partial(jax_pallas_tendency.pallas_tendencies, interpret=True))
    shape = (128, 16, 8)
    gj = jax_latlon(*shape, dtype=jnp.float32)
    sj = jax_state(gj, noise_velocity=1e-3)
    gt = simple_latitude_longitude_grid(*shape, device="cpu", dtype=torch.float32)
    st = state_from_numpy(_jax_arrays(sj), "cpu")
    # a fresh trace, so the patched kernel is the one traced
    step = jax.jit(functools.partial(jax_time_step, dataclasses.replace(jax_config(),
                                                                       kernels="pallas")))
    ref = _jax_arrays(step(gj, sj, DT))
    port = state_to_numpy(loop(_pallas(baroclinic_instability_config()), gt, st, DT, 1))
    assert list(port) == list(ref)
    for name in ref:
        np.testing.assert_allclose(port[name], ref[name], rtol=1e-3, atol=5e-6, err_msg=name)


def test_pallas_route_runs_k6_and_k5_only(monkeypatch):
    """A "pallas" step calls K6 once and K5 once per substep, and neither
    K1 nor K2; "torch" still calls K1 and K2."""
    calls = {"K6": 0, "K5": 0, "K1": 0, "K2": 0}

    def counted(name, fn):
        def run(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return run

    monkeypatch.setattr(hydrostatic, "pallas_tendencies",
                        counted("K6", hydrostatic.pallas_tendencies))
    monkeypatch.setattr(hydrostatic, "zslab_tendencies", counted("K1", hydrostatic.zslab_tendencies))
    monkeypatch.setattr(free_surface, "barotropic_block",
                        counted("K5", free_surface.barotropic_block))
    monkeypatch.setattr(free_surface, "barotropic_loop", counted("K2", free_surface.barotropic_loop))
    cfg, grid, state = baroclinic_instability_model(32, 16, 6, device="cpu", kernels="pallas")
    loop(cfg, grid, state, DT, 2)
    W = free_surface.exchange_width(cfg.free_surface, grid)
    assert W == 4
    blocks = -(-cfg.free_surface.substeps // W)
    assert calls == {"K6": 2, "K5": 2 * blocks, "K1": 0, "K2": 0}
    loop(dataclasses.replace(cfg, kernels="torch"), grid, state, DT, 1)
    assert calls == {"K6": 2, "K5": 2 * blocks, "K1": 1, "K2": 1}


def test_pallas_mode_dispatch():
    cfg = HydrostaticConfig(kernels="pallas")
    assert not uses_kernel(cfg, torch.zeros(2))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        uses_kernel(cfg, torch.zeros(2, device="meta"))
    with pytest.raises(ValueError, match="kernels must be one of"):
        HydrostaticConfig(kernels="jnp")
