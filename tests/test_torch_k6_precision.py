"""The precision modes on the ``kernels="pallas"`` route (kernel K6), the
explicit free surface with CATKE on the tripolar grid, and the new
combinations on tiles, against the JAX package's.

K6's bfloat16 twin (``pallas_tendencies_plain`` on bfloat16 operands:
float32 arithmetic on the widened operands and grid, each output rounded
to bfloat16) against JAX's ``pallas_tendencies`` in interpret mode on the
same operands and grid cast to bfloat16, which rounds every operation in
bfloat16: the flagship (T, S, metric columns), the tripolar grid with the
Gaussian islands (T, S, e, metric planes) and four tracers (T, S, e, eps),
tests/test_torch_pallas_tendency.py's operands. Each output within twice
JAX's own distance between its bfloat16 and float32 kernels
(tests/test_torch_precision.py's protocol).

One step of the K6 route against JAX's own kernels="pallas" step, its K6
in interpret mode (GB25_BAROTROPIC_BLOCK unset: both free surfaces are the
blocked solve at the grid halo):
  - "float32" on the flagship (128x16x8), float32 state: 1e-4 of each
    field's largest value, the mode's bound on the K1 route;
  - "bfloat16" on the flagship and on the coupled tripolar climate with
    CATKE (48x24x8), float32 states: each field within twice JAX's own
    distance between its "bfloat16" and float32 steps, and at least the
    "float32" bound (the climate's T at rest, which neither package's
    bfloat16 tendency moves, parts by the closure's float32 rounding);
  - "float64" on the flagship's float64 state: JAX runs K6 on float64
    operands (interpret mode only: Mosaic has no float64 vectors), the port
    K6's float64 twin (its plain version here; on the card its float64
    instance), the same function: 1e-10 of each field's
    largest value.
The explicit free surface with CATKE on the tripolar climate (the unfused
K1 route with no compute_dtype): 3 float64 coupled steps against JAX
kernels="jnp" at 1e-10.

Tiles, one case per route on 2x2 gloo ranks, each held bit for bit to the
same step forced onto a 1x1 mesh in this process (the tiles compose
exactly) and to the port's serial step at the mode's bound, 1e-4 of each
field's largest value (the serial K1 route's free surface is the
whole-loop solve, the tiles' the blocked one; the serial K6 route blocks
at the same width): "bf16s" on the tripolar CATKE climate (48x24x8) and
"bfloat16" on the flagship on the K6 route (32x16x8).
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
from gb25_tpu.models import ExplicitFreeSurface as JaxExplicit
from gb25_tpu.models import baroclinic_instability_config as jax_config
from gb25_tpu.models import baroclinic_instability_state as jax_state
from gb25_tpu.models import time_step as jax_time_step
from gb25_tpu.models.coupled import coupled_time_step as jax_coupled_time_step
from gb25_tpu_torch.convert import state_from_numpy, state_to_numpy
from gb25_tpu_torch.grids import simple_latitude_longitude_grid
from gb25_tpu_torch.models import (
    ExplicitFreeSurface,
    baroclinic_instability_config,
    coupled_loop,
    coupled_time_step,
    loop,
    time_step,
)
from gb25_tpu_torch.ops.pallas_tendency import pallas_tendencies_plain
from gb25_tpu_torch.parallel import make_mesh, run_decomposed, spawn
from gb25_tpu_torch.utils.correctness import compare_states
from test_torch_climate import _jax_arrays, _models
from test_torch_pallas_tendency import CASES, _k6_inputs

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


@pytest.fixture(autouse=True)
def _blocked_jax(monkeypatch):
    """JAX's free surface blocked at the grid halo, its z-slab kernel off."""
    monkeypatch.delenv("GB25_BAROTROPIC_BLOCK", raising=False)
    monkeypatch.delenv("GB25_ZSLAB_INTERPRET", raising=False)


def t(a):
    """A JAX-layout array as a port tensor (axes reversed)."""
    return torch.from_numpy(np.array(np.transpose(np.asarray(a))))


def back(x):
    return np.transpose(x.detach().float().numpy()).astype(np.float64)


def _assert_within(name, got, want, atol):
    err = np.abs(got - want)
    assert np.isfinite(got).all(), name
    assert err.max() <= atol, (f"{name}: apart by up to {err.max():.3e}, bound {atol:.3e} "
                               f"(largest value {np.abs(want).max():.3e})")


def _jax_cast(tree, dtype):
    return jax.tree_util.tree_map(
        lambda x: x.astype(dtype) if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


@pytest.mark.parametrize("case", CASES)
def test_plain_k6_bf16_twin_within_jax_own_distance(case):
    (cfg_j, gj), (cfg_t, gt), (f_ff, ue, ve, tr_e) = _k6_inputs(case, np.float32)

    def jax_k6(dtype):
        g = _jax_cast(gj, dtype)
        return jax_pallas_tendency.pallas_tendencies(
            cfg_j, g, f_ff.astype(dtype), ue.astype(dtype), ve.astype(dtype),
            {k: c.astype(dtype) for k, c in tr_e.items()}, bx=gj.Nx // 2, by=gj.Ny,
            interpret=True)

    ref, ref32 = jax_k6(jnp.bfloat16), jax_k6(jnp.float32)
    bf = torch.bfloat16
    got = pallas_tendencies_plain(cfg_t, gt.cast(bf), t(f_ff).to(bf), t(ue).to(bf),
                                  t(ve).to(bf), {k: t(c).to(bf) for k, c in tr_e.items()})
    assert got[0].dtype == bf and all(g.dtype == bf for g in got[2].values())
    pairs = [("Gu", got[0], ref[0], ref32[0]), ("Gv", got[1], ref[1], ref32[1])]
    pairs += [("G" + k, got[2][k], ref[2][k], ref32[2][k]) for k in tr_e]
    for name, g, w, w32 in pairs:
        w, w32 = (np.asarray(x).astype(np.float64) for x in (w, w32))
        own = np.abs(w - w32).max()
        assert own > 0.0, name
        _assert_within(name, back(g), w, 2 * own)


def _pallas(cfg, mode):
    return dataclasses.replace(cfg, kernels="pallas", compute_dtype=mode)


@functools.lru_cache(maxsize=None)
def _flagship_jax(mode, dtype=jnp.float32):
    """JAX's flagship state at 128x16x8 and its kernels="pallas" step in
    ``mode``, K6 in interpret mode (the step imports ``pallas_tendencies``
    when it runs; a fresh trace per mode)."""
    mp = pytest.MonkeyPatch()
    mp.delenv("GB25_BAROTROPIC_BLOCK", raising=False)
    mp.setattr(jax_pallas_tendency, "pallas_tendencies",
               functools.partial(jax_pallas_tendency.pallas_tendencies, interpret=True))
    try:
        gj = jax_latlon(128, 16, 8, dtype=dtype)
        sj = jax_state(gj, noise_velocity=1e-3)
        step = jax.jit(functools.partial(jax_time_step, _pallas(jax_config(), mode)))
        return _jax_arrays(sj), _jax_arrays(step(gj, sj, DT))
    finally:
        mp.undo()


def _flagship_port(mode, init, dtype=torch.float32):
    grid = simple_latitude_longitude_grid(128, 16, 8, device="cpu", dtype=dtype)
    cfg = _pallas(baroclinic_instability_config(), mode)
    return state_to_numpy(loop(cfg, grid, state_from_numpy(init, "cpu"), DT, 1))


def test_k6_route_float32_matches_jax():
    init, ref = _flagship_jax("float32")
    port = _flagship_port("float32", init)
    assert list(port) == list(ref)
    for name in ref:
        want = ref[name].astype(np.float64)
        _assert_within(name, port[name].astype(np.float64), want, 1e-4 * np.abs(want).max())


def test_k6_route_float64_matches_jax_k6_in_float64():
    init, ref = _flagship_jax("float64", jnp.float64)
    port = _flagship_port("float64", init, torch.float64)
    assert list(port) == list(ref) and port["u"].dtype == np.float64
    compare_states(ref, port, rtol=1e-10, verbose=False)


def _check_own_distance(port, ref, ref32):
    """Each field within twice JAX's own distance, and at least the
    float32 mode's 1e-4 of its largest value: a field that the bfloat16
    tendency does not move (T of the climate at rest, whose G is 0) still
    carries the float32 rounding of the closure, which the two packages
    compute in other forms."""
    assert list(port) == list(ref)
    for name in ref:
        want = ref[name].astype(np.float64)
        own = np.abs(want - ref32[name].astype(np.float64)).max()
        _assert_within(name, port[name].astype(np.float64), want,
                       max(2 * own, 1e-4 * np.abs(want).max()))


def test_k6_route_bfloat16_flagship_within_jax_own_distance():
    (init, ref), (_, ref32) = _flagship_jax("bfloat16"), _flagship_jax(None)
    _check_own_distance(_flagship_port("bfloat16", init), ref, ref32)


def test_k6_route_bfloat16_tripolar_climate_within_jax_own_distance(monkeypatch):
    monkeypatch.setattr(jax_pallas_tendency, "pallas_tendencies",
                        functools.partial(jax_pallas_tendency.pallas_tendencies, interpret=True))
    (cj, gj, aj, sj), (ct, gt, at, st) = _models(8.0, 8, torch.float32,
                                                 grid_type="gaussian_islands_tripolar")
    refs = {}
    for mode in ("bfloat16", None):
        c = dataclasses.replace(cj, ocean=_pallas(cj.ocean, mode))
        refs[mode] = _jax_arrays(jax.jit(functools.partial(jax_coupled_time_step, c))(
            gj, aj, sj, DT))
    ct = dataclasses.replace(ct, ocean=_pallas(ct.ocean, "bfloat16"))
    port = state_to_numpy(coupled_time_step(ct, gt, at, st, DT))
    _check_own_distance(port, refs["bfloat16"], refs[None])


def test_explicit_free_surface_with_catke_on_tripolar_matches_jax_f64():
    (cj, gj, aj, sj), (ct, gt, at, st) = _models(8.0, 8, torch.float64,
                                                 grid_type="gaussian_islands_tripolar")
    cj = dataclasses.replace(cj, ocean=dataclasses.replace(
        cj.ocean, kernels="jnp", free_surface=JaxExplicit()))
    ct = dataclasses.replace(ct, ocean=dataclasses.replace(
        ct.ocean, free_surface=ExplicitFreeSurface()))
    assert not ct.ocean.fused and gt.north_fold
    step = jax.jit(jax_coupled_time_step)
    for _ in range(3):
        sj = step(cj, gj, aj, sj, DT)
    ref, port = _jax_arrays(sj), state_to_numpy(coupled_loop(ct, gt, at, st, DT, 3))
    assert list(port) == list(ref)
    compare_states(ref, port, rtol=1e-10, verbose=False)
    assert np.abs(port["Geta"]).max() > 0.0


def _tiles_vs_serial(cfg, grid, init, atmos=None):
    """One step on 2x2 gloo ranks: bit for bit with the step forced onto
    a 1x1 mesh, and within 1e-4 of each field's largest value of the
    serial step."""
    port = spawn(run_decomposed, 4, cfg, grid, init, DT, 1, atmos, shape=(2, 2))[0]
    whole = run_decomposed(make_mesh(), cfg, grid, init, DT, 1, atmos, force_comm="local")
    for name in port:
        np.testing.assert_array_equal(port[name], whole[name], err_msg=name)
    state = state_from_numpy(init, "cpu")
    if atmos is None:
        serial = state_to_numpy(time_step(cfg, grid, state, DT))
    else:
        serial = state_to_numpy(coupled_time_step(cfg, grid, atmos, state, DT))
    assert list(port) == list(serial)
    for name in serial:
        want = serial[name].astype(np.float64)
        _assert_within(name, port[name].astype(np.float64), want, 1e-4 * np.abs(want).max())


def test_bf16s_climate_on_tiles():
    (_, _, _, sj), (ct, gt, at, _) = _models(8.0, 8, torch.float32,
                                             grid_type="gaussian_islands_tripolar")
    ct = dataclasses.replace(ct, ocean=dataclasses.replace(ct.ocean, compute_dtype="bf16s"))
    _tiles_vs_serial(ct, gt, _jax_arrays(sj), at)


def test_bfloat16_k6_route_on_tiles():
    gj = jax_latlon(32, 16, 8, dtype=jnp.float32)
    init = _jax_arrays(jax_state(gj, noise_velocity=1e-3))
    grid = simple_latitude_longitude_grid(32, 16, 8, device="cpu", dtype=torch.float32)
    _tiles_vs_serial(_pallas(baroclinic_instability_config(), "bfloat16"), grid, init)
