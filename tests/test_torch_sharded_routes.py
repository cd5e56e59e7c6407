"""The decomposed path on the routes the serial path runs: the K6 route
(kernels="pallas") and the run scripts' further choices (the
``compute_dtype`` modes, ``ExplicitFreeSurface``,
``VerticalScalarDiffusivity``) on tiles, against the JAX package's serial
step.

Every case spawns one gloo group of CPU ranks (``parallel.spawn``), each
rank running ``parallel.sharded.run_decomposed`` (its kernels' plain
versions: the tensors lie on the CPU); the gathered state comes back as
numpy. JAX runs serially with kernels="jnp" and GB25_BAROTROPIC_BLOCK
unset: its blocked free surface at the width the tiles run (the grid halo,
W = 4), so only reassociation differs.

float64, 3 steps (an Euler step and two AB2 steps), at 1e-10 of each
field's largest value, as tests/test_torch_sharded.py:
  - the K6 route on the flagship (32x16x4) on (2,2) and (1,2) meshes, and
    on the coupled tripolar climate (resolution 8: 48x24x4) on 2x2;
  - the K6 route on the four meshes of MULTICHIP_r05.json with its grids
    (__graft_entry__.dryrun_multichip): 4x2 at (32,16,4), 8x1 at
    (64,8,4), 2x4 at (16,32,4) and 1x8 at (8,64,4) in JAX's (Nx, Ny, Nz),
    lat-lon and tripolar (Ny at least 16, the north fold across the top
    rank row), as the dry run builds them, at dt = 60 s (the dry run's
    tripolar dt = 5 s leaves max|Gu| ~2e-7 after 3 steps at (32,16,4),
    where the serial routes' float64 reassociation against JAX already
    reaches 1.5e-10 of it at one south-row face);
  - on 2x2 at 32x16x8: ExplicitFreeSurface, VerticalScalarDiffusivity and
    compute_dtype="float64", each against JAX's same choice.
float32 at 32x16x8 on 2x2, one step (float32 runs part through the
barotropic feedback over more: "f32x2" over 3 steps parts by 5e-3 of
max|Gu|, the float32 fused step by 1.5e-2), each against JAX's own mode at
tests/test_torch_precision.py's per-mode tolerances (each field within a
share of its largest value), and bit for bit with the same step forced
onto a 1x1 mesh in this process (the tiles compose exactly):
  - "f32x2", 2e-6 (the port computes it in native float64; measured
    3.5e-7, in eta);
  - "float32", 1e-4, "bf16s"'s: float32 arithmetic in both packages
    (measured 3.7e-5, in GT; K1's unfused form);
  - "bf16s", 1e-4, against JAX kernels="zslab" with GB25_ZSLAB_INTERPRET=1
    (its serial free surface is then the whole-loop kernel in interpret
    mode, ~1e-9 from the blocked solve);
  - "bfloat16", within twice JAX's own distance between its "bfloat16"
    and float32 steps.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gb25_tpu.grids import simple_latitude_longitude_grid as jax_latlon
from gb25_tpu.grids import tripolar_grid as jax_tripolar
from gb25_tpu.models import ExplicitFreeSurface as JaxExplicit
from gb25_tpu.models import VerticalScalarDiffusivity as JaxScalar
from gb25_tpu.models import baroclinic_instability_config as jax_config
from gb25_tpu.models import baroclinic_instability_state as jax_state
from gb25_tpu.models import time_step as jax_time_step
from gb25_tpu.models.coupled import coupled_time_step as jax_coupled_time_step
from gb25_tpu.utils.correctness import _leaf_names
from gb25_tpu_torch.grids import simple_latitude_longitude_grid, tripolar_grid
from gb25_tpu_torch.models import (
    ExplicitFreeSurface,
    VerticalScalarDiffusivity,
    baroclinic_instability_config,
)
from gb25_tpu_torch.parallel import make_mesh, run_decomposed, spawn
from gb25_tpu_torch.utils.correctness import compare_states
from test_torch_climate import _models

DT = 60.0
STEPS = 3
SHAPE = (32, 16, 8)
# MULTICHIP_r05.json's meshes and lat-lon grids, in JAX's (Nx, Ny, Nz)
MULTICHIP = {"4x2": ((4, 2), (32, 16, 4)), "8x1": ((8, 1), (64, 8, 4)),
             "2x4": ((2, 4), (16, 32, 4)), "1x8": ((1, 8), (8, 64, 4))}
CHOICES = {  # JAX's config keywords, the port's, and the compute_dtype of both
    "explicit": ({"free_surface": JaxExplicit()}, {"free_surface": ExplicitFreeSurface()}, None),
    "vertical_scalar": ({"closure": JaxScalar()}, {"closure": VerticalScalarDiffusivity()}, None),
    "float64": ({}, {}, "float64"),
}


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
    """JAX's serial free surface blocked at the tiles' width, its kernels
    off (the cases that want them set it again)."""
    monkeypatch.delenv("GB25_BAROTROPIC_BLOCK", raising=False)
    monkeypatch.delenv("GB25_ZSLAB_INTERPRET", raising=False)


def _arrays(state):
    return {name: np.asarray(x) for name, x in _leaf_names(state)}


def _jax_steps(cfg, grid, state, n, dt=DT):
    step = jax.jit(jax_time_step)
    for _ in range(n):
        state = step(cfg, grid, state, dt)
    return _arrays(state)


def _decomposed(mesh, cfg, grid, init, n, dt=DT, atmos=None):
    """Rank 0's gathered state after ``n`` decomposed steps on ``mesh``."""
    return spawn(run_decomposed, mesh[0] * mesh[1], cfg, grid, init, dt, n, atmos,
                 shape=mesh)[0]


def _check_f64(ref, port, n=STEPS):
    assert list(port) == list(ref)
    compare_states(ref, port, rtol=1e-10, verbose=False)
    assert int(port["iteration"]) == n


def _grids(kind, shape, dtype):
    """JAX's grid and the port's, lat-lon or tripolar."""
    jdt = {torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype]
    if kind == "tripolar":
        return (jax_tripolar(*shape, dtype=jdt),
                tripolar_grid(*shape, device="cpu", dtype=dtype))
    return (jax_latlon(*shape, dtype=jdt),
            simple_latitude_longitude_grid(*shape, device="cpu", dtype=dtype))


def _k6_case(kind, shape, mesh, dt):
    """3 steps of the K6 route decomposed over ``mesh`` against 3 JAX
    serial steps, float64."""
    gj, gt = _grids(kind, shape, torch.float64)
    sj = jax_state(gj, noise_velocity=1e-3)
    ref = _jax_steps(dataclasses.replace(jax_config(), kernels="jnp"), gj, sj, STEPS, dt)
    port = _decomposed(mesh, baroclinic_instability_config(kernels="pallas"), gt, _arrays(sj),
                       STEPS, dt)
    _check_f64(ref, port)
    return gt, port


@pytest.mark.parametrize("mesh", [(2, 2), (1, 2)])
def test_k6_route_decomposed_matches_jax_serial_f64(mesh):
    grid, port = _k6_case("latlon", (32, 16, 4), mesh, DT)
    # K6 has no wall logic: the upper tiles' row 0 is an interior v row
    assert np.abs(port["v"][:, grid.Ny // mesh[1], :]).min() > 0.0
    assert np.abs(port["v"][:, 0, :]).max() == 0.0


def test_k6_route_tripolar_climate_decomposed_matches_jax_serial_f64():
    (cj, gj, aj, sj), (ct, gt, at, _) = _models(8.0, 4, torch.float64,
                                                grid_type="gaussian_islands_tripolar")
    assert gt.north_fold and (gt.Nx, gt.Ny) == (48, 24)
    cj = dataclasses.replace(cj, ocean=dataclasses.replace(cj.ocean, kernels="jnp"))
    ct = dataclasses.replace(ct, ocean=dataclasses.replace(ct.ocean, kernels="pallas"))
    init = _arrays(sj)
    step = jax.jit(jax_coupled_time_step)
    for _ in range(STEPS):
        sj = step(cj, gj, aj, sj, DT)
    port = _decomposed((2, 2), ct, gt, init, STEPS, atmos=at)
    _check_f64(_arrays(sj), port)
    land = np.asarray(gj.bottom_height) == 0.0
    assert land.any() and np.all(port["eta"][land] == 0.0)


@pytest.mark.parametrize("kind", ["latlon", "tripolar"])
@pytest.mark.parametrize("name", list(MULTICHIP))
def test_multichip_meshes_on_the_k6_route_f64(name, kind):
    mesh, (Nx, Ny, Nz) = MULTICHIP[name]
    _k6_case(kind, (Nx, max(Ny, 16) if kind == "tripolar" else Ny, Nz), mesh, DT)


@pytest.mark.parametrize("choice", list(CHOICES))
def test_choice_decomposed_matches_jax_serial_f64(choice):
    jax_kw, port_kw, mode = CHOICES[choice]
    gj, gt = _grids("latlon", SHAPE, torch.float64)
    sj = jax_state(gj, noise_velocity=1e-3)
    cfg_j = dataclasses.replace(jax_config(**jax_kw), kernels="jnp", compute_dtype=mode)
    ref = _jax_steps(cfg_j, gj, sj, STEPS)
    cfg = dataclasses.replace(baroclinic_instability_config(**port_kw), compute_dtype=mode)
    port = _decomposed((2, 2), cfg, gt, _arrays(sj), STEPS)
    _check_f64(ref, port)
    if choice == "explicit":
        assert np.abs(port["Geta"]).max() > 0.0


@functools.lru_cache(maxsize=None)
def _jax_mode(mode):
    """JAX's float32 state at 32x16x8 and its serial step in ``mode`` (None:
    float32; "bf16s" with kernels="zslab" and GB25_ZSLAB_INTERPRET=1),
    computed once per mode. "f32x2" steps eagerly: on the CPU jitting its
    multifloat step takes ~17 s, the eager step ~3 s."""
    gj = jax_latlon(*SHAPE, dtype=jnp.float32)
    sj = jax_state(gj, noise_velocity=1e-3)
    mp = pytest.MonkeyPatch()
    if mode == "bf16s":
        mp.setenv("GB25_ZSLAB_INTERPRET", "1")
    try:
        cfg = dataclasses.replace(jax_config(), kernels="zslab" if mode == "bf16s" else "jnp",
                                  compute_dtype=mode)
        step = jax_time_step if mode == "f32x2" else jax.jit(jax_time_step)
        return _arrays(sj), _arrays(step(cfg, gj, sj, DT))
    finally:
        mp.undo()


def _mode_step(mode, init):
    """One step of ``mode`` on 2x2 tiles, held bit for bit to the same step
    forced onto a 1x1 mesh."""
    grid = simple_latitude_longitude_grid(*SHAPE, device="cpu", dtype=torch.float32)
    cfg = dataclasses.replace(baroclinic_instability_config(), compute_dtype=mode)
    port = _decomposed((2, 2), cfg, grid, init, 1)
    whole = run_decomposed(make_mesh(), cfg, grid, init, DT, 1, force_comm="local")
    for name in port:
        np.testing.assert_array_equal(port[name], whole[name], err_msg=name)
    return port


@pytest.mark.parametrize("mode,scale", [("f32x2", 2e-6), ("float32", 1e-4), ("bf16s", 1e-4)])
def test_mode_decomposed_matches_jax_mode(mode, scale):
    init, ref = _jax_mode(mode)
    port = _mode_step(mode, init)
    assert list(port) == list(ref) and port["u"].dtype == np.float32
    for name in ref:
        want = ref[name].astype(np.float64)
        np.testing.assert_allclose(port[name].astype(np.float64), want, rtol=0,
                                   atol=scale * np.abs(want).max(), err_msg=name)


def test_bfloat16_decomposed_within_jax_own_distance():
    (init, ref), (_, ref32) = _jax_mode("bfloat16"), _jax_mode(None)
    port = _mode_step("bfloat16", init)
    assert list(port) == list(ref)
    for name in ref:
        assert np.isfinite(port[name]).all(), name
        want = ref[name].astype(np.float64)
        own = np.abs(want - ref32[name].astype(np.float64)).max()
        np.testing.assert_allclose(port[name].astype(np.float64), want, rtol=0, atol=2 * own,
                                   err_msg=name)
