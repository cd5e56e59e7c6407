"""The port's decomposed step against the JAX package's serial step.

Every decomposed run spawns one gloo group of CPU ranks
(``parallel.spawn``), each rank running
``parallel.sharded.run_decomposed``: the global grid localized to its
tile, the JAX initial state cut to the tile, ``n`` steps with halo
exchange, the blocked barotropic solve (K5's plain version) and, on the
tripolar grid, the fold across the top rank row; the gathered state comes
back as numpy.

float64, 3 steps (an Euler step and two AB2 steps) against JAX serial
``time_step`` / ``coupled_time_step`` with kernels="jnp" at the same
``exchange_width`` (its blocked array path, GB25_BAROTROPIC_BLOCK unset),
at 1e-10 of each field's largest value, as tests/test_torch_step.py:
  - the flagship (32x16x4, W = the halo) on (2,2), (4,1) and (1,2) meshes;
  - the tripolar flagship at W = 30 on 2x2 (64x64x4, tests/test_sharded.py's
    own case);
  - the coupled tripolar climate model on 2x2 (resolution 8: 48x24x4);
  - the flagship on a 1x1 mesh in process, forced onto the decomposed
    path in the "local" and the "ring" mode (a world-size-1 gloo group).
float32, one step against JAX ``sharded_step_fn`` with kernels="zslab" and
GB25_ZSLAB_INTERPRET=1 (its K1 and K5 in interpret mode under shard_map) on
a (1,2) mesh at 128x64x8 (tiles of 128x32, the least the JAX kernel
takes), at tests/test_torch_step.py's rtol 1e-3 / atol 5e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from gb25_tpu.grids import simple_latitude_longitude_grid as jax_latlon
from gb25_tpu.grids import tripolar_grid as jax_tripolar
from gb25_tpu.models import baroclinic_instability_config as jax_config
from gb25_tpu.models import baroclinic_instability_state as jax_state
from gb25_tpu.models import time_step as jax_time_step
from gb25_tpu.models.config import SplitExplicitFreeSurface as JaxFS
from gb25_tpu.models.coupled import coupled_time_step as jax_coupled_time_step
from gb25_tpu.parallel import make_mesh as jax_make_mesh
from gb25_tpu.parallel import shard_state as jax_shard_state
from gb25_tpu.parallel import sharded_step_fn as jax_sharded_step_fn
from gb25_tpu.utils.correctness import _leaf_names
from gb25_tpu_torch.grids import simple_latitude_longitude_grid, tripolar_grid
from gb25_tpu_torch.models import baroclinic_instability_config
from gb25_tpu_torch.models.config import SplitExplicitFreeSurface
from gb25_tpu_torch.ops.pallas_zslab import zslab_tendencies_plain
from gb25_tpu_torch.parallel import make_mesh, run_decomposed, spawn
from gb25_tpu_torch.utils.correctness import compare_states
from test_torch_climate import _models

DT = 60.0
STEPS = 3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: beside other busy
    test processes, torch's default of one OpenMP thread per core made the
    plain versions' many small launches ~100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(state):
    return {name: np.asarray(x) for name, x in _leaf_names(state)}


def _jax_steps(step, state, n=STEPS):
    for _ in range(n):
        state = step(state)
    return _arrays(state)


def _configs(exchange_width=None):
    fs = dict(exchange_width=exchange_width)
    return (dataclasses.replace(jax_config(), kernels="jnp", free_surface=JaxFS(**fs)),
            dataclasses.replace(baroclinic_instability_config(),
                                free_surface=SplitExplicitFreeSurface(**fs)))


@pytest.fixture(scope="module")
def flagship(request):
    """The flagship at 32x16x4 f64: the JAX initial state, the JAX serial
    reference after 3 steps, and the port's config and grid."""
    mp = pytest.MonkeyPatch()
    mp.delenv("GB25_BAROTROPIC_BLOCK", raising=False)
    mp.delenv("GB25_ZSLAB_INTERPRET", raising=False)
    request.addfinalizer(mp.undo)
    cfg_j, cfg_t = _configs()
    gj = jax_latlon(32, 16, 4, dtype=jnp.float64)
    sj = jax_state(gj, noise_velocity=1e-3)
    step = jax.jit(jax_time_step)
    ref = _jax_steps(lambda s: step(cfg_j, gj, s, DT), sj)
    gt = simple_latitude_longitude_grid(32, 16, 4, device="cpu", dtype=torch.float64)
    return _arrays(sj), ref, cfg_t, gt


def _check(ref, port):
    assert list(port) == list(ref)
    compare_states(ref, port, rtol=1e-10, verbose=False)
    assert int(port["iteration"]) == STEPS


@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 2)])
def test_flagship_decomposed_matches_jax_serial_f64(flagship, shape):
    init, ref, cfg, grid = flagship
    port = spawn(run_decomposed, shape[0] * shape[1], cfg, grid, init, DT, STEPS,
                 shape=shape)[0]
    _check(ref, port)
    if shape[1] > 1:
        # the upper tiles' row 0 is an interior v row, not a wall
        assert np.abs(port["v"][:, grid.Ny // shape[1], :]).min() > 0.0


@pytest.mark.parametrize("mode", ["local", "ring"])
def test_forced_1x1_matches_jax_serial_f64(flagship, mode):
    init, ref, cfg, grid = flagship
    if mode == "local":
        _check(ref, run_decomposed(make_mesh(), cfg, grid, init, DT, STEPS, force_comm="local"))
        return
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        port = run_decomposed(make_mesh(), cfg, grid, init, DT, STEPS, force_comm="ring")
    finally:
        dist.destroy_process_group()
    _check(ref, port)


def test_tripolar_flagship_w30_decomposed_matches_jax_serial_f64(monkeypatch):
    monkeypatch.delenv("GB25_BAROTROPIC_BLOCK", raising=False)
    cfg_j, cfg_t = _configs(exchange_width=30)
    gj = jax_tripolar(64, 64, 4, dtype=jnp.float64)
    sj = jax_state(gj, noise_velocity=1e-3)
    step = jax.jit(jax_time_step)
    ref = _jax_steps(lambda s: step(cfg_j, gj, s, DT), sj)
    gt = tripolar_grid(64, 64, 4, device="cpu", dtype=torch.float64)
    _check(ref, spawn(run_decomposed, 4, cfg_t, gt, _arrays(sj), DT, STEPS, shape=(2, 2))[0])


def test_tripolar_climate_decomposed_matches_jax_serial_f64(monkeypatch):
    monkeypatch.delenv("GB25_BAROTROPIC_BLOCK", raising=False)
    monkeypatch.delenv("GB25_ZSLAB_INTERPRET", raising=False)
    (cj, gj, aj, sj), (ct, gt, at, st) = _models(8.0, 4, torch.float64,
                                                 grid_type="gaussian_islands_tripolar")
    assert gt.north_fold and (gt.Nx, gt.Ny) == (48, 24)
    cj = dataclasses.replace(cj, ocean=dataclasses.replace(cj.ocean, kernels="jnp"))
    step = jax.jit(jax_coupled_time_step)
    ref = _jax_steps(lambda s: step(cj, gj, aj, s, DT), sj)
    port = spawn(run_decomposed, 4, ct, gt, _arrays(sj), DT, STEPS, at, shape=(2, 2))[0]
    _check(ref, port)
    land = np.asarray(gj.bottom_height) == 0.0
    assert land.any() and np.all(port["eta"][land] == 0.0)


def test_decomposed_step_matches_jax_sharded_kernels_f32(monkeypatch):
    monkeypatch.setenv("GB25_ZSLAB_INTERPRET", "1")
    monkeypatch.delenv("GB25_BAROTROPIC_BLOCK", raising=False)
    shape, mesh_shape = (128, 64, 8), (1, 2)
    gj = jax_latlon(*shape, dtype=jnp.float32)
    sj = jax_state(gj, noise_velocity=1e-3)
    cfg_j = dataclasses.replace(jax_config(), kernels="zslab")
    mesh = jax_make_mesh(2, shape=mesh_shape)
    fn = jax_sharded_step_fn(cfg_j, gj, mesh, check_vma=False)
    ref = _arrays(fn(jax_shard_state(sj, mesh), jnp.float32(DT)))
    gt = simple_latitude_longitude_grid(*shape, device="cpu", dtype=torch.float32)
    port = spawn(run_decomposed, 2, baroclinic_instability_config(), gt, _arrays(sj), DT, 1,
                 shape=mesh_shape)[0]
    assert list(port) == list(ref)
    for name in ref:
        np.testing.assert_allclose(port[name], ref[name], rtol=1e-3, atol=5e-6, err_msg=name)


def test_k1_wall_row_only_where_asked():
    """K1's plain version zeroes row 0 of Gv, v* and the v* integral with
    wall_v, and leaves it (and every other row) alone without."""
    grid = simple_latitude_longitude_grid(16, 8, 4, device="cpu", dtype=torch.float64)
    rng = np.random.default_rng(5)

    def ext(kind):
        from gb25_tpu_torch.ops.halos import extend_field

        return extend_field(grid, torch.from_numpy(rng.standard_normal(grid.shape)), kind)

    ue, ve = 0.1 * ext("u"), 0.1 * ext("v")
    tr = {"T": 10.0 + ext("c"), "S": 35.0 + ext("c")}
    prev = (torch.zeros(grid.shape, dtype=torch.float64),
            1e-6 * torch.from_numpy(rng.standard_normal(grid.shape)),
            {k: torch.zeros(grid.shape, dtype=torch.float64) for k in tr})
    cfg = baroclinic_instability_config()
    on = zslab_tendencies_plain(cfg, grid, ue, ve, tr, prev, (60.0, -30.0), wall_v=True)
    off = zslab_tendencies_plain(cfg, grid, ue, ve, tr, prev, (60.0, -30.0), wall_v=False)
    for i, name in ((1, "Gv"), (4, "v*")):
        assert float(on[i][:, 0].abs().max()) == 0.0, name
        assert float(off[i][:, 0].abs().min()) > 0.0, name
        assert torch.equal(on[i][:, 1:], off[i][:, 1:]), name
    assert float(on[6][3][0].abs().max()) == 0.0 and float(off[6][3][0].abs().min()) > 0.0
    assert torch.equal(on[0], off[0]) and torch.equal(on[6][3][1:], off[6][3][1:])
