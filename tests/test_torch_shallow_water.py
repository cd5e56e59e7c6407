"""The port's shallow-water model (``bench.py --config atmosphere``)
against the JAX package's, on the CPU in float64 at 48x24.

- 5 steps (an Euler step, then AB2) from a perturbed state made with a
  numpy seed, against JAX ``sw_loop``, at 1e-10 of each field's largest
  value (only the order of operations may differ), with the
  vector-invariant momentum advection and without it, and on the tripolar
  grid;
- tests/test_shallow_water.py's three physics tests on the port: a resting
  state stays at rest; mass is conserved to 1e-12 while a gravity wave
  radiates; a geostrophic jet develops along a ridge;
- the decomposed run on a (2,2) gloo mesh (``run_decomposed_sw``: the
  grid localized to each tile, the halos exchanged) against the port's
  serial run at rtol 1e-10 / atol 1e-13, the JAX test's tolerances for its
  (4,2) mesh;
- ``shallow_water_model`` builds bench.py's atmosphere state.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gb25_tpu.grids import simple_latitude_longitude_grid as jax_latlon
from gb25_tpu.grids import tripolar_grid as jax_tripolar
from gb25_tpu.models.shallow_water import ShallowWaterConfig as JaxConfig
from gb25_tpu.models.shallow_water import shallow_water_state as jax_state
from gb25_tpu.models.shallow_water import sw_loop as jax_sw_loop
from gb25_tpu.utils.correctness import _leaf_names
from gb25_tpu_torch.convert import sw_state_from_numpy, sw_state_to_numpy
from gb25_tpu_torch.grids import simple_latitude_longitude_grid, tripolar_grid
from gb25_tpu_torch.models import (
    ShallowWaterConfig,
    shallow_water_model,
    shallow_water_state,
    sw_loop,
)
from gb25_tpu_torch.parallel import run_decomposed_sw, spawn
from gb25_tpu_torch.utils.correctness import compare_states

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


def _arrays(state):
    return {name: np.asarray(x) for name, x in _leaf_names(state)}


def _perturbed(shape, seed):
    """A JAX-layout (Nx, Ny) state: currents of ~0.1 m/s (v 0 on the south
    wall face), h = 1000 m plus ~1 m of noise, as numpy arrays."""
    rng = np.random.default_rng(seed)
    z = np.zeros(shape)
    v = 0.1 * rng.standard_normal(shape)
    v[:, 0] = 0.0
    return {"u": 0.1 * rng.standard_normal(shape), "v": v,
            "h": 1000.0 + rng.standard_normal(shape), "Gu": z, "Gv": z, "Gh": z,
            "time": np.zeros(()), "iteration": np.asarray(0, np.int32)}


@pytest.mark.parametrize("advection,tripolar", [("vector_invariant", False), ("none", False),
                                                ("vector_invariant", True)])
def test_five_steps_match_jax_f64(advection, tripolar):
    if tripolar:
        gj = jax_tripolar(48, 48, 1, dtype=jnp.float64)
        gt = tripolar_grid(48, 48, 1, device="cpu", dtype=torch.float64)
    else:
        gj = jax_latlon(48, 24, 1, dtype=jnp.float64)
        gt = simple_latitude_longitude_grid(48, 24, 1, device="cpu", dtype=torch.float64)
    init = _perturbed((gj.Nx, gj.Ny), seed=11)
    sj = jax_state(gj)
    sj = sj.replace(**{k: jnp.asarray(a) for k, a in init.items() if k != "iteration"})
    ref = _arrays(jax.jit(jax_sw_loop, static_argnames="n")(
        JaxConfig(momentum_advection=advection), gj, sj, DT, 5))
    port = sw_loop(ShallowWaterConfig(momentum_advection=advection), gt,
                   sw_state_from_numpy(init, "cpu"), DT, 5)
    assert port.iteration == 5
    out = sw_state_to_numpy(port)
    assert list(out) == list(ref)
    compare_states(ref, out, rtol=1e-10, verbose=False)


def _grid():
    return simple_latitude_longitude_grid(48, 24, 1, device="cpu", dtype=torch.float64)


def _mass(grid, h):
    az = grid.azc[0, grid.hy : grid.hy + grid.Ny, 0]
    return float((h * az[:, None]).sum())


def test_resting_state_stays_resting():
    grid = _grid()
    s = sw_loop(ShallowWaterConfig(), grid, shallow_water_state(grid, h0=1000.0), DT, 10)
    assert float(s.u.abs().max()) < 1e-12
    np.testing.assert_allclose(s.h.numpy(), 1000.0)


def test_gravity_wave_and_mass_conservation():
    grid = _grid()
    s = shallow_water_state(grid, h0=1000.0)
    lam = grid.lam_c_i.reshape(1, -1)
    phi = grid.phi_c_i.reshape(-1, 1)
    s = s.replace(h=s.h + 1.0 * torch.exp(-((lam - 180.0) ** 2 + phi**2) / 300.0))
    mass0 = _mass(grid, s.h)
    # c = sqrt(gH) ~ 100 m/s; dx_min ~ 150 km -> dt = 60 s is safe
    s = sw_loop(ShallowWaterConfig(coriolis=0.0), grid, s, DT, 200)
    assert abs(_mass(grid, s.h) - mass0) / mass0 < 1e-12  # conservative mass flux
    assert float((s.h - 1000.0).abs().max()) < 2.0  # a wave radiated, bounded
    assert bool(torch.isfinite(s.u).all())


def test_geostrophic_adjustment_produces_balanced_flow():
    grid = _grid()
    s = shallow_water_state(grid, h0=1000.0)
    phi = grid.phi_c_i.reshape(-1, 1)
    s = s.replace(h=s.h + 2.0 * torch.exp(-((phi - 40.0) ** 2) / 50.0))
    s = sw_loop(ShallowWaterConfig(), grid, s, DT, 400)
    # a zonal jet emerges along the ridge's flank
    assert 0.01 < float(s.u.abs().max()) < 10.0
    assert bool(torch.isfinite(s.h).all())


def test_decomposed_2x2_matches_serial_f64():
    grid = _grid()
    cfg = ShallowWaterConfig()
    s = shallow_water_state(grid, h0=500.0)
    lam = grid.lam_c_i.reshape(1, -1)
    phi = grid.phi_c_i.reshape(-1, 1)
    s = s.replace(h=s.h + 1.0 * torch.exp(-((lam - 90.0) ** 2 + (phi + 20.0) ** 2) / 400.0))
    ref = sw_state_to_numpy(sw_loop(cfg, grid, s, DT, 5))
    port = spawn(run_decomposed_sw, 4, cfg, grid, sw_state_to_numpy(s), DT, 5, shape=(2, 2))[0]
    assert list(port) == list(ref)
    for name in ref:
        np.testing.assert_allclose(port[name], ref[name], rtol=1e-10, atol=1e-13, err_msg=name)
    # the upper tiles' local row 0 is an interior v row, not a wall
    assert np.abs(port["v"][:, grid.Ny // 2]).max() > 1e-6


def test_model_is_bench_atmosphere_state():
    cfg, grid, s = shallow_water_model(48, 24, device="cpu", dtype=torch.float64)
    assert cfg == ShallowWaterConfig() and (grid.Nx, grid.Ny, grid.Nz) == (48, 24, 1)
    gj = jax_latlon(48, 24, 1, dtype=jnp.float64)
    sj = jax_state(gj, h0=1000.0)
    phi = gj.phi_c_i.reshape(1, -1)
    hj = sj.h + 2.0 * jnp.exp(-((phi - 40.0) ** 2) / 50.0) + 0.0 * gj.lam_c_i.reshape(-1, 1)
    np.testing.assert_allclose(sw_state_to_numpy(s)["h"], np.asarray(hj), rtol=1e-14)
    assert s.iteration == 0 and float(s.time) == 0.0 and float(s.u.abs().max()) == 0.0


def test_config_rejects_other_advection():
    with pytest.raises(ValueError, match="momentum_advection"):
        ShallowWaterConfig(momentum_advection="weno")
    assert dataclasses.replace(ShallowWaterConfig(), coriolis=0.0).coriolis == 0.0
