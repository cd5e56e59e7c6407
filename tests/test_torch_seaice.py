"""The port's prognostic slab sea ice against the JAX package's.

float64, the same seeded numpy inputs to both, at 1e-12 of each field's
largest value: ``_skin_temperature``, ``seaice_thermodynamics`` (the new
ice and every entry of the coupling dict) and ``seaice_advect``, on the
plain lat-lon grid, the Gaussian-islands grid (land columns stay free of
ice) and the tripolar grid (the fold's ghosts in the width-1 extension).
The advection conserves the ice volume (the JAX package's own case,
tests/test_seaice.py). Three ``coupled_ice_time_step``s (the Euler step
and two AB2 steps) with the polar band supercooled (T = -2.2 degC poleward
of 60 degrees) and an initial cover (v = 1 m, a = 0.9 poleward of 70
degrees), on the islands and the tripolar grid, against JAX with
kernels="jnp" and GB25_BAROTROPIC_BLOCK=1, at 1e-10 on ocean and ice.
``seaice_advect`` on a 2x1 gloo mesh is held to the serial call in
tests/test_torch_data.py, which runs the slice's decomposed cases on one
spawn.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gb25_tpu.grids.immersed import with_bathymetry as jax_with_bathymetry
from gb25_tpu.models.coupled import coupled_ice_time_step as jax_coupled_ice_time_step
from gb25_tpu.models.coupled import data_free_ocean_climate_model as jax_climate_model
from gb25_tpu.models.seaice import SeaIceState as JaxIce
from gb25_tpu.models.seaice import _skin_temperature as jax_skin_temperature
from gb25_tpu.models.seaice import seaice_advect as jax_seaice_advect
from gb25_tpu.models.seaice import seaice_thermodynamics as jax_thermodynamics
from gb25_tpu.utils.correctness import _leaf_names
from gb25_tpu_torch.convert import (
    atmosphere_from_numpy,
    ice_state_from_numpy,
    ice_state_to_numpy,
    immersed_grid_from_numpy,
    state_from_numpy,
    state_to_numpy,
)
from gb25_tpu_torch.models import coupled_ice_loop, data_free_ocean_climate_model
from gb25_tpu_torch.models.seaice import (
    SeaIceState,
    SlabSeaIce,
    _skin_temperature,
    seaice_advect,
    seaice_thermodynamics,
)
from gb25_tpu_torch.utils.correctness import compare_states
from test_torch_climate import _island

DT = 60.0
GRIDS = ["latlon", "gaussian_islands", "gaussian_islands_tripolar"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors (the other test
    files' reason)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def back(t):
    return np.transpose(t.detach().cpu().numpy())


def _jax_arrays(state):
    return {name: np.asarray(x) for name, x in _leaf_names(state)}


def _models(grid_type, resolution=8.0, Nz=4):
    """The JAX slab-ice climate model and the port's, float64, the port's
    grid, atmosphere and state carried across from JAX's arrays. The
    islands grid gains a rectangular island, land to the surface (the
    Gaussian islands have no land column at this size; the tripolar grid's
    pole caps are land)."""
    cj, gj, aj, sj = jax_climate_model(resolution=resolution, Nz=Nz, dtype=jnp.float64,
                                       grid_type=grid_type, sea_ice="slab")
    if grid_type == "gaussian_islands":
        gj = jax_with_bathymetry(gj, _island(gj.Nx, gj.Ny))
    ct, gt, _, _ = data_free_ocean_climate_model(resolution=resolution, Nz=Nz, device="cpu",
                                                 dtype=torch.float64, grid_type=grid_type,
                                                 sea_ice="slab")
    if gj.immersed:
        gt = immersed_grid_from_numpy(gt, np.asarray(gj.bottom_height))
    at = atmosphere_from_numpy({k: np.asarray(f) for k, f in aj.fields.items()},
                               np.asarray(aj.times), aj.period, "cpu")
    st = state_from_numpy(_jax_arrays(sj), "cpu")
    assert isinstance(ct.sea_ice, SlabSeaIce) and ct.sea_ice == SlabSeaIce()
    return (cj, gj, aj, sj), (ct, gt, at, st)


def _latitude(gj):
    """Cell-center latitude, (Nx, Ny) numpy."""
    if getattr(gj, "phi2_c", None) is not None:
        return np.asarray(gj.phi2_c)
    return np.broadcast_to(np.asarray(gj.phi_c_i)[None, :], (gj.Nx, gj.Ny))


def _inputs(gj, sj, seed):
    """Seeded ocean, ice and atmosphere inputs in JAX's layout: T about the
    freezing point (some cells supercooled), surface currents, ice of all
    thicknesses with open water, and an atmosphere from cold to melting."""
    rng = np.random.default_rng(seed)
    shape3, shape2 = sj.u.shape, (gj.Nx, gj.Ny)
    arrays = _jax_arrays(sj)
    arrays["tracers/T"] = rng.uniform(-2.6, 3.0, shape3)
    arrays["tracers/S"] = rng.uniform(30.0, 36.0, shape3)
    arrays["u"] = 0.3 * rng.standard_normal(shape3)
    v = 0.3 * rng.standard_normal(shape3)
    v[:, 0, :] = 0.0
    arrays["v"] = v
    vol = rng.uniform(0.0, 3.0, shape2) * (rng.uniform(size=shape2) > 0.3)
    conc = np.where(vol > 0, rng.uniform(0.05, 1.0, shape2), 0.0)
    atmos = {
        "Ta": rng.uniform(240.0, 280.0, shape2), "ua": rng.uniform(-10.0, 10.0, shape2),
        "va": rng.uniform(-10.0, 10.0, shape2), "qa": rng.uniform(0.0, 2e-3, shape2),
        "pa": np.full(shape2, 101325.0), "Qsw": rng.uniform(0.0, 400.0, shape2),
        "Qlw": rng.uniform(150.0, 350.0, shape2),
    }
    return arrays, {"v": vol, "a": conc}, atmos


def _jax_state(sj, arrays):
    tr = {k: jnp.asarray(arrays[f"tracers/{k}"]) for k in sj.tracers}
    return sj.replace(u=jnp.asarray(arrays["u"]), v=jnp.asarray(arrays["v"]), tracers=tr)


def _close(got, want, name, rel=1e-12):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-300),
                               err_msg=name)


def test_skin_temperature_matches_jax_f64():
    rng = np.random.default_rng(5)
    shape = (12, 9)
    si = SlabSeaIce()
    atmos = {"ua": rng.uniform(-10, 10, shape), "va": rng.uniform(-10, 10, shape),
             "Ta": rng.uniform(230.0, 285.0, shape), "Qsw": rng.uniform(0, 500, shape),
             "Qlw": rng.uniform(150, 350, shape)}
    h = rng.uniform(0.05, 4.0, shape)
    T_f = rng.uniform(-2.0, -1.5, shape)
    want = jax_skin_temperature(si, jnp.asarray(h), jnp.asarray(T_f),
                                {k: jnp.asarray(a) for k, a in atmos.items()})
    got = _skin_temperature(si, torch.as_tensor(h.T), torch.as_tensor(T_f.T),
                            {k: torch.as_tensor(a.T) for k, a in atmos.items()})
    _close(back(got), want, "Ts")
    assert float(got.max()) <= 0.0 and float(got.min()) < -1.0  # clamped and cold ice


@pytest.mark.parametrize("grid_type", GRIDS)
def test_thermodynamics_matches_jax_f64(grid_type):
    (cj, gj, _, sj), (ct, gt, _, _) = _models(grid_type)
    arrays, ice, atmos = _inputs(gj, sj, seed=11)
    want_ice, want = jax_thermodynamics(cj.sea_ice, gj, {k: jnp.asarray(a) for k, a in
                                                         atmos.items()},
                                        _jax_state(sj, arrays),
                                        JaxIce(v=jnp.asarray(ice["v"]), a=jnp.asarray(ice["a"])),
                                        3600.0)
    got_ice, got = seaice_thermodynamics(ct.sea_ice, gt,
                                         {k: torch.as_tensor(a.T) for k, a in atmos.items()},
                                         state_from_numpy(arrays, "cpu"),
                                         ice_state_from_numpy(ice, "cpu"), 3600.0)
    assert set(got) == set(want) == {"T_flux", "S_flux", "shade", "Ts", "Q_conductive",
                                     "Q_basal"}
    for k in want:
        _close(back(got[k]), want[k], k)
    for k, t in ice_state_to_numpy(got_ice).items():
        _close(t, getattr(want_ice, k), k)
    # frazil and growth happen, and some ice melts
    dv = back(got_ice.v) - ice["v"]
    assert dv.max() > 0.0 and dv.min() < 0.0


@pytest.mark.parametrize("grid_type", GRIDS)
def test_advect_matches_jax_f64(grid_type):
    (cj, gj, _, sj), (ct, gt, _, _) = _models(grid_type)
    arrays, ice, atmos = _inputs(gj, sj, seed=23)
    want = jax_seaice_advect(cj.sea_ice, gj, _jax_state(sj, arrays),
                             JaxIce(v=jnp.asarray(ice["v"]), a=jnp.asarray(ice["a"])),
                             {k: jnp.asarray(a) for k, a in atmos.items()}, 3600.0)
    got = seaice_advect(ct.sea_ice, gt, state_from_numpy(arrays, "cpu"),
                        ice_state_from_numpy(ice, "cpu"),
                        {k: torch.as_tensor(a.T) for k, a in atmos.items()}, 3600.0)
    for k, t in ice_state_to_numpy(got).items():
        _close(t, getattr(want, k), k)
    moved = ice_state_to_numpy(got)["v"] - ice["v"]
    assert np.abs(moved).max() > 1e-3
    if gt.immersed:
        land = back(gt.bottom_height) == 0.0
        assert land.any() and back(got.v)[land].max() == 0.0


def test_advection_conserves_volume():
    """Uniform zonal drift on the periodic lat-lon grid: sum(v Az) is kept
    by the flux form (the JAX package's case)."""
    _, (ct, gt, at, st) = _models("latlon", resolution=16.0)
    si = SlabSeaIce(wind_drift_factor=0.0)
    st = st.replace(u=torch.full_like(st.u, 0.5))
    rng = np.random.default_rng(0)
    v0 = torch.as_tensor(rng.uniform(size=(gt.Ny, gt.Nx)))
    ice = SeaIceState(v=v0, a=torch.clamp(2 * v0, 0.0, 1.0))
    az = gt.azc[0, gt.hy : gt.hy + gt.Ny, :].expand(gt.Ny, gt.Nx)
    tot0 = float((ice.v * az).sum())
    af = at.at_time(st.time)
    for _ in range(5):
        ice = seaice_advect(si, gt, st, ice, af, 20_000.0)
    assert abs(float((ice.v * az).sum()) - tot0) / tot0 < 1e-12
    assert float(ice.v.min()) >= 0.0


def _polar_start(gj, sj):
    """The JAX state with T = -2.2 poleward of 60 degrees and the ice
    cover v = 1 m, a = 0.9 poleward of 70 degrees."""
    phi = np.abs(_latitude(gj))
    T = np.where(phi[:, :, None] > 60.0, -2.2, np.asarray(sj.tracers["T"]))
    sj = sj.replace(tracers={**sj.tracers, "T": jnp.asarray(T)})
    cover = phi > 70.0
    if gj.immersed:
        cover &= np.asarray(gj.bottom_height) < 0.0
    ice = {"v": np.where(cover, 1.0, 0.0), "a": np.where(cover, 0.9, 0.0)}
    return sj, ice


@pytest.mark.parametrize("grid_type", ["gaussian_islands", "gaussian_islands_tripolar"])
def test_three_coupled_ice_steps_match_jax_f64(monkeypatch, grid_type):
    monkeypatch.setenv("GB25_BAROTROPIC_BLOCK", "1")
    monkeypatch.delenv("GB25_ZSLAB_INTERPRET", raising=False)
    (cj, gj, aj, sj), (ct, gt, at, _) = _models(grid_type)
    cj = dataclasses.replace(cj, ocean=dataclasses.replace(cj.ocean, kernels="jnp"))
    sj, ice = _polar_start(gj, sj)
    st, it = state_from_numpy(_jax_arrays(sj), "cpu"), ice_state_from_numpy(ice, "cpu")
    step = jax.jit(jax_coupled_ice_time_step)
    ij = JaxIce(v=jnp.asarray(ice["v"]), a=jnp.asarray(ice["a"]))
    for _ in range(3):
        sj, ij = step(cj, gj, aj, sj, ij, DT)
    st, it = coupled_ice_loop(ct, gt, at, st, it, DT, 3)
    ref, port = _jax_arrays(sj), state_to_numpy(st)
    assert list(port) == list(ref) and int(port["iteration"]) == 3
    compare_states(ref, port, rtol=1e-10, verbose=False)
    compare_states({"v": np.asarray(ij.v), "a": np.asarray(ij.a)}, ice_state_to_numpy(it),
                   rtol=1e-10, verbose=False)
    v, a = ice_state_to_numpy(it)["v"], ice_state_to_numpy(it)["a"]
    assert v.min() >= 0.0 and 0.0 <= a.min() and a.max() <= 1.0
    phi = np.abs(_latitude(gj))
    band = (phi > 60.0) & (phi < 70.0)
    if gj.immersed:
        band &= np.asarray(gj.bottom_height) < 0.0
    assert v[band].max() > 0.0  # the supercooled band froze
    assert v[phi < 40.0].max() == 0.0
