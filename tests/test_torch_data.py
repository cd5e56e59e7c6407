"""The port's data layer and T/S restoring against the JAX package's.

The same files (written here: ``.npz`` and NetCDF) and grids go to both
packages; numpy alone computes the regridding in each, so the results are
bit for bit:
  - the linearly tapered polar mask (lat-lon and tripolar grids);
  - ``climatology_restoring``: synthetic, from an ``.npz`` file and from a
    NetCDF file (targets and rates);
  - ``initial_state_from_climatology``;
  - ``regrid_bathymetry`` from ``.npz`` and NetCDF (the bottom and the
    immersed geometry built on it);
  - ``file_prescribed_atmosphere``, pre-regridded (the record) and in the
    gather form (its value at a few model times, at 1e-12 of each field's
    largest value: the gathers and the time interpolation are torch ops);
  - the gather form against the pre-regridded form at a few model times,
    from a file and for the data-free atmosphere;
  - an explicit climatology path that does not exist raises.
Restoring in the ocean step, float64, 3 steps (the Euler step and two AB2
steps) at 1e-10 of each field's largest value against JAX kernels="jnp":
on the "auto" route (fused K1's plain version: the increment enters G and
the fused update as dt c1 inc; GB25_BAROTROPIC_BLOCK=1) and on the
"pallas" route (K6's plain version, unfused; GB25_BAROTROPIC_BLOCK unset),
and decomposed on a 2x1 gloo mesh through ``sharded_step_fn(restoring=)``,
each tile's targets cut from the global ones, against JAX serial.
"""

import dataclasses
import functools
import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gb25_tpu.io as jax_io
from gb25_tpu.data import climatology_restoring as jax_restoring
from gb25_tpu.data import file_prescribed_atmosphere as jax_file_atmosphere
from gb25_tpu.data import initial_state_from_climatology as jax_initial_state
from gb25_tpu.data import linearly_tapered_polar_mask as jax_polar_mask
from gb25_tpu.data import regrid_bathymetry as jax_regrid_bathymetry
from gb25_tpu.grids import simple_latitude_longitude_grid as jax_latlon
from gb25_tpu.grids import tripolar_grid as jax_tripolar
from gb25_tpu.grids.immersed import immersed_masks as jax_immersed_masks
from gb25_tpu.models import baroclinic_instability_config as jax_config
from gb25_tpu.models import baroclinic_instability_state as jax_state
from gb25_tpu.models import time_step as jax_time_step
from gb25_tpu.models.catke import CATKEVerticalDiffusivity as JaxCATKE
from gb25_tpu.utils.correctness import _leaf_names
from gb25_tpu_torch.convert import (
    ice_state_from_numpy,
    ice_state_to_numpy,
    restoring_from_numpy,
    state_from_numpy,
    state_to_numpy,
)
from gb25_tpu_torch.data import (
    climatology_restoring,
    file_prescribed_atmosphere,
    initial_state_from_climatology,
    linearly_tapered_polar_mask,
    regrid_bathymetry,
)
from gb25_tpu_torch.data.netcdf import NetCDF3Writer
from gb25_tpu_torch.grids import simple_latitude_longitude_grid, tripolar_grid
from gb25_tpu_torch.grids.immersed import immersed_masks
from gb25_tpu_torch.models import baroclinic_instability_config, loop
from gb25_tpu_torch.models.atmosphere import data_free_atmosphere
from gb25_tpu_torch.models.catke import CATKEVerticalDiffusivity
from gb25_tpu_torch.io import restore_state
from gb25_tpu_torch.models.seaice import seaice_advect
from gb25_tpu_torch.models.state import initial_state
from gb25_tpu_torch.parallel import spawn
from gb25_tpu_torch.utils.correctness import compare_states
from test_torch_seaice import _inputs as _ice_inputs
from test_torch_seaice import _models as _ice_models
from test_torch_simulation import _assert_arrays_equal, _random_state
from test_torch_mesh_jobs import production_cases

DT = 60.0
SHAPE = (32, 16, 4)


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


def _grids(kind, shape=SHAPE):
    if kind == "tripolar":
        return (jax_tripolar(*shape, dtype=jnp.float64),
                tripolar_grid(*shape, device="cpu", dtype=torch.float64))
    return (jax_latlon(*shape, dtype=jnp.float64),
            simple_latitude_longitude_grid(*shape, device="cpu", dtype=torch.float64))


def _climatology(Na=36, Ma=18):
    rng = np.random.default_rng(3)
    lon = (np.arange(Na) + 0.5) * (360.0 / Na)
    lat = -90.0 + (np.arange(Ma) + 0.5) * (180.0 / Ma)
    depth = np.array([5.0, 60.0, 300.0, 1200.0, 3500.0])  # positive down
    T = (25.0 * np.cos(np.deg2rad(lat))[None, :, None] * np.exp(-depth / 900.0)[None, None, :]
         + rng.uniform(0, 1, (Na, Ma, len(depth))))
    S = 34.0 + rng.uniform(0, 2, (Na, Ma, len(depth)))
    return lon, lat, depth, T, S


def _write_climatology(tmp_path, fmt):
    lon, lat, depth, T, S = _climatology()
    if fmt == "npz":
        p = str(tmp_path / "climatology.npz")
        np.savez(p, lon=lon, lat=lat, z_levels=-depth, T=T, S=S)
        return p
    p = str(tmp_path / "climatology.nc")
    w = NetCDF3Writer(p, {"lon": len(lon), "lat": len(lat), "depth": len(depth)})
    w.define("lon", ("lon",), np.float64, {"units": "degrees_east"})
    w.define("lat", ("lat",), np.float64, {"units": "degrees_north"})
    w.define("depth", ("depth",), np.float64, {"units": "m"})
    w.define("THETA", ("depth", "lat", "lon"), np.float64, {})
    w.define("SALT", ("depth", "lat", "lon"), np.float64, {})
    w.write("lon", lon)
    w.write("lat", lat)
    w.write("depth", depth)
    w.write("THETA", np.transpose(T, (2, 1, 0)))
    w.write("SALT", np.transpose(S, (2, 1, 0)))
    w.close()
    return p


def _write_bathymetry(tmp_path, fmt):
    lon = np.linspace(0.5, 359.5, 72)
    lat = np.linspace(-89.5, 89.5, 36)
    z = (-3000.0 + 1500.0 * np.sin(np.deg2rad(lat))[None, :] * np.cos(np.deg2rad(2 * lon))[:, None]
         + 4500.0 * np.exp(-((lon[:, None] - 120.0) ** 2 + (lat[None, :] - 10.0) ** 2) / 200.0))
    if fmt == "npz":
        p = str(tmp_path / "bathymetry.npz")
        np.savez(p, lon=lon, lat=lat, z=z)
        return p
    p = str(tmp_path / "bathymetry.nc")
    w = NetCDF3Writer(p, {"lon": len(lon), "lat": len(lat)})
    w.define("lon", ("lon",), np.float64, {})
    w.define("lat", ("lat",), np.float64, {})
    w.define("z", ("lat", "lon"), np.float64, {})
    w.write("lon", lon)
    w.write("lat", lat)
    w.write("z", z.T)
    w.close()
    return p


def _write_atmosphere(tmp_path, fmt, Na=36, Ma=18, Nt=4):
    rng = np.random.default_rng(9)
    lon = (np.arange(Na) + 0.5) * (360.0 / Na)
    lat = -90.0 + (np.arange(Ma) + 0.5) * (180.0 / Ma)
    times = np.arange(Nt) * 21600.0
    Ta = 270.0 + 20.0 * rng.uniform(size=(Na, Ma, Nt))
    ua = 10.0 * rng.standard_normal((Na, Ma, Nt))
    Qsw = 400.0 * rng.uniform(size=(Na, Ma, Nt))
    if fmt == "npz":
        p = str(tmp_path / "atmosphere.npz")
        np.savez(p, lon=lon, lat=lat, times=times, Ta=Ta, ua=ua, Qsw=Qsw)
        return p
    p = str(tmp_path / "atmosphere.nc")
    w = NetCDF3Writer(p, {"time": None, "lat": Ma, "lon": Na})
    w.define("lon", ("lon",), np.float64, {})
    w.define("lat", ("lat",), np.float64, {})
    w.define("time", ("time",), np.float64, {"units": "hours since 2000-01-01"})
    for name in ("tas", "uas", "rsds"):
        w.define(name, ("time", "lat", "lon"), np.float64, {})
    w.write("lon", lon)
    w.write("lat", lat)
    for k in range(Nt):
        w.append(time=times[k] / 3600.0, tas=Ta[:, :, k].T, uas=ua[:, :, k].T,
                 rsds=Qsw[:, :, k].T)
    w.close()
    return p


@pytest.mark.parametrize("kind", ["latlon", "tripolar"])
def test_polar_mask_matches_jax(kind):
    gj, gt = _grids(kind)
    np.testing.assert_array_equal(back(linearly_tapered_polar_mask(gt)),
                                  np.asarray(jax_polar_mask(gj)))
    np.testing.assert_array_equal(
        back(linearly_tapered_polar_mask(gt, (-70.0, -50.0), (40.0, 75.0))),
        np.asarray(jax_polar_mask(gj, (-70.0, -50.0), (40.0, 75.0))))


@pytest.mark.parametrize("source", ["synthetic", "npz", "nc"])
@pytest.mark.parametrize("kind", ["latlon", "tripolar"])
def test_climatology_restoring_matches_jax(tmp_path, kind, source):
    gj, gt = _grids(kind)
    path = None if source == "synthetic" else _write_climatology(tmp_path, source)
    want = jax_restoring(gj, path=path)
    got = climatology_restoring(gt, path=path)
    assert list(got) == list(want) == ["T", "S"]
    for name in want:
        for g, w in zip(got[name], want[name]):
            np.testing.assert_array_equal(back(g), np.asarray(w), err_msg=name)
    assert got["T"][1].shape == (1, gt.Ny, gt.Nx)
    assert float(got["T"][1].max()) > 0.0 and float(got["T"][1].min()) == 0.0


def test_initial_state_from_climatology_matches_jax(tmp_path):
    gj, gt = _grids("tripolar")
    path = _write_climatology(tmp_path, "npz")
    want = jax_initial_state(gj, jax_config(closure=JaxCATKE()), path=path)
    got = initial_state_from_climatology(
        gt, baroclinic_instability_config(closure=CATKEVerticalDiffusivity()), path=path)
    ref = {name: np.asarray(x) for name, x in _leaf_names(want)}
    port = state_to_numpy(got)
    assert list(port) == list(ref)
    for name in ref:
        np.testing.assert_array_equal(port[name], ref[name], err_msg=name)


@pytest.mark.parametrize("fmt", ["npz", "nc"])
@pytest.mark.parametrize("kind", ["latlon", "tripolar"])
def test_regrid_bathymetry_matches_jax(tmp_path, kind, fmt):
    gj, gt = _grids(kind)
    path = _write_bathymetry(tmp_path, fmt)
    gj, gt = jax_regrid_bathymetry(gj, path), regrid_bathymetry(gt, path)
    assert gt.immersed
    np.testing.assert_array_equal(back(gt.bottom_height), np.asarray(gj.bottom_height))
    for got, want in zip(immersed_masks(gt), jax_immersed_masks(gj)):
        np.testing.assert_array_equal(back(got), np.asarray(want))
    bh = back(gt.bottom_height)
    assert (bh == 0.0).any() and (bh < -1000.0).any()


TIMES = (0.0, 5000.0, 21600.0, 50000.0, 86000.0, 100000.0)


@pytest.mark.parametrize("fmt", ["npz", "nc"])
def test_file_atmosphere_matches_jax(tmp_path, fmt):
    gj, gt = _grids("tripolar")
    path = _write_atmosphere(tmp_path, fmt)
    pre_j, pre_t = jax_file_atmosphere(gj, path), file_prescribed_atmosphere(gt, path)
    gat_j = jax_file_atmosphere(gj, path, pre_regrid=False)
    gat_t = file_prescribed_atmosphere(gt, path, pre_regrid=False)
    assert pre_t.on_ocean_grid and not gat_t.on_ocean_grid
    assert list(pre_t.fields) == list(pre_j.fields) and pre_t.period == pre_j.period
    for k, f in pre_j.fields.items():
        np.testing.assert_array_equal(back(pre_t.fields[k]), np.asarray(f), err_msg=k)
    np.testing.assert_array_equal(pre_t.times.numpy(), np.asarray(pre_j.times))
    for t in TIMES:
        want = gat_j.at_time(jnp.asarray(t))
        got = gat_t.at_time(torch.tensor(t, dtype=torch.float64))
        pre = pre_t.at_time(torch.tensor(t, dtype=torch.float64))
        for k, w in want.items():
            w = np.asarray(w)
            tol = 1e-12 * np.abs(w).max()
            np.testing.assert_allclose(back(got[k]), w, rtol=0, atol=tol, err_msg=f"{k} at {t}")
            # the two forms: regrid-then-lerp against lerp-then-regrid
            np.testing.assert_allclose(back(pre[k]), w, rtol=0, atol=tol, err_msg=f"{k} at {t}")


@pytest.mark.parametrize("kind", ["latlon", "tripolar"])
def test_data_free_gather_form_matches_pre_regridded(kind):
    _, gt = _grids(kind)
    pre, gat = data_free_atmosphere(gt), data_free_atmosphere(gt, pre_regrid=False)
    assert gat.fields["Ta"].shape == (24, 180, 360) and gat.gather[0].shape == (gt.Ny, gt.Nx)
    for t in TIMES:
        a = pre.at_time(torch.tensor(t, dtype=torch.float64))
        b = gat.at_time(torch.tensor(t, dtype=torch.float64))
        for k in a:
            tol = 1e-12 * max(float(a[k].abs().max()), 1e-300)
            torch.testing.assert_close(b[k], a[k], rtol=0, atol=tol, msg=f"{k} at {t}")


def test_explicit_missing_climatology_raises(tmp_path):
    _, gt = _grids("latlon")
    missing = str(tmp_path / "no_such_climatology.npz")
    with pytest.raises(FileNotFoundError, match="climatology dataset not found"):
        climatology_restoring(gt, path=missing)
    with pytest.raises(FileNotFoundError, match="climatology dataset not found"):
        initial_state_from_climatology(gt, baroclinic_instability_config(), path=missing)
    with pytest.raises(FileNotFoundError, match="climatology dataset not found"):
        climatology_restoring(gt, synthetic=False)


def _restoring_case():
    """The flagship (32x16x4, f64) from JAX's state with T perturbed, and
    the synthetic climatology restoring at 1/(1 hour)."""
    gj, gt = _grids("latlon")
    sj = jax_state(gj, noise_velocity=1e-3)
    sj = sj.replace(tracers={**sj.tracers, "T": sj.tracers["T"] + 3.0})
    rj = jax_restoring(gj, rate=1.0 / 3600.0)
    rt = restoring_from_numpy({k: (np.asarray(a), np.asarray(r)) for k, (a, r) in rj.items()},
                              "cpu")
    return gj, gt, sj, rj, rt


def _jax_steps(cfg, gj, sj, rj, n=3):
    step = jax.jit(lambda s: jax_time_step(cfg, gj, s, DT, restoring=rj))
    for _ in range(n):
        sj = step(sj)
    return {name: np.asarray(x) for name, x in _leaf_names(sj)}


@functools.lru_cache(maxsize=None)
def _jax_reference(block):
    """JAX's three steps of ``_restoring_case`` (kernels="jnp") with
    GB25_BAROTROPIC_BLOCK=``block`` (None: unset), computed once per
    setting for the tests of this module that read it."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("GB25_BAROTROPIC_BLOCK", "GB25_ZSLAB_INTERPRET")}
    if block is not None:
        env["GB25_BAROTROPIC_BLOCK"] = block
    with mock.patch.dict(os.environ, env, clear=True):
        gj, _, sj, rj, _ = _restoring_case()
        return _jax_steps(dataclasses.replace(jax_config(), kernels="jnp"), gj, sj, rj)


@pytest.mark.parametrize("route", ["auto", "pallas"])
def test_three_restoring_steps_match_jax_f64(monkeypatch, route):
    if route == "auto":
        monkeypatch.setenv("GB25_BAROTROPIC_BLOCK", "1")
    else:
        monkeypatch.delenv("GB25_BAROTROPIC_BLOCK", raising=False)
    monkeypatch.delenv("GB25_ZSLAB_INTERPRET", raising=False)
    gj, gt, sj, rj, rt = _restoring_case()
    ref = _jax_reference("1" if route == "auto" else None)
    cfg = baroclinic_instability_config(kernels=route)
    assert cfg.fused == (route == "auto")
    st = state_from_numpy({name: np.asarray(x) for name, x in _leaf_names(sj)}, "cpu")
    port = state_to_numpy(loop(cfg, gt, st, DT, 3, restoring=rt))
    assert list(port) == list(ref)
    compare_states(ref, port, rtol=1e-10, verbose=False)
    # the restoring moved T: the same steps without it differ
    free = state_to_numpy(loop(cfg, gt, st, DT, 3))
    assert np.abs(free["tracers/T"] - port["tracers/T"]).max() > 1e-3


# ---------------------------------------------------------------------------
# the slice's decomposed cases, on one 2x1 gloo spawn
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_2x1(tmp_path_factory):
    """One spawn of a 2x1 gloo mesh runs every decomposed case of the
    slice (``test_torch_mesh_jobs.production_cases``): the restoring steps
    through ``sharded_step_fn(restoring=)``, ``seaice_advect`` on the
    islands and the tripolar grid, and a sharded checkpoint write. Returns
    the cases' inputs, serial references and gathered results."""
    # the restoring case and the tiles' steps with GB25_BAROTROPIC_BLOCK unset
    with mock.patch.dict(os.environ):
        os.environ.pop("GB25_BAROTROPIC_BLOCK", None)
        _, gt, sj, _, rt = _restoring_case()
        arrays = {name: np.asarray(x) for name, x in _leaf_names(sj)}
        restoring_case = (baroclinic_instability_config(), gt, arrays, DT, 3, None, False, rt)
        advect_cases, advect_want = [], []
        for grid_type in ("gaussian_islands", "gaussian_islands_tripolar"):
            (_, gj, _, sj), (ct, gt, _, _) = _ice_models(grid_type)
            arrays, ice, atmos = _ice_inputs(gj, sj, seed=37)
            out = seaice_advect(ct.sea_ice, gt, state_from_numpy(arrays, "cpu"),
                                ice_state_from_numpy(ice, "cpu"),
                                {k: torch.as_tensor(a.T) for k, a in atmos.items()}, 3600.0)
            advect_want.append(ice_state_to_numpy(out))
            advect_cases.append((ct.sea_ice, gt, arrays, ice, atmos, 3600.0))
        ckpt_grid, _, ckpt_arrays = _random_state(seed=3)
        ckpt_dir = tmp_path_factory.mktemp("ckpt_2x1")
        got = spawn(production_cases, 2, restoring_case, advect_cases,
                    (ckpt_arrays, str(ckpt_dir)), shape=(2, 1))[0]
    return {"got": got, "advect_want": advect_want, "ckpt": (ckpt_grid, ckpt_arrays, ckpt_dir)}


def test_restoring_decomposed_2x1_matches_jax_serial_f64(mesh_2x1):
    """Each tile's targets cut from the global ones, against JAX serial."""
    ref = _jax_reference(None)
    port = mesh_2x1["got"]["restoring"]
    assert list(port) == list(ref)
    compare_states(ref, port, rtol=1e-10, verbose=False)


def test_advect_on_2x1_mesh_is_the_serial_call(mesh_2x1):
    """``seaice_advect`` with the width-1 extension exchanged, on the
    islands grid and on the tripolar grid (whose fold joins the top row of
    both tiles), equals the serial call bit for bit."""
    for g, w in zip(mesh_2x1["got"]["advect"], mesh_2x1["advect_want"]):
        for k in ("v", "a"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_checkpoint_from_2x1_mesh_reassembles(mesh_2x1):
    """The checkpoint the mesh wrote, one tile a rank with its global
    slices, reassembles with JAX's ``load_global_field`` and restores
    serially, bit for bit."""
    grid, arrays, path = mesh_2x1["ckpt"]
    assert sorted(os.listdir(path)) == ["fields_rank0.npz", "fields_rank1.npz",
                                        "index_rank0.json", "index_rank1.json"]
    assert jax_io.load_metadata(str(path))["nprocs"] == 2
    with open(path / "index_rank1.json") as f:
        assert json.load(f)["fields"]["u"]["shards"][0]["slices"] == [[16, 32], [0, 16], [0, 4]]
    for name, want in arrays.items():
        np.testing.assert_array_equal(jax_io.load_global_field(str(path), name), want,
                                      err_msg=name)
    back = restore_state(initial_state(grid, ("T", "S", "e")), str(path))
    _assert_arrays_equal(state_to_numpy(back), arrays)
