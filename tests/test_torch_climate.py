"""The port's coupled climate model against the JAX package's.

Static parts, float64, bit for bit: the Gaussian-islands bathymetry, the
immersed masks and face bottoms, the immersed face depths and the
pre-regridded atmosphere (and its value at a few model times).

The coupled step, float64, 3 steps (an Euler step and two AB2 steps)
against JAX ``coupled_time_step`` with kernels="jnp" and
GB25_BAROTROPIC_BLOCK=1, at 1e-10 of each field's largest value: on
``data_free_ocean_climate_model`` at resolution 8 (48x24x8) and on a grid
with a rectangular island whose columns are land to the surface. The port
runs the fused form (x* = x + dt c1 G + dt c2 G_prev, forcing (Us - U0)/dt,
the Pallas kernels' formula order in the Thomas solves) where the JAX
array path forms c1 G + c2 G_prev first, so only reassociation differs.

float32, one step against JAX kernels="zslab" with GB25_ZSLAB_INTERPRET=1
(its CATKE, z-slab, barotropic and Thomas Pallas kernels in interpret
mode) at 128x64x4, at the rtol 1e-3 / atol 5e-6 of
tests/test_pallas_catke.py. One step, for the TEOS-10 float32 rounding
reason tests/test_torch_step.py gives.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gb25_tpu.grids.immersed import face_bottom_planes as jax_face_bottom_planes
from gb25_tpu.grids.immersed import immersed_masks as jax_immersed_masks
from gb25_tpu.grids.immersed import with_bathymetry as jax_with_bathymetry
from gb25_tpu.models.coupled import compute_interface_fluxes as jax_interface_fluxes
from gb25_tpu.models.coupled import coupled_time_step as jax_coupled_time_step
from gb25_tpu.models.coupled import data_free_ocean_climate_model as jax_climate_model
from gb25_tpu.utils.correctness import _leaf_names
from gb25_tpu_torch.convert import (
    atmosphere_from_numpy,
    immersed_grid_from_numpy,
    state_from_numpy,
    state_to_numpy,
)
from gb25_tpu_torch.grids.immersed import face_bottom_planes, immersed_masks, with_bathymetry
from gb25_tpu_torch.models import coupled_loop, coupled_time_step, data_free_ocean_climate_model
from gb25_tpu_torch.models.config import HydrostaticConfig
from gb25_tpu_torch.models.coupled import compute_interface_fluxes
from gb25_tpu_torch.models.free_surface import face_depths
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


def _jax_arrays(state):
    return {name: np.asarray(x) for name, x in _leaf_names(state)}


def back(t):
    return np.transpose(t.detach().cpu().numpy())


def _island(Nx, Ny):
    """A rectangular island, land to the surface, in JAX's (Nx, Ny)."""
    bh = np.full((Nx, Ny), -5000.0)
    bh[Nx // 4 : Nx // 4 + 5, Ny // 3 : Ny // 3 + 4] = 0.0
    bh[Nx // 2 : Nx // 2 + 3, 2 : 6] = -300.0
    return bh


def _models(resolution, Nz, dtype, grid_type="gaussian_islands", island=False):
    """The JAX model and the port's, the port's grid, atmosphere and state
    carried across from JAX's arrays."""
    jdt = {torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype]
    cj, gj, aj, sj = jax_climate_model(resolution=resolution, Nz=Nz, dtype=jdt,
                                       grid_type=grid_type)
    ct, gt, _, _ = data_free_ocean_climate_model(resolution=resolution, Nz=Nz, device="cpu",
                                                 dtype=dtype, grid_type=grid_type)
    if island:
        gj = jax_with_bathymetry(gj, _island(gj.Nx, gj.Ny))
    if gj.immersed:
        gt = immersed_grid_from_numpy(gt, np.asarray(gj.bottom_height))
    at = atmosphere_from_numpy({k: np.asarray(f) for k, f in aj.fields.items()},
                               np.asarray(aj.times), aj.period, "cpu")
    st = state_from_numpy(_jax_arrays(sj), "cpu")
    return (cj, gj, aj, sj), (ct, gt, at, st)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_bathymetry_and_masks_match_jax(dtype):
    (_, gj, _, _), _ = _models(8.0, 8, dtype)
    _, gt, _, _ = data_free_ocean_climate_model(resolution=8.0, Nz=8, device="cpu",
                                                dtype=dtype)
    assert gt.immersed
    np.testing.assert_array_equal(back(gt.bottom_height), np.asarray(gj.bottom_height))
    for got, want in zip(immersed_masks(gt), jax_immersed_masks(gj)):
        np.testing.assert_array_equal(back(got), np.asarray(want))
    for got, want in zip(face_bottom_planes(gt), jax_face_bottom_planes(gj)):
        np.testing.assert_array_equal(back(got), np.asarray(want))


@pytest.mark.parametrize("island", [False, True])
def test_face_depths_match_jax_f64(island):
    """The discrete immersed face depths of the JAX free surface: the sum
    of dz over the cells above each face bottom."""
    (_, gj, _, _), (_, gt, _, _) = _models(8.0, 8, torch.float64, island=island)
    zc = gj.z_c[0, 0, gj.hz : gj.hz + gj.Nz]
    dzc = gj.dz_c[0, 0, gj.hz : gj.hz + gj.Nz]
    for got, bf in zip(face_depths(gt), jax_face_bottom_planes(gj)):
        want = jnp.sum(jnp.where(zc[None, None, :] > bf[:, :, None], dzc[None, None, :], 0.0),
                       axis=2)
        np.testing.assert_array_equal(back(got), np.asarray(want))
    if island:
        Hu, Hv = face_depths(gt)
        assert float(Hu.min()) == 0.0 and float(Hv.min()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_atmosphere_matches_jax(dtype):
    (_, _, aj, _), _ = _models(8.0, 4, dtype)
    _, _, at, _ = data_free_ocean_climate_model(resolution=8.0, Nz=4, device="cpu", dtype=dtype)
    assert set(at.fields) == set(aj.fields)
    for k, f in aj.fields.items():
        np.testing.assert_array_equal(back(at.fields[k]), np.asarray(f), err_msg=k)
    np.testing.assert_array_equal(at.times.numpy(), np.asarray(aj.times))
    jdt = np.dtype(str(dtype).removeprefix("torch."))
    for t in (0.0, 1800.0, 3600.0, 5000.0, 86000.0, 90000.0):
        a = aj.at_time(jnp.asarray(t, jdt))
        b = at.at_time(torch.tensor(t, dtype=dtype))
        for k in a:
            np.testing.assert_array_equal(back(b[k]), np.asarray(a[k]), err_msg=f"{k} at {t}")


def test_interface_fluxes_match_jax_f64():
    (cj, gj, aj, sj), (ct, gt, at, st) = _models(8.0, 8, torch.float64)
    rng = np.random.default_rng(31)
    # surface currents, so the wind is taken relative to them
    u = np.asarray(sj.u) + 0.1 * rng.standard_normal(sj.u.shape)
    v = np.asarray(sj.v) + 0.1 * rng.standard_normal(sj.v.shape)
    v[:, 0, :] = 0.0
    sj = sj.replace(u=jnp.asarray(u), v=jnp.asarray(v))
    st = state_from_numpy(_jax_arrays(sj), "cpu")
    want, _ = jax_interface_fluxes(cj, gj, aj, sj)
    got, _ = compute_interface_fluxes(ct, gt, at, st)
    assert set(got) == set(want) == {"u", "v", "T", "S", "e"}
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(back(got[k]), w, rtol=0, atol=1e-12 * np.abs(w).max(),
                                   err_msg=k)


@pytest.mark.parametrize("island", [False, True], ids=["gaussian_islands", "rect_island"])
def test_three_coupled_steps_match_jax_array_path_f64(monkeypatch, island):
    monkeypatch.setenv("GB25_BAROTROPIC_BLOCK", "1")
    monkeypatch.delenv("GB25_ZSLAB_INTERPRET", raising=False)
    (cj, gj, aj, sj), (ct, gt, at, st) = _models(8.0, 8, torch.float64, island=island)
    cj = dataclasses.replace(cj, ocean=dataclasses.replace(cj.ocean, kernels="jnp"))
    step = jax.jit(jax_coupled_time_step)
    for _ in range(3):
        sj = step(cj, gj, aj, sj, DT)
    st = coupled_loop(ct, gt, at, st, DT, 3)
    ref, port = _jax_arrays(sj), state_to_numpy(st)
    assert list(port) == list(ref)
    compare_states(ref, port, rtol=1e-10, verbose=False)
    assert int(port["iteration"]) == 3
    assert np.abs(port["u"]).max() > 0.0
    if island:
        land = np.asarray(gj.bottom_height) == 0.0
        assert land.any() and np.all(port["eta"][land] == 0.0)


def test_coupled_step_matches_jax_kernels_f32(monkeypatch):
    monkeypatch.setenv("GB25_ZSLAB_INTERPRET", "1")
    (cj, gj, aj, sj), (ct, gt, at, st) = _models(3.0, 4, torch.float32)
    assert (gj.Nx, gj.Ny) == (128, 64)
    cj = dataclasses.replace(cj, ocean=dataclasses.replace(cj.ocean, kernels="zslab"))
    ref = _jax_arrays(jax.jit(jax_coupled_time_step)(cj, gj, aj, sj, DT))
    port = state_to_numpy(coupled_time_step(ct, gt, at, st, DT))
    assert list(port) == list(ref)
    for name in ref:
        np.testing.assert_allclose(port[name], ref[name], rtol=1e-3, atol=5e-6, err_msg=name)


def test_coupled_loop_is_coupled_step_repeated():
    """``coupled_loop`` is ``coupled_time_step`` n times, bit for bit."""
    _, (ct, gt, at, st) = _models(12.0, 4, torch.float64)
    a = coupled_loop(ct, gt, at, st, DT, 2)
    b = coupled_time_step(ct, gt, at, coupled_time_step(ct, gt, at, st, DT), DT)
    compare_states(state_to_numpy(a), state_to_numpy(b), rtol=0.0, verbose=False)


def test_solid_faces_and_land_stay_at_rest():
    """After a few steps on the rectangular-island grid: u and v are 0 on
    the faces of land columns (face depth 0), eta is 0 on land columns,
    e >= 0, and the freezing limiter holds. (Below the bottom of a partly
    fluid column the implicit solves, run after the re-mask, leave small
    values on solid faces, in the JAX package as here; the next step masks
    them before any use.)"""
    ct, gt, at, st = data_free_ocean_climate_model(resolution=12.0, Nz=4, device="cpu",
                                                   dtype=torch.float64, grid_type="latlon")
    gt = with_bathymetry(gt, torch.as_tensor(_island(gt.Nx, gt.Ny).T))
    s = coupled_loop(ct, gt, at, st, 600.0, 4)
    Hu, Hv = face_depths(gt)
    assert bool((Hu == 0).any()) and bool((Hv == 0).any())
    assert float(s.u[:, Hu == 0].abs().max()) == 0.0
    assert float(s.v[:, Hv == 0].abs().max()) == 0.0
    assert float(s.eta[gt.bottom_height == 0.0].abs().max()) == 0.0
    assert float(s.tracers["e"].min()) >= 0.0
    Tf = -ct.sea_ice.liquidus.slope * s.tracers["S"]
    assert bool((s.tracers["T"] >= Tf).all())
    assert float(s.u.abs().max()) > 0.0


def test_config_rejects_other_tracer_sets_and_tripolar():
    from gb25_tpu_torch.models.catke import CATKEVerticalDiffusivity

    with pytest.raises(ValueError, match="tracers"):
        HydrostaticConfig(tracers=("T", "S", "e"))
    with pytest.raises(ValueError, match="tracers"):
        HydrostaticConfig(tracers=("T", "S"), closure=CATKEVerticalDiffusivity())
    # the tripolar grid is taken by its name only (tests/test_torch_tripolar.py)
    with pytest.raises(ValueError, match="gaussian_islands_tripolar"):
        data_free_ocean_climate_model(resolution=8.0, Nz=4, device="cpu", grid_type="tripolar")
    _, grid, _, _ = data_free_ocean_climate_model(resolution=8.0, Nz=4, device="cpu",
                                                  grid_type="gaussian_islands_tripolar")
    assert grid.north_fold and grid.immersed
