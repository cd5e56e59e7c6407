"""The port's tripolar grid, north fold and tripolar climate model against
the JAX package's.

Static parts, bit for bit in float64 and float32: the grid (48x32x4, as
tests/test_tripolar.py), the fold halos of each kind (``extend_field``,
``extend2``, ``extend_field_xy``, corners included), the seam-row
projection, the Gaussian-islands geometry on the tripolar grid and the
atmosphere regridded onto its 2-D centres.

Kernels' plain versions in float32 against the JAX Pallas kernels in
interpret mode: K2's fold instance (128x32, rtol 1e-5 as
tests/test_barotropic_kernel.py, with and without bathymetry) and K1 on
2-D metric planes (128x32x8, rtol 2e-4 as tests/test_zslab.py).

The coupled step on ``grid_type="gaussian_islands_tripolar"``: 3 steps in
float64 against JAX ``kernels="jnp"`` with GB25_BAROTROPIC_BLOCK=1 at 1e-10
of each field's largest value (resolution 8: 48x24x8), and one step in
float32 against the JAX interpret-mode kernels at rtol 1e-3 / atol 5e-6
(resolution 3: 128x64x4), as tests/test_torch_climate.py does on the
lat-lon grid.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gb25_tpu.grids import tripolar_grid as jax_tripolar_grid
from gb25_tpu.grids.immersed import face_bottom_planes as jax_face_bottom_planes
from gb25_tpu.grids.immersed import gaussian_islands_bottom as jax_islands
from gb25_tpu.grids.immersed import immersed_masks as jax_immersed_masks
from gb25_tpu.grids.immersed import with_bathymetry as jax_with_bathymetry
from gb25_tpu.grids.tripolar import north_fold_projection as jax_north_fold_projection
from gb25_tpu.models import baroclinic_instability_config as jax_config
from gb25_tpu.models import baroclinic_instability_state as jax_state
from gb25_tpu.models.atmosphere import data_free_atmosphere as jax_atmosphere
from gb25_tpu.models.catke import CATKEVerticalDiffusivity as JaxCATKE
from gb25_tpu.models.coupled import coupled_time_step as jax_coupled_time_step
from gb25_tpu.ops.halos import extend2 as jax_extend2
from gb25_tpu.ops.halos import extend_field as jax_extend_field
from gb25_tpu.ops.halos import extend_field_xy as jax_extend_field_xy
from gb25_tpu.ops.operators import coriolis_ff as jax_coriolis_ff
from gb25_tpu.ops.pallas_barotropic import pallas_barotropic_loop
from gb25_tpu.ops.pallas_zslab import zslab_tendencies as jax_zslab_tendencies
from gb25_tpu_torch.grids import tripolar_grid
from gb25_tpu_torch.grids.immersed import (
    face_bottom_planes,
    gaussian_islands_bottom,
    immersed_masks,
    interior_masks,
    with_bathymetry,
)
from gb25_tpu_torch.grids.tripolar import north_fold_projection
from gb25_tpu_torch.models import baroclinic_instability_config, coupled_loop, coupled_time_step
from gb25_tpu_torch.models.atmosphere import data_free_atmosphere
from gb25_tpu_torch.models.catke import CATKEVerticalDiffusivity
from gb25_tpu_torch.models.free_surface import face_depths
from gb25_tpu_torch.ops.halos import extend2, extend_field, extend_field_xy
from gb25_tpu_torch.ops.operators import coriolis_ff
from gb25_tpu_torch.ops.pallas_barotropic import barotropic_loop
from gb25_tpu_torch.ops.pallas_zslab import zslab_tendencies_plain
from gb25_tpu_torch.utils.correctness import compare_states
from test_torch_climate import _jax_arrays, _models
from gb25_tpu_torch.convert import state_to_numpy

PAIRS = {torch.float64: jnp.float64, torch.float32: jnp.float32}
NX, NY, NZ = 48, 32, 4
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
    """A JAX-layout array as a port tensor (axes reversed)."""
    return torch.from_numpy(np.array(np.transpose(np.asarray(a))))


def back(x):
    return np.transpose(x.detach().numpy())


def _grids(dtype, shape=(NX, NY, NZ)):
    return (jax_tripolar_grid(*shape, dtype=PAIRS[dtype]),
            tripolar_grid(*shape, device="cpu", dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tripolar_statics_bitwise(dtype):
    gj, gt = _grids(dtype)
    assert gt.north_fold and gt.immersed and gt.x_periodic
    assert (gt.Nx, gt.Ny, gt.Nz, gt.halo, gt.pole_index) == (
        gj.Nx, gj.Ny, gj.Nz, gj.halo, gj.pole_index)
    # JAX (X, Y, 1) planes and (X, Y) coordinates; the port (1, Y, X), (Y, X)
    for name in ("dxc", "dxf", "dyc", "dyf", "azc", "azf", "phi2_ff", "lam2_c", "phi2_c",
                 "bottom_height"):
        np.testing.assert_array_equal(back(getattr(gt, name)), np.asarray(getattr(gj, name)),
                                      err_msg=name)
    for name in ("lam_c", "lam_f", "phi_c", "phi_f", "z_c", "z_f", "dz_c", "dz_f"):
        np.testing.assert_array_equal(getattr(gt, name).numpy().reshape(-1),
                                      np.asarray(getattr(gj, name)).reshape(-1), err_msg=name)
    # f from the corner latitude: bit for bit in float64; float32 sin rounds
    # differently in torch and XLA, by at most an ulp
    np.testing.assert_allclose(back(coriolis_ff(gt, 7.292115e-5)),
                               np.asarray(jax_coriolis_ff(gj, 7.292115e-5)),
                               rtol=0 if dtype == torch.float64 else 2.5e-7, atol=0)
    # the pole caps are land, fold-symmetric, and no interior metric is 0
    assert bool((gt.bottom_height == 0.0).any())
    assert float(gt.dxc.min()) > 0.0 and float(gt.azf.min()) > 0.0


@pytest.mark.parametrize("kind", ["c", "u", "v", "w"])
def test_fold_halos_bitwise(kind):
    """Each kind through the fold, the south boundary and the x wrap, then
    z, corners included; 3-D fields, planes at width 1 and 5, planes at the
    grid's halo, in float64 and float32."""
    rng = np.random.default_rng("cuvw".index(kind))
    for dtype in (torch.float64, torch.float32):
        gj, gt = _grids(dtype)
        a = rng.standard_normal((NX, NY, NZ)).astype(np.dtype(str(dtype)[6:]))
        np.testing.assert_array_equal(back(extend_field(gt, t(a), kind)),
                                      np.asarray(jax_extend_field(gj, jnp.asarray(a), kind)))
        a2 = a[:, :, 0]
        for h in (1, 5):
            np.testing.assert_array_equal(back(extend2(gt, t(a2), kind, h)),
                                          np.asarray(jax_extend2(gj, jnp.asarray(a2), kind, None, h)))
        np.testing.assert_array_equal(back(extend_field_xy(gt, t(a2), kind)),
                                      np.asarray(jax_extend_field_xy(gj, jnp.asarray(a2), kind)))


def test_north_fold_projection_bitwise():
    gj, gt = _grids(torch.float64)
    rng = np.random.default_rng(3)
    u, v = (rng.standard_normal((NX, NY, NZ)) for _ in range(2))
    eta = rng.standard_normal((NX, NY))
    tr = {k: rng.standard_normal((NX, NY, NZ)) for k in ("T", "S", "e")}
    uj, _, etaj, trj = jax_north_fold_projection(
        gj, jnp.asarray(u), jnp.asarray(v), jnp.asarray(eta),
        {k: jnp.asarray(c) for k, c in tr.items()})
    ut, etat, trt = t(u), t(eta), {k: t(c) for k, c in tr.items()}
    north_fold_projection(gt, ut, etat, trt)
    np.testing.assert_array_equal(back(ut), np.asarray(uj))
    np.testing.assert_array_equal(back(etat), np.asarray(etaj))
    for k in tr:
        np.testing.assert_array_equal(back(trt[k]), np.asarray(trj[k]), err_msg=k)
    # the seam row is now its own mirror image
    p = gt.pole_index
    fold = [(2 * p - i) % NX for i in range(NX)]
    np.testing.assert_allclose(etat[-1].numpy(), etat[-1].numpy()[fold], rtol=1e-15)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_gaussian_islands_geometry_on_tripolar_bitwise(dtype):
    """The islands bathymetry from the 2-D centres, the pole caps kept as
    land, the masks, face bottoms and face depths through the fold halos."""
    gj, gt = _grids(dtype)
    gj, gt = jax_islands(gj), gaussian_islands_bottom(gt)
    np.testing.assert_array_equal(back(gt.bottom_height), np.asarray(gj.bottom_height))
    for got, want in zip(immersed_masks(gt), jax_immersed_masks(gj)):
        np.testing.assert_array_equal(back(got), np.asarray(want))
    for got, want in zip(face_bottom_planes(gt), jax_face_bottom_planes(gj)):
        np.testing.assert_array_equal(back(got), np.asarray(want))
    zc = gj.z_c[0, 0, gj.hz : gj.hz + gj.Nz]
    dzc = gj.dz_c[0, 0, gj.hz : gj.hz + gj.Nz]
    for got, bf in zip(face_depths(gt), jax_face_bottom_planes(gj)):
        want = jnp.sum(jnp.where(zc[None, None, :] > bf[:, :, None], dzc[None, None, :], 0.0),
                       axis=2)
        np.testing.assert_array_equal(back(got), np.asarray(want))


def test_with_bathymetry_keeps_the_pole_caps():
    gj, gt = _grids(torch.float64)
    caps = gt.bottom_height == 0.0
    flat = np.full((NX, NY), -5000.0)
    gj2, gt2 = jax_with_bathymetry(gj, flat), with_bathymetry(gt, t(flat))
    assert bool((gt2.bottom_height[caps] == 0.0).all())
    assert float(gt2.bottom_height[~caps].max()) == float(gt2.z_f_i[0])
    np.testing.assert_array_equal(back(gt2.bottom_height), np.asarray(gj2.bottom_height))


def test_atmosphere_on_tripolar_bitwise():
    gj, gt = _grids(torch.float32)
    aj, at = jax_atmosphere(gj), data_free_atmosphere(gt)
    for k, f in aj.fields.items():
        np.testing.assert_array_equal(back(at.fields[k]), np.asarray(f), err_msg=k)


def _planes(shape, seed):
    """eta0, U0, V0, GU, GV from a numpy seed in JAX's (Nx, Ny) layout."""
    rng = np.random.default_rng(seed)
    eta0, U0, V0 = (rng.standard_normal(shape).astype(np.float32) * s for s in (1e-3, 1.0, 1.0))
    GU, GV = (rng.standard_normal(shape).astype(np.float32) * 1e-4 for _ in range(2))
    V0[:, 0] = 0.0
    GV[:, 0] = 0.0
    return eta0, U0, V0, GU, GV


@pytest.mark.parametrize("bathymetry", [False, True], ids=["flat", "island"])
def test_plain_k2_fold_matches_jax_kernel_f32(bathymetry):
    """K2's fold instance (the ghost flux above the seam row, 2-D planes)
    against the JAX whole-loop kernel, whose fold is a permutation matmul.
    With bathymetry: an island and a shelf kept off the seam rows (land
    there must be fold-symmetric), its face depths and mask planes; without
    it: a 4000 m deep ocean and no masks. dt = 10 s as the JAX test: the
    metric-floored pole columns are gravity-wave unstable at larger dtau."""
    Nx, Ny = 128, 32
    gj, gt = _grids(torch.float32, (Nx, Ny, 8))
    eta0, U0, V0, GU, GV = _planes((Nx, Ny), 21)
    if bathymetry:
        bh = np.full((Nx, Ny), -4000.0)
        bh[40:60, 10:20] = 100.0
        bh[90:100, 20:26] = -50.0
        gj = jax_with_bathymetry(gj, jnp.asarray(bh, jnp.float32))
        gt = with_bathymetry(gt, t(bh.astype(np.float32)))
        Hu, Hv = (back(h) for h in face_depths(gt))
        mu, mv = (Hu > 0).astype(np.float32), (Hv > 0).astype(np.float32)
        GU, GV = GU * mu, GV * mv
        masks = (mu, mv)
    else:
        Hu = Hv = np.full((Nx, Ny), 4000.0, np.float32)
        masks = (None, None)
    ref = pallas_barotropic_loop(
        jax_config(), gj, *(jnp.asarray(a) for a in (eta0, U0, V0, GU, GV, Hu, Hv)),
        jnp.float32(10.0), *(None if m is None else jnp.asarray(m) for m in masks),
        interpret=True)
    out = barotropic_loop(baroclinic_instability_config(), gt,
                          *(t(a) for a in (eta0, U0, V0, GU, GV, Hu, Hv)), 10.0,
                          *(None if m is None else t(m) for m in masks))
    for got, want in zip(out, ref):
        want = np.asarray(want)
        assert np.isfinite(want).all()
        np.testing.assert_allclose(back(got), want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_plain_k1_on_tripolar_matches_jax_kernel_f32():
    """K1's plain version on 2-D metric planes and f (tracers T, S, e, the
    immersed integrals of the pole caps) against the JAX z-slab kernel in
    interpret mode. The momentum tendencies are compared on fluid faces:
    on the faces of the degenerate pole cells (land, their spacing floored
    at 1e-3 of the largest) one ulp of the hydrostatic pressure, which the
    two programs sum in other orders, over the floored spacing is ~1e-7,
    and every step masks those faces to 0 after K1."""
    shape = (128, 32, 8)
    gj, gt = _grids(torch.float32, shape)
    sj = jax_state(gj, noise_velocity=1e-3)
    rng = np.random.default_rng(12)
    tr = {**{k: np.asarray(c) for k, c in sj.tracers.items()},
          "e": (1e-5 * (1.0 + rng.random(shape))).astype(np.float32)}
    prev = {k: (rng.standard_normal(shape) * 1e-7).astype(np.float32)
            for k in ("Gu", "Gv", "T", "S", "e")}
    prev["Gv"][:, 0, :] = 0.0
    ab = (np.float32(DT) * np.float32(1.6), np.float32(DT) * np.float32(-0.6))

    cfg_j = jax_config(closure=JaxCATKE())
    ue = jax_extend_field(gj, sj.u, "u")
    ve = jax_extend_field(gj, sj.v, "v")
    tr_j = {k: jax_extend_field(gj, jnp.asarray(c), "c") for k, c in tr.items()}
    ref = jax_zslab_tendencies(
        cfg_j, gj, jax_coriolis_ff(gj, cfg_j.coriolis), ue, ve, tr_j, interpret=True,
        ab2=(jnp.asarray([[ab[0], ab[1]]], jnp.float32), jnp.asarray(prev["Gu"]),
             jnp.asarray(prev["Gv"]), {k: jnp.asarray(prev[k]) for k in tr}),
        wall_v=True, integrals=True)

    cfg = baroclinic_instability_config(closure=CATKEVerticalDiffusivity())
    got = zslab_tendencies_plain(
        cfg, gt, extend_field(gt, t(sj.u), "u"), extend_field(gt, t(sj.v), "v"),
        {k: extend_field(gt, t(c), "c") for k, c in tr.items()},
        (t(prev["Gu"]), t(prev["Gv"]), {k: t(prev[k]) for k in tr}),
        (float(ab[0]), float(ab[1])), face_bottoms=face_bottom_planes(gt))
    Gu, Gv, Gtr, u_new, v_new, tr_new, ints = got
    um, vm = (back(m) > 0 for m in interior_masks(gt))
    assert not um.all() and um.mean() > 0.98

    def check(port, want, atol, fluid=True):
        port, want = back(port), np.asarray(want)
        np.testing.assert_allclose(np.where(fluid, port, 0.0), np.where(fluid, want, 0.0),
                                   rtol=2e-4, atol=atol)

    def updated_atol(G):
        return float(ab[0]) * 2e-4 * float(np.abs(np.asarray(G)).max())

    check(Gu, ref[0], 1e-9, um)
    check(Gv, ref[1], 1e-9, vm)
    check(u_new, ref[3], updated_atol(ref[0]), um)
    check(v_new, ref[4], updated_atol(ref[1]), vm)
    for k in tr:
        check(Gtr[k], ref[2][k], 1e-7)
        check(tr_new[k], ref[5][k], updated_atol(ref[2][k]))
    H = float(np.asarray(gj.dz_c)[0, 0, 4:-4].sum())
    for port, want, G in zip(ints, ref[6], (0.0, 0.0, ref[0], ref[1])):
        check(port, want, 2e-4 * float(np.abs(np.asarray(want)).max()) + updated_atol(G) * H)


def test_three_tripolar_coupled_steps_match_jax_array_path_f64(monkeypatch):
    monkeypatch.setenv("GB25_BAROTROPIC_BLOCK", "1")
    monkeypatch.delenv("GB25_ZSLAB_INTERPRET", raising=False)
    (cj, gj, aj, sj), (ct, gt, at, st) = _models(8.0, 8, torch.float64,
                                                 grid_type="gaussian_islands_tripolar")
    assert gt.north_fold and (gt.Nx, gt.Ny) == (48, 24)
    cj = dataclasses.replace(cj, ocean=dataclasses.replace(cj.ocean, kernels="jnp"))
    step = jax.jit(jax_coupled_time_step)
    for _ in range(3):
        sj = step(cj, gj, aj, sj, DT)
    st = coupled_loop(ct, gt, at, st, DT, 3)
    ref, port = _jax_arrays(sj), state_to_numpy(st)
    assert list(port) == list(ref)
    compare_states(ref, port, rtol=1e-10, verbose=False)
    assert np.abs(port["u"]).max() > 0.0
    land = np.asarray(gj.bottom_height) == 0.0
    assert land.any() and np.all(port["eta"][land] == 0.0)


def test_tripolar_coupled_step_matches_jax_kernels_f32(monkeypatch):
    monkeypatch.setenv("GB25_ZSLAB_INTERPRET", "1")
    (cj, gj, aj, sj), (ct, gt, at, st) = _models(3.0, 4, torch.float32,
                                                 grid_type="gaussian_islands_tripolar")
    assert (gj.Nx, gj.Ny) == (128, 64) and gt.north_fold
    cj = dataclasses.replace(cj, ocean=dataclasses.replace(cj.ocean, kernels="zslab"))
    ref = _jax_arrays(jax.jit(jax_coupled_time_step)(cj, gj, aj, sj, DT))
    port = state_to_numpy(coupled_time_step(ct, gt, at, st, DT))
    assert list(port) == list(ref)
    for name in ref:
        np.testing.assert_allclose(port[name], ref[name], rtol=1e-3, atol=5e-6, err_msg=name)
