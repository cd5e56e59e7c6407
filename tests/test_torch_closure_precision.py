"""The precision modes with the closures and on every grid: K1's unfused
forms for three and four tracers on the lat-lon, islands and tripolar
grids, and one step of each ``compute_dtype`` with CATKE and k-epsilon,
against the JAX package's.

K1's plain unfused forms against JAX ``zslab_tendencies`` (no ``ab2``, no
integrals) in interpret mode, float32 and ``storage_dtype=bfloat16``: three
tracers (T, S, e: CATKE) and four (T, S, e, eps: k-epsilon) on the lat-lon
grid (32x16x8), the lat-lon grid with the Gaussian islands and the
tripolar grid with the islands on its poles (both 48x24x8, the climate
model's at resolution 8). The unfused form has no immersed variant: its
tendencies do not read the face bottoms, and the islands case holds it to
JAX's kernel on an immersed grid. K1's tolerance: rtol 2e-4, atol 1e-9
for the momentum and 1e-7 for the tracers (tests/test_torch_precision.py);
on the immersed grids the momentum on fluid faces (on the tripolar pole
cells, land with spacings floored at 1e-3 of the largest, one ulp of the
pressure summed in another order is ~1e-7, test_torch_tripolar.py).

One step of the port against JAX's own mode (GB25_BAROTROPIC_BLOCK=1, so
JAX's array free surface re-imposes its boundary conditions every
substep, as K2 does) on two models: the coupled climate on the tripolar
islands grid with CATKE (48x24x8) and the k-epsilon flagship (32x16x8),
each from its float64 state (the climate's at rest, the flagship's with
velocity noise 1e-3). In JAX the closure runs its array code on the
state-precision fields under any ``compute_dtype``
(gb25_tpu/models/hydrostatic.py:308-312, 378-379); the port runs K4's
plain version, the JAX kernel's form, on the same fields. In float32 the
two forms part by up to 2e-4 of k-epsilon's G_e (its sources cancel) and
7e-5 of CATKE's e after one step, in every mode, no compute_dtype too; in
float64 they agree to rounding. So the state is float64, as the one that
bench.py --dtype float64 steps: the closure runs in float64 in both
packages and what each mode changes, the tendency stage, is compared (the
float32 and bf16s stages on the float32 copies that ``k1_operand_dtype``
makes). Tolerances, of each field's largest value, as
tests/test_torch_precision.py sets them for the flagship:
  - "bf16s" and "float32": 1e-4, against JAX's K1 route (kernels="zslab",
    GB25_ZSLAB_INTERPRET=1: its unfused z-slab kernel on the float32 or
    bfloat16-rounded copies), the port's route. Under "float32" the two
    programs round TEOS-10 in float32 apart by an ulp, and p = csum -
    total cancels two column sums of ~300 m^2/s^2: at the tripolar
    climate's bottom level beside the seam Gu parts by 1.5e-9 (2.3e-3 of
    its largest value, in JAX's own array route against its K1 route
    too). Gu and Gv are held at the larger of 1e-4 of their largest value
    and 8 float32 ulps of the largest column total of b dz over the face's
    spacing (chip_smoke.py's ``pressure_ulp_atol``), u and v at dt times
    that;
  - "float64" and "f32x2" (the port computes "f32x2" in native float64):
    2e-6;
  - "bfloat16": each field within twice JAX's own distance between its
    "bfloat16" step and its step with no compute_dtype (at least 1e-10 of
    its largest value, float64 rounding: S, which neither step moves
    beyond it).
The climate's steps, and the check that its K4 reads the float64
buoyancy under "float32", are in tests/test_torch_climate_precision.py
(the two models in two files, so that xdist's workers share the JAX
steps' cost).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gb25_tpu.grids import simple_latitude_longitude_grid as jax_latlon
from gb25_tpu.models import baroclinic_instability_config as jax_config
from gb25_tpu.models import time_step as jax_time_step
from gb25_tpu.models.catke import CATKEVerticalDiffusivity as JaxCATKE
from gb25_tpu.models.coupled import coupled_time_step as jax_coupled_time_step
from gb25_tpu.models.keps import TKEDissipationVerticalDiffusivity as JaxKEps
from gb25_tpu.ops.operators import coriolis_ff as jax_coriolis_ff
from gb25_tpu.ops.pallas_zslab import zslab_tendencies as jax_zslab_tendencies
from gb25_tpu_torch.convert import state_from_numpy, state_to_numpy
from gb25_tpu_torch.grids import simple_latitude_longitude_grid
from gb25_tpu_torch.grids.immersed import face_masks, interior_masks
from gb25_tpu_torch.models import (
    baroclinic_instability_config,
    baroclinic_instability_state,
    coupled_time_step,
    time_step,
)
from gb25_tpu_torch.models.catke import CATKEVerticalDiffusivity
from gb25_tpu_torch.models.keps import TKEDissipationVerticalDiffusivity
from gb25_tpu_torch.ops.halos import extend_field
from gb25_tpu_torch.ops.pallas_zslab import zslab_tendencies_plain
from test_torch_climate import _jax_arrays, _models
from test_torch_keps import _keps_states

DT = 60.0
GRIDS = ("latlon", "islands", "tripolar")
SCALES = {"bf16s": 1e-4, "float32": 1e-4, "float64": 2e-6, "f32x2": 2e-6}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: beside other busy
    test processes, torch's default of one OpenMP thread per core made the
    plain versions' many small launches ~100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def back(x):
    return np.transpose(x.detach().numpy())


@functools.lru_cache(maxsize=None)
def _k1_case(grid_type, ntr):
    """JAX's config, grid and f, the port's config and grid, and K1's
    extended operands: made in the port (the analytic T and S of the
    model's state, u and v noise of 1e-3 from numpy, e around 1e-5 and eps
    around 1e-8, u and v masked on solid faces), handed to JAX as the same
    values."""
    closure_j, closure_t = ((JaxCATKE(), CATKEVerticalDiffusivity()) if ntr == 3
                            else (JaxKEps(), TKEDissipationVerticalDiffusivity()))
    if grid_type == "latlon":
        shape = (32, 16, 8)
        gj = jax_latlon(*shape, dtype=jnp.float32)
        gt = simple_latitude_longitude_grid(*shape, device="cpu", dtype=torch.float32)
        st = baroclinic_instability_state(gt, tracers=("T", "S"))
    else:
        name = "gaussian_islands_tripolar" if grid_type == "tripolar" else "gaussian_islands"
        (_, gj, _, _), (_, gt, _, st) = _models(8.0, 8, torch.float32, grid_type=name)
        shape = (gt.Nx, gt.Ny, gt.Nz)
    assert gt.immersed == (grid_type != "latlon") and gt.north_fold == (grid_type == "tripolar")
    cfg_j = jax_config(closure=closure_j)
    cfg_t = baroclinic_instability_config(closure=closure_t)
    assert len(cfg_t.tracers) == ntr
    rng = np.random.default_rng(ntr)
    zyx = shape[::-1]
    tr = {"T": st.tracers["T"], "S": st.tracers["S"]}
    for name, scale in (("e", 1e-5), ("eps", 1e-8)):
        if name in cfg_t.tracers:
            tr[name] = torch.from_numpy((scale * (1.0 + rng.random(zyx))).astype(np.float32))
    ue, ve = (extend_field(gt, torch.from_numpy(1e-3 * rng.standard_normal(zyx)).float(), kind)
              for kind in ("u", "v"))
    if gt.immersed:
        um, vm = face_masks(gt)
        ue, ve = ue * um, ve * vm
    tr_e = {k: extend_field(gt, c, "c") for k, c in tr.items()}

    def j(x):
        return jnp.asarray(back(x))

    f_j = jax_coriolis_ff(gj, cfg_j.coriolis).astype(jnp.float32)
    return (cfg_j, gj, f_j, j(ue), j(ve), {k: j(c) for k, c in tr_e.items()}), \
        (cfg_t, gt, ue, ve, tr_e)


@pytest.mark.parametrize("storage", [None, torch.bfloat16], ids=["f32", "bf16_storage"])
@pytest.mark.parametrize("ntr", [3, 4])
@pytest.mark.parametrize("grid_type", GRIDS)
def test_plain_k1_unfused_matches_jax_kernel(grid_type, ntr, storage):
    (cfg_j, gj, f_j, ue_j, ve_j, tr_j), (cfg, gt, ue, ve, tr_e) = _k1_case(grid_type, ntr)
    ref = jax_zslab_tendencies(cfg_j, gj, f_j, ue_j, ve_j, tr_j, interpret=True, wall_v=True,
                               storage_dtype=None if storage is None else jnp.bfloat16)
    Gu, Gv, Gtr = zslab_tendencies_plain(cfg, gt, ue, ve, tr_e, storage=storage)
    assert list(Gtr) == list(cfg.tracers) and float(Gv[:, 0, :].abs().max()) == 0.0
    fluid = {"Gu": True, "Gv": True}
    if gt.immersed:
        um, vm = interior_masks(gt)
        fluid = {"Gu": back(um) > 0, "Gv": back(vm) > 0}
        assert not fluid["Gu"].all()
    pairs = [("Gu", Gu, ref[0], 1e-9), ("Gv", Gv, ref[1], 1e-9)]
    pairs += [("G" + k, Gtr[k], ref[2][k], 1e-7) for k in tr_e]
    for name, got, want, atol in pairs:
        keep = fluid.get(name, True)
        want = np.asarray(want)
        assert np.isfinite(want).all() and np.abs(want).max() > 0.0, name
        np.testing.assert_allclose(np.where(keep, back(got), 0.0), np.where(keep, want, 0.0),
                                   rtol=2e-4, atol=atol, err_msg=name)


@functools.lru_cache(maxsize=None)
def jax_model(model):
    """``model`` as both packages build it in float64 (JAX's state carried
    across): (JAX's config, grid, atmosphere, state, the port's config,
    grid, atmosphere) of the tripolar CATKE climate ("climate") or the
    k-epsilon flagship ("keps", no atmosphere)."""
    if model == "climate":
        (cj, gj, aj, sj), (ct, gt, at, _) = _models(8.0, 8, torch.float64,
                                                    grid_type="gaussian_islands_tripolar")
        return cj, gj, aj, sj, ct, gt, at
    kj, kgj, ksj, kgt, _ = _keps_states((32, 16, 8), jnp.float64)
    return (kj, kgj, None, ksj,
            baroclinic_instability_config(closure=TKEDissipationVerticalDiffusivity()), kgt,
            None)


def with_mode(model, cfg, mode, kernels):
    """``cfg`` (the climate's coupled config or the flagship's) with the
    ocean's ``compute_dtype`` and ``kernels`` set."""
    if model == "climate":
        return dataclasses.replace(cfg, ocean=dataclasses.replace(
            cfg.ocean, compute_dtype=mode, kernels=kernels))
    return dataclasses.replace(cfg, compute_dtype=mode, kernels=kernels)


@functools.lru_cache(maxsize=None)
def _jax_step(model, mode):
    """JAX's step of ``model`` in ``mode`` from its float64 state,
    GB25_BAROTROPIC_BLOCK=1; "bf16s" and "float32" on its K1
    route (kernels="zslab", GB25_ZSLAB_INTERPRET=1), the others on
    kernels="jnp". Jitted once per mode; "f32x2" eagerly (its
    multifloat step's jit costs more than the step, as in
    test_torch_sharded_routes.py)."""
    cj, gj, aj, sj = jax_model(model)[:4]
    mp = pytest.MonkeyPatch()
    mp.setenv("GB25_BAROTROPIC_BLOCK", "1")
    k1 = mode in ("bf16s", "float32")
    if k1:
        mp.setenv("GB25_ZSLAB_INTERPRET", "1")
    try:
        cfg = with_mode(model, cj, mode, "zslab" if k1 else "jnp")
        step = jax_coupled_time_step if model == "climate" else jax_time_step
        step = step if mode == "f32x2" else jax.jit(step)
        args = (cfg, gj, aj, sj, DT) if model == "climate" else (cfg, gj, sj, DT)
        return _jax_arrays(step(*args))
    finally:
        mp.undo()


def _port_step(model, mode):
    cj, gj, aj, sj, cfg, gt, at = jax_model(model)
    cfg = with_mode(model, cfg, mode, "auto")
    state = state_from_numpy(_jax_arrays(sj), "cpu")
    if model == "climate":
        out = coupled_time_step(cfg, gt, at, state, DT)
    else:
        out = time_step(cfg, gt, state, DT)
    out = state_to_numpy(out)
    assert out["u"].dtype == np.float64  # the state stays in its precision
    return out


def _assert_close(name, got, want, atol):
    """|got - want| <= atol everywhere (atol a number or a per-element
    array)."""
    err = np.abs(got - want)
    bad = err > atol
    assert not bad.any(), (f"{name}: {int(bad.sum())} of {bad.size} elements apart by up to "
                           f"{float(err[bad].max()):.3e} (largest value "
                           f"{float(np.abs(want).max()):.3e})")


def _atol(model, mode, name, want):
    """The bound of field ``name`` (JAX's ``want``): SCALES[mode] of its
    largest value; for Gu, Gv and u, v under the float32 stages at least
    the float32 pressure's (see the module's docstring)."""
    atol = SCALES[mode] * np.abs(want).max()
    if mode not in ("bf16s", "float32") or name not in ("u", "v", "Gu", "Gv"):
        return atol
    _, _, _, sj, cfg, gt, _ = jax_model(model)
    ocean = cfg.ocean if model == "climate" else cfg
    hx, hy, hz = gt.halo
    zc, dz = (m[hz : hz + gt.Nz] for m in (gt.z_c, gt.dz_c))
    T, S = (torch.from_numpy(np.transpose(np.asarray(sj.tracers[k]))) for k in ("T", "S"))
    p = float((ocean.eos.buoyancy(T, S, zc) * dz).sum(dim=0).abs().max())
    spacing = (gt.dxc if name in ("u", "Gu") else gt.dyf)[0, hy : hy + gt.Ny]
    if spacing.shape[1] > 1:
        spacing = spacing[:, hx : hx + gt.Nx]
    ulps = 8.0 * float(np.finfo(np.float32).eps) * p / spacing.expand(gt.Ny, gt.Nx)
    ulps = back(ulps)[:, :, None] * (DT if name in ("u", "v") else 1.0)
    return np.maximum(atol, ulps)


def check_mode_step(model, mode):
    """One step of ``model`` in ``mode`` against JAX's at SCALES[mode]
    (``_atol``)."""
    ref, port = _jax_step(model, mode), _port_step(model, mode)
    assert list(port) == list(ref)
    for name in ref:
        want = ref[name].astype(np.float64)
        _assert_close(name, port[name], want, _atol(model, mode, name, want))
    assert port["tracers/e"].min() >= 0.0


def check_bfloat16_step(model):
    """One "bfloat16" step of ``model`` within twice JAX's own distance."""
    ref, ref32, port = _jax_step(model, "bfloat16"), _jax_step(model, None), _port_step(
        model, "bfloat16")
    assert list(port) == list(ref)
    for name in ref:
        assert np.isfinite(port[name]).all(), name
        want = ref[name].astype(np.float64)
        own = np.abs(want - ref32[name].astype(np.float64)).max()
        _assert_close(name, port[name], want, max(2 * own, 1e-10 * np.abs(want).max()))


@pytest.mark.parametrize("mode", list(SCALES))
def test_keps_step_matches_jax_mode(mode):
    check_mode_step("keps", mode)


def test_keps_bfloat16_step_within_jax_own_distance():
    check_bfloat16_step("keps")
