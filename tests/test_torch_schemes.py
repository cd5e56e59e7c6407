"""The JAX package's other model choices in the port: the advection schemes
(``momentum_advection`` "weno_vector_invariant", "vector_invariant",
"none"; ``tracer_advection`` "weno5", "centered2", "upwind1", "none"), the
kinetic energy ``ke_scheme`` "standard", ``LinearEquationOfState`` and the
buoyancy tracer ``tracers=("b",)``.

- Operators: ``centered2``, ``upwind1`` (both alignments, the three axes,
  winds of both signs and zero), ``kinetic_energy(..., "standard")`` and
  ``LinearEquationOfState.buoyancy`` against the JAX functions on the same
  float64 numpy inputs, to 1e-15 relative.
- ``tendency_math`` for the 20 scheme combinations (5 momentum variants x
  4 tracer schemes) under TEOS-10, the linear equation of state and the b
  tracer, against JAX's in float64 at 1e-12 of each field's largest value.
- K1's and K6's plain versions against the JAX kernels in interpret mode
  in float32, at tests/test_torch_zslab.py's and
  tests/test_torch_pallas_tendency.py's tolerances: ``zslab_tendencies``
  fused and unfused for two combinations other than the flagship's and for
  the one-tracer b instance; ``pallas_tendencies`` for the linear equation
  of state and for the b tracer.
- 3 steps (an Euler step and two AB2 steps) in float64 on the K1 route
  ("auto"; JAX with GB25_BAROTROPIC_BLOCK=1) and the K6 route ("pallas";
  JAX with it unset), against JAX ``time_step`` with kernels="jnp" at 1e-10
  of each field's largest value, as tests/test_torch_config_choices.py:
  each momentum variant with WENO-5 tracers, each tracer scheme with WENO
  vector-invariant momentum, the b tracer under the split-explicit free
  surface (tests/test_model.py's configuration), CATKE with the linear
  equation of state and no advection (tests/test_catke.py's) and ("b", "e")
  with CATKE; and one combination on two gloo ranks against JAX serially.
- "bf16s" with the b tracer against JAX's own bf16s step at
  tests/test_torch_precision.py's bound.
- The independent float64 oracle of tests/test_numpy_oracle.py (imported,
  not edited) against the port's full step on both routes, at that test's
  tolerances; the port's counterparts of tests/test_physics_regression.py's
  b-tracer and linear-EOS tests.
- Config errors: an unknown scheme and a tracer set outside the rule raise.

JAX is jitted once per configuration and route (module-scoped caches).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gb25_tpu.ops.pallas_tendency as jax_pallas_tendency
from gb25_tpu.grids import latitude_longitude_grid as jax_latlon_grid
from gb25_tpu.grids import simple_latitude_longitude_grid as jax_grid
from gb25_tpu.models import ExplicitFreeSurface as JaxExplicit
from gb25_tpu.models import baroclinic_instability_config as jax_config
from gb25_tpu.models import baroclinic_instability_state as jax_state
from gb25_tpu.models import time_step as jax_time_step
from gb25_tpu.models.catke import CATKEVerticalDiffusivity as JaxCATKE
from gb25_tpu.models.config import SplitExplicitFreeSurface as JaxSplit
from gb25_tpu.models.hydrostatic import tendency_math as jax_tendency_math
from gb25_tpu.models.state import initial_state as jax_initial_state
from gb25_tpu.ops.eos import LinearEquationOfState as JaxLinear
from gb25_tpu.ops.halos import extend_field as jax_extend_field
from gb25_tpu.ops.operators import coriolis_ff as jax_coriolis_ff
from gb25_tpu.ops.operators import kinetic_energy as jax_kinetic_energy
from gb25_tpu.ops.pallas_zslab import zslab_tendencies as jax_zslab_tendencies
from gb25_tpu.ops.weno import centered2 as jax_centered2
from gb25_tpu.ops.weno import upwind1 as jax_upwind1
from gb25_tpu.utils.correctness import _leaf_names
from gb25_tpu_torch.convert import state_from_numpy, state_to_numpy
from gb25_tpu_torch.grids import latitude_longitude_grid, simple_latitude_longitude_grid
from gb25_tpu_torch.models import (
    ExplicitFreeSurface,
    HydrostaticConfig,
    SplitExplicitFreeSurface,
    VerticalScalarDiffusivity,
    baroclinic_instability_config,
    baroclinic_instability_model,
    buoyancy_tracer_state,
    initial_state,
    loop,
    time_step,
)
from gb25_tpu_torch.models.catke import CATKEVerticalDiffusivity
from gb25_tpu_torch.models.hydrostatic import tendency_math
from gb25_tpu_torch.ops import weno
from gb25_tpu_torch.ops.eos import LinearEquationOfState
from gb25_tpu_torch.ops.halos import extend_field
from gb25_tpu_torch.ops.operators import coriolis_ff, kinetic_energy
from gb25_tpu_torch.ops.pallas_tendency import pallas_tendencies_plain
from gb25_tpu_torch.ops.pallas_zslab import zslab_tendencies_plain
from gb25_tpu_torch.parallel import run_decomposed, spawn
from gb25_tpu_torch.utils.correctness import compare_states
from test_numpy_oracle import Oracle
from test_numpy_oracle import _grid as oracle_grid

DT = 60.0
SHAPE = (32, 16, 6)  # JAX's (Nx, Ny, Nz)
# the momentum variants: (momentum_advection, ke_scheme)
MOMENTUM = {"weno_vi": ("weno_vector_invariant", "hollingsworth"),
            "weno_vi_standard": ("weno_vector_invariant", "standard"),
            "vi": ("vector_invariant", "hollingsworth"),
            "vi_standard": ("vector_invariant", "standard"),
            "none": ("none", "hollingsworth")}
TRACER = ("weno5", "centered2", "upwind1", "none")


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


def _arrays(state):
    return {name: np.asarray(x) for name, x in _leaf_names(state)}


def _configs(mom="weno_vi", tr="weno5", eos="teos10", tracers=("T", "S"), closure=None,
             free_surface=None, route="auto"):
    """The JAX config (kernels="jnp") and the port's (kernels=route) of one
    choice of schemes, equation of state, tracers, closure and free
    surface (None: each package's split-explicit default; "explicit";
    or a substep count)."""
    momentum, ke = MOMENTUM[mom]
    if free_surface == "explicit":
        fs_j, fs_t = JaxExplicit(), ExplicitFreeSurface()
    elif free_surface is not None:
        fs_j, fs_t = JaxSplit(substeps=free_surface), SplitExplicitFreeSurface(substeps=free_surface)
    else:
        fs_j = fs_t = None
    cl_j, cl_t = (JaxCATKE(), CATKEVerticalDiffusivity()) if closure == "catke" else (None, None)
    lin = eos == "linear"
    cfg_j = jax_config(free_surface=fs_j, closure=cl_j, momentum_advection=momentum,
                       tracer_advection=tr, eos=JaxLinear() if lin else None)
    cfg_j = dataclasses.replace(cfg_j, kernels="jnp", ke_scheme=ke,
                                tracers=tuple(tracers) + cfg_j.tracers[2:])
    cfg_t = baroclinic_instability_config(kernels=route, closure=cl_t, free_surface=fs_t,
                                          momentum_advection=momentum, tracer_advection=tr,
                                          eos=LinearEquationOfState() if lin else None)
    cfg_t = dataclasses.replace(cfg_t, ke_scheme=ke, tracers=tuple(tracers) + cfg_t.tracers[2:])
    return cfg_j, cfg_t


def _with_b(state):
    """A JAX state with its T and S replaced by b, the linear equation of
    state's buoyancy of them (stably stratified), first among the tracers."""
    tr = dict(state.tracers)
    b = JaxLinear().buoyancy(tr.pop("T"), tr.pop("S"), None)
    G = {k: g for k, g in state.Gtracers.items() if k not in ("T", "S")}
    return state.replace(tracers={"b": b, **tr}, Gtracers={"b": jnp.zeros_like(b), **G})


# --------------------------------------------------------------------------
# operators
# --------------------------------------------------------------------------

def _op_inputs(seed=3):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((10, 9, 8))
    vel = rng.standard_normal((10, 9, 8))
    vel[rng.random(vel.shape) < 0.2] = 0.0  # zero winds take the from-above sample
    return a, vel


def _close_rel(got, want):
    np.testing.assert_allclose(back(got), np.asarray(want), rtol=1e-15,
                               atol=1e-15 * np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("axis", ["x", "y", "z"])
@pytest.mark.parametrize("align", ["face", "center"])
def test_reconstructions_match_jax(axis, align):
    a, vel = _op_inputs()
    assert (vel > 0).any() and (vel < 0).any() and (vel == 0).any()
    _close_rel(weno.centered2(t(a), axis, align), jax_centered2(jnp.asarray(a), axis, align))
    _close_rel(weno.upwind1(t(a), t(vel), axis, align),
               jax_upwind1(jnp.asarray(a), jnp.asarray(vel), axis, align))


@pytest.mark.parametrize("scheme", ["standard", "hollingsworth"])
def test_kinetic_energy_matches_jax(scheme):
    u, v = _op_inputs(5)
    _close_rel(kinetic_energy(t(u), t(v), scheme),
               jax_kinetic_energy(jnp.asarray(u), jnp.asarray(v), scheme))


def test_linear_equation_of_state_matches_jax():
    rng = np.random.default_rng(9)
    T = 10.0 + 5.0 * rng.standard_normal((10, 9, 8))
    S = 35.0 + rng.standard_normal((10, 9, 8))
    z = -4000.0 * rng.random((1, 1, 8))
    _close_rel(LinearEquationOfState().buoyancy(t(T), t(S), t(z)),
               JaxLinear().buoyancy(jnp.asarray(T), jnp.asarray(S), jnp.asarray(z)))
    # bfloat16 rounds its constants as the JAX package's weak-typed ones
    got = LinearEquationOfState().buoyancy(t(T).to(torch.bfloat16), t(S).to(torch.bfloat16), None)
    want = JaxLinear().buoyancy(jnp.asarray(T, jnp.bfloat16), jnp.asarray(S, jnp.bfloat16), None)
    np.testing.assert_array_equal(back(got.float()), np.asarray(want.astype(jnp.float32)))


# --------------------------------------------------------------------------
# tendency_math, every combination
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _extended(np_dtype, shape=SHAPE, btracer=False):
    """The JAX flagship state (T and S replaced by b with ``btracer``)
    extended in both packages, with each package's grid."""
    jdt = jnp.float64 if np_dtype == np.float64 else jnp.float32
    tdt = torch.float64 if np_dtype == np.float64 else torch.float32
    gj = jax_grid(*shape, dtype=jdt)
    sj = jax_state(gj, noise_velocity=1e-3)
    if btracer:
        sj = _with_b(sj)
    gt = simple_latitude_longitude_grid(*shape, device="cpu", dtype=tdt)
    jax_in = (jax_extend_field(gj, sj.u, "u"), jax_extend_field(gj, sj.v, "v"),
              {k: jax_extend_field(gj, c, "c") for k, c in sj.tracers.items()})
    port_in = (extend_field(gt, t(sj.u), "u"), extend_field(gt, t(sj.v), "v"),
               {k: extend_field(gt, t(c), "c") for k, c in sj.tracers.items()})
    return gj, gt, jax_in, port_in


TENDENCY_CASES = {f"{m}-{tr}": (m, tr, "teos10", False) for m in MOMENTUM for tr in TRACER}
TENDENCY_CASES["oracle_linear"] = ("vi_standard", "centered2", "linear", False)
TENDENCY_CASES["b_tracer"] = ("weno_vi", "weno5", "teos10", True)


@pytest.mark.parametrize("case", list(TENDENCY_CASES))
def test_tendency_math_matches_jax_f64(case):
    mom, tr, eos, btracer = TENDENCY_CASES[case]
    cfg_j, cfg_t = _configs(mom, tr, eos, ("b",) if btracer else ("T", "S"))
    gj, gt, (ue, ve, tr_e), (ut, vt, trt) = _extended(np.float64, btracer=btracer)
    ref = jax_tendency_math(cfg_j, gj, jax_coriolis_ff(gj, cfg_j.coriolis), ue, ve, tr_e)
    got = tendency_math(cfg_t, gt, coriolis_ff(gt, cfg_t.coriolis), ut, vt, trt)
    pairs = [("Gu", got[0], ref[0]), ("Gv", got[1], ref[1])]
    pairs += [("G" + k, got[2][k], ref[2][k]) for k in trt]
    for name, g, w in pairs:
        g, w = back(gt.interior(g)), np.asarray(gj.interior(w))
        if tr == "none" and name not in ("Gu", "Gv"):
            assert not g.any() and not w.any()
            continue
        assert np.abs(w).max() > 0.0
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12 * np.abs(w).max(), err_msg=name)


# --------------------------------------------------------------------------
# K1's and K6's plain versions against the JAX kernels in interpret mode
# --------------------------------------------------------------------------

K1_CASES = {"vi_standard-centered2": ("vi_standard", "centered2", False),
            "none-upwind1": ("none", "upwind1", False),
            "b_tracer": ("weno_vi", "weno5", True)}
K1_SHAPE = (32, 16, 8)


def _check_tendencies(port, ref, names):
    np.testing.assert_allclose(back(port[0]), np.asarray(ref[0]), rtol=2e-4, atol=1e-9)
    np.testing.assert_allclose(back(port[1]), np.asarray(ref[1]), rtol=2e-4, atol=1e-9)
    for k in names:
        np.testing.assert_allclose(back(port[2][k]), np.asarray(ref[2][k]), rtol=2e-4, atol=1e-7)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("case", list(K1_CASES))
def test_plain_k1_matches_jax_kernel_f32(case, fused):
    mom, tr, btracer = K1_CASES[case]
    cfg_j, cfg_t = _configs(mom, tr, tracers=("b",) if btracer else ("T", "S"))
    gj, gt, (ue, ve, tr_e), (ut, vt, trt) = _extended(np.float32, K1_SHAPE, btracer)
    names = list(trt)
    f_ff = jax_coriolis_ff(gj, cfg_j.coriolis).astype(jnp.float32)
    if not fused:
        ref = jax_zslab_tendencies(cfg_j, gj, f_ff, ue, ve, tr_e, interpret=True, wall_v=True)
        port = zslab_tendencies_plain(cfg_t, gt, ut, vt, trt)
        _check_tendencies(port, ref, names)
        assert float(port[1][:, 0, :].abs().max()) == 0.0
        return
    rng = np.random.default_rng(17)
    prev = {k: (rng.standard_normal(K1_SHAPE) * 1e-7).astype(np.float32)
            for k in ("Gu", "Gv", *names)}
    prev["Gv"][:, 0, :] = 0.0
    ab = (np.float32(DT) * np.float32(1.6), np.float32(DT) * np.float32(-0.6))
    ab_j = jnp.asarray([[ab[0], ab[1]]], jnp.float32)
    ref = jax_zslab_tendencies(
        cfg_j, gj, f_ff, ue, ve, tr_e, interpret=True, wall_v=True, integrals=True,
        ab2=(ab_j, jnp.asarray(prev["Gu"]), jnp.asarray(prev["Gv"]),
             {k: jnp.asarray(prev[k]) for k in names}))
    port = zslab_tendencies_plain(cfg_t, gt, ut, vt, trt,
                                  (t(prev["Gu"]), t(prev["Gv"]), {k: t(prev[k]) for k in names}),
                                  (float(ab[0]), float(ab[1])))
    _check_tendencies(port, ref, names)
    # the updated fields: the tendencies' tolerance carried through x*
    for got, want, G in [(port[3], ref[3], ref[0]), (port[4], ref[4], ref[1]),
                         *((port[5][k], ref[5][k], ref[2][k]) for k in names)]:
        atol = float(ab[0]) * 2e-4 * float(np.abs(np.asarray(G)).max())
        np.testing.assert_allclose(back(got), np.asarray(want), rtol=2e-4, atol=atol)
    H = float(np.asarray(gj.dz_c)[:, :, 4:-4].sum())
    for got, want, G in zip(port[6], ref[6], (0.0, 0.0, ref[0], ref[1])):
        atol = (2e-4 * float(np.abs(np.asarray(want)).max())
                + float(ab[0]) * 2e-4 * float(np.abs(np.asarray(G)).max()) * H)
        np.testing.assert_allclose(back(got), np.asarray(want), rtol=2e-4, atol=atol)


@pytest.mark.parametrize("case", ["linear", "b_tracer"])
def test_plain_k6_matches_jax_kernel_f32(case):
    btracer = case == "b_tracer"
    if btracer:
        cfg_j, cfg_t = _configs("weno_vi", "weno5", tracers=("b",), route="pallas")
    else:
        cfg_j, cfg_t = _configs("vi_standard", "centered2", "linear", route="pallas")
    shape = (128, 16, 8)
    gj, gt, (ue, ve, tr_e), (ut, vt, trt) = _extended(np.float32, shape, btracer)
    f_ff = jax_coriolis_ff(gj, cfg_j.coriolis).astype(jnp.float32)
    ref = jax_pallas_tendency.pallas_tendencies(cfg_j, gj, f_ff, ue, ve, tr_e, bx=gj.Nx // 2,
                                                by=gj.Ny, interpret=True)
    port = pallas_tendencies_plain(cfg_t, gt, t(f_ff), ut, vt, trt)
    assert set(port[2]) == set(ref[2]) == set(trt)
    _check_tendencies(port, ref, list(trt))


# --------------------------------------------------------------------------
# three steps against JAX kernels="jnp"
# --------------------------------------------------------------------------

STEP_CASES = {
    # each momentum variant with WENO-5 tracers
    "weno_vi_standard": {"mom": "weno_vi_standard"},
    "vi": {"mom": "vi"},
    "vi_standard": {"mom": "vi_standard"},
    "mom_none": {"mom": "none"},
    # each tracer scheme with WENO vector-invariant momentum
    "centered2": {"tr": "centered2"},
    "upwind1": {"tr": "upwind1"},
    "tr_none": {"tr": "none"},
    # tests/test_model.py's buoyancy-tracer configuration
    "b_split": {"tracers": ("b",), "free_surface": 10},
    # tests/test_catke.py's column: linear EOS, no advection, explicit
    "catke_linear_none": {"mom": "none", "tr": "none", "eos": "linear", "closure": "catke",
                          "free_surface": "explicit"},
    "b_catke": {"tracers": ("b",), "closure": "catke"},
}


def _step_inputs(case):
    """JAX's grid, initial state and the port's grid of a step case."""
    kw = STEP_CASES[case]
    if case == "catke_linear_none":
        gj = jax_latlon_grid(4, 8, 50, latitude=(-2.0, 2.0), longitude=(0.0, 360.0),
                             depth=200.0, surface_dz=None, dtype=jnp.float64)
        gt = latitude_longitude_grid(4, 8, 50, device="cpu", latitude=(-2.0, 2.0),
                                     longitude=(0.0, 360.0), depth=200.0, surface_dz=None,
                                     dtype=torch.float64)
        eos = JaxLinear()
        z = gj.z_c_i.reshape(1, 1, -1)
        T = jnp.broadcast_to(15.0 + 1e-5 / (eos.g * eos.alpha) * z, gj.shape)
        rng = np.random.default_rng(23)
        sj = jax_initial_state(gj, ("T", "S", "e"), jnp.float64).replace(
            u=jnp.asarray(1e-2 * rng.standard_normal(gj.shape)),
            v=jnp.asarray(1e-2 * rng.standard_normal(gj.shape)).at[:, 0, :].set(0.0),
            tracers={"T": T, "S": jnp.full(gj.shape, 35.0), "e": jnp.full(gj.shape, 1e-6)})
        return gj, sj, gt
    shape = (16, 8, 4) if case == "b_split" else SHAPE
    gj = jax_grid(*shape, dtype=jnp.float64)
    sj = jax_state(gj, noise_velocity=1e-3,
                   tracers=("T", "S", "e") if kw.get("closure") == "catke" else ("T", "S"))
    if case == "b_split":
        z = gj.z_c_i.reshape(1, 1, -1)
        sj = sj.replace(tracers={"b": jnp.broadcast_to(4e-6 * z, gj.shape)},
                        Gtracers={"b": jnp.zeros(gj.shape)})
    elif kw.get("tracers") == ("b",):
        sj = _with_b(sj)
    return gj, sj, simple_latitude_longitude_grid(*shape, device="cpu", dtype=torch.float64)


# Cases whose JAX steps run un-jitted: in the CATKE column under the linear
# equation of state (b linear in z, N^2 a difference of nearly equal b),
# XLA's jitted step parts from JAX's own eager step by 3.7e-7 of max e
# after one step (under TEOS-10 by 3e-14), while the port agrees with the
# eager step to float64 rounding.
EAGER_CASES = ("catke_linear_none",)


@functools.lru_cache(maxsize=None)
def _jax_run(case, blocked):
    """JAX's state after 3 steps (GB25_BAROTROPIC_BLOCK=1 unless
    ``blocked``) and its initial state, as numpy."""
    mp = pytest.MonkeyPatch()
    if blocked:
        mp.delenv("GB25_BAROTROPIC_BLOCK", raising=False)
    else:
        mp.setenv("GB25_BAROTROPIC_BLOCK", "1")
    mp.delenv("GB25_ZSLAB_INTERPRET", raising=False)
    try:
        cfg_j, _ = _configs(**STEP_CASES[case])
        gj, sj, _ = _step_inputs(case)
        init = _arrays(sj)
        eager = case in EAGER_CASES
        step = jax_time_step if eager else jax.jit(jax_time_step)
        with jax.disable_jit(eager):
            for _ in range(3):
                sj = step(cfg_j, gj, sj, DT)
        return init, _arrays(sj)
    finally:
        mp.undo()


@pytest.mark.parametrize("route", ["auto", "pallas"])
@pytest.mark.parametrize("case", list(STEP_CASES))
def test_three_steps_match_jax_f64(case, route):
    kw = STEP_CASES[case]
    # the explicit free surface runs no barotropic solve: one JAX run serves both routes
    blocked = route == "pallas" and kw.get("free_surface") != "explicit"
    init, ref = _jax_run(case, blocked)
    _, cfg_t = _configs(**kw, route=route)
    _, _, gt = _step_inputs(case)
    port = state_to_numpy(loop(cfg_t, gt, state_from_numpy(init, "cpu"), DT, 3))
    assert list(port) == list(ref)
    compare_states(ref, port, rtol=1e-10, verbose=False)
    assert np.abs(port["u"]).max() > 0.0 and int(port["iteration"]) == 3


def test_decomposed_matches_jax_serial_f64(monkeypatch):
    """The oracle's schemes with the linear equation of state on a (1, 2)
    mesh of gloo ranks (K1's route on tiles, the blocked free surface at
    the halo's width) against JAX serially with its blocked free surface."""
    monkeypatch.delenv("GB25_BAROTROPIC_BLOCK", raising=False)
    monkeypatch.delenv("GB25_ZSLAB_INTERPRET", raising=False)
    cfg_j, cfg_t = _configs("vi_standard", "centered2", "linear")
    gj = jax_grid(*SHAPE, dtype=jnp.float64)
    sj = jax_state(gj, noise_velocity=1e-3)
    init = _arrays(sj)
    step = jax.jit(jax_time_step)
    for _ in range(3):
        sj = step(cfg_j, gj, sj, DT)
    gt = simple_latitude_longitude_grid(*SHAPE, device="cpu", dtype=torch.float64)
    port = spawn(run_decomposed, 2, cfg_t, gt, init, DT, 3, None, shape=(1, 2))[0]
    compare_states(_arrays(sj), port, rtol=1e-10, verbose=False)


def test_bf16s_with_the_b_tracer_matches_jax(monkeypatch):
    """"bf16s" on the b tracer (K1's one-tracer bf16-storage instance, its
    plain version here) one step at 32x16x8 in float32 against JAX's bf16s
    step (kernels="zslab", interpret mode), at 1e-4 of each field's largest
    value (tests/test_torch_precision.py's bound for the mode)."""
    monkeypatch.setenv("GB25_BAROTROPIC_BLOCK", "1")
    monkeypatch.setenv("GB25_ZSLAB_INTERPRET", "1")
    shape = (32, 16, 8)
    gj = jax_grid(*shape, dtype=jnp.float32)
    sj = _with_b(jax_state(gj, noise_velocity=1e-3))
    cfg_j, cfg_t = _configs(tracers=("b",))
    cfg_j = dataclasses.replace(cfg_j, kernels="zslab", compute_dtype="bf16s")
    ref = _arrays(jax.jit(jax_time_step)(cfg_j, gj, sj, DT))
    gt = simple_latitude_longitude_grid(*shape, device="cpu", dtype=torch.float32)
    cfg_t = dataclasses.replace(cfg_t, compute_dtype="bf16s")
    port = state_to_numpy(time_step(cfg_t, gt, state_from_numpy(_arrays(sj), "cpu"), DT))
    assert list(port) == list(ref)
    for name in ref:
        want = ref[name].astype(np.float64)
        np.testing.assert_allclose(port[name].astype(np.float64), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=name)


# --------------------------------------------------------------------------
# the independent float64 oracle and the physics checks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["auto", "pallas"])
def test_full_step_matches_numpy_oracle(route):
    """tests/test_numpy_oracle.py's case on the port: its grid, state,
    configuration (linear EOS, centred vector-invariant momentum with the
    standard kinetic energy, centred tracers, explicit free surface) and
    tolerances, one Euler step of dt = 30 s."""
    gj = oracle_grid()
    NX, NY, NZ = gj.Nx, gj.Ny, gj.Nz
    gt = latitude_longitude_grid(NX, NY, NZ, device="cpu", latitude=(-60.0, 60.0),
                                 longitude=(0.0, 360.0), depth=1000.0, surface_dz=None,
                                 dtype=torch.float64)
    eos = LinearEquationOfState()
    cfg = HydrostaticConfig(tracers=("T", "S"), momentum_advection="vector_invariant",
                            tracer_advection="centered2", eos=eos,
                            free_surface=ExplicitFreeSurface(), kernels=route,
                            ke_scheme="standard")
    rng = np.random.default_rng(7)
    u0 = rng.standard_normal((NX, NY, NZ)) * 1e-2
    v0 = rng.standard_normal((NX, NY, NZ)) * 1e-2
    v0[:, 0, :] = 0.0
    T0 = 10.0 + rng.standard_normal((NX, NY, NZ)) * 0.1
    S0 = 35.0 + rng.standard_normal((NX, NY, NZ)) * 0.1
    eta0 = rng.standard_normal((NX, NY)) * 1e-3
    state = initial_state(gt, ("T", "S")).replace(
        u=t(u0), v=t(v0), eta=t(eta0), tracers={"T": t(T0), "S": t(S0)})
    dt = 30.0
    s1 = time_step(cfg, gt, state, dt)

    o = Oracle(gj, JaxLinear())
    Gu, Gv, GT, GS, Geta = o.tendencies(u0, v0, T0, S0, eta0)
    v1 = v0 + dt * Gv
    v1[:, 0, :] = 0.0
    np.testing.assert_allclose(back(s1.tracers["T"]), T0 + dt * GT, rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(back(s1.tracers["S"]), S0 + dt * GS, rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(back(s1.eta), eta0 + dt * Geta, rtol=1e-10, atol=1e-15)
    np.testing.assert_allclose(back(s1.v), v1, rtol=1e-9, atol=1e-13)
    np.testing.assert_allclose(back(s1.u), u0 + dt * Gu, rtol=1e-9, atol=1e-13)


def _buoyant_column_response(route, btracer):
    """Deep u one Euler step from rest under a buoyant column at lon 180:
    a Gaussian b > 0 column, or a warm one under the linear equation of
    state (tests/test_physics_regression.py's two experiments)."""
    NX, NY, NZ = 32, 8, 6
    gt = latitude_longitude_grid(NX, NY, NZ, device="cpu", latitude=(-20.0, 20.0),
                                 longitude=(0.0, 360.0), depth=1000.0, surface_dz=None,
                                 dtype=torch.float64)
    cfg = HydrostaticConfig(tracers=("b",) if btracer else ("T", "S"),
                            momentum_advection="vector_invariant", tracer_advection="centered2",
                            eos=LinearEquationOfState(), free_surface=ExplicitFreeSurface(),
                            kernels=route, coriolis=0.0)
    lon = gt.lam_c_i.numpy()
    bump = np.exp(-((lon - 180.0) ** 2) / (2 * 30.0**2))  # (Nx,)

    def column(x):
        return torch.from_numpy(np.broadcast_to(x, (NZ, NY, NX)).copy())

    if btracer:
        tracers = {"b": column(1e-4 * bump)}
    else:
        tracers = {"T": column(10.0 + 2.0 * bump), "S": torch.full((NZ, NY, NX), 35.0,
                                                                    dtype=torch.float64)}
    state = initial_state(gt, cfg.tracers).replace(tracers=tracers)
    u1 = time_step(cfg, gt, state, 60.0).u[0, NY // 2].numpy()  # deepest level
    return lon, u1


@pytest.mark.parametrize("route", ["auto", "pallas"])
@pytest.mark.parametrize("btracer", [True, False], ids=["b_tracer", "linear_eos"])
def test_deep_flow_converges_toward_buoyant_column(btracer, route):
    lon, u1 = _buoyant_column_response(route, btracer)
    east = (lon > 190.0) & (lon < 300.0)  # flow must be westward
    west = (lon > 60.0) & (lon < 170.0)   # flow must be eastward
    assert np.all(u1[east] < 0.0), u1[east]
    assert np.all(u1[west] > 0.0), u1[west]
    assert np.max(np.abs(u1)) > 1e-8


def test_buoyancy_tracer_state_is_the_linear_buoyancy():
    cfg, grid, state = baroclinic_instability_model(16, 8, 4, device="cpu", dtype=torch.float64)
    bstate = buoyancy_tracer_state(state, grid)
    hz = grid.hz
    b = bstate.tracers["b"]
    assert list(bstate.tracers) == ["b"] and list(bstate.Gtracers) == ["b"]
    want = LinearEquationOfState().buoyancy(state.tracers["T"], state.tracers["S"], None)
    assert torch.equal(b, want)
    assert (b[1:] - b[:-1] > 0).all(), "stably stratified: b grows upward"
    assert grid.z_c[hz : hz + grid.Nz].shape[0] == b.shape[0]


# --------------------------------------------------------------------------
# config errors
# --------------------------------------------------------------------------

@pytest.mark.parametrize("field", ["momentum_advection", "tracer_advection", "ke_scheme"])
def test_unknown_scheme_raises(field):
    with pytest.raises(ValueError, match=field):
        HydrostaticConfig(**{field: "weno9"})


@pytest.mark.parametrize("tracers,closure", [
    (("T",), None), (("b", "S"), None), (("S", "T"), None), (("T", "S", "e"), None),
    (("b",), CATKEVerticalDiffusivity()), (("b", "e", "T"), CATKEVerticalDiffusivity())])
def test_tracer_set_outside_the_rule_raises(tracers, closure):
    with pytest.raises(ValueError, match="tracers"):
        HydrostaticConfig(tracers=tracers, closure=closure)


def test_every_accepted_choice_constructs():
    for m, (mom, ke) in MOMENTUM.items():
        for tr in TRACER:
            for eos in (None, LinearEquationOfState()):
                for tracers, closure in ((("T", "S"), None), (("b",), VerticalScalarDiffusivity()),
                                         (("b", "e"), CATKEVerticalDiffusivity())):
                    HydrostaticConfig(tracers=tracers, closure=closure, momentum_advection=mom,
                                      tracer_advection=tr, ke_scheme=ke,
                                      **({"eos": eos} if eos else {}))
    with pytest.raises(ValueError, match="equation of state"):
        HydrostaticConfig(eos=object())
