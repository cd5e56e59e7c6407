"""The port's precision modes (``HydrostaticConfig.compute_dtype``) and
K1's unfused forms against the JAX package's.

K1's plain unfused forms against JAX ``zslab_tendencies`` in interpret
mode at 32x16x8 (tests/test_zslab.py's inputs): without ``ab2`` in float32,
and with ``storage_dtype=bfloat16``, at K1's tolerance (rtol 2e-4, atol
1e-9 for the momentum and 1e-7 for the tracers: both compute in float32 on
the same bfloat16-rounded operands, the kernel's z carries summed in
another order). The bf16 form on operands rounded beforehand equals itself
on the raw ones bit for bit (rounding is idempotent), and differs from the
float32 form (the rounding bites).

One step of each mode from the same float32 state at 32x16x8, against JAX's
own mode (GB25_BAROTROPIC_BLOCK=1: JAX's array free surface re-imposes its
boundary conditions every substep, as K2 does):
  - "bf16s" against JAX kernels="zslab" with GB25_ZSLAB_INTERPRET=1: atol
    1e-4 of each field's largest value (measured at most 3.9e-5, in GT; u,
    v, eta within 1.3e-6): float32 arithmetic on the same rounded operands;
  - "float32" (K1's unfused form, the AB2 update outside) against JAX's
    "float32": atol 1e-4, "bf16s"'s, float32 arithmetic in both packages
    (measured at most 3.7e-5, in GT);
  - "float64" and "f32x2" against JAX's "float64" and its double-single
    "f32x2" (the port computes "f32x2" in native float64, a deviation
    logged in ROADMAP.md): atol 2e-6 of each field's largest value
    (measured at most 3.3e-7, in v): the tendencies agree to their float32
    cast, the float32 update and free surface round differently in torch
    and XLA;
  - "bfloat16": the two packages round bfloat16 differently (torch's WENO
    is written in another algebraic form, ops/weno.py), so the tolerance is
    sized from the data: each field within twice JAX's own distance between
    its "bfloat16" and float32 steps. Measured on the CPU: port-vs-JAX
    over JAX-bf16-vs-JAX-f32, max abs, u 7.2e-9 / 1.2e-7, v 2.2e-4 /
    1.5e-3, eta 6.0e-6 / 1.7e-4, T 7.6e-6 / 9.5e-6, S 9.5e-7 / 9.5e-7, Gu
    1.2e-10 / 2.0e-9, Gv 3.6e-6 / 2.6e-5, GT 1.3e-7 / 1.5e-7, GS 3.7e-9 /
    2.9e-9 (ratios at most 1.27).
Then the port's version of tests/test_precision.py::
test_bf16_compute_tracks_f32 with its bounds, the routes (the serial K1
routes under an unfused AB2 run K2, not the blocked solve), the
combinations that raise ("float16" and the float8 modes, which go
non-finite in JAX, among them) and the rule that picks a kernel or its
plain version from the state's dtype.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gb25_tpu.grids import simple_latitude_longitude_grid as jax_grid
from gb25_tpu.models import baroclinic_instability_config as jax_config
from gb25_tpu.models import baroclinic_instability_state as jax_state
from gb25_tpu.models import time_step as jax_time_step
from gb25_tpu.ops.halos import extend_field as jax_extend_field
from gb25_tpu.ops.operators import coriolis_ff as jax_coriolis_ff
from gb25_tpu.ops.pallas_zslab import zslab_tendencies as jax_zslab_tendencies
from gb25_tpu.utils.correctness import _leaf_names
from gb25_tpu_torch.convert import state_from_numpy, state_to_numpy
from gb25_tpu_torch.grids import simple_latitude_longitude_grid
from gb25_tpu_torch.models import (
    ExplicitFreeSurface,
    baroclinic_instability_config,
    baroclinic_instability_model,
    free_surface,
    loop,
    time_step,
)
from gb25_tpu_torch.models.catke import CATKEVerticalDiffusivity
from gb25_tpu_torch.models.config import KERNEL_MODES, NONFINITE_COMPUTE_DTYPES
from gb25_tpu_torch.models.hydrostatic import k1_operand_dtype, k6_operand_dtype
from gb25_tpu_torch.models.keps import TKEDissipationVerticalDiffusivity
from gb25_tpu_torch.ops import (
    pallas_barotropic,
    pallas_catke,
    pallas_tendency,
    pallas_tridiag,
    pallas_zslab,
)
from gb25_tpu_torch.ops.halos import extend_field
from gb25_tpu_torch.ops.pallas_zslab import zslab_tendencies, zslab_tendencies_plain
from gb25_tpu_torch.utils import cuda_build

DT = 60.0
SHAPE = (32, 16, 8)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: beside other busy
    test processes, torch's default of one OpenMP thread per core made the
    plain versions' many small launches ~100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t3(a):
    return torch.from_numpy(np.array(np.transpose(np.asarray(a))))


def back(t):
    return np.transpose(t.numpy())


def _arrays(state):
    return {name: np.asarray(x) for name, x in _leaf_names(state)}


def _k1_inputs():
    """The JAX float32 flagship state at 32x16x8 extended in both packages,
    JAX's config and f, the port's grid and config."""
    gj = jax_grid(*SHAPE, dtype=jnp.float32)
    sj = jax_state(gj, noise_velocity=1e-3)
    cfg_j = jax_config()
    jax_in = (jax_extend_field(gj, sj.u, "u"), jax_extend_field(gj, sj.v, "v"),
              {k: jax_extend_field(gj, c, "c") for k, c in sj.tracers.items()})
    gt = simple_latitude_longitude_grid(*SHAPE, device="cpu", dtype=torch.float32)
    port_in = (extend_field(gt, t3(sj.u), "u"), extend_field(gt, t3(sj.v), "v"),
               {k: extend_field(gt, t3(sj.tracers[k]), "c") for k in ("T", "S")})
    f_ff = jax_coriolis_ff(gj, cfg_j.coriolis).astype(jnp.float32)
    return cfg_j, gj, f_ff, jax_in, baroclinic_instability_config(), gt, port_in


def _check_k1(port, ref):
    Gu, Gv, Gtr = port
    np.testing.assert_allclose(back(Gu), np.asarray(ref[0]), rtol=2e-4, atol=1e-9)
    np.testing.assert_allclose(back(Gv), np.asarray(ref[1]), rtol=2e-4, atol=1e-9)
    for k in ("T", "S"):
        np.testing.assert_allclose(back(Gtr[k]), np.asarray(ref[2][k]), rtol=2e-4, atol=1e-7)
    assert float(Gv[:, 0, :].abs().max()) == 0.0  # the wall row


def test_plain_k1_unfused_matches_jax_kernel_f32():
    cfg_j, gj, f_ff, (ue, ve, tr_e), cfg, gt, (ut, vt, trt) = _k1_inputs()
    ref = jax_zslab_tendencies(cfg_j, gj, f_ff, ue, ve, tr_e, interpret=True, wall_v=True)
    _check_k1(zslab_tendencies_plain(cfg, gt, ut, vt, trt), ref)


def test_plain_k1_bf16_storage_matches_jax_kernel():
    cfg_j, gj, f_ff, (ue, ve, tr_e), cfg, gt, (ut, vt, trt) = _k1_inputs()
    ref = jax_zslab_tendencies(cfg_j, gj, f_ff, ue, ve, tr_e, interpret=True, wall_v=True,
                               storage_dtype=jnp.bfloat16)
    port = zslab_tendencies_plain(cfg, gt, ut, vt, trt, storage=torch.bfloat16)
    _check_k1(port, ref)

    def rt(x):
        return x.to(torch.bfloat16).float()

    pre = zslab_tendencies_plain(cfg, gt, rt(ut), rt(vt), {k: rt(c) for k, c in trt.items()},
                                 storage=torch.bfloat16)
    f32 = zslab_tendencies_plain(cfg, gt, ut, vt, trt)
    flat = [(port[0], pre[0], f32[0]), (port[1], pre[1], f32[1]),
            *((port[2][k], pre[2][k], f32[2][k]) for k in ("T", "S"))]
    for a, b, _ in flat:
        assert torch.equal(a, b)  # rounding at storage is idempotent
    assert max(float((a - c).abs().max()) for a, _, c in flat) > 0.0  # and it bites
    # the dispatching entry point runs the plain version on CPU tensors
    again = zslab_tendencies(cfg, gt, ut, vt, trt, storage=torch.bfloat16)
    assert torch.equal(again[0], port[0]) and torch.equal(again[2]["T"], port[2]["T"])


def test_k1_bf16_storage_refuses_the_fused_update():
    _, _, _, _, cfg, gt, (ut, vt, trt) = _k1_inputs()
    prev = (torch.zeros(gt.shape), torch.zeros(gt.shape),
            {k: torch.zeros(gt.shape) for k in trt})
    for fn in (zslab_tendencies, zslab_tendencies_plain):
        with pytest.raises(ValueError, match="unrounded"):
            fn(cfg, gt, ut, vt, trt, prev, (60.0, 0.0), storage=torch.bfloat16)


@pytest.fixture(scope="module")
def _jax_steps():
    """JAX's float32 state at 32x16x8 and its steps, one per mode (jitted
    once per mode), with GB25_BAROTROPIC_BLOCK=1 and, for "bf16s",
    GB25_ZSLAB_INTERPRET=1."""
    mp = pytest.MonkeyPatch()
    mp.setenv("GB25_BAROTROPIC_BLOCK", "1")
    gj = jax_grid(*SHAPE, dtype=jnp.float32)
    sj = jax_state(gj, noise_velocity=1e-3)
    steps = {}
    try:
        for mode in (None, "float32", "bfloat16", "float64", "f32x2", "bf16s"):
            if mode == "bf16s":
                mp.setenv("GB25_ZSLAB_INTERPRET", "1")
            kernels = "zslab" if mode == "bf16s" else "jnp"
            cfg = dataclasses.replace(jax_config(), kernels=kernels, compute_dtype=mode)
            steps[mode] = _arrays(jax.jit(jax_time_step)(cfg, gj, sj, DT))
    finally:
        mp.undo()
    return _arrays(sj), steps


def _port_step(state, mode):
    gt = simple_latitude_longitude_grid(*SHAPE, device="cpu", dtype=torch.float32)
    cfg = dataclasses.replace(baroclinic_instability_config(), compute_dtype=mode)
    out = state_to_numpy(time_step(cfg, gt, state_from_numpy(state, "cpu"), DT))
    assert out["u"].dtype == np.float32  # the state stays in its precision
    return out


@pytest.mark.parametrize("mode,scale", [("bf16s", 1e-4), ("float32", 1e-4), ("float64", 2e-6),
                                        ("f32x2", 2e-6)])
def test_step_matches_jax_mode(_jax_steps, mode, scale):
    state, steps = _jax_steps
    ref, port = steps[mode], _port_step(state, mode)
    assert list(port) == list(ref)
    for name in ref:
        want = ref[name].astype(np.float64)
        np.testing.assert_allclose(port[name].astype(np.float64), want, rtol=0,
                                   atol=scale * np.abs(want).max(), err_msg=name)


def test_float32_mode_on_a_float64_state_matches_jax(monkeypatch):
    """"float32" on a float64 state: JAX casts the fields and the grid to
    float32 for the tendency stage; the port hands K1's unfused float32
    instance (its plain version here) float32 copies of both. One step at
    32x16x8 against JAX's, atol 1e-4 of each field's largest value, the
    float32 mode's bound (measured at most 3.0e-5, in GT); the state stays
    float64."""
    monkeypatch.setenv("GB25_BAROTROPIC_BLOCK", "1")
    gj = jax_grid(*SHAPE, dtype=jnp.float64)
    sj = jax_state(gj, noise_velocity=1e-3)
    cfg_j = dataclasses.replace(jax_config(), kernels="jnp", compute_dtype="float32")
    ref = _arrays(jax.jit(jax_time_step)(cfg_j, gj, sj, DT))
    gt = simple_latitude_longitude_grid(*SHAPE, device="cpu", dtype=torch.float64)
    cfg = dataclasses.replace(baroclinic_instability_config(), compute_dtype="float32")
    port = state_to_numpy(time_step(cfg, gt, state_from_numpy(_arrays(sj), "cpu"), DT))
    assert list(port) == list(ref) and port["u"].dtype == np.float64
    for name in ref:
        want = ref[name].astype(np.float64)
        np.testing.assert_allclose(port[name], want, rtol=0, atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)


def test_bfloat16_step_matches_jax_within_its_own_distance(_jax_steps):
    state, steps = _jax_steps
    ref, ref32, port = steps["bfloat16"], steps[None], _port_step(state, "bfloat16")
    assert list(port) == list(ref)
    for name in ref:
        assert np.isfinite(port[name]).all(), name
        want = ref[name].astype(np.float64)
        own = np.abs(want - ref32[name].astype(np.float64)).max()
        np.testing.assert_allclose(port[name].astype(np.float64), want, rtol=0, atol=2 * own,
                                   err_msg=name)


def test_bf16_compute_tracks_f32():
    """tests/test_precision.py::test_bf16_compute_tracks_f32 on the port:
    10 steps at 32x16x6 with compute_dtype="bfloat16" against float32."""
    cfg32, grid, state = baroclinic_instability_model(32, 16, 6, device="cpu")
    cfg16 = dataclasses.replace(cfg32, compute_dtype="bfloat16")
    s32 = loop(cfg32, grid, state, DT, 10)
    s16 = loop(cfg16, grid, state, DT, 10)
    assert s16.u.dtype == torch.float32
    du = float((s16.u - s32.u).abs().max())
    scale = float(s32.u.abs().max())
    assert du < 0.15 * max(scale, 1e-6), (du, scale)
    assert float((s16.tracers["T"] - s32.tracers["T"]).abs().max()) < 0.3
    for x in (s16.u, s16.v, s16.eta, *s16.tracers.values()):
        assert torch.isfinite(x).all()


@pytest.mark.parametrize("mode", ["bf16s", "float32", "float64", "explicit"])
def test_unfused_k1_routes_run_k2(monkeypatch, mode):
    """Under an unfused AB2 the serial K1 route runs the whole-loop solve
    (K2's plain version here), as the JAX package does, never the blocked
    one; the "pallas" route runs the blocked one (the monkeypatch bites)."""
    calls = {"loop": 0}
    real_loop = free_surface.barotropic_loop

    def counted(*a, **kw):
        calls["loop"] += 1
        return real_loop(*a, **kw)

    def refuse(*a, **kw):
        raise AssertionError("the blocked solve ran")

    monkeypatch.setattr(free_surface, "barotropic_loop", counted)
    monkeypatch.setattr(free_surface, "_blocked_solve", refuse)
    kw = {"free_surface": ExplicitFreeSurface()} if mode == "explicit" else {}
    cfg, grid, state = baroclinic_instability_model(16, 8, 4, device="cpu", **kw)
    if mode != "explicit":
        cfg = dataclasses.replace(cfg, compute_dtype=mode)
    loop(cfg, grid, state, DT, 2)
    assert calls["loop"] == (0 if mode == "explicit" else 2)
    with pytest.raises(AssertionError, match="blocked"):
        time_step(baroclinic_instability_config(kernels="pallas"), grid, state, DT)


def test_refused_combinations_raise():
    cfg = baroclinic_instability_config()
    with pytest.raises(ValueError, match="bf16s"):
        dataclasses.replace(cfg, kernels="pallas", compute_dtype="bf16s")
    # every other compute_dtype runs on the "pallas" route: K6 on copies in
    # "float32", "bfloat16" or "float64", the float64 array path for "f32x2",
    # the limbs' array path for "bf16x2"
    _, grid, state = baroclinic_instability_model(16, 8, 4, device="cpu")
    for mode, array in (("float32", None), ("bfloat16", None), ("float64", None),
                        ("f32x2", torch.float64), ("bf16x2", "bf16x2")):
        pallas = dataclasses.replace(cfg, kernels="pallas", compute_dtype=mode)
        assert pallas.array_dtype == array and not pallas.fused
        out = time_step(pallas, grid, state, DT)
        assert out.u.dtype == torch.float32 and torch.isfinite(out.u).all()
    # "bf16x2" (paired bfloat16 limbs) runs on the K1 routes too, unfused
    bf16x2 = dataclasses.replace(cfg, compute_dtype="bf16x2")
    assert bf16x2.array_dtype == "bf16x2" and not bf16x2.fused
    assert torch.isfinite(time_step(bf16x2, grid, state, DT).u).all()
    for mode in NONFINITE_COMPUTE_DTYPES:
        with pytest.raises(NotImplementedError, match="non-finite.*Not to port"):
            dataclasses.replace(cfg, compute_dtype=mode)
    with pytest.raises(ValueError, match="compute_dtype"):
        dataclasses.replace(cfg, compute_dtype="float128")
    assert not dataclasses.replace(cfg, compute_dtype="float32").fused
    # and every compute_dtype with CATKE and k-epsilon
    for closure in (CATKEVerticalDiffusivity(), TKEDissipationVerticalDiffusivity()):
        with_closure = baroclinic_instability_config(closure=closure)
        _, grid, state = baroclinic_instability_model(16, 8, 4, device="cpu", closure=closure)
        for mode in ("bf16s", "bfloat16"):
            out = time_step(dataclasses.replace(with_closure, compute_dtype=mode), grid, state, DT)
            assert all(torch.isfinite(c).all() for c in out.tracers.values())


def test_kernel_route_follows_the_state_dtype():
    """The one rule every wrapper dispatches by (``kernel_route``, from the
    device and the dtype alone; no device needed): on a CUDA operand
    "auto" launches every kernel for a float32 state and takes every plain
    version for a float64 or float16 state, as the JAX package's gates send
    a non-float32 ue to its array path; "pallas" refuses such a state; the
    CPU and "torch" always take the plain versions. "float32" and "bf16s" on
    a state of another dtype hand K1 float32 copies, which launch it. Under
    "pallas" a float64 state launches K6's float64 instance and takes the
    plain versions of K2-K5, as the JAX package's gates do."""
    for dtype in (torch.float64, torch.float16):
        assert not cuda_build.kernel_route("auto", "cuda", dtype)
    assert not cuda_build.kernel_route("pallas", "cuda", torch.float64)
    assert cuda_build.kernel_route("pallas", "cuda", torch.float64, pallas_tendency.DTYPES)
    with pytest.raises(NotImplementedError, match="float32"):
        cuda_build.kernel_route("pallas", "cuda", torch.float16)
    for kernels in ("auto", "pallas"):
        assert cuda_build.kernel_route(kernels, "cuda", torch.float32)
    for kernels in KERNEL_MODES:
        for dtype in (torch.float32, torch.float64, torch.float16):
            assert not cuda_build.kernel_route(kernels, "cpu", dtype)
    assert not cuda_build.kernel_route("torch", "cuda", torch.float64)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        cuda_build.kernel_route("auto", "meta", torch.float32)
    for module in (pallas_zslab, pallas_barotropic, pallas_tridiag, pallas_catke,
                   pallas_tendency):
        assert module.uses_kernel is cuda_build.uses_kernel
    for mode in ("float32", "bf16s"):
        cfg = dataclasses.replace(baroclinic_instability_config(), compute_dtype=mode)
        for dtype in (torch.float64, torch.float16):
            assert k1_operand_dtype(cfg, dtype) == torch.float32
        assert k1_operand_dtype(cfg, torch.float32) is None
    for mode in (None, "bfloat16", "float64", "f32x2", "bf16x2"):
        cfg = dataclasses.replace(baroclinic_instability_config(), compute_dtype=mode)
        assert k1_operand_dtype(cfg, torch.float64) is None
    # K6 also reads bfloat16 (its instance for "bfloat16" on the "pallas"
    # route), on float32 or bfloat16 copies of the state (k6_operand_dtype)
    bf = torch.bfloat16
    assert cuda_build.kernel_route("pallas", "cuda", bf, pallas_tendency.DTYPES)
    assert not cuda_build.kernel_route("auto", "cuda", bf)
    assert not cuda_build.kernel_route("pallas", "cpu", bf, pallas_tendency.DTYPES)
    for mode, dtype, want in (("float32", torch.float64, torch.float32),
                              ("float32", torch.float32, None), ("bfloat16", torch.float32, bf),
                              ("bfloat16", torch.float64, bf), (None, torch.float64, None),
                              ("float64", torch.float32, torch.float64),
                              ("float64", torch.float64, None), ("bf16x2", torch.float32, None)):
        cfg = dataclasses.replace(baroclinic_instability_config(kernels="pallas"),
                                  compute_dtype=mode)
        assert k6_operand_dtype(cfg, dtype) == want
