"""Paired-bfloat16 limbs (``compute_dtype="bf16x2"``, the port's
``ops/multifloat.py``) and a float64 state on the ``kernels="pallas"``
route, against the JAX package.

The limb arithmetic against JAX's ``TwoFloat`` with bfloat16 limbs on the
same numpy inputs, JAX run op by op (each operation compiled alone, so XLA
rounds every one): ``from_array`` of float64, + - * / with limbs, with
Python numbers on either side and with plain tensors, ``**``, negation,
``sqrt``, ``where``, ``roll`` and ``cat`` bit for bit on both limbs, and the
comparisons on the float32 value. ``cumsum`` and ``sum`` add the promoted
limbs in float32 and re-split the sum, in an order of their own: torch's
CPU cumsum accumulates float32 in float64 (its CUDA scan along z in
float32), XLA's CPU scan in a tree order; so against JAX they are held to
2 float32 ulps of each partial sum's magnitude per term summed plus the
re-split's 2^-16 of the value (on inputs whose sums of limbs are exact in
float32 they agree bit for bit), and ``sum`` is the last running sum bit
for bit. A function ``TwoFloat`` has no rule for raises ``TypeError``.

The tendency precision ladder of tests/test_multifloat.py on the port
(24x16x8, inputs rounded to float32 so that every mode reads the same
values): bf16x2 within bf16 / 50 and 1e-2 of float64.

The port's bf16x2 tendencies (``tendency_math`` on the limbs, the
tendency stage's array path) against JAX's on the same operands and grid,
JAX run op by op: each output within twice JAX's own distance between its
bf16x2 and float64 tendencies, on the flagship (64x16x8), the tripolar
islands grid with CATKE (64x32x8) and four tracers. One step against JAX's
own jitted step (XLA may skip bfloat16 roundings there, at
``xla_allow_excess_precision``'s default): the flagship at 64x16x8 on the
"auto" and "pallas" routes and the coupled tripolar climate with CATKE at
48x24x8, float32 states, each field within twice JAX's own distance
between its bf16x2 and float64-compute steps and at least the float32
mode's 1e-4 of its largest value. bf16x2 on 2x2 gloo tiles bit for bit
with the step forced onto a 1x1 mesh and within 1e-4 of each field's
largest value of the serial step.

A float64 state on kernels="pallas" (K6's float64 instance on the card,
its plain twin here) against JAX's kernels="pallas" step in float64 (its
K6 in interpret mode) at 1e-10.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gb25_tpu.ops.multifloat as jmf
import gb25_tpu.ops.pallas_tendency as jax_pallas_tendency
from gb25_tpu.grids import simple_latitude_longitude_grid as jax_latlon
from gb25_tpu.models import baroclinic_instability_config as jax_config
from gb25_tpu.models import baroclinic_instability_state as jax_state
from gb25_tpu.models import time_step as jax_time_step
from gb25_tpu.models.coupled import coupled_time_step as jax_coupled_time_step
from gb25_tpu.models.hydrostatic import tendency_math as jax_tendency_math
from gb25_tpu_torch.convert import state_from_numpy, state_to_numpy
from gb25_tpu_torch.grids import simple_latitude_longitude_grid
from gb25_tpu_torch.models import (
    baroclinic_instability_config,
    baroclinic_instability_state,
    coupled_time_step,
    data_free_ocean_climate_model,
    loop,
)
from gb25_tpu_torch.models.config import COMPUTE_DTYPES
from gb25_tpu_torch.models.hydrostatic import tendency_math
from gb25_tpu_torch.ops import multifloat as pmf
from gb25_tpu_torch.ops.halos import extend_field
from gb25_tpu_torch.ops.operators import coriolis_ff
from gb25_tpu_torch.utils.correctness import compare_states
from test_torch_climate import _jax_arrays, _models
from test_torch_k6_precision import _assert_within, _tiles_vs_serial
from test_torch_pallas_tendency import _k6_inputs

DT = 60.0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors (the other test
    files' reason: beside other busy test processes, one thread per core
    made the many small launches of the array path ~100x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _blocked_jax(monkeypatch):
    """JAX's free surface blocked at the grid halo, its z-slab kernel off."""
    monkeypatch.delenv("GB25_BAROTROPIC_BLOCK", raising=False)
    monkeypatch.delenv("GB25_ZSLAB_INTERPRET", raising=False)


# ---------------------------------------------------------------------------
# the limb arithmetic
# ---------------------------------------------------------------------------

def _operands(seed=3, shape=(16, 8, 12)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-10.0, 10.0, shape) * np.exp(rng.uniform(-6.0, 6.0, shape))
    b = rng.uniform(0.1, 10.0, shape)
    return a, b


def _limbs(x):
    """Both limbs of a TwoFloat of either package as float32 numpy."""
    if isinstance(x, pmf.TwoFloat):
        return x.hi.float().numpy(), x.lo.float().numpy()
    return np.asarray(x.hi.astype(jnp.float32)), np.asarray(x.lo.astype(jnp.float32))


def _pair(a, b):
    return ((jmf.TwoFloat.from_array(jnp.asarray(a), jnp.bfloat16),
             jmf.TwoFloat.from_array(jnp.asarray(b), jnp.bfloat16)),
            (pmf.TwoFloat.from_array(torch.from_numpy(a)),
             pmf.TwoFloat.from_array(torch.from_numpy(b))))


OPS = {
    "from_array": lambda x, y, m: x,
    "add": lambda x, y, m: x + y,
    "sub": lambda x, y, m: x - y,
    "mul": lambda x, y, m: x * y,
    "div": lambda x, y, m: x / y,
    "add_number": lambda x, y, m: 0.37 + x,
    "sub_from_number": lambda x, y, m: 1.3 - x,
    "mul_number": lambda x, y, m: (13.0 / 12.0) * x,
    "number_over": lambda x, y, m: 1.0 / y,
    "over_number": lambda x, y, m: x / (40.0 * 35.16504 / 35.0),
    "square": lambda x, y, m: x ** 2,
    "neg": lambda x, y, m: -x,
    "sqrt": lambda x, y, m: m.sqrt(y),
    "where": lambda x, y, m: m.where(x > 0.0, x, y),
    "where_number": lambda x, y, m: m.where(x > 0.0, x, 0.5),
    "roll": lambda x, y, m: m.roll(x, 2, 1),
    "cat": lambda x, y, m: m.cat([x, y], 2),
}


class _JaxFns:
    sqrt = staticmethod(jmf.mf_sqrt)
    where = staticmethod(jmf.mf_where)
    roll = staticmethod(jmf.mf_roll)
    cat = staticmethod(jmf.mf_concatenate)


class _PortFns:
    sqrt = staticmethod(torch.sqrt)
    where = staticmethod(torch.where)
    roll = staticmethod(lambda a, s, d: torch.roll(a, s, dims=d))
    cat = staticmethod(lambda xs, d: torch.cat(xs, dim=d))


@pytest.mark.parametrize("op", list(OPS))
def test_limb_arithmetic_bit_for_bit_with_jax(op):
    (ja, jb), (pa, pb) = _pair(*_operands())
    got = OPS[op](pa, pb, _PortFns)
    want = OPS[op](ja, jb, _JaxFns)
    assert isinstance(got, pmf.TwoFloat) and got.dtype == torch.bfloat16
    for g, w in zip(_limbs(got), _limbs(want)):
        np.testing.assert_array_equal(g, w)


def test_plain_tensor_operands_and_comparisons():
    """A plain tensor on either side is split into limbs first, as JAX's
    ``_coerce`` does; comparisons return the float32 value's."""
    a, b = _operands(4)
    (ja, _), (pa, _) = _pair(a, b)
    bt = torch.from_numpy(b.astype(np.float32))
    bj = jnp.asarray(b.astype(np.float32))
    for got, want in ((bt + pa, ja + bj), (bt - pa, bj - ja), (bt * pa, ja * bj),
                      (bt / pa, bj / ja), (pa / bt, ja / bj)):
        for g, w in zip(_limbs(got), _limbs(want)):
            np.testing.assert_array_equal(g, w)
    for got, want in ((pa > 0.0, ja > 0.0), (pa < bt, ja < bj), (pa >= 1.0, ja >= 1.0),
                      (pa <= pa, ja <= ja)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(pa.to(torch.float64).numpy(),
                                  np.asarray(ja.to_array(jnp.float64)))


@pytest.mark.parametrize("keepdim", [False, True])
@pytest.mark.parametrize("axis", [0, 2])
def test_cumsum_and_sum(axis, keepdim):
    """The promoted limbs' float32 running sums, re-split, against JAX's
    (another order of addition) within 2 float32 ulps of each partial sum's
    magnitude per term plus 2^-16 of the value; the sum is the last running
    sum; on limbs whose float32 sums are exact, bit for bit."""
    (ja, _), (pa, _) = _pair(*_operands(5, (40, 6, 30)))
    got = torch.cumsum(pa, dim=axis)
    hi, lo = _limbs(pa)
    n = pa.shape[axis]
    scale = np.cumsum(np.abs(hi.astype(np.float64) + lo), axis=axis)
    gv = got.to(torch.float64).numpy()
    tol = 2 * n * np.finfo(np.float32).eps * scale + 2.0 ** -16 * np.abs(gv)
    jv = np.asarray(jmf.mf_cumsum(ja, axis).to_array(jnp.float64))
    assert (np.abs(gv - jv) <= tol).all()
    total = pa.sum(dim=axis, keepdim=keepdim)
    jt = np.asarray(jmf.mf_sum(ja, axis, keepdims=keepdim).to_array(jnp.float64))
    last = np.take(gv, [-1] if keepdim else -1, axis=axis)
    np.testing.assert_array_equal(total.to(torch.float64).numpy(), last)
    assert (np.abs(total.to(torch.float64).numpy() - jt)
            <= np.take(tol, [-1] if keepdim else -1, axis=axis)).all()
    # bf16 values within a factor 100 of each other, 16 terms: float32 sums exact
    (_, ja), (_, pa) = _pair(*_operands(6, (16, 8, 12)))
    pa, ja = pa * 0.0 + pa.hi, ja * 0.0 + ja.hi  # one significant limb each
    for g, w in zip(_limbs(torch.cumsum(pa, dim=axis)), _limbs(jmf.mf_cumsum(ja, axis))):
        np.testing.assert_array_equal(g, w)


def test_unknown_function_raises():
    (_, _), (pa, _) = _pair(*_operands())
    with pytest.raises(TypeError, match="no rule"):
        torch.exp(pa)
    with pytest.raises(ValueError, match="bf16x2"):
        pmf.wrap_compute(torch.ones(2), "f32x2")


def test_numbers_become_limb_pairs():
    """A Python number meets limbs as the pair ``from_array`` makes of it
    (rounded to float32, then split), not rounded once to bfloat16:
    TEOS-10's coefficients keep ~16 bits."""
    c = 8.0189615746e02
    x = pmf.TwoFloat.from_array(torch.ones(3, dtype=torch.float64))
    got = (x * c).to(torch.float64)
    hi = float(torch.tensor(c, dtype=torch.float32).to(torch.bfloat16))
    assert (got != hi).all()
    assert abs(float(got[0]) - c) < 2.0 ** -15 * c


# ---------------------------------------------------------------------------
# the tendency precision ladder and the tendencies against JAX's
# ---------------------------------------------------------------------------

def _ladder_setup():
    grid = simple_latitude_longitude_grid(24, 16, 8, device="cpu", dtype=torch.float64)
    cfg = baroclinic_instability_config()
    state = baroclinic_instability_state(grid, noise_velocity=1e-3)

    def r32(x):  # every mode consumes the same float32-representable values
        return x.float().double()

    ue, ve = r32(extend_field(grid, state.u, "u")), r32(extend_field(grid, state.v, "v"))
    tr_e = {k: r32(extend_field(grid, c, "c")) for k, c in state.tracers.items()}
    return cfg, grid, r32(coriolis_ff(grid, cfg.coriolis)), ue, ve, tr_e


def _port_tendency(cfg, grid, f_ff, ue, ve, tr_e, mode):
    if mode == "bf16x2":
        def conv(x):
            return pmf.wrap_compute(x, mode)
    else:
        dt = {"f64": torch.float64, "f32": torch.float32, "bf16": torch.bfloat16}[mode]

        def conv(x):
            return x.to(dt)
    grid_c = grid.cast(mode if mode == "bf16x2" else conv(grid.dxc).dtype)
    Gu, Gv, Gtr = tendency_math(cfg, grid_c, conv(f_ff), conv(ue), conv(ve),
                                {k: conv(c) for k, c in tr_e.items()})
    return [pmf.unwrap_compute(grid.interior(x), torch.float64).numpy()
            for x in (Gu, Gv, *(Gtr[k] for k in sorted(Gtr)))]


def _err(got, ref):
    return max(np.max(np.abs(g - r)) / (np.max(np.abs(r)) + 1e-300) for g, r in zip(got, ref))


def test_tendency_precision_ladder():
    """tests/test_multifloat.py::test_tendency_precision_ladder's bf16x2
    bounds on the port: bf16x2 within bf16 / 50 and 1e-2 of float64."""
    args = _ladder_setup()
    ref = _port_tendency(*args, "f64")
    errs = {m: _err(_port_tendency(*args, m), ref) for m in ("f32", "bf16", "bf16x2")}
    assert errs["bf16x2"] < errs["bf16"] / 50, errs
    assert errs["bf16x2"] < 1e-2, errs
    assert errs["f32"] < errs["bf16x2"], errs


def t(a):
    """A JAX-layout array as a port tensor (axes reversed)."""
    return torch.from_numpy(np.array(np.transpose(np.asarray(a))))


def _jax_tendency(cfg, grid, f_ff, ue, ve, tr_e, mode):
    """JAX's tendency_math, op by op, in bf16x2 limbs (grid wrapped as its
    hydrostatic step wraps it) or in float64; interior, sorted tracers, the
    port's layout, float64."""
    if mode == "bf16x2":
        def conv(x):
            return jmf.wrap_compute(x, mode)
    else:
        def conv(x):
            return jnp.asarray(x, jnp.float64)
    grid_c = jax.tree_util.tree_map(
        lambda x: conv(x) if jnp.issubdtype(x.dtype, jnp.floating) else x, grid)
    with jax.disable_jit():
        Gu, Gv, Gtr = jax_tendency_math(cfg, grid_c, conv(f_ff), conv(ue), conv(ve),
                                        {k: conv(c) for k, c in tr_e.items()})
    hx, hy, hz = grid.halo

    def crop(a):
        a = np.asarray(jmf.unwrap_compute(a, jnp.float64))
        return np.transpose(a[hx:-hx, hy:-hy, hz:-hz])

    return [crop(x) for x in (Gu, Gv, *(Gtr[k] for k in sorted(Gtr)))]


@pytest.mark.parametrize("case", ["flagship", "tripolar", "four_tracers"])
def test_bf16x2_tendencies_within_jax_own_distance(case):
    (cfg_j, gj), (cfg_t, gt), (f_ff, ue, ve, tr_e) = _k6_inputs(case, np.float32)
    ref = _jax_tendency(cfg_j, gj, f_ff, ue, ve, tr_e, "bf16x2")
    ref64 = _jax_tendency(cfg_j, gj, f_ff, ue, ve, tr_e, "f64")
    got = _port_tendency(cfg_t, gt, t(f_ff), t(ue), t(ve), {k: t(c) for k, c in tr_e.items()},
                         "bf16x2")
    names = ["Gu", "Gv", *sorted(tr_e)]
    for name, g, w, w64 in zip(names, got, ref, ref64):
        own = np.abs(w - w64).max()
        assert own > 0.0, name
        _assert_within(name, g, w, 2 * own)


def _check_own_distance(port, ref, ref64):
    """Each field within twice JAX's own distance between its bf16x2 and
    float64-compute steps, and at least the float32 mode's 1e-4 of its
    largest value."""
    assert list(port) == list(ref)
    for name in ref:
        want = ref[name].astype(np.float64)
        own = np.abs(want - ref64[name].astype(np.float64)).max()
        _assert_within(name, port[name].astype(np.float64), want,
                       max(2 * own, 1e-4 * np.abs(want).max()))


def _with(cfg, mode, kernels):
    return dataclasses.replace(cfg, compute_dtype=mode, kernels=kernels)


@functools.lru_cache(maxsize=None)
def _flagship_jax(mode, kernels, dtype=jnp.float32):
    """JAX's flagship state at 64x16x8 and its step in ``mode`` on its
    ``kernels`` route ("pallas": K6 in interpret mode)."""
    mp = pytest.MonkeyPatch()
    mp.delenv("GB25_BAROTROPIC_BLOCK", raising=False)
    mp.setattr(jax_pallas_tendency, "pallas_tendencies",
               functools.partial(jax_pallas_tendency.pallas_tendencies, interpret=True))
    try:
        gj = jax_latlon(64, 16, 8, dtype=dtype)
        sj = jax_state(gj, noise_velocity=1e-3)
        step = jax.jit(functools.partial(jax_time_step, _with(jax_config(), mode, kernels)))
        return _jax_arrays(sj), _jax_arrays(step(gj, sj, DT))
    finally:
        mp.undo()


def _flagship_port(mode, kernels, init, dtype=torch.float32):
    grid = simple_latitude_longitude_grid(64, 16, 8, device="cpu", dtype=dtype)
    cfg = dataclasses.replace(baroclinic_instability_config(), compute_dtype=mode,
                              kernels={"jnp": "torch", "zslab": "auto"}.get(kernels, kernels))
    return state_to_numpy(loop(cfg, grid, state_from_numpy(init, "cpu"), DT, 1))


@pytest.mark.parametrize("kernels", ["jnp", "pallas"])
def test_bf16x2_flagship_step_within_jax_own_distance(kernels):
    (init, ref), (_, ref64) = (_flagship_jax("bf16x2", kernels),
                               _flagship_jax("float64", kernels))
    _check_own_distance(_flagship_port("bf16x2", kernels, init), ref, ref64)


def test_bf16x2_catke_tripolar_climate_step_within_jax_own_distance():
    (cj, gj, aj, sj), (ct, gt, at, st) = _models(8.0, 8, torch.float32,
                                                 grid_type="gaussian_islands_tripolar")
    refs = {mode: _jax_arrays(jax.jit(functools.partial(
        jax_coupled_time_step, dataclasses.replace(
            cj, ocean=_with(cj.ocean, mode, "jnp"))))(gj, aj, sj, DT))
        for mode in ("bf16x2", "float64")}
    ct = dataclasses.replace(ct, ocean=dataclasses.replace(ct.ocean, compute_dtype="bf16x2"))
    assert ct.ocean.array_dtype == "bf16x2" and gt.north_fold
    port = state_to_numpy(coupled_time_step(ct, gt, at, st, DT))
    _check_own_distance(port, refs["bf16x2"], refs["float64"])


def test_bf16x2_on_tiles():
    gj = jax_latlon(32, 16, 8, dtype=jnp.float32)
    init = _jax_arrays(jax_state(gj, noise_velocity=1e-3))
    grid = simple_latitude_longitude_grid(32, 16, 8, device="cpu", dtype=torch.float32)
    cfg = dataclasses.replace(baroclinic_instability_config(), compute_dtype="bf16x2")
    _tiles_vs_serial(cfg, grid, init)


def test_grid_limb_cast_is_kept():
    """``grid.cast("bf16x2")``: every floating field as limbs, integer and
    boolean fields as they are, built once and kept in the grid's cache."""
    _, gt, _, _ = data_free_ocean_climate_model(resolution=8.0, Nz=4, device="cpu",
                                                grid_type="gaussian_islands_tripolar")
    g2 = gt.cast("bf16x2")
    assert g2 is gt.cast("bf16x2") and "bf16x2" in COMPUTE_DTYPES
    for f in dataclasses.fields(gt):
        x = getattr(gt, f.name)
        if torch.is_tensor(x):
            y = getattr(g2, f.name)
            if x.is_floating_point():
                assert isinstance(y, pmf.TwoFloat), f.name
                assert torch.equal(y.hi, x.to(torch.bfloat16)), f.name
            else:
                assert y is x, f.name
    assert isinstance(g2.geometry.u_mask, pmf.TwoFloat)


# ---------------------------------------------------------------------------
# a float64 state on the K6 route
# ---------------------------------------------------------------------------

def test_float64_state_on_pallas_matches_jax():
    """A float64 state under kernels="pallas" with no compute_dtype: JAX
    runs K6 on float64 operands (interpret mode), the port K6's float64
    twin (its plain version here), one step at 1e-10."""
    init, ref = _flagship_jax(None, "pallas", jnp.float64)
    port = _flagship_port(None, "pallas", init, torch.float64)
    assert port["u"].dtype == np.float64
    compare_states(ref, port, rtol=1e-10, verbose=False)
