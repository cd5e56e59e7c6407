"""The port's flagship step against the JAX package's.

float64, 3 steps (an Euler step and two AB2 steps) against JAX
``time_step`` with kernels="jnp" and GB25_BAROTROPIC_BLOCK=1 (the wall
conditions re-imposed every substep, as K2 does). The port runs the fused
form (x* = x + dt c1 G + dt c2 G_prev, forcing (Us - U0)/dt) where the JAX
array path forms c1 G + c2 G_prev first, so only reassociation differs:
1e-10 of each field's largest value.

float32, one step against JAX with kernels="zslab" and
GB25_ZSLAB_INTERPRET=1 (its Pallas kernels in interpret mode), at the
rtol 1e-3 / atol 5e-6 of tests/test_zslab.py. One step, not three: in
float32 the TEOS-10 anomaly (rho' ~ 1028 against rho0 = 1020) keeps ~1e-6
of rounding noise in b, which the pressure integral carries into the
tendencies, so two float32 programs that round b differently (torch and
XLA) part by ~1e-5 in u after three steps. JAX's own float32 run parts
from its float64 run by the same amount; the float64 comparison above is
the tight one.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gb25_tpu.grids import simple_latitude_longitude_grid as jax_grid
from gb25_tpu.models import baroclinic_instability_config as jax_config
from gb25_tpu.models import baroclinic_instability_state as jax_state
from gb25_tpu.models import time_step as jax_time_step
from gb25_tpu.utils.correctness import _leaf_names
from gb25_tpu_torch.convert import state_from_numpy, state_to_numpy
from gb25_tpu_torch.grids import simple_latitude_longitude_grid
from gb25_tpu_torch.models import baroclinic_instability_config, loop, time_step
from gb25_tpu_torch.utils.correctness import compare_states

DT = 60.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _run_both(shape, jdtype, tdtype, kernels, steps=3):
    gj = jax_grid(*shape, dtype=jdtype)
    sj = jax_state(gj, noise_velocity=1e-3)
    gt = simple_latitude_longitude_grid(*shape, device="cpu", dtype=tdtype)
    st = state_from_numpy(_jax_arrays(sj), "cpu")

    cfg_j = dataclasses.replace(jax_config(), kernels=kernels)
    step = jax.jit(jax_time_step)
    for _ in range(steps):
        sj = step(cfg_j, gj, sj, DT)
    st = loop(baroclinic_instability_config(), gt, st, DT, steps)
    return _jax_arrays(sj), state_to_numpy(st)


def test_three_steps_match_jax_array_path_f64(monkeypatch):
    monkeypatch.setenv("GB25_BAROTROPIC_BLOCK", "1")
    monkeypatch.delenv("GB25_ZSLAB_INTERPRET", raising=False)
    ref, port = _run_both((32, 16, 8), jnp.float64, torch.float64, "jnp")
    assert list(port) == list(ref)
    compare_states(ref, port, rtol=1e-10, verbose=False)
    assert int(port["iteration"]) == 3


def test_step_matches_jax_kernels_f32(monkeypatch):
    monkeypatch.setenv("GB25_ZSLAB_INTERPRET", "1")
    ref, port = _run_both((128, 32, 8), jnp.float32, torch.float32, "zslab", steps=1)
    for name in ref:
        np.testing.assert_allclose(port[name], ref[name], rtol=1e-3, atol=5e-6, err_msg=name)


def test_step_is_time_step_repeated():
    """``loop`` is ``time_step`` n times, bit for bit."""
    gt = simple_latitude_longitude_grid(16, 8, 4, device="cpu", dtype=torch.float64)
    sj = jax_state(jax_grid(16, 8, 4, dtype=jnp.float64), noise_velocity=1e-3)
    s0 = state_from_numpy(_jax_arrays(sj), "cpu")
    cfg = baroclinic_instability_config()
    a = loop(cfg, gt, s0, DT, 2)
    b = time_step(cfg, gt, time_step(cfg, gt, s0, DT), DT)
    compare_states(state_to_numpy(a), state_to_numpy(b), rtol=0.0, verbose=False)


def test_import_without_jax_or_triton():
    """The port imports with jax and triton blocked and without a GPU."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['triton'] = None\n"
        "import gb25_tpu_torch\n"
        "import gb25_tpu_torch.convert, gb25_tpu_torch.utils.correctness\n"
        "import gb25_tpu_torch.ops.pallas_zslab, gb25_tpu_torch.ops.pallas_barotropic\n"
        "import gb25_tpu_torch.ops.pallas_catke, gb25_tpu_torch.ops.pallas_tridiag\n"
        "import gb25_tpu_torch.models.coupled, gb25_tpu_torch.utils.profiling\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules"
        " if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_advance_clock_matches_jax(dtype):
    """The Kahan clock rounds as the JAX package's, bit for bit, and its
    compensated value stays within a second of the exact sum."""
    from gb25_tpu.models.state import advance_clock as jax_advance_clock
    from gb25_tpu_torch.models import advance_clock

    tj = lj = jnp.zeros((), dtype)
    tt = lt = torch.zeros((), dtype=getattr(torch, np.dtype(dtype).name))
    for _ in range(3000):
        tj, lj = jax_advance_clock(tj, lj, jnp.asarray(DT, dtype))
        tt, lt = advance_clock(tt, lt, DT)
    assert float(tt) == float(tj) and float(lt) == float(lj)
    assert abs(float(tt) - float(lt) - 3000 * DT) <= 1.0


def test_compare_states_reports_and_raises():
    from gb25_tpu.utils.correctness import default_rtol as jax_default_rtol
    from gb25_tpu_torch.utils.correctness import default_rtol

    for dt in (np.float32, np.float64, np.int32):
        assert default_rtol(dt) == jax_default_rtol(dt)
    a = {"u": np.ones((2, 3)), "iteration": np.asarray(3, np.int32)}
    b = {"u": np.ones((2, 3)) * (1 + 1e-9), "iteration": np.asarray(3, np.int32)}
    report = compare_states(a, b, rtol=1e-8, verbose=False)
    assert [r[0] for r in report] == ["u", "iteration"]
    with pytest.raises(AssertionError, match="u"):
        compare_states(a, b, rtol=1e-10, verbose=False)
