"""Every ``compute_dtype`` on the coupled climate (the tripolar grid with
the Gaussian islands, CATKE, 48x24x8, its float64 state at rest), as
``bench.py --config climate --compute-dtype`` sets its ocean's, against
the JAX package's own mode: one step each, by the protocol and at the
tolerances of tests/test_torch_closure_precision.py, which holds the
k-epsilon flagship the same way (the two models in two files, so that
xdist's workers share the JAX steps' cost).

Under "float32" the float64 climate's K4 reads the float64 fields and
their float64 buoyancy, as JAX's closure does, not K1's float32 copies (a
float32 b would move N^2 by a float32 ulp, whose sign decides the
diffusivities): the buoyancy K4 is handed is float64 and equal to the
state's own.
"""

import pytest
import torch

from gb25_tpu_torch.convert import state_from_numpy
from gb25_tpu_torch.models import coupled_time_step, hydrostatic
from gb25_tpu_torch.ops.halos import extend_field
from test_torch_climate import _jax_arrays
from test_torch_closure_precision import (
    DT,
    SCALES,
    check_bfloat16_step,
    check_mode_step,
    jax_model,
    with_mode,
)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: beside other busy
    test processes, torch's default of one OpenMP thread per core made the
    plain versions' many small launches ~100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode", list(SCALES))
def test_climate_step_matches_jax_mode(mode):
    check_mode_step("climate", mode)


def test_climate_bfloat16_step_within_jax_own_distance():
    check_bfloat16_step("climate")


def test_float32_mode_hands_k4_the_state_buoyancy(monkeypatch):
    cj, gj, aj, sj, ct, gt, at = jax_model("climate")
    st = state_from_numpy(_jax_arrays(sj), "cpu")
    seen = []
    real = hydrostatic.catke_diffusivities_kernel

    def spy(cfg, grid, ue, ve, be, e):
        seen.append(be)
        return real(cfg, grid, ue, ve, be, e)

    monkeypatch.setattr(hydrostatic, "catke_diffusivities_kernel", spy)
    coupled_time_step(with_mode("climate", ct, "float32", "auto"), gt, at, st, DT)
    (be,) = seen
    want = hydrostatic.buoyancy_field(ct.ocean, gt, {
        k: extend_field(gt, c, "c") for k, c in st.tracers.items()})
    assert be.dtype == torch.float64 and torch.equal(be, want)
