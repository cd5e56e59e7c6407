"""Where K1's buoyancy comes from, on the CPU (one torch thread, 32x16x4).

A step makes the eager buoyancy (``pallas_zslab.column_buoyancy`` under
``step/teos10``) wherever K1 does not make b itself. With CATKE and with
k-epsilon, whose N^2 reads b, it is made once and K4 and K1 receive the
same tensor. With no closure, on the kernel route (``uses_kernel`` made to
say so here, where the wrapper then runs its plain version), TEOS-10's b
of T and S and the b tracer are left to the kernel: the step calls it
never, opens no ``step/teos10`` span and hands K1 no b. The linear
equation of state under the flagship's schemes, whose compiled instance
makes TEOS-10's b alone, and the plain route (the CPU's own) keep the
eager b. All on the fused route and on the unfused one (the explicit free
surface). Which calls make b (``pallas_zslab.makes_b``): no b handed in,
float32 storage, at most two tracers, TEOS-10 on the compiled instance.
K1's launches counted by where b came from (``b_own_share``, the flag on
``KERNEL``; the kernel's launch stubbed) and the profiling CLI's line.
"""

import dataclasses

import pytest
import torch

from gb25_tpu_torch import baroclinic_instability_model
from gb25_tpu_torch.models import ExplicitFreeSurface, hydrostatic
from gb25_tpu_torch.models.baroclinic import buoyancy_tracer_state
from gb25_tpu_torch.models.catke import CATKEVerticalDiffusivity
from gb25_tpu_torch.models.keps import TKEDissipationVerticalDiffusivity
from gb25_tpu_torch.ops import pallas_zslab
from gb25_tpu_torch.ops.eos import LinearEquationOfState
from gb25_tpu_torch.utils import profiling, tracing

CLOSURES = {"none": None, "b_tracer": None, "linear": None, "catke": CATKEVerticalDiffusivity,
            "keps": TKEDissipationVerticalDiffusivity}


@pytest.fixture(autouse=True)
def _one_torch_thread_and_tracer_off():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.disable()
    yield
    tracing.disable()
    torch.set_num_threads(n)


def _model(case, route):
    closure = CLOSURES[case]
    cfg, grid, state = baroclinic_instability_model(
        32, 16, 4, device="cpu", closure=None if closure is None else closure())
    if case == "b_tracer":
        cfg = dataclasses.replace(cfg, tracers=("b",))
        state = buoyancy_tracer_state(state, grid)
    if case == "linear":
        cfg = dataclasses.replace(cfg, eos=LinearEquationOfState())
    if route == "unfused":
        cfg = dataclasses.replace(cfg, free_surface=ExplicitFreeSurface())
    return cfg, grid, state


@pytest.mark.parametrize("kernel_route", [True, False], ids=["kernel", "plain"])
@pytest.mark.parametrize("route", ["fused", "unfused"])
@pytest.mark.parametrize("case", list(CLOSURES))
def test_eager_buoyancy_only_where_k1_does_not_make_b(case, route, kernel_route, monkeypatch):
    cfg, grid, state = _model(case, route)
    made, k1_b, k4_b = [], [], []
    column_buoyancy, zslab_tendencies = hydrostatic.column_buoyancy, hydrostatic.zslab_tendencies

    def counted_column_buoyancy(*args):
        made.append(column_buoyancy(*args))
        return made[-1]

    def seen_zslab_tendencies(*args, **kw):
        k1_b.append(kw.get("buoyancy"))
        return zslab_tendencies(*args, **kw)

    def closure_kernel(real):
        def seen(cfg, grid, ue, ve, be, *rest):
            k4_b.append(be)
            return real(cfg, grid, ue, ve, be, *rest)
        return seen

    monkeypatch.setattr(hydrostatic, "uses_kernel", lambda *args: kernel_route)
    monkeypatch.setattr(hydrostatic, "column_buoyancy", counted_column_buoyancy)
    monkeypatch.setattr(hydrostatic, "zslab_tendencies", seen_zslab_tendencies)
    for name in ("catke_diffusivities_kernel", "keps_diffusivities_kernel"):
        monkeypatch.setattr(hydrostatic, name, closure_kernel(getattr(hydrostatic, name)))
    tracing.enable("cpu")
    out = hydrostatic.time_step(cfg, grid, state, 10.0)
    spans = tracing.snapshot()
    tracing.disable()
    assert all(torch.isfinite(t).all() for t in (out.u, out.v, out.eta))
    assert len(k1_b) == 1 and "step/K1_tendencies" in spans
    if kernel_route and case in ("none", "b_tracer"):
        assert made == [] and k4_b == [] and k1_b == [None]
        assert "step/teos10" not in spans
        return
    assert len(made) == 1 and spans["step/teos10"]["count"] == 1
    be, b_total = made[0]
    assert k1_b[0][0] is be and k1_b[0][1] is b_total
    assert k4_b == ([] if CLOSURES[case] is None else [be])


def test_which_calls_make_b():
    cfg, _, _ = _model("none", "fused")
    ts, b = {"T": None, "S": None}, {"b": None}
    assert pallas_zslab.makes_b(cfg, ts) and pallas_zslab.makes_b(cfg, b)
    assert not pallas_zslab.makes_b(cfg, {"b": None, "e": None})  # compiled, not TEOS-10
    assert not pallas_zslab.makes_b(cfg, {"T": None, "S": None, "e": None})
    assert not pallas_zslab.makes_b(cfg, ts, storage=torch.bfloat16)
    linear = dataclasses.replace(cfg, eos=LinearEquationOfState())
    assert not pallas_zslab.makes_b(linear, ts)  # the compiled instance makes TEOS-10's alone
    assert pallas_zslab.makes_b(dataclasses.replace(linear, tracer_advection="centered2"), ts)


def test_own_b_names_the_tracers_and_scalars():
    cfg, grid, state = _model("none", "fused")
    own = pallas_zslab.own_b(cfg, {"S": None, "T": None})
    assert (own.mode, own.iT, own.iS) == (0, 1, 0)
    assert own.rho0 == pytest.approx(cfg.eos.rho0) and own.neg_g == pytest.approx(-cfg.eos.g)
    bcfg, _, _ = _model("b_tracer", "fused")
    own = pallas_zslab.own_b(bcfg, {"b": None})
    assert (own.mode, own.iT, own.iS) == (2, 0, 0)


def test_b_own_share_counts_flagged_launches(monkeypatch):
    monkeypatch.setattr(pallas_zslab.KERNEL, "call", lambda *args: None)
    before = pallas_zslab.b_launches()
    assert pallas_zslab.b_own_share(before) is None
    assert profiling.b_source_line(before) is None
    for flag in ("own_b", "own_b", "own_b", None):
        pallas_zslab.KERNEL.launch("zslab_tendencies_f32", flag=flag)
    assert pallas_zslab.b_own_share(before) == 0.75
    line = profiling.b_source_line(before)
    assert "75.0%" in line and "3 made" in line and "1 read" in line
