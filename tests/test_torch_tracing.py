"""The port's tracer (``utils.tracing``) on the CPU, where a stamp reads
the host clock and drives the same bookkeeping as on the card.

- off (the default): ``span`` is a plain ``torch.profiler`` range, no stamp
  is launched, nothing is recorded and the device loop's graph key holds
  None where the tracer's table would be;
- on, over host-launched steps of a tiny flagship and of a tiny coupled
  step with slab sea ice on the tripolar grid: each stage's count is 3
  times its count in one step (1 a step, ``step/seaice`` 2), self time is
  at most the total, ``step/north_fold``'s parent is the barotropic span,
  and the ``step`` root's own time and its stages' self times add up to
  the root;
- a tiny ``Simulation`` opens one ``sim/chunk`` and one ``loop/call`` a
  chunk, the call inside the chunk;
- the graph key differs with the tracer on and off, and between two
  ``enable`` calls;
- with the graph emulated (tests/test_torch_device_loop.py): the replayed
  steps take ``loop/replay`` as their parent, ``LoopStats.copy_bytes``
  counts the state's bytes each way a call, and the boundary reading
  finds one boundary between two calls, its idle time all put down to
  named spans or to none;
- the boundary reading on made-up stamps: the copies come off the
  boundary, each idle instant goes to the innermost host span open then
  (or to none), and one whose next work was already launched is also
  counted as the card's own (queued);
- ``tracing.stamped`` reads only the timed calls, and turns the tracer
  off; ``analysis.trace.range_busy_ms`` on a made-up trace.
On the card (marked ``cuda``, skipped here): ``copy_bytes`` of real
replays, a capture anew once the tracer is enabled after a capture, the
stamps counting one ``step/K1_tendencies`` a replayed step over 3 replays,
and, on a 360x160x8 and a 1440x640x16 k-epsilon flagship (its closure reads
b, so its step keeps the eager buoyancy), the replayed TEOS-10 time
within 3% of CUDA events recorded in the same graph around the same span,
and within 10% of its device busy time in steps launched from the host,
and a call's stamps within 2% of CUDA events around it.
"""

import dataclasses
import functools

import pytest
import torch

from gb25_tpu_torch import baroclinic_instability_model, data_free_ocean_climate_model
from gb25_tpu_torch.models import device_loop as dl
from gb25_tpu_torch.models import loop
from gb25_tpu_torch.models.coupled import coupled_ice_time_step
from gb25_tpu_torch.models.hydrostatic import premask_state, time_step
from gb25_tpu_torch.models.keps import TKEDissipationVerticalDiffusivity
from gb25_tpu_torch.models.seaice import initial_ice_state
from gb25_tpu_torch.simulation import Simulation
from gb25_tpu_torch.utils import tracing

DT = 60.0


@pytest.fixture(autouse=True)
def _one_torch_thread_and_tracer_off():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.disable()
    yield
    tracing.disable()
    torch.set_num_threads(n)


def _flagship(n=32, m=16, nz=4, device="cpu", **config_kw):
    cfg, grid, state = baroclinic_instability_model(n, m, nz, device=device, **config_kw)
    step = functools.partial(time_step, cfg, grid, dt=DT, premasked=True)
    return cfg, grid, premask_state(grid, state), step


def _coupled_ice():
    ccfg, grid, atmos, state = data_free_ocean_climate_model(
        resolution=8.0, Nz=4, device="cpu", grid_type="gaussian_islands_tripolar",
        sea_ice="slab")
    state, ice = premask_state(grid, state), initial_ice_state(grid)

    def steps(n):
        nonlocal state, ice
        for _ in range(n):
            state, ice = coupled_ice_time_step(ccfg, grid, atmos, state, ice, DT,
                                               premasked=True)
    return steps


def _flagship_steps():
    _, _, state, step = _flagship()

    def steps(n):
        nonlocal state
        state = dl.host_loop(step, state, n)
    return steps


MODELS = {"flagship": _flagship_steps, "coupled_ice_tripolar": _coupled_ice}


def test_off_is_a_plain_range():
    from torch.profiler import record_function

    assert tracing.stamping() is None
    assert isinstance(tracing.span("step/teos10"), record_function)
    assert tracing.kept() == ()
    cfg, grid, state, step = _flagship()
    before = tracing.KERNEL.launches
    key = dl._key(step, dl._tensors(state), dl.BLOCK_STEPS)
    out = loop(cfg, grid, state, DT, 2)
    assert tracing.KERNEL.launches == before
    assert tracing.snapshot() == {} and tracing.boundary_attribution() is None
    assert key[-1] is None and key == dl._key(step, dl._tensors(out), dl.BLOCK_STEPS)


@pytest.mark.parametrize("model", list(MODELS))
def test_each_stage_counted_each_step(model):
    steps = MODELS[model]()
    tracing.enable("cpu")
    steps(1)  # the Euler step
    tracing.reset()
    steps(1)
    one = tracing.snapshot()
    tracing.reset()
    steps(3)
    three = tracing.snapshot()
    stages = [k for k in one if k.startswith("step/")]
    assert "step/teos10" in stages and "step/K2_barotropic" in stages
    assert set(three) == set(one)
    for name, s in three.items():
        want = 2 if name == "step/seaice" else 1
        assert one[name]["count"] == want, name
        assert s["count"] == 3 * want and s["host_count"] == s["count"], name
        assert 0 <= s["self_ms"] <= s["total_ms"] + 1e-9, name
    assert three["step"]["parent"] is None
    assert all(three[k]["parent"] in ("step", "step/K2_barotropic") for k in stages)


def test_nested_spans_add_up_to_the_root():
    steps = MODELS["coupled_ice_tripolar"]()
    tracing.enable("cpu")
    steps(1)
    tracing.reset()
    steps(2)
    snap = tracing.snapshot()
    assert snap["step/north_fold"]["parent"] == "step/K2_barotropic"
    bt = snap["step/K2_barotropic"]
    assert bt["self_ms"] == pytest.approx(bt["total_ms"] - snap["step/north_fold"]["total_ms"])
    root = snap["step"]
    children = sum(s["total_ms"] for s in snap.values() if s["parent"] == "step")
    assert root["self_ms"] == pytest.approx(root["total_ms"] - children)
    selfs = sum(s["self_ms"] for k, s in snap.items() if k.startswith("step/"))
    assert selfs + root["self_ms"] == pytest.approx(root["total_ms"])


def test_simulation_spans_each_chunk():
    cfg, grid, state, _ = _flagship()
    sim = Simulation(cfg, grid, state, DT, stop_iteration=2, inner_steps=2)
    sim.run()
    tracing.enable("cpu")
    sim.stop_iteration = 8
    sim.run()  # 3 chunks of 2 steps
    snap = tracing.snapshot()
    assert snap["sim/chunk"]["count"] == 3 and snap["loop/call"]["count"] == 3
    assert snap["loop/call"]["parent"] == "sim/chunk"
    assert snap["step"]["count"] == 6 and snap["step"]["parent"] == "loop/call"
    for name in ("sim/schedule", "sim/callbacks", "sim/writers"):
        assert snap[name]["parent"] is None, name


def test_graph_key_follows_the_tracer():
    _, _, state, step = _flagship()
    tensors = dl._tensors(state)
    off = dl._key(step, tensors, 4)
    tracing.enable("cpu")
    on = dl._key(step, tensors, 4)
    tracing.enable("cpu")
    again = dl._key(step, tensors, 4)
    tracing.disable()
    assert off != on and on != again and off == dl._key(step, tensors, 4)
    assert on[:-1] == off[:-1]


class _EmulatedGraph:
    """A captured block on the CPU (tests/test_torch_device_loop.py): its
    steps from the static state, the result copied back into it."""

    def __init__(self, step, state, static, block):
        self.step, self.state, self.static, self.block = step, state, static, block

    def replay(self):
        out = dl._tensors(dl.host_loop(self.step, dl._with_tensors(self.state, self.static),
                                       self.block))
        for field, t in out.items():
            if t is not self.static[field]:
                self.static[field].copy_(t)


def _emulated_capture(step, state, block, key, cache):
    static = {field: t.clone() for field, t in dl._tensors(state).items()}
    dl.STATS.captures += 1
    dl.STATS.captured_steps += block
    return dl._Captured(_EmulatedGraph(step, state, static, block), static, key,
                        dl._kept(step, cache), {})


def test_emulated_replays_copies_and_boundary(monkeypatch):
    monkeypatch.setattr(dl, "_on_card", lambda tensors: True)
    monkeypatch.setattr(dl, "_capture", _emulated_capture)
    _, grid, state, step = _flagship()
    block = 2
    state = dl.device_loop(step, state, block + 1, grid.cache, block)  # Euler step, capture
    tracing.enable("cpu")
    state = dl.device_loop(step, state, block + 1, grid.cache, block)  # captures anew
    tracing.reset()
    dl.STATS.reset()
    for _ in range(2):
        state = dl.device_loop(step, state, 2 * block, grid.cache, block)
    nbytes = sum(t.numel() * t.element_size() for t in dl._tensors(state).values())
    assert dl.STATS.copy_bytes == 2 * 2 * nbytes  # in and out, each of the 2 calls
    assert dl.STATS.captures == 0
    snap = tracing.snapshot()
    assert snap["loop/replay"]["count"] == 2 and snap["loop/replay"]["parent"] == "loop/call"
    assert snap["step"]["count"] == 8 and snap["step"]["parent"] == "loop/replay"
    assert snap["loop/copy_in"]["count"] == snap["loop/own"]["count"] == 2
    b = tracing.boundary_attribution()
    assert b["boundaries"] == 1 and b["dropped"] == 0
    assert b["boundary_ms"] == pytest.approx(b["copy_ms"] + b["idle_ms"])
    assert b["idle_ms"] == pytest.approx(sum(b["named_ms"].values()) + b["unnamed_ms"])
    assert 0 <= b["queued_ms"] <= b["idle_ms"]
    assert set(b["named_ms"]) <= {"loop/call", "loop/own", "loop/copy_in", "loop/replay"}


def test_boundary_reading_on_made_up_stamps():
    """Two calls, the host ahead through the first (its close runs after
    the clone), then waiting in ``sim/callbacks`` for the card, then in
    ``sim/schedule``; ns on one clock."""
    t = tracing.Tracer(torch.device("cpu"))
    names = ["loop/call", "loop/copy_in", "loop/replay", "loop/own", "sim/callbacks",
             "sim/schedule"]
    slot = {n: i + 1 for i, n in enumerate(names)}
    t.slots.update({(n, None): slot[n] for n in names})
    occ = [  # name, depth, host t0, t1, device open, close
        ("loop/copy_in", 1, 1, 2, 3, 8), ("loop/replay", 1, 3, 4, 8, 50),
        ("loop/own", 1, 5, 6, 50, 58), ("loop/call", 0, 0, 30, 0, 58),
        ("sim/callbacks", 0, 31, 90, 58, 90), ("sim/schedule", 0, 92, 100, 92, 100),
        ("loop/copy_in", 1, 102, 103, 103, 110), ("loop/replay", 1, 111, 112, 112, 150),
        ("loop/call", 0, 101, 130, 101, 150),
    ]
    for name, depth, t0, t1, a, b in occ:
        cell = len(t.occurrences) * 2
        t.clock.log[cell], t.clock.log[cell + 1] = a, b
        t.occurrences.append(tracing._Occurrence(slot[name], depth, t0, t1, t0, t1, cell,
                                                 cell + 1))
    t.cells = 2 * len(occ)
    b = {k: v * 1e6 if isinstance(v, float) else v for k, v in t.boundary_attribution().items()}
    assert b["boundaries"] == 1
    assert (b["boundary_ms"], b["copy_ms"], b["idle_ms"]) == pytest.approx((62, 15, 47))
    got = {k: round(v * 1e6, 6) for k, v in t.boundary_attribution()["named_ms"].items()}
    assert got == {"sim/callbacks": 32, "sim/schedule": 8, "loop/call": 2, "loop/copy_in": 1,
                   "loop/replay": 1}
    assert (b["queued_ms"], b["unnamed_ms"]) == pytest.approx((2, 3))


def test_stamped_reads_the_timed_calls_alone():
    _, _, state, step = _flagship()
    held = {"state": state}

    def steps(n):
        held["state"] = dl.host_loop(step, held["state"], n)
        return n

    out, seconds, snap, boundary = tracing.stamped(lambda: steps(2), lambda: steps(3))
    assert out == 3 and seconds > 0 and boundary is None
    assert snap["step"]["count"] == 3 and snap["step/teos10"]["count"] == 3
    assert tracing.stamping() is None


def test_range_busy_ms_unions_the_kernels_inside():
    from gb25_tpu_torch.analysis.trace import range_busy_ms

    def x(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    events = [x("gpu_user_annotation", "step/teos10", 100, 50),
              x("gpu_user_annotation", "step/teos10", 300, 20),
              x("gpu_user_annotation", "step/K1_tendencies", 200, 90),
              x("kernel", "a", 100, 10), x("kernel", "b", 105, 10), x("kernel", "c", 130, 40),
              x("gpu_memcpy", "d", 310, 5), x("kernel", "e", 90, 20), x("kernel", "f", 200, 80)]
    # 100-115 and 130-150 (cut at its end) in the first, 310-315 in the second
    assert range_busy_ms(events, "step/teos10") == pytest.approx(40e-3)
    assert range_busy_ms(events, "step/K1_tendencies") == pytest.approx(80e-3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the stamps run on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_copy_bytes_each_way(cuda):
    cfg, grid, state, _ = _flagship(64, 32, 8, "cuda")
    state = loop(cfg, grid, state, DT, dl.BLOCK_STEPS + 1)
    dl.STATS.reset()
    state = loop(cfg, grid, state, DT, dl.BLOCK_STEPS)
    nbytes = sum(t.numel() * t.element_size() for t in dl._tensors(state).values())
    assert (dl.STATS.replays, dl.STATS.captures) == (1, 0)
    assert dl.STATS.copy_bytes == 2 * nbytes


@pytest.mark.cuda
def test_card_enable_after_capture_captures_again(cuda):
    cfg, grid, state, _ = _flagship(64, 32, 8, "cuda")
    state = loop(cfg, grid, state, DT, dl.BLOCK_STEPS + 1)
    dl.STATS.reset()
    state = loop(cfg, grid, state, DT, dl.BLOCK_STEPS)
    assert dl.STATS.captures == 0
    tracing.enable()
    state = loop(cfg, grid, state, DT, dl.BLOCK_STEPS + 1)
    assert dl.STATS.captures == 1
    torch.cuda.synchronize()
    tracing.disable()
    state = loop(cfg, grid, state, DT, dl.BLOCK_STEPS + 1)
    assert dl.STATS.captures == 2


@pytest.mark.cuda
def test_card_stamps_count_replayed_steps(cuda):
    cfg, grid, state, _ = _flagship(64, 32, 8, "cuda")
    state = loop(cfg, grid, state, DT, 1)
    tracing.enable()
    state = loop(cfg, grid, state, DT, dl.BLOCK_STEPS + 1)
    torch.cuda.synchronize()
    tracing.reset()
    dl.STATS.reset()
    state = loop(cfg, grid, state, DT, 3 * dl.BLOCK_STEPS)
    torch.cuda.synchronize()
    snap = tracing.snapshot()
    assert dl.STATS.replays == 3 and dl.STATS.eager_steps == 0
    assert snap["step/K1_tendencies"]["count"] == 3 * dl.BLOCK_STEPS
    assert snap["step"]["count"] == 3 * dl.BLOCK_STEPS
    assert snap["loop/replay"]["count"] == 1
    assert 0 < snap["step"]["total_ms"] <= snap["loop/replay"]["total_ms"]
    stages = sum(s["self_ms"] for k, s in snap.items() if k.startswith("step/"))
    assert stages + snap["step"]["self_ms"] == pytest.approx(snap["step"]["total_ms"])


class _EventSpan:
    """A span that also records a CUDA event pair around itself, each
    event a node of the graph under capture (``external``), so it keeps
    the times of the graph's latest replay."""

    def __init__(self, inner, marks):
        self.inner = inner
        self.pair = tuple(torch.cuda.Event(enable_timing=True, external=True)
                          for _ in range(2))
        marks.append(self.pair)

    def __enter__(self):
        self.inner.__enter__()
        self.pair[0].record()
        return self

    def __exit__(self, *exc):
        self.pair[1].record()
        return self.inner.__exit__(*exc)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(360, 160, 8), (1440, 640, 16)])
def test_card_replayed_teos10_matches_host_launched(cuda, size, monkeypatch, tmp_path):
    """The stamps' ``step/teos10`` a replayed step against, first, CUDA
    events recorded inside the same captured graph around the same span,
    read after each of the same replays (the stamps time what the card
    ran), and the stamped ``loop/call`` against CUDA events around each
    call; then against the device busy time inside the span in steps
    launched from the host (the union of its kernels, as the benchmark's
    ``teos10_ms`` reads it). As in the benchmark's stamped phase, 2 calls
    after the capture are thrown away first. At 360x160x8 the fields stay
    in the card's 50 MB L2; at 1440x640x16 they do not."""
    from gb25_tpu_torch.analysis import trace
    from gb25_tpu_torch.models import hydrostatic
    from gb25_tpu_torch.utils.profiling import with_profiler

    marks = []  # an event pair for each step/teos10 a capture records

    def span(name):
        inner = tracing.span(name)
        if name != "step/teos10" or not torch.cuda.is_current_stream_capturing():
            return inner
        return _EventSpan(inner, marks)

    monkeypatch.setattr(hydrostatic, "span", span)
    cfg, grid, state, step = _flagship(*size, "cuda",
                                       closure=TKEDissipationVerticalDiffusivity())
    state = loop(cfg, grid, state, DT, 1)
    tracing.enable()
    state = loop(cfg, grid, state, DT, dl.BLOCK_STEPS + 1)
    assert len(marks) == dl.BLOCK_STEPS
    state = loop(cfg, grid, state, DT, 2 * dl.BLOCK_STEPS)
    torch.cuda.synchronize()
    tracing.reset()
    dl.STATS.reset()
    event_ms = call_ms = 0.0
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        state = loop(cfg, grid, state, DT, dl.BLOCK_STEPS)
        end.record()
        torch.cuda.synchronize()
        call_ms += start.elapsed_time(end)
        event_ms += sum(a.elapsed_time(b) for a, b in marks)
    snap = tracing.snapshot()
    tracing.disable()
    assert (dl.STATS.replays, dl.STATS.eager_steps) == (3, 0)
    teos = snap["step/teos10"]
    assert teos["count"] == 3 * dl.BLOCK_STEPS
    replayed_ms = teos["total_ms"] / teos["count"]
    event_ms /= teos["count"]
    assert replayed_ms == pytest.approx(event_ms, rel=0.03)
    assert snap["loop/call"]["total_ms"] == pytest.approx(call_ms, rel=0.02)
    state = dl.host_loop(step, state, 1)
    with with_profiler(str(tmp_path)):
        state = dl.host_loop(step, state, 2)
    path, = trace.find_trace_files(str(tmp_path))
    busy_ms = trace.range_busy_ms(trace.read_events(path), "step/teos10") / 2
    assert replayed_ms == pytest.approx(busy_ms, rel=0.1), (
        f"replayed {replayed_ms} ms a step by the stamps, {event_ms} by CUDA events in the same "
        f"graph; host-launched busy {busy_ms}")


def test_span_names_in_models_go_through_the_tracer():
    """No ``record_function`` is left in the models: every span is a
    ``tracing.span``."""
    from pathlib import Path

    import gb25_tpu_torch.models as models

    for path in Path(models.__file__).parent.glob("*.py"):
        assert "record_function" not in path.read_text(), path.name


def test_dataclass_stats_reset_clears_copy_bytes():
    dl.STATS.copy_bytes = 5
    dl.STATS.reset()
    assert dataclasses.asdict(dl.STATS)["copy_bytes"] == 0
