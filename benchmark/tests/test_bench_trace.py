"""The reading of a profiled window's Chrome trace (``trace.window_of``):
only what starts inside the host range around the active calls counts, a
stage's time is the device's busy time inside its ``step/*`` range (its
waits on the host do not count), and a trace without such a range cannot
give one."""

import pytest

from benchmark import trace


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _events():
    return [
        # a thrown-away call before the active range: not counted
        _x("k_warm", "kernel", 10.0, 50.0),
        _x(trace.ACTIVE, "user_annotation", 100.0, 1000.0),
        # two steps; each step/teos10 range holds two kernels with a 300 us
        # wait on the host between them
        _x("step/teos10", "gpu_user_annotation", 200.0, 400.0),
        _x("k_a", "kernel", 200.0, 50.0),
        _x("k_b", "kernel", 550.0, 50.0),
        _x("step/teos10", "gpu_user_annotation", 700.0, 200.0),
        _x("k_a", "kernel", 700.0, 100.0),
        _x("memset", "gpu_memset", 750.0, 100.0),  # overlaps k_a: counted once
        _x("k_c", "kernel", 950.0, 100.0),          # outside the stage
        _x("launch", "cuda_runtime", 400.0, 100.0),
    ]


def test_stage_time_is_the_busy_time_inside_its_range():
    w = trace.window_of(_events(), wall=1e-3, steps=2)
    # (50 + 50) + (150: 700-850 merged) us over 2 steps
    assert w.stage_busy_ms() == {"step/teos10": pytest.approx(0.125)}
    assert w.launches("k_a") == 2 and w.launches("k_warm") == 0
    assert w.busy_s() == pytest.approx((50 + 50 + 150 + 100) / 1e6)
    assert w.kernel_ms_per_step("k_c") == pytest.approx(0.05)
    assert w.idle_gaps(1) == [["launch", pytest.approx(300e-6)]]


def test_a_trace_without_stage_ranges_gives_none():
    events = [e for e in _events() if e["cat"] != "gpu_user_annotation"]
    with pytest.raises(RuntimeError, match="step/"):
        trace.window_of(events, wall=1e-3, steps=2).stage_busy_ms()


def test_profiled_on_the_cpu_reads_its_own_window():
    calls = []

    def call():
        calls.append(1)
        return 3

    w, (before, after) = trace.profiled(call, 2, marks=lambda: len(calls))
    assert (before, after) == (1, 3) and w.steps == 6 and w.wall_s > 0
