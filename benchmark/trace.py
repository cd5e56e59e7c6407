"""Reading a ``torch.profiler`` trace: the arithmetic of the port's
``utils/profiling.py`` (``step_breakdown``: the ``step/*`` ranges, device
time by kernel name), frozen here, read from the Chrome trace of a
profiled window with its timeline: device busy time as the union of
kernel, copy and memset intervals (in the whole window and inside each
``step/*`` range), the idle gaps and what the host was doing in each."""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import tempfile
import time

import torch

# each hand-written kernel's device symbol, by the CUDA source that holds it
# (the port's ``utils/profiling.KERNELS``)
KERNEL_SYMBOLS = {
    "zslab_tendencies.cu": "zslab_tendencies_kernel",
    "tendencies.cu": "tendency_stage_kernel",
    "barotropic_loop.cu": "barotropic_loop_",
    "barotropic_block.cu": "barotropic_block_kernel",
    "implicit_diffusion.cu": "implicit_diffusion_kernel",
    "catke_diffusivities.cu": "catke_diffusivities_kernel",
    "keps_diffusivities.cu": "keps_diffusivities_kernel",
}

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("user_annotation", "cpu_op", "python_function", "cuda_runtime")


@dataclasses.dataclass
class Window:
    """A profiled window: its wall seconds, the steps it ran, its device
    intervals (name, start us, duration us), its host intervals (name,
    start us, duration us, category) and its device-side stage ranges
    (name, start us, duration us)."""

    wall_s: float
    steps: int
    device: list
    host: list
    ranges: list

    def stage_busy_ms(self):
        """Each ``step/*`` range's device busy time, ms a step: the union of
        the device intervals that start inside each of its occurrences (one
        stream runs them in order), cut at its end, summed. Idle time
        inside a range (the device waiting on the host's launches) does not
        count. Raises where the trace holds no such range."""
        if not self.ranges:
            raise RuntimeError("the trace holds no device-side step/* range: no stage to read")
        out = {}
        for name, t, d in self.ranges:
            within = [(n, s, min(s + e, t + d) - s) for n, s, e in self.device
                      if t <= s <= t + d]
            busy = sum(b - a for a, b in _union(within))
            out[name] = out.get(name, 0.0) + busy / 1e3 / self.steps
        return out

    def kernel_ms_per_step(self, symbol):
        """Device ms a step of the kernels whose name holds ``symbol``;
        None where none ran."""
        durs = [d for name, _, d in self.device if symbol in name]
        return sum(durs) / 1e3 / self.steps if durs else None

    def launches(self, symbol):
        return sum(1 for name, _, _ in self.device if symbol in name)

    def busy_s(self):
        """The union of the device intervals, in seconds."""
        return sum(b - a for a, b in _union(self.device)) / 1e6

    def top_ops(self, n=10):
        """The ``n`` device operations that took most time: [name, seconds]."""
        total = collections.Counter()
        for name, _, d in self.device:
            total[name] += d / 1e6
        return [[name, s] for name, s in total.most_common(n)]

    def idle_gaps(self, n=10):
        """The ``n`` longest gaps between device intervals inside the window,
        each named by the innermost host interval that spans its middle:
        [name, seconds]."""
        spans = _union(self.device)
        gaps = [(b0, a1) for (_, b0), (a1, _) in zip(spans, spans[1:]) if a1 > b0]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            mid = 0.5 * (a + b)
            inside = [(d, name) for name, t, d, _ in self.host if t <= mid <= t + d]
            out.append([min(inside)[1] if inside else "host: no traced activity",
                        (b - a) / 1e6])
        return out


def _union(intervals):
    """Merged [start, end] of (name, start, duration) intervals, in order."""
    merged = []
    for _, t, d in sorted(intervals, key=lambda x: x[1]):
        if merged and t <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t + d)
        else:
            merged.append([t, t + d])
    return merged


ACTIVE = "benchmark/active"  # the host range around the profiled calls that count
STAGE = "step/"  # the prefix of the port's stage ranges


def profiled(call, active, warmup=1, marks=None):
    """Run ``call()`` (which returns the steps it ran) ``warmup`` + ``active``
    times under ``torch.profiler`` (CPU and, where the process uses a card,
    CUDA activity), the active calls inside the host range ``ACTIVE``. Only
    what starts inside that range counts: the first graph launch under the
    profiler waits ~10 ms on the tracer, which no run without it pays, and
    the warm-up calls' kernels stay out of the counts. ``marks()``, where
    given, is read just before and just after the active calls. Returns (a
    ``Window`` of the active calls, the two marks). The Chrome trace goes
    to the temporary directory and is deleted once read."""
    from torch.profiler import ProfilerActivity, profile, record_function

    card = torch.cuda.is_available() and torch.cuda.is_initialized()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    steps = 0
    with profile(activities=activities) as prof:
        for _ in range(warmup):
            call()
        _synchronize(card)
        before = marks() if marks else None
        t0 = time.perf_counter()
        with record_function(ACTIVE):
            for _ in range(active):
                steps += call()
            _synchronize(card)
        wall = time.perf_counter() - t0
        after = marks() if marks else None
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return window_of(events, wall, steps), (before, after)


def window_of(events, wall, steps):
    """The ``Window`` of the Chrome trace ``events`` inside the host range
    ``ACTIVE``: its device intervals, its host intervals and the
    device-side ``step/*`` ranges (``gpu_user_annotation``)."""
    events = [e for e in events if e.get("ph") == "X" and "dur" in e]
    (start, length), = [(float(e["ts"]), float(e["dur"])) for e in events
                        if e["name"] == ACTIVE and e.get("cat") in HOST_CATEGORIES]
    inside = [e for e in events if start <= float(e["ts"]) <= start + length]
    device = [(e["name"], float(e["ts"]), float(e["dur"])) for e in inside
              if e.get("cat") in DEVICE_CATEGORIES]
    host = [(e["name"], float(e["ts"]), float(e["dur"]), e["cat"]) for e in inside
            if e.get("cat") in HOST_CATEGORIES and e["name"] != ACTIVE]
    ranges = [(e["name"], float(e["ts"]), float(e["dur"])) for e in inside
              if e.get("cat") == "gpu_user_annotation" and e["name"].startswith(STAGE)]
    return Window(wall, steps, device, host, ranges)


def _synchronize(card):
    if card:
        torch.cuda.synchronize()
