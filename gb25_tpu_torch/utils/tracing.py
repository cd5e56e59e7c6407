"""The port's in-program tracer: named spans over a step's stages, the
device loop's call boundary and the production driver's chunk boundary.

``span(name)`` is a ``torch.profiler`` range (``record_function``), so a
profiled run names its stages and boundaries. Off, the default, that is
all it is: it launches nothing, reads no clock and allocates nothing.

``enable()`` turns the tracer on (``disable()`` off). Each span then also
  - stamps the device where it opens and where it closes
    (``csrc/trace_stamp.cu``: the device clock into the span's slot of a
    table on the device). A stamp captured into a CUDA graph runs again at
    every replay and the stamps accumulate, so one host read after any
    number of replays gives each stage's device time in replayed steps,
    the launch gaps between its kernels included. On a CPU device a stamp
    reads the host clock, so the same bookkeeping runs there;
  - reads the host's ``time.perf_counter_ns()`` at entry and at exit
    (where it runs from the host: a capture only records its stamps);
  - records its parent: the innermost span open on the host where it
    opened; inside a capture, the ``loop/replay`` that will replay it
    (``parent``).
A slot is a (name, parent) pair. ``snapshot()`` gives, by name, the device
total and self ms (the total less the part its child spans cover), the
count, the parent (the one under which it took most time), and the host ms
and count. ``reset()`` zeroes them in place, since a captured graph holds
the table's address. ``boundary_attribution()`` reads the device loop's
call boundaries: the device time from the close of one call's last
``loop/replay`` to the open of the next call's first, less the copies
stamped inside it, is put down, on the host's clock (``enable`` and
``reset`` place the device clock on it), to the innermost host span open
at each idle instant; the part of it where the host had already launched
the card's next work (the card's own gap) is also counted apart.
``stamped(capture, timed)`` is the stamped read of a timed path: the
tracer on, its graphs captured anew, the timed calls read, the tracer off.

The device loop keys its graphs by ``stamping()`` (None while off), so
enabling or disabling the tracer makes the next call capture anew rather
than replay a graph recorded with another table, or none.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import ctypes
import itertools
import time

import torch
from torch.profiler import record_function

from gb25_tpu_torch.utils.cuda_build import CudaKernel

_P = ctypes.c_void_p
_I = ctypes.c_int

KERNEL = CudaKernel("trace_stamp.cu", {"trace_stamp": [_P, _I, _I, _I, _P, _P]})

SLOTS = 512        # distinct (name, parent) pairs a tracer holds
LOG_CELLS = 1 << 16  # stamps of host-launched spans kept for the boundary reading
_CLOCK_SLOT = 0    # the slot the clock's calibration stamps
_CALIBRATIONS = 8  # stamps bracketed by host clock reads; the narrowest bracket is kept

_TRACER = None
_GENERATION = itertools.count(1)


def span(name: str):
    """A named span: a ``torch.profiler`` range, and with the tracer on
    (``enable``) also its device stamps, host times and parent."""
    if _TRACER is None:
        return record_function(name)
    return _Span(_TRACER, name)


def parent(name: str):
    """Inside it, spans take ``name`` as their parent without a span of
    that name being open: the device loop records its graphs' steps under
    the ``loop/replay`` that replays them. Nothing while the tracer is
    off."""
    if _TRACER is None:
        return contextlib.nullcontext()
    return _TRACER.within(name)


def enable(device=None):
    """Turn the tracer on, with a fresh table on ``device`` (the card where
    one is visible, else the CPU); builds or loads the stamp kernel on a
    card. Returns the tracer."""
    global _TRACER
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    _TRACER = Tracer(torch.device(device))
    return _TRACER


def disable():
    """Turn the tracer off; a graph captured with its stamps is never
    replayed again (``stamping`` keys it)."""
    global _TRACER
    _TRACER = None


def stamping():
    """The device loop's key of the tracer: None while off, else an id of
    this ``enable``'s table."""
    return None if _TRACER is None else _TRACER.generation


def kept() -> tuple:
    """What a graph captured now must keep alive: the tracer's device
    tables (empty while off)."""
    return () if _TRACER is None else _TRACER.clock.tensors()


def reset():
    """Zero the spans' totals, counts and occurrences and place the device
    clock on the host's again (as ``device_loop.STATS.reset``); call it
    with no span open, as a span open across it would close on a zeroed
    start."""
    if _TRACER is not None:
        _TRACER.reset()


def snapshot() -> dict:
    """Each span's readings since the last ``reset``, by name ({} while
    off): see ``Tracer.snapshot``."""
    return {} if _TRACER is None else _TRACER.snapshot()


def boundary_attribution():
    """The call boundaries since the last ``reset`` (None while off): see
    ``Tracer.boundary_attribution``."""
    return None if _TRACER is None else _TRACER.boundary_attribution()


def stamped(capture, timed):
    """The stamped read of a timed path: turn the tracer on, run
    ``capture()`` (which captures the path's graphs anew, now with the
    stamps, and runs whatever should not be read), zero the tracer, run
    ``timed()``, read, and turn the tracer off. The device is synchronized
    after each call. Returns (``timed()``'s result, its seconds through the
    synchronize, ``snapshot()``, ``boundary_attribution()``)."""
    tracer = enable()
    try:
        capture()
        tracer.clock.synchronize()
        reset()
        t0 = time.perf_counter()
        out = timed()
        tracer.clock.synchronize()
        seconds = time.perf_counter() - t0
        return out, seconds, snapshot(), boundary_attribution()
    finally:
        disable()


class _Span:
    """A span with the tracer on. Its host interval runs from entering the
    ``with`` to leaving it; ``opened`` and ``closed`` are the host times
    just after its two stamps were launched."""

    __slots__ = ("tracer", "name", "range", "slot", "host", "cell", "t0", "opened", "closed")

    def __init__(self, tracer, name):
        self.tracer, self.name = tracer, name
        self.range = record_function(name)

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        self.range.__enter__()
        self.tracer.open(self)
        return self

    def __exit__(self, *exc):
        try:
            cell = self.tracer.close(self)
        finally:
            self.range.__exit__(*exc)
        self.tracer.finish(self, cell, time.perf_counter_ns())
        return False


class _DeviceClock:
    """Stamps on the card: one launch of ``trace_stamp`` each, on the
    current stream (a capture's, under one)."""

    def __init__(self, device):
        KERNEL.load()
        self.device = device
        self.table = torch.zeros(3 * SLOTS, dtype=torch.int64, device=device)
        self.log = torch.zeros(LOG_CELLS, dtype=torch.int64, device=device)
        self.cal = torch.zeros(1, dtype=torch.int64, device=device)

    def tensors(self):
        return self.table, self.log, self.cal

    def stamp(self, slot, close, cell):
        log = None if cell < 0 else self.log.data_ptr() + 8 * cell
        self._launch(slot, close, log)

    def _launch(self, slot, close, log):
        with torch.cuda.device(self.device):
            KERNEL.launch("trace_stamp", self.table.data_ptr(), SLOTS, slot, int(close), log,
                          torch.cuda.current_stream(self.device).cuda_stream)

    def capturing(self):
        return torch.cuda.is_current_stream_capturing()

    def synchronize(self):
        torch.cuda.synchronize(self.device)

    def zero(self):
        self.table.zero_()

    def read(self, cells):
        return self.table.tolist(), self.log[:cells].tolist()

    def calibrate(self):
        """(device ns - host ns, the bracket's width in ns): a stamp
        launched on an idle card between two host clock reads around a
        synchronize, the narrowest of a few."""
        best = None
        for _ in range(_CALIBRATIONS):
            torch.cuda.synchronize(self.device)
            h0 = time.perf_counter_ns()
            self._launch(_CLOCK_SLOT, False, self.cal.data_ptr())
            torch.cuda.synchronize(self.device)
            h1 = time.perf_counter_ns()
            offset = int(self.cal.item()) - (h0 + h1) // 2
            if best is None or h1 - h0 < best[1]:
                best = (offset, h1 - h0)
        return best


class _HostClock:
    """Stamps on a CPU device: the host clock, in the same table layout."""

    def __init__(self):
        self.table = [0] * (3 * SLOTS)
        self.log = [0] * LOG_CELLS

    def tensors(self):
        return ()

    def stamp(self, slot, close, cell):
        now = time.perf_counter_ns()
        if close:
            self.table[SLOTS + slot] += now - self.table[slot]
            self.table[2 * SLOTS + slot] += 1
        else:
            self.table[slot] = now
        if cell >= 0:
            self.log[cell] = now

    def capturing(self):
        return False

    def synchronize(self):
        pass

    def zero(self):
        self.table = [0] * (3 * SLOTS)

    def read(self, cells):
        return list(self.table), self.log[:cells]

    def calibrate(self):
        return 0, 0


# a span run from the host: its slot, depth, host entry and exit (ns), the
# host times its two stamps had been launched by, and their log cells
_Occurrence = collections.namedtuple("_Occurrence", "slot depth t0 t1 opened closed open close")


class Tracer:
    """One ``enable``'s table and bookkeeping (see the module's doc)."""

    def __init__(self, device):
        self.device = device
        self.generation = next(_GENERATION)
        self.clock = _DeviceClock(device) if device.type == "cuda" else _HostClock()
        self.slots = {(None, None): _CLOCK_SLOT}  # (name, parent) -> slot
        self.stack = []  # the names of the spans open on the host, innermost last
        self.reset()

    def reset(self):
        self.clock.zero()
        self.host_ns = [0] * SLOTS
        self.host_count = [0] * SLOTS
        self.occurrences = []
        self.cells = 0
        self.dropped = 0  # occurrences past LOG_CELLS, left out of the boundary reading
        self.offset_ns, self.width_ns = self.clock.calibrate()

    @contextlib.contextmanager
    def within(self, name):
        self.stack.append(name)
        try:
            yield
        finally:
            self.stack.pop()

    def _slot(self, name):
        key = (name, self.stack[-1] if self.stack else None)
        slot = self.slots.get(key)
        if slot is None:
            if len(self.slots) >= SLOTS:
                raise RuntimeError(f"the tracer holds {SLOTS} (span, parent) pairs")
            slot = self.slots[key] = len(self.slots)
        return slot

    def _cell(self):
        if self.cells >= LOG_CELLS:
            return -1
        self.cells += 1
        return self.cells - 1

    def open(self, s):
        s.slot = self._slot(s.name)
        self.stack.append(s.name)
        s.host = not self.clock.capturing()
        s.cell = self._cell() if s.host else -1
        self.clock.stamp(s.slot, False, s.cell)
        s.opened = time.perf_counter_ns()

    def close(self, s):
        """Stamp the close; returns its log cell."""
        cell = self._cell() if s.host else -1
        self.clock.stamp(s.slot, True, cell)
        s.closed = time.perf_counter_ns()
        self.stack.pop()
        return cell

    def finish(self, s, cell, t1):
        if not s.host:
            return
        self.host_ns[s.slot] += t1 - s.t0
        self.host_count[s.slot] += 1
        if s.cell < 0 or cell < 0:
            self.dropped += 1
        else:
            self.occurrences.append(_Occurrence(s.slot, len(self.stack), s.t0, t1, s.opened,
                                                s.closed, s.cell, cell))

    def snapshot(self) -> dict:
        """By span name, since the last ``reset``: ``total_ms`` (device
        time between its stamps, summed), ``count`` (its closes on the
        device, replays included), ``self_ms`` (total less its child spans'
        totals), ``parent`` (the parent under which it took most device
        time; None at the root), ``host_ms`` and ``host_count`` (its runs
        from the host). Spans with nothing since the reset are left out."""
        table, _ = self.clock.read(0)
        out, children = {}, collections.Counter()
        for (name, par), slot in self.slots.items():
            if slot == _CLOCK_SLOT:
                continue
            total, count = table[SLOTS + slot], table[2 * SLOTS + slot]
            r = out.setdefault(name, {"total_ms": 0.0, "count": 0, "host_ms": 0.0,
                                      "host_count": 0, "parents": collections.Counter()})
            r["total_ms"] += total / 1e6
            r["count"] += count
            r["host_ms"] += self.host_ns[slot] / 1e6
            r["host_count"] += self.host_count[slot]
            r["parents"][par] += total + 1  # + 1: a parent seen with no time still counts
            if par is not None:
                children[par] += total
        snap = {}
        for name, r in out.items():
            if not (r["count"] or r["host_count"]):
                continue
            parents = r.pop("parents")
            snap[name] = {**r, "self_ms": r["total_ms"] - children[name] / 1e6,
                          "parent": max(parents, key=parents.get)}
        return snap

    def boundary_attribution(self):
        """The boundaries between consecutive ``loop/call`` spans that
        replayed: each from the device stamp that closed the call's last
        ``loop/replay`` to the one that opened the next call's first. Its
        idle time is the boundary less the device intervals of the copies
        (``loop/copy_in``, ``loop/own``) inside it. Each idle instant, on
        the host's clock, is put down to the innermost host span open then,
        and counted ``queued`` too where the next stamp the card ran after
        it had already been launched (the host was ahead: the gap is the
        card's own). Returns None with fewer than two such calls, else the
        mean a boundary of: ``boundary_ms``, ``copy_ms``, ``idle_ms``,
        ``named_ms`` (by host span), ``unnamed_ms`` (in no span; the two
        add up to ``idle_ms``) and ``queued_ms`` (of ``idle_ms``), with
        ``boundaries``, ``clock_uncertainty_ms`` (half the calibration's
        bracket) and ``dropped`` (spans past the log)."""
        _, log = self.clock.read(self.cells)
        names = {slot: name for (name, _), slot in self.slots.items()}
        occ = [(names[o.slot], o, log[o.open], log[o.close]) for o in self.occurrences]
        edges = []  # (first replay's open, last replay's close) of each call, device ns
        for name, c, _, _ in occ:
            if name != "loop/call":
                continue
            inner = [(a, b) for n, o, a, b in occ
                     if n == "loop/replay" and c.t0 <= o.t0 and o.t1 <= c.t1]
            if inner:
                edges.append((min(a for a, _ in inner), max(b for _, b in inner)))
        edges.sort()
        bounds = [(prev[1], nxt[0]) for prev, nxt in zip(edges, edges[1:])]
        if not bounds:
            return None
        host = [(o.t0, o.t1, o.depth, n) for n, o, _, _ in occ]
        # each stamp on the host's clock, beside the host time it was launched by
        stamps = sorted((d - self.offset_ns, h) for _, o, a, b in occ
                        for d, h in ((a, o.opened), (b, o.closed)))
        copied = [(a, b) for n, _, a, b in occ if n in ("loop/copy_in", "loop/own")]
        total = copy = queued = 0
        named = collections.Counter()
        for a, b in bounds:
            total += b - a
            busy = _clip(copied, a, b)
            copy += sum(y - x for x, y in busy)
            for x, y in _gaps(busy, a, b):
                for who, ahead, ns in _attribute(host, stamps, x - self.offset_ns,
                                                 y - self.offset_ns):
                    named[who] += ns
                    queued += ns if ahead else 0
        n = len(bounds)
        unnamed = named.pop(None, 0)
        return {"boundaries": n, "boundary_ms": total / n / 1e6, "copy_ms": copy / n / 1e6,
                "idle_ms": (total - copy) / n / 1e6,
                "named_ms": {k: v / n / 1e6 for k, v in named.most_common()},
                "unnamed_ms": unnamed / n / 1e6, "queued_ms": queued / n / 1e6,
                "clock_uncertainty_ms": self.width_ns / 2e6, "dropped": self.dropped}


def _clip(intervals, a, b):
    """The union of ``intervals`` ((start, end) pairs) cut to [a, b]."""
    out = []
    for x, y in sorted((max(x, a), min(y, b)) for x, y in intervals):
        if y <= x:
            continue
        if out and x <= out[-1][1]:
            out[-1][1] = max(out[-1][1], y)
        else:
            out.append([x, y])
    return out


def _gaps(busy, a, b):
    """[a, b] less the sorted, disjoint ``busy`` intervals inside it."""
    out, t = [], a
    for x, y in busy:
        if x > t:
            out.append((t, x))
        t = max(t, y)
    if b > t:
        out.append((t, b))
    return out


def _attribute(host, stamps, a, b):
    """(who, queued, ns) pieces of the card's idle [a, b] (host clock):
    ``who`` the innermost of the ``host`` spans ((t0, t1, depth, name)) open
    then, None where none is; ``queued`` where the next of the sorted
    ``stamps`` ((device time on the host's clock, host launch time)) after
    the piece had been launched before it."""
    host = [h for h in host if h[0] < b and h[1] > a]
    times = [t for t, _ in stamps]
    cuts = sorted({a, b, *(t for t0, t1, _, _ in host for t in (t0, t1) if a < t < b),
                   *(t for t in times if a < t < b)})
    out = []
    for x, y in zip(cuts, cuts[1:]):
        mid = (x + y) / 2
        nxt = bisect.bisect_right(times, mid)
        ahead = nxt < len(stamps) and stamps[nxt][1] <= mid
        open_ = [(depth, t0, name) for t0, t1, depth, name in host if t0 <= mid < t1]
        out.append((max(open_)[2] if open_ else None, ahead, y - x))
    return out
