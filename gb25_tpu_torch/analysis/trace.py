"""Summaries of ``torch.profiler`` traces (the port's counterpart of the
JAX package's ``analysis/xplane.py``, which decodes XSpace protobufs).

``utils.profiling.with_profiler`` writes each traced process's Chrome-trace
JSON (``*.pt.trace.json``) into a directory; ``summarize`` adds up the time
of each event name across the traces there, by default of the events that
ran on the device (kernels, copies, fills), and prints the largest:

    python -m gb25_tpu_torch.analysis.trace DIR [--top 20]

``range_busy_ms`` reads one trace's device busy time inside a span's range.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

# the Chrome-trace categories of work on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def find_trace_files(logdir):
    return sorted(glob.glob(os.path.join(logdir, "**", "*.pt.trace.json"), recursive=True))


def read_events(path) -> list:
    """The complete events ("ph": "X") of one Chrome-trace JSON."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in events if e.get("ph") == "X"]


def op_durations(events, category=None) -> dict:
    """Total duration [ms] per event name, largest first: of the device's
    events, or of those of ``category`` ("cpu_op", "user_annotation",
    "cuda_runtime", ...)."""
    cats = DEVICE_CATEGORIES if category is None else (category,)
    totals = {}
    for e in events:
        if e.get("cat") in cats:
            totals[e["name"]] = totals.get(e["name"], 0.0) + float(e.get("dur", 0.0)) / 1e3
    return dict(sorted(totals.items(), key=lambda kv: -kv[1]))


def range_busy_ms(events, name) -> float:
    """The device's busy time inside the device-side ranges ``name``
    (``gpu_user_annotation``: a ``utils.tracing.span`` as the card ran it),
    ms: the union of the device events that start inside each occurrence
    (one stream runs them in order), cut at its end, summed. The card's
    waits on the host's launches inside a range do not count."""
    total = 0.0
    for r in events:
        if r.get("cat") != "gpu_user_annotation" or r["name"] != name:
            continue
        a, b = float(r["ts"]), float(r["ts"]) + float(r["dur"])
        end = a
        for t, d in sorted((float(e["ts"]), float(e["dur"])) for e in events
                           if e.get("cat") in DEVICE_CATEGORIES and a <= float(e["ts"]) <= b):
            lo, hi = max(t, end), min(t + d, b)
            if hi > lo:
                total += hi - lo
                end = hi
    return total / 1e3


def summarize(logdir, top=20):
    """The ``top`` device event names by total time [ms] across every trace
    under ``logdir``: [(name, ms)]."""
    out = {}
    for path in find_trace_files(logdir):
        for name, ms in op_durations(read_events(path)).items():
            out[name] = out.get(name, 0.0) + ms
    return sorted(out.items(), key=lambda kv: -kv[1])[:top]


def main(argv=None):
    p = argparse.ArgumentParser(description="top events of the torch.profiler traces in a "
                                            "directory")
    p.add_argument("logdir")
    p.add_argument("--top", type=int, default=20)
    args = p.parse_args(argv)
    rows = summarize(args.logdir, args.top)
    total = sum(ms for _, ms in rows)
    print(f"{'ms':>12} {'share':>6}  name ({len(find_trace_files(args.logdir))} traces)")
    for name, ms in rows:
        print(f"{ms:12.3f} {100 * ms / total if total else 0.0:5.1f}%  {name[:110]}")
    return rows


if __name__ == "__main__":
    main()
