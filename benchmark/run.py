"""One run of one cell of the port's benchmark, on the machine it starts on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's program from its configuration, warms up and captures
everything the timed path replays (set-up, timed from the process's start),
runs the timed path for ``--seconds`` seconds, then holds what it produced
to the plain reference (``check``) and prints the result as the last line
of standard output: ``correct``, ``attempted`` (the window's steps),
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer metrics), ``device`` and, traced, ``breakdown``; last,
``checks``, each number compared beside its limit, which also end standard
error. Exits with a code other than 0, and prints no result, without a
CUDA card or with fewer cards than the cell asks for, and when the JAX
package or JAX itself is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import check, spec, trace  # noqa: E402
from benchmark.counts.shape import Shape  # noqa: E402
from benchmark.drivers import velocity_noise  # noqa: E402

T_IMPORTED = time.perf_counter()  # torch and the harness imported

# whole top-level module names that must not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "gb25_tpu")
PROFILED_CALLS = 2  # whole replayed calls in the traced window
HOST_STEPS = 2      # steps launched from the host for the stage spans
RESULT_KEYS = ("correct", "attempted", "failed", "metrics", "device", "breakdown", "checks")


class NoCard(RuntimeError):
    pass


def card_check(chips):
    """Raise ``NoCard`` unless ``chips`` CUDA cards are visible."""
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: the benchmark measures the port on the card only")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards, {torch.cuda.device_count()} visible")


def memory_peak(device):
    """The run's peak allocated device memory, bytes (0 off the card)."""
    return torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0


def forbidden_modules():
    """The loaded modules whose top-level name is a forbidden one."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def device_launches():
    """Each hand-written kernel's launches on the device so far, by its CUDA
    source: the wrappers' counts less what captures recorded plus what
    replays made (``models.device_loop.STATS.launches``)."""
    from gb25_tpu_torch.models import device_loop
    from gb25_tpu_torch.utils.cuda_build import launch_counts

    out = {}
    for kernel in launch_counts():
        out[kernel.source] = out.get(kernel.source, 0) + device_loop.STATS.launches(kernel)
    return out


def trace_layers(run, cell, shape, steps, wall):
    """The traced run's per-layer readings: ``PROFILED_CALLS`` whole calls of
    the timed path under the profiler after one traced and thrown away (its
    kernel launches held against the launch counters), then ``HOST_STEPS``
    steps launched from the host, after one thrown away, for each stage's
    device busy time inside its ``step/*`` range. Returns (metrics, busy
    and window seconds, breakdown)."""
    window, (before, after) = trace.profiled(lambda: run.profile(1), PROFILED_CALLS,
                                              marks=device_launches)
    for source, symbol in trace.KERNEL_SYMBOLS.items():
        counted = after.get(source, 0) - before.get(source, 0)
        seen = window.launches(symbol)
        if counted != seen:
            raise RuntimeError(f"the profiler saw {seen} launches of {symbol}, the launch "
                               f"counters {counted}: the trace lost records")
    host, _ = trace.profiled(lambda: run.host_steps(1), HOST_STEPS)
    spans = host.stage_busy_ms()
    ctx = types.SimpleNamespace(shape=shape, steps=steps, wall_s=wall, profiled=window,
                                spans=spans,
                                stats=run.stats, workload=cell.workload, config=cell.config)
    metrics = {}
    for m in cell.per_layer:
        value = spec.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    busy = {"busy_s": window.busy_s(), "window_s": window.wall_s}
    return metrics, busy, {"device_ops": window.top_ops(), "idle_gaps": window.idle_gaps()}


def compare(cell, seed, device, out, snapshot, iteration, last_steps, euler):
    """Every reading of the comparison (``check``), by name."""
    c = cell.config
    model = spec.reference(c["name"]).build(c, cell.workload["route"], device, torch.float64)
    u, v = velocity_noise((c["Nz"], c["Ny"], c["Nx"]), seed, c["noise_velocity"], device)
    first = model.steps(model.with_velocity(u.double(), v.double()), 1)
    found = check.readings("euler", euler, model.fields(first), model.prognostic)
    del first, u, v
    start = model.from_fields(snapshot, iteration)
    snapshot.clear()
    ref = model.steps(start, last_steps)
    del start
    found.update(check.readings("step", out, model.fields(ref), model.prognostic))
    return found


def measure(cell, seed, seconds, traced, device="cuda", t_start=None, control=None,
            marks=()):
    """Set-up, the window, the traced readings where ``traced``, then the
    comparison with the reference once the program is freed. Returns a
    dict of the end-to-end readings, the per-layer ones, the comparison and
    the window's steps. ``marks``: (name, ``time.perf_counter()``) of the
    set-up phases before this call, logged with the driver's."""
    t_start = time.perf_counter() if t_start is None else t_start
    c, w = cell.config, cell.workload
    run = spec.driver(w["driver"]).Run(c, w, seed, device, control)
    run.setup()
    setup_s = time.perf_counter() - t_start
    marks = [("start", t_start), *marks, *run.phases]
    log("set-up phases: " + ", ".join(f"{b[0]} {b[1] - a[1]:.3f} s"
                                      for a, b in zip(marks, marks[1:])))
    steps, wall = run.window(seconds, lambda: memory_peak(device))
    shape = Shape.of(c)
    rate = shape.cells * steps / wall
    log(f"window: {steps} steps in {wall:.6f} s, {wall / steps * 1e3:.6f} ms a step, "
        f"{rate:.6e} cell-steps/s, {steps * c['dt'] / wall / 365.0:.6f} simulated years a day "
        f"(SYPD); set-up {setup_s:.6f} s")
    peak = run.peak
    e2e = {"cell_steps_per_s": rate, "peak_mem_gib": peak / 2**30, "setup_s": setup_s}
    layers = trace_layers(run, cell, shape, steps, wall) if traced else None
    out, snapshot, euler = run.output(), run.snapshot, run.euler
    iteration, last_steps = run.snapshot_iteration, run.last_steps
    run.free()
    del run
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    found = compare(cell, seed, device, out, snapshot, iteration, last_steps, euler)
    return {"end_to_end": e2e, "layers": layers, "readings": found, "steps": steps,
            "peak_bytes": peak, "checked_steps": {"euler": 1, "step": last_steps}}


def passes(x):
    """A number at or under its limit (a NaN or an infinite gap fails)."""
    return math.isfinite(x["value"]) and x["value"] <= x["limit"]


def judge(readings, limits):
    """(correct, {name: {"value", "limit"}}) over the numbers ``limits``
    names, in its order."""
    out = {name: {"value": readings[name], "limit": limits[name]} for name in limits}
    return all(passes(x) for x in out.values()), out


def failed_steps(checks, checked_steps):
    """The steps the failed numbers cover: each point of the run ("euler",
    "step") once, however many of its fields fail."""
    return sum(checked_steps[p] for p in {n.split(".")[0] for n, x in checks.items()
                                          if not passes(x)})


def result_line(correct, attempted, failed, metrics, device, checks, breakdown=None):
    """The result's JSON line: the contract's keys, ``checks`` last."""
    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return json.dumps(line)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = spec.benchmark()
    cell = spec.Cell(bench, args.workload)
    try:
        card_check(cell.entry["chips"])
    except NoCard as e:
        log(f"benchmark: {e}")
        return 2
    marks = (("torch", T_IMPORTED), ("card", time.perf_counter()))
    r = measure(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START,
                marks=marks)
    correct, checks = judge(r["readings"], cell.workload["limits"])
    failed = failed_steps(checks, r["checked_steps"])
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
              "memory_peak_bytes": r["peak_bytes"]}
    if args.trace:
        metrics, busy, breakdown = r["layers"]
        device.update(busy)
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in r["end_to_end"].items()
                   if k in units}
        breakdown = None
    found = forbidden_modules()
    if found:
        log(f"benchmark: loaded in this process, and not allowed: {', '.join(found)}")
        return 3
    log("readings: " + ", ".join(f"{k} {g!r}" for k, g in r["readings"].items()))
    for name, x in checks.items():
        log(f"{name} {x['value']!r} limit {x['limit']!r}")
    print(result_line(correct, r["steps"], failed, metrics, device, checks, breakdown),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
