"""The stamped phase of a traced run: the timed path once more with the
port's tracer on (``gb25_tpu_torch.utils.tracing``), its graphs captured
anew with the spans' device stamps, which run again at every replay.

    stamps = stamped.phase(run, driver)

Run it after every other traced reading: it turns the tracer on, captures
the timed path's graphs again as ``Run.setup`` does (the loop
driver: one call of ``call_steps`` + 1 steps; the simulation driver: the
chunk that realigns the run on its chunks, then the chunk that captures
the lead graph and the one that captures the full graph), throws ``DISCARD``
calls away, zeroes the tracer and times ``CALLS`` whole calls of the timed
path (``run.profile``), the profiler off and the card synchronized at both
ends, then turns the tracer off (``tracing.stamped``). It leaves what the window produced
(``run.output()``, ``run.snapshot``, ``run.stats``) as it was.

It returns None where the port has no tracer, else ``ctx.stamps`` for the
readers of ``teos10_replayed_ms``, ``fluxes_replayed_ms``,
``call_boundary_ms`` and ``boundary_copy_gib``: a dict of
  - ``spans``: ``tracing.snapshot()`` over the stamped calls (each span's
    device total and self ms, count and parent);
  - ``steps``: the replayed steps of those calls, ``calls``: their number;
  - ``copy_bytes``: ``device_loop.STATS.copy_bytes`` over them;
  - ``boundary``: ``tracing.boundary_attribution()`` over them;
  - ``ms_per_step``: their wall ms a step.
Every step of the stamped calls is replayed: a call with an eager step
raises, as its host-launched stages would enter the replayed readings.
``log(stamps, window_ms)`` writes the per-stage table, the boundary and
the stamped calls' ms a step beside the untraced window's to standard
error.
"""

import sys

CALLS = 4    # the stamped calls read
DISCARD = 2  # calls thrown away after the captures


def recapture(run, driver):
    """Capture the timed path's graphs again, as ``Run.setup`` does."""
    if driver == "loop":
        run.state = run.loop(run.cfg, run.grid, run.state, run.dt, run.calls + 1)
        return
    sim = run.sim
    sim.stop_iteration = -(-sim.iteration // run.inner) * run.inner  # a whole chunk again
    sim.run()
    run.profile(2)  # the lead graph's chunk, then the full graph's


def phase(run, driver):
    try:
        from gb25_tpu_torch.utils import tracing
    except ImportError:
        return None
    from gb25_tpu_torch.models import device_loop

    s = device_loop.STATS

    def capture():
        recapture(run, driver)
        run.profile(DISCARD)

    def timed():
        before = (s.replayed_steps, s.eager_steps, s.copy_bytes)
        steps = run.profile(CALLS)
        return steps, [a - b for a, b in zip((s.replayed_steps, s.eager_steps, s.copy_bytes),
                                             before)]

    (steps, (replayed, eager, copied)), wall, spans, boundary = tracing.stamped(capture, timed)
    if eager or replayed != steps:
        raise RuntimeError(f"the stamped calls ran {eager} of their {steps} steps eagerly")
    return {"spans": spans, "steps": replayed, "calls": CALLS, "copy_bytes": copied,
            "boundary": boundary, "ms_per_step": 1e3 * wall / steps}


def log(stamps, window_ms):
    """The stamped calls' readings on standard error."""
    if stamps is None:
        return
    steps, spans = stamps["steps"], stamps["spans"]
    out = [f"stamped calls: {stamps['calls']} calls, {steps} replayed steps, "
           f"{stamps['ms_per_step']:.6f} ms a step against the untraced window's "
           f"{window_ms:.6f} ({100 * (stamps['ms_per_step'] / window_ms - 1):+.3f}%)",
           "stamped spans (device ms a replayed step: total, self; count a step; parent):"]
    for name, x in sorted(spans.items(), key=lambda kv: -kv[1]["total_ms"]):
        out.append(f"  {x['total_ms'] / steps:11.6f} {x['self_ms'] / steps:11.6f} "
                   f"{x['count'] / steps:8.3f}  {name}  ({x['parent']})")
    b = stamps["boundary"]
    if b is not None:
        named = ", ".join(f"{k} {v:.6f}" for k, v in b["named_ms"].items())
        out.append(f"call boundary ({b['boundaries']} boundaries, ms each): {b['boundary_ms']:.6f}"
                   f", copies {b['copy_ms']:.6f}, idle {b['idle_ms']:.6f}: {named}, no span "
                   f"{b['unnamed_ms']:.6f}; of the idle, queued {b['queued_ms']:.6f} (clock +- "
                   f"{b['clock_uncertainty_ms']:.6f}); copied "
                   f"{stamps['copy_bytes'] / stamps['calls'] / 2**30:.6f} GiB a call")
    print("\n".join(out), file=sys.stderr, flush=True)
