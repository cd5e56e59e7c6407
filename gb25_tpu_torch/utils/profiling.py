"""Where a step's device time goes (the port's counterpart of
``gb25_tpu.utils.profiling``, built on ``torch.profiler``).

    python -m gb25_tpu_torch.utils.profiling
        [--model flagship|climate|tripolar|keps|shallow_water] [--steps 4 --warmup 3]
        [--kernels auto|torch|pallas] [--decomposed local|ring] [--blocks 1 2 4 8 16]
        [--compute-dtype float32|bf16s|bfloat16|float64|f32x2|bf16x2]
        [--closure none|vertical_scalar]
        [--free-surface split_explicit|explicit] [--dt 60]

Profiles at 1536x768x64 on the GPU after a warm-up: the flagship
baroclinic-instability ocean, the coupled climate model at 1/4 degree on
the lat-lon islands grid or on the tripolar grid, the flagship with the
k-epsilon closure (started from e = 1e-5, eps = 1e-8), or the
shallow-water model of ``bench.py --config atmosphere`` at 1536x768.
``--kernels pallas`` runs the K6 route (``models.hydrostatic``).
``--compute-dtype`` and ``--free-surface explicit`` reach every model but
shallow water (the climate's as ``bench.py --config climate
--compute-dtype`` sets its ocean's), ``--closure vertical_scalar`` the
flagship: the run scripts' further choices (the JAX package's
``utils/args.py``): a precision mode (K1's unfused float32 or
bf16-storage instance, K6's bfloat16 or float64 instance on the K6 route,
or the cast array path, ``step/tendency_array``, paired-bfloat16 limbs
under bf16x2), the vertical
scalar closure (K3's constant-kappa pair) and the explicit free surface
(K1 unfused, ``step/explicit_free_surface``; run it at ``--dt 5``: the
quasi-AB2 step damps the fastest gravity wave of the 80-degree rows only
below ~6 s).
``--decomposed`` runs the model on the decomposed path forced onto a 1x1
mesh (``parallel.sharded``, exchange_width = 30: one block of 30 K5
substeps a step) in the "local" or the "ring" mode, on the tile grid and
exchange of one ``sharded_step_fn`` (the grid keeps the captured graph),
with every other option.

Three windows. First ``--steps`` steps launched one by one from the host:
the device time per kernel name, grouped into the hand-written kernels and
the torch ops around them, and the device busy share of the window (summed
kernel time over wall time; a single stream has no overlap), with K1's
launches by where b came from (made in the kernel, or read from the
caller's eager buoyancy: ``pallas_zslab.b_own_share``). Then the loop
as a user runs it, replayed from its captured CUDA graph
(``models.device_loop``; the forced 1x1 decomposed path too): wall,
device busy, idle share, peak device memory and the graph's pool. Last,
the replayed loop again with the tracer on (``utils.tracing``), its graph
captured anew with the spans' device stamps, which run at every replay:
each stage's total and self device ms a replayed step (the ``step`` root,
its ``step/*`` stages; self leaves out the spans nested in it) and its
count a step. ``--blocks`` times the replayed loop with graphs of each
block length. Needs a CUDA device; it fails without one.
``queued_device_ms`` times a call by the device alone (``chip_smoke.py``
[19], ``solver_variants.py``).

The run scripts' phase timing and traces (the JAX package's
``gb25_tpu/utils/profiling.py``): ``Timer`` prints the
``[rank] label: X seconds`` lines the reference's weak-scaling scrapers
parse; ``with_profiler`` writes a ``torch.profiler`` Chrome trace
(``analysis.trace`` summarizes it); ``annotate`` names a span in it
(a ``utils.tracing`` span);
``gbprofile`` runs cProfile over a phase; ``allocator_stats`` reads the
caching allocator of each card. The JAX package's
``force_virtual_cpu_devices`` has no counterpart: the port's CPU ranks are
processes of a gloo group (``parallel.spawn``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import os
import time

import torch

from gb25_tpu_torch.utils import tracing


def _synchronize():
    """Wait for the card's queued work where the process has used a card."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """Phase timer printing ``[{rank}] {label}: {seconds:.6f} seconds`` (the
    reference's ``@time "[rank] label"`` log line, which its weak-scaling
    tooling scrapes). The card is synchronized before the clock is read at
    both ends, so a phase holds the device work it queued. ``times`` keeps
    each label's seconds, in the order run."""

    def __init__(self, rank: int = 0):
        self.rank = rank
        self.times = {}

    @contextlib.contextmanager
    def __call__(self, label: str):
        _synchronize()
        t0 = time.perf_counter()
        yield
        _synchronize()
        dt = time.perf_counter() - t0
        self.times[label] = dt
        print(f"[{self.rank}] {label}: {dt:.6f} seconds", flush=True)


@contextlib.contextmanager
def with_profiler(directory: str | None):
    """Trace the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is present) and write it as a Chrome-trace JSON
    ``<host>_<pid>.pt.trace.json`` into ``directory``; None traces
    nothing."""
    if directory is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(directory, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        _synchronize()
    prof.export_chrome_trace(os.path.join(directory,
                                          f"{os.uname().nodename}_{os.getpid()}.pt.trace.json"))


def annotate(name: str, **metadata):
    """A span named in the trace (``tracing.span``) with the JAX package's
    label: ``name#k=v,...#`` with metadata, else ``name``."""
    label = name
    if metadata:
        label += "#" + ",".join(f"{k}={v}" for k, v in metadata.items()) + "#"
    return tracing.span(label)


@contextlib.contextmanager
def gbprofile(name: str, enabled: bool = True):
    """Host-side Python profile of a phase (the reference's @gbprofile):
    cProfile over the block, the 60 costliest calls by cumulative time
    written to ``profile_<name>.txt`` in the working directory."""
    if not enabled:
        yield
        return
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    try:
        yield
    finally:
        prof.disable()
        with open(f"profile_{name}.txt", "w") as f:
            pstats.Stats(prof, stream=f).sort_stats("cumulative").print_stats(60)


def allocator_stats() -> dict:
    """The caching allocator's ``torch.cuda.memory_stats`` of each visible
    card, by "cuda:<index>"; ``{}`` without a card."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())}

NX, NY, NZ = 1536, 768, 64  # the flagship grid


def queued_device_ms(fn, reps):
    """Mean device time of ``fn()`` over ``reps`` calls by CUDA events, the
    calls queued behind a sleeping kernel (~1 ms a call), so that the
    host's cost of a call (a K5 block of 4 substeps takes less time on the
    card than its wrapper on the host) does not enter."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e6) * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    raise RuntimeError("torch.profiler event carries no device time")


def step_breakdown(run, state, steps):
    """Profile ``run(state, steps)``; returns (rows, wall_ms, state): rows of
    (kernel name, device ms per step, calls per step), largest first."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = run(state, steps)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = []
    for evt in prof.key_averages():
        if evt.is_user_annotation:
            continue  # the spans (``tracing.span``): their device time is their kernels'
        us = _device_us(evt)
        if us > 0 and getattr(evt, "device_type", None) != torch.autograd.DeviceType.CPU:
            rows.append((evt.key, us / 1e3 / steps, evt.count / steps))
    rows.sort(key=lambda r: -r[1])
    return rows, wall_ms / steps, state


def stamped_stages(run, state, steps):
    """The stages of ``run(state, steps)`` (a loop replayed from its kept
    graph) by the tracer's device stamps (``tracing.stamped``): one call of
    ``steps`` + 1 steps that captures the graph anew with the stamps, then
    the ``steps`` read (``steps`` a whole number of blocks). Returns (rows,
    state): rows of (span, total ms a step, self ms a step, count a step)
    for the ``step`` root and its ``step/*`` stages, largest first."""
    held = {"state": state}

    def call(n):
        held["state"] = run(held["state"], n)

    _, _, snap, _ = tracing.stamped(lambda: call(steps + 1), lambda: call(steps))
    rows = [(name, s["total_ms"] / steps, s["self_ms"] / steps, s["count"] / steps)
            for name, s in snap.items() if name == "step" or name.startswith("step/")]
    rows.sort(key=lambda r: -r[1])
    return rows, held["state"]


# each hand-written kernel's device symbol (its instances share it) and the
# group its time is summed under, by the short name chip_smoke.py uses
KERNELS = {
    "K1": ("zslab_tendencies_kernel", "K1 zslab_tendencies (CUDA)"),
    "K6": ("tendency_stage_kernel", "K6 tendencies (CUDA)"),
    "K2": ("barotropic_loop_", "K2 barotropic_loop (CUDA)"),
    "K5": ("barotropic_block_kernel", "K5 barotropic_block (CUDA)"),
    "K3": ("implicit_diffusion_kernel", "K3 implicit_diffusion (CUDA)"),
    "K4": ("catke_diffusivities_kernel", "K4 catke_diffusivities (CUDA)"),
    "K4_keps": ("keps_diffusivities_kernel", "K4 keps_diffusivities (CUDA)"),
}


def group(name: str) -> str:
    for symbol, label in KERNELS.values():
        if symbol in name:
            return label
    return "torch ops (halo fill, TEOS-10, masks, fluxes, planes, correction)"


def b_source_line(since):
    """The line for K1's launches since the reading ``since`` of
    ``pallas_zslab.b_launches`` by where b came from; None where K1
    launched none."""
    from gb25_tpu_torch.ops import pallas_zslab

    share = pallas_zslab.b_own_share(since)
    if share is None:
        return None
    made, total = (now - then for now, then in zip(pallas_zslab.b_launches(), since))
    return (f"  K1 b made in the kernel: {100 * share:.1f}% of {total} launches "
            f"({made} made, {total - made} read from the eager buoyancy)")


def replayed_line(run, state, steps):
    """Profile ``run(state, steps)`` (a loop replayed from its kept graph);
    returns (wall ms/step, device busy ms/step, peak allocated GB, reserved
    GB, state)."""
    torch.cuda.reset_peak_memory_stats()
    rows, wall_ms, state = step_breakdown(run, state, steps)
    busy = sum(r[1] for r in rows)
    return wall_ms, busy, torch.cuda.max_memory_allocated() / 1e9, \
        torch.cuda.memory_reserved() / 1e9, state


def block_sweep(step, state, cache, blocks, steps=64):
    """ms/step of the loop replayed from graphs of each block length in
    ``blocks``: for each, a call from ``state`` that captures (freeing the
    graph of the block before), then ``steps`` timed steps (a multiple of
    every block) from where it ended; with the pool each graph reserved and
    the peak allocated memory."""
    from gb25_tpu_torch.models import device_loop

    out = []
    for block in blocks:
        if steps % block:
            raise ValueError(f"{steps} steps are no whole number of blocks of {block}")
        device_loop.STATS.reset()
        warm = device_loop.device_loop(step, state, block + 1, cache, block)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        device_loop.device_loop(step, warm, steps, cache, block)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / steps
        out.append((block, ms, device_loop.STATS.pool_bytes / 1e9,
                    torch.cuda.max_memory_allocated() / 1e9))
        del warm
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="flagship",
                   choices=["flagship", "climate", "tripolar", "keps", "shallow_water"])
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--kernels", default="auto", choices=["auto", "torch", "pallas"])
    p.add_argument("--decomposed", default=None, choices=["local", "ring"])
    p.add_argument("--blocks", type=int, nargs="*", default=None)
    p.add_argument("--compute-dtype", default=None,
                   choices=["float32", "bf16s", "bfloat16", "float64", "f32x2", "bf16x2"])
    p.add_argument("--closure", default="none", choices=["none", "vertical_scalar"])
    p.add_argument("--free-surface", default="split_explicit",
                   choices=["split_explicit", "explicit"])
    p.add_argument("--dt", type=float, default=60.0)
    args = p.parse_args()
    dt = args.dt
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA device")

    from gb25_tpu_torch.models import (
        baroclinic_instability_model,
        coupled_loop,
        coupled_time_step,
        data_free_ocean_climate_model,
        device_loop,
        loop,
        shallow_water_model,
        sw_loop,
        sw_time_step,
        time_step,
    )
    from gb25_tpu_torch.models.config import (
        ExplicitFreeSurface,
        SplitExplicitFreeSurface,
        VerticalScalarDiffusivity,
    )
    from gb25_tpu_torch.models.hydrostatic import premask_state
    from gb25_tpu_torch.models.keps import TKEDissipationVerticalDiffusivity
    from gb25_tpu_torch.ops import pallas_zslab
    from gb25_tpu_torch.parallel import make_mesh, sharded_coupled_step_fn, sharded_step_fn

    def blocked(cfg):
        if args.decomposed is None or isinstance(cfg.free_surface, ExplicitFreeSurface):
            return cfg
        return dataclasses.replace(cfg, free_surface=SplitExplicitFreeSurface(exchange_width=30))

    shape = f"{NX}x{NY}x{NZ}"
    if args.model == "shallow_water":
        cfg, grid, state = shallow_water_model(NX, NY)
        shape = f"{NX}x{NY}"

        step = functools.partial(sw_time_step, cfg, grid, dt=dt)

        def run(s, n):
            return sw_loop(cfg, grid, s, dt, n)
    elif args.model in ("flagship", "keps"):
        closure = TKEDissipationVerticalDiffusivity() if args.model == "keps" else None
        if args.closure == "vertical_scalar":
            closure = VerticalScalarDiffusivity()
        fs = ExplicitFreeSurface() if args.free_surface == "explicit" else None
        cfg, grid, state = baroclinic_instability_model(NX, NY, NZ, kernels=args.kernels,
                                                        closure=closure, free_surface=fs)
        cfg = dataclasses.replace(blocked(cfg), compute_dtype=args.compute_dtype)
        if args.decomposed:
            fn = sharded_step_fn(cfg, grid, make_mesh(), force_comm=args.decomposed)
        else:
            step = functools.partial(time_step, cfg, grid, dt=dt, premasked=True)

            def run(s, n):
                return loop(cfg, grid, s, dt, n)
    else:
        grid_type = "gaussian_islands_tripolar" if args.model == "tripolar" else "gaussian_islands"
        ccfg, grid, atmos, state = data_free_ocean_climate_model(
            resolution=384 / NX, Nz=NZ, kernels=args.kernels, grid_type=grid_type)
        ocean = ccfg.ocean
        if args.free_surface == "explicit":
            ocean = dataclasses.replace(ocean, free_surface=ExplicitFreeSurface())
        ocean = dataclasses.replace(blocked(ocean), compute_dtype=args.compute_dtype)
        ccfg = dataclasses.replace(ccfg, ocean=ocean)
        if args.decomposed:
            fn = sharded_coupled_step_fn(ccfg, grid, atmos, make_mesh(),
                                         force_comm=args.decomposed)
        else:
            step = functools.partial(coupled_time_step, ccfg, grid, atmos, dt=dt, premasked=True)

            def run(s, n):
                return coupled_loop(ccfg, grid, atmos, s, dt, n)
    if args.decomposed:
        # one fn: its tile grid keeps the loop's captured graph
        grid, step = fn.grid, functools.partial(fn.step, dt=dt)

        def run(s, n):
            return fn(s, dt, n)

    def eager(s, n):  # every step from the host
        return device_loop.host_loop(step, s, n)

    state = premask_state(grid, run(state, args.warmup))
    torch.cuda.reset_peak_memory_stats()
    k1_before = pallas_zslab.b_launches()
    rows, wall_ms, state = step_breakdown(eager, state, args.steps)
    busy = sum(r[1] for r in rows)
    route = f" decomposed 1x1 {args.decomposed}" if args.decomposed else ""
    if args.model != "shallow_water":
        route += "".join(f" {k}={v}" for k, v in (("compute_dtype", args.compute_dtype),
                                                   ("closure", args.closure),
                                                   ("free_surface", args.free_surface), ("dt", dt))
                         if v not in (None, "none", "split_explicit", 60.0))
    print(f"{args.model}{route} {shape} kernels={args.kernels} on "
          f"{torch.cuda.get_device_name(0)}, {args.steps} steps launched from the host: wall "
          f"{wall_ms:.3f} ms/step, device busy {busy:.3f} ms/step ({100 * busy / wall_ms:.1f}%), "
          f"idle {100 * (1 - busy / wall_ms):.1f}%, peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    groups = {}
    for name, ms, calls in rows:
        g = groups.setdefault(group(name), [0.0, 0.0])
        g[0] += ms
        g[1] += calls
    for g, (ms, calls) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms:9.3f} ms/step {100 * ms / busy:5.1f}%  {calls:7.1f} launches/step  {g}")
    k1_line = b_source_line(k1_before)
    if k1_line:
        print(k1_line)
    print("top kernels (device ms/step, launches/step):")
    for name, ms, calls in rows[:25]:
        print(f"  {ms:9.3f}  {calls:6.1f}  {name[:110]}")
    n = 2 * device_loop.BLOCK_STEPS
    device_loop.STATS.reset()
    state = run(state, n + 1)  # one step from the host, a capture, replays
    pool = device_loop.STATS.pool_bytes / 1e9
    wall_r, busy_r, peak, reserved, state = replayed_line(run, state, n)
    print(f"replayed loop ({n} steps, {n // device_loop.BLOCK_STEPS} replays of a "
          f"{device_loop.BLOCK_STEPS}-step graph): wall {wall_r:.3f} ms/step, device busy "
          f"{busy_r:.3f} ms/step ({100 * busy_r / wall_r:.1f}%), idle "
          f"{100 * (1 - busy_r / wall_r):.1f}%, peak device memory {peak:.2f} GB allocated, "
          f"{reserved:.2f} GB reserved, graph pool {pool:.2f} GB")
    stages, state = stamped_stages(run, state, n)
    print(f"stages of a replayed step (the tracer's device stamps over {n} replayed steps; "
          "self: less the spans nested in it):")
    for name, total, own, count in stages:
        print(f"  {total:9.3f} ms/step total {own:9.3f} self {100 * total / wall_r:5.1f}% of "
              f"wall  {count:5.2f}/step  {name}")
    if args.blocks:
        print("the replayed loop by block length (64 steps timed after a call that captures):")
        for block, ms, pool, peak in block_sweep(step, state, grid.cache, args.blocks):
            print(f"  block {block:3d}: {ms:.3f} ms/step, graph pool {pool:.2f} GB, peak "
                  f"allocated {peak:.2f} GB")


if __name__ == "__main__":
    main()
