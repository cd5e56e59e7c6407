"""Where a step's device time goes (the port's counterpart of
``gb25_tpu.utils.profiling``, built on ``torch.profiler``).

    python -m gb25_tpu_torch.utils.profiling
        [--model flagship|climate|tripolar|keps] [--steps 4 --warmup 3]
        [--kernels auto|torch|pallas] [--decomposed local|ring]

Profiles a few steps at 1536x768x64 on the GPU after a warm-up: the
flagship baroclinic-instability ocean, the coupled climate model at 1/4
degree on the lat-lon islands grid or on the tripolar grid, or the
flagship with the k-epsilon closure (started from e = 1e-5, eps = 1e-8).
``--kernels pallas`` runs the K6 route (``models.hydrostatic``).
``--decomposed`` runs the model on the decomposed path forced onto a 1x1
mesh (``parallel.sharded``, exchange_width = 30: one block of 30 K5
substeps a step) in the "local" or the "ring" mode.
Prints the device time per kernel name, grouped into the
hand-written kernels and the torch ops around them, the device busy share
of the profiled window (summed kernel time over wall time; overlap between
kernels is ignored, which a single stream does not have) and the peak
device memory. Needs a CUDA device; it fails without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

NX, NY, NZ = 1536, 768, 64  # the flagship grid


def _device_us(evt, total=False) -> float:
    attrs = ("device_time_total", "cuda_time_total") if total else (
        "self_device_time_total", "self_cuda_time_total")
    for attr in attrs:
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    raise RuntimeError("torch.profiler event carries no device time")


def step_breakdown(run, state, steps):
    """Profile ``run(state, steps)``; returns (rows, stages, wall_ms,
    state): rows of (kernel name, device ms per step, calls per step) and
    stages of (profiler range, its device span in ms per step), largest
    first."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = run(state, steps)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows, stages = [], []
    for evt in prof.key_averages():
        if evt.key.startswith("step/"):
            # A range shows twice. On the device timeline: its span from the
            # first to the last kernel launched inside it, idle gaps
            # included, the stage's share of the step. On the host: the
            # device time of the torch ops inside it, which misses the
            # ctypes-launched CUDA kernels (no torch op owns them); skipped.
            if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CPU:
                stages.append((evt.key, _device_us(evt, total=True) / 1e3 / steps))
            continue
        us = _device_us(evt)
        if us > 0 and getattr(evt, "device_type", None) != torch.autograd.DeviceType.CPU:
            rows.append((evt.key, us / 1e3 / steps, evt.count / steps))
    rows.sort(key=lambda r: -r[1])
    stages.sort(key=lambda r: -r[1])
    return rows, stages, wall_ms / steps, state


def group(name: str) -> str:
    if "zslab_tendencies_kernel" in name:
        return "K1 zslab_tendencies (CUDA)"
    if "tendency_stage_kernel" in name:
        return "K6 tendencies (CUDA)"
    if "barotropic_loop_" in name:
        return "K2 barotropic_loop (CUDA)"
    if "barotropic_block_kernel" in name:
        return "K5 barotropic_block (CUDA)"
    if "implicit_diffusion_kernel" in name:
        return "K3 implicit_diffusion (CUDA)"
    if "catke_diffusivities_kernel" in name:
        return "K4 catke_diffusivities (CUDA)"
    if "keps_diffusivities_kernel" in name:
        return "K4 keps_diffusivities (CUDA)"
    return "torch ops (halo fill, TEOS-10, masks, fluxes, planes, correction)"


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="flagship",
                   choices=["flagship", "climate", "tripolar", "keps"])
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--kernels", default="auto", choices=["auto", "torch", "pallas"])
    p.add_argument("--decomposed", default=None, choices=["local", "ring"])
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA device")

    from gb25_tpu_torch.models import (
        baroclinic_instability_model,
        coupled_loop,
        data_free_ocean_climate_model,
        loop,
    )
    from gb25_tpu_torch.models.config import SplitExplicitFreeSurface
    from gb25_tpu_torch.models.keps import TKEDissipationVerticalDiffusivity
    from gb25_tpu_torch.parallel import make_mesh, sharded_coupled_step_fn, sharded_step_fn

    def blocked(cfg):
        if args.decomposed is None:
            return cfg
        return dataclasses.replace(cfg, free_surface=SplitExplicitFreeSurface(exchange_width=30))

    if args.model in ("flagship", "keps"):
        closure = TKEDissipationVerticalDiffusivity() if args.model == "keps" else None
        cfg, grid, state = baroclinic_instability_model(NX, NY, NZ, kernels=args.kernels,
                                                        closure=closure)
        cfg = blocked(cfg)

        def run(s, n):
            if args.decomposed:
                return sharded_step_fn(cfg, grid, make_mesh(), n_inner=n,
                                       force_comm=args.decomposed)(s, 60.0)
            return loop(cfg, grid, s, 60.0, n)
    else:
        grid_type = "gaussian_islands_tripolar" if args.model == "tripolar" else "gaussian_islands"
        ccfg, grid, atmos, state = data_free_ocean_climate_model(
            resolution=384 / NX, Nz=NZ, kernels=args.kernels, grid_type=grid_type)
        ccfg = dataclasses.replace(ccfg, ocean=blocked(ccfg.ocean))

        def run(s, n):
            if args.decomposed:
                return sharded_coupled_step_fn(ccfg, grid, atmos, make_mesh(), n_inner=n,
                                               force_comm=args.decomposed)(s, 60.0)
            return coupled_loop(ccfg, grid, atmos, s, 60.0, n)

    state = run(state, args.warmup)
    torch.cuda.reset_peak_memory_stats()
    rows, stages, wall_ms, _ = step_breakdown(run, state, args.steps)
    busy = sum(r[1] for r in rows)
    route = f" decomposed 1x1 {args.decomposed}" if args.decomposed else ""
    print(f"{args.model}{route} {NX}x{NY}x{NZ} kernels={args.kernels} on "
          f"{torch.cuda.get_device_name(0)}: wall {wall_ms:.3f} ms/step, device busy "
          f"{busy:.3f} ms/step ({100 * busy / wall_ms:.1f}%), idle {100 * (1 - busy / wall_ms):.1f}%, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    groups = {}
    for name, ms, calls in rows:
        g = groups.setdefault(group(name), [0.0, 0.0])
        g[0] += ms
        g[1] += calls
    for g, (ms, calls) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms:9.3f} ms/step {100 * ms / busy:5.1f}%  {calls:7.1f} launches/step  {g}")
    print("device span per stage of the step (profiler ranges step/*, idle gaps included):")
    for name, ms in stages:
        print(f"  {ms:9.3f} ms/step {100 * ms / wall_ms:5.1f}% of wall  {name}")
    print("top kernels (device ms/step, launches/step):")
    for name, ms, calls in rows[:25]:
        print(f"  {ms:9.3f}  {calls:6.1f}  {name[:110]}")


if __name__ == "__main__":
    main()
