"""Where a step's device time goes (the port's counterpart of
``gb25_tpu.utils.profiling``, built on ``torch.profiler``).

    python -m gb25_tpu_torch.utils.profiling [--steps 4 --warmup 3 --kernels auto]

Profiles a few flagship steps (1536x768x64) on the GPU after a warm-up
and prints the device time per kernel name, grouped into K1, K2 and the
torch ops around them, plus the device busy share of the profiled window (summed kernel
time over wall time; overlap between kernels is ignored, which a single
stream does not have). Needs a CUDA device; it fails without one.
"""

from __future__ import annotations

import argparse
import time

import torch

NX, NY, NZ = 1536, 768, 64  # the flagship grid


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    raise RuntimeError("torch.profiler event carries no device time")


def step_breakdown(cfg, grid, state, dt, steps):
    """Profile ``steps`` time steps; returns (rows, wall_ms, state) with rows
    of (kernel name, device ms per step, calls per step), largest first."""
    from torch.profiler import ProfilerActivity, profile

    from gb25_tpu_torch.models.hydrostatic import loop

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = loop(cfg, grid, state, dt, steps)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = []
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and getattr(evt, "device_type", None) != torch.autograd.DeviceType.CPU:
            rows.append((evt.key, us / 1e3 / steps, evt.count / steps))
    rows.sort(key=lambda r: -r[1])
    return rows, wall_ms / steps, state


def group(name: str) -> str:
    if "zslab_tendencies_kernel" in name:
        return "K1 zslab_tendencies (CUDA)"
    if "barotropic_substep_kernel" in name:
        return "K2 barotropic_substep (CUDA)"
    return "torch ops (halo fill, TEOS-10, planes, correction)"


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--kernels", default="auto", choices=["auto", "torch"])
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA device")

    from gb25_tpu_torch.models import baroclinic_instability_model, loop

    cfg, grid, state = baroclinic_instability_model(NX, NY, NZ, device="cuda", kernels=args.kernels)
    state = loop(cfg, grid, state, 60.0, args.warmup)
    rows, wall_ms, _ = step_breakdown(cfg, grid, state, 60.0, args.steps)
    busy = sum(r[1] for r in rows)
    print(f"{NX}x{NY}x{NZ} kernels={args.kernels} on "
          f"{torch.cuda.get_device_name(0)}: wall {wall_ms:.3f} ms/step, device busy "
          f"{busy:.3f} ms/step ({100 * busy / wall_ms:.1f}%), idle {100 * (1 - busy / wall_ms):.1f}%")
    groups = {}
    for name, ms, calls in rows:
        g = groups.setdefault(group(name), [0.0, 0.0])
        g[0] += ms
        g[1] += calls
    for g, (ms, calls) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms:9.3f} ms/step {100 * ms / busy:5.1f}%  {calls:7.1f} launches/step  {g}")
    print("top kernels (device ms/step, launches/step):")
    for name, ms, calls in rows[:25]:
        print(f"  {ms:9.3f}  {calls:6.1f}  {name[:110]}")


if __name__ == "__main__":
    main()
