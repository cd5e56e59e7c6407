"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``gb25_tpu_torch/csrc`` and drives its
main path, the flagship baroclinic-instability ocean at 1536x768x64 f32
(halo 4, dt = 60 s, 30 barotropic substeps), through the public entry
points:

  1. the card's name and power limit, torch and CUDA versions;
  2. the kernel build (nvcc, sm_90a) and its time;
  3. K1 (zslab_tendencies) against its plain PyTorch version at the
     flagship shapes, rtol 2e-4;
  4. K2 (barotropic_loop) against its plain version at 1536x768, rtol 1e-5;
  5. the main path: one step with kernels="auto" against one with
     kernels="torch" (rtol 1e-3, atol 5e-6), then 8 warm-up steps and two
     256-step loops, the second one timed; the launch counts must show
     one K1 launch per step and 30 K2 launches per step, and the fields
     must stay finite;
  6. a few steps of the plain path, timed.

Every phase raises on failure, and the script then exits non-zero. The
line before the last is a JSON object with each kernel's launches, error
against its plain version and times (K1's ``ms`` is the CUDA kernel alone;
its ``wrapper_ms`` and ``plain_ms`` both include their own TEOS-10
buoyancy and column total); the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits 2 and
prints no result.
"""

import json
import subprocess
import sys
import time

import torch

REFERENCE_CELL_STEPS_PER_SEC = 768 * 768 * 64 / 0.221  # GB-25 on one Alps GH200
NX, NY, NZ = 1536, 768, 64
DT = 60.0
WARMUP, STEPS, PLAIN_STEPS = 8, 256, 3
DEVICE = "cuda"


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps, warmup=1):
    """Mean device time of ``fn()`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name, got, want, rtol, atol):
    """Raise if ``got`` is outside rtol/atol of ``want``; return the errors."""
    got = got.double()
    want = want.double()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values in the kernel output")
    err = (got - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp_min(1e-30)).max())
    bad = int((err > atol + rtol * want.abs()).sum())
    print(f"  {name:10s} max|ref| {float(want.abs().max()):.4e}  max abs err {max_abs:.3e}  "
          f"max rel err {max_rel:.3e}  (rtol {rtol:g}, atol {atol:.1e}, outside: {bad})")
    if bad:
        raise AssertionError(f"{name}: {bad} elements outside rtol={rtol} atol={atol}")
    return max_abs


def phase_k1(cfg, grid, state, gen):
    """K1 against zslab_tendencies_plain on the flagship operands."""
    import dataclasses

    from gb25_tpu_torch.ops import pallas_zslab
    from gb25_tpu_torch.ops.halos import extend_field

    ue = extend_field(grid, state.u, "u")
    ve = extend_field(grid, state.v, "v")
    tr_e = {k: extend_field(grid, c, "c") for k, c in state.tracers.items()}

    def noise():
        return 1e-7 * torch.randn(grid.shape, generator=gen, device=DEVICE)

    Gv_p = noise()
    Gv_p[:, 0, :] = 0.0
    prev = (noise(), Gv_p, {"T": noise(), "S": noise()})
    ab = (float(torch.tensor(DT * 1.6, dtype=torch.float32)),
          float(torch.tensor(DT * -0.6, dtype=torch.float32)))
    cfg_plain = dataclasses.replace(cfg, kernels="torch")

    def run_kernel():
        return pallas_zslab.zslab_tendencies(cfg, grid, ue, ve, tr_e, prev, ab)

    def run_plain():
        return pallas_zslab.zslab_tendencies(cfg_plain, grid, ue, ve, tr_e, prev, ab)

    got, want = run_kernel(), run_plain()
    torch.cuda.synchronize()
    names = ("Gu", "Gv", "GT", "GS", "u*", "v*", "T*", "S*", "U0", "V0", "Us", "Vs")

    def flat(r):
        Gu, Gv, Gtr, un, vn, trn, ints = r
        return [Gu, Gv, Gtr["T"], Gtr["S"], un, vn, trn["T"], trn["S"], *ints]

    g, w = flat(got), flat(want)
    a = ab[0]
    H = float(grid.dz_c[grid.hz : grid.hz + grid.Nz].sum())
    Gmax = [float(x.abs().max()) for x in w[:4]]
    # atol: tests/test_zslab.py's for the tendencies; the tendencies'
    # tolerance carried through x* = x + dt c1 G (and its depth integral)
    # for the updated fields; 2e-4 of the largest integral for U0, V0
    atols = [1e-9, 1e-9, 1e-7, 1e-7,
             a * 2e-4 * Gmax[0], a * 2e-4 * Gmax[1], a * 2e-4 * Gmax[2], a * 2e-4 * Gmax[3],
             2e-4 * float(w[8].abs().max()), 2e-4 * float(w[9].abs().max()),
             2e-4 * float(w[10].abs().max()) + a * 2e-4 * Gmax[0] * H,
             2e-4 * float(w[11].abs().max()) + a * 2e-4 * Gmax[1] * H]
    errs = [compare(n, x, y, 2e-4, at) for n, x, y, at in zip(names, g, w, atols)]
    if float(g[5][:, 0, :].abs().max()) != 0.0:
        raise AssertionError("K1 left v* nonzero on the south wall row")
    del got, want, g, w

    # the CUDA kernel alone, on buoyancy and column total computed once; the
    # wrappers, each with its own TEOS-10 and column total, beside it
    hz, Nz = grid.hz, grid.Nz
    be = cfg.eos.buoyancy(tr_e["T"], tr_e["S"], grid.z_c).contiguous()
    b_total = (be[hz : hz + Nz] * grid.dz_c[hz : hz + Nz]).sum(dim=0).contiguous()
    ms = cuda_time_ms(
        lambda: pallas_zslab.zslab_kernel(cfg, grid, ue, ve, tr_e, be, b_total, prev, ab), reps=10)
    wrapper_ms = cuda_time_ms(run_kernel, reps=10)
    plain_ms = cuda_time_ms(run_plain, reps=3)
    print(f"  K1 CUDA kernel alone {ms:.3f} ms; wrapper (TEOS-10 + column total + kernel) "
          f"{wrapper_ms:.3f} ms; plain wrapper {plain_ms:.3f} ms")
    return {"max_abs_err": max(errs), "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms}


def phase_k2(cfg, grid, state, gen):
    """K2 against barotropic_loop_plain at 1536x768."""
    import dataclasses

    from gb25_tpu_torch.models.free_surface import face_depths
    from gb25_tpu_torch.ops.pallas_barotropic import barotropic_loop

    dz = grid.dz_c[grid.hz : grid.hz + grid.Nz]
    U0 = (state.u * dz).sum(0)
    V0 = (state.v * dz).sum(0)
    eta0 = 1e-2 * torch.randn((NY, NX), generator=gen, device=DEVICE)
    GU = 1e-4 * torch.randn((NY, NX), generator=gen, device=DEVICE)
    GV = 1e-4 * torch.randn((NY, NX), generator=gen, device=DEVICE)
    GV[0] = 0.0
    Hu, Hv = face_depths(grid)
    cfg_plain = dataclasses.replace(cfg, kernels="torch")

    def run(c):
        return barotropic_loop(c, grid, eta0, U0, V0, GU, GV, Hu, Hv, DT)

    got, want = run(cfg), run(cfg_plain)
    torch.cuda.synchronize()
    errs = [compare(n, x, y, 1e-5, 1e-6 * float(y.abs().max()))
            for n, x, y in zip(("eta_b", "U_b", "V_b"), got, want)]
    ms = cuda_time_ms(lambda: run(cfg), reps=20)
    plain_ms = cuda_time_ms(lambda: run(cfg_plain), reps=5)
    print(f"  K2 loop of {cfg.free_surface.substeps} substeps: {ms:.3f} ms; plain {plain_ms:.3f} ms")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms}


def phase_step_compare(cfg, grid, state):
    import dataclasses

    from gb25_tpu_torch import time_step

    def fields(s):
        return {"u": s.u, "v": s.v, "eta": s.eta, **s.tracers,
                "Gu": s.Gu, "Gv": s.Gv, **{"G" + k: g for k, g in s.Gtracers.items()}}

    a = fields(time_step(cfg, grid, state, DT))
    b = fields(time_step(dataclasses.replace(cfg, kernels="torch"), grid, state, DT))
    for name in a:
        compare(name, a[name], b[name], 1e-3, 5e-6)


def check_state(state):
    fields = {"u": state.u, "v": state.v, "eta": state.eta, **state.tracers}
    for name, f in fields.items():
        if not torch.isfinite(f).all():
            raise AssertionError(f"{name} is not finite after the run")
    umax = float(state.u.abs().max())
    if not 0.0 < umax < 10.0:
        raise AssertionError(f"max|u| = {umax} m/s is not a sane ocean velocity")
    if tuple(state.u.shape) != (NZ, NY, NX) or tuple(state.eta.shape) != (NY, NX):
        raise AssertionError(f"unexpected shapes {tuple(state.u.shape)}, {tuple(state.eta.shape)}")
    return umax


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import dataclasses

    from gb25_tpu_torch import baroclinic_instability_model, loop
    from gb25_tpu_torch.ops import pallas_barotropic, pallas_zslab

    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    for k in (pallas_zslab.KERNEL, pallas_barotropic.KERNEL):
        k.load()
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {k.source}: {line.strip()}")
    print(f"[2] kernels built in {time.perf_counter() - t0:.1f} s")

    cfg, grid, state = baroclinic_instability_model(NX, NY, NZ, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(1234)
    print(f"[3] K1 vs plain at {NX}x{NY}x{NZ}")
    k1 = phase_k1(cfg, grid, state, gen)
    print(f"[4] K2 vs plain at {NX}x{NY}")
    k2 = phase_k2(cfg, grid, state, gen)
    torch.cuda.empty_cache()

    print("[5] main path: one step, kernels='auto' vs 'torch'")
    phase_step_compare(cfg, grid, state)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pallas_zslab.KERNEL.launches = 0
    pallas_barotropic.KERNEL.launches = 0
    s = loop(cfg, grid, state, DT, WARMUP)
    s = loop(cfg, grid, s, DT, STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = loop(cfg, grid, s, DT, STEPS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"K1": pallas_zslab.KERNEL.launches, "K2": pallas_barotropic.KERNEL.launches}
    n_steps = WARMUP + 2 * STEPS
    substeps = cfg.free_surface.substeps
    if launches != {"K1": n_steps, "K2": n_steps * substeps}:
        raise AssertionError(f"launch counts {launches}, expected K1 = {n_steps}, "
                             f"K2 = {n_steps * substeps}")
    umax = check_state(s)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms_step = 1e3 * elapsed / STEPS
    rate = NX * NY * NZ * STEPS / elapsed
    print(f"  launches over {n_steps} steps: {launches}; max|u| = {umax:.4f} m/s; "
          f"iteration {s.iteration}; peak device memory {peak_gb:.2f} GB")

    print(f"[6] plain path, {PLAIN_STEPS} steps")
    cfg_plain = dataclasses.replace(cfg, kernels="torch")
    sp = loop(cfg_plain, grid, state, DT, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sp = loop(cfg_plain, grid, sp, DT, PLAIN_STEPS)
    torch.cuda.synchronize()
    plain_ms_step = 1e3 * (time.perf_counter() - t0) / PLAIN_STEPS
    check_state(sp)

    print(f"[7] {NX}x{NY}x{NZ} f32 on {card}:")
    print(f"  kernels: {ms_step:.3f} ms/step, {rate:.4e} cell-steps/s "
          f"({rate / REFERENCE_CELL_STEPS_PER_SEC:.3f}x GB-25 on one GH200), "
          f"timed second {STEPS}-step loop")
    print(f"  plain torch: {plain_ms_step:.3f} ms/step, "
          f"{NX * NY * NZ / (plain_ms_step / 1e3):.4e} cell-steps/s over {PLAIN_STEPS} steps")

    kernels = [
        {"name": "zslab_tendencies", "route": "cuda",
         "source": "gb25_tpu_torch/csrc/zslab_tendencies.cu",
         "replaces": "gb25_tpu/ops/pallas_zslab.py:275", "launches": launches["K1"],
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"], "wrapper_ms": k1["wrapper_ms"],
         "plain_ms": k1["plain_ms"]},
        {"name": "barotropic_loop", "route": "cuda",
         "source": "gb25_tpu_torch/csrc/barotropic_loop.cu",
         "replaces": "gb25_tpu/ops/pallas_barotropic.py:94", "launches": launches["K2"],
         "max_abs_err": k2["max_abs_err"], "ms": k2["ms"], "plain_ms": k2["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
