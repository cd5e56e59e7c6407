"""The production-run protocol (port of the JAX package's
``scripts/run_10day.py``) on the coupled data-free climate model
(tripolar grid with the Gaussian islands, CATKE, air-sea fluxes), by
default 10 simulated days at 1536x768x64:

  * ``Simulation`` with progress every 10 iterations, a surface writer at
    0.3 of the run and a checkpoint at half of it (``CheckpointWriter``);
  * a real kill and resume: ``interrupt`` runs to half time, checkpoints
    and its process exits; ``resume`` is a new process that restores the
    checkpoint and runs on to the end;
  * the resumed final state against the uninterrupted one, bit for bit on
    every field (15 with CATKE: u, v, eta, T, S, e, their tendencies, the
    clock and the iteration).

Phases, each its own process (``--phase all`` runs the three as
subprocesses, then compares):
    full      -> <out>/full_final/      (the uninterrupted final state)
    interrupt -> <out>/ckpt_interrupt/  (the half-time checkpoint, then exit)
    resume    -> <out>/resume_final/    (restored, half time -> end)
    compare   -> the bitwise verdict (``--json-out`` with ``all``)

    python -m gb25_tpu_torch.scripts.run_10day --phase all --nx 1536 --nz 64 --dt 60 --days 0.1
    python -m gb25_tpu_torch.scripts.run_10day --phase all --nx 32 --nz 4 --dt 600 \\
        --days 0.1 --device cpu

``--out`` and ``--json-out`` default under the repository's root
(``run10day_out/``, ``chiprun_out/``).
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
INNER_STEPS = 10


def build(nx, nz, device):
    """(ccfg, grid, state, step_fn) of the climate model at nx x nx/2 x nz."""
    from gb25_tpu_torch.models.coupled import coupled_loop, data_free_ocean_climate_model

    ccfg, grid, atmos, state = data_free_ocean_climate_model(
        resolution=384.0 / nx, Nz=nz, device=device, grid_type="gaussian_islands_tripolar")

    def step_fn(cfg_unused, grid_, s, dt, n):
        return coupled_loop(ccfg, grid_, atmos, s, dt, n, chunk=INNER_STEPS)

    return ccfg, grid, state, step_fn


def make_sim(grid, state, step_fn, dt, stop_days, out, ccfg, tag, total_days=10.0):
    """The protocol's ``Simulation``: progress every 10 iterations, the
    surface writer at 0.3 and the checkpoint at 0.5 of ``total_days`` (the
    reference's 3-day writer and 5-day checkpoint of a 10-day run), each
    phase with a checkpoint directory of its own."""
    from gb25_tpu_torch.io import NPZOutputWriter
    from gb25_tpu_torch.simulation import (
        CheckpointWriter,
        IterationInterval,
        Simulation,
        progress_callback,
    )

    sim = Simulation(ccfg.ocean, grid, state, dt=dt, stop_time=stop_days * 86400.0,
                     inner_steps=INNER_STEPS, step_fn=step_fn)
    sim.add_callback(progress_callback, IterationInterval(10))
    sim.add_output_writer(NPZOutputWriter(os.path.join(out, f"surface_{tag}"),
                                          interval_seconds=0.3 * total_days * 86400.0))
    ckpt = CheckpointWriter(os.path.join(out, f"ckpt_{tag}"),
                            interval_seconds=0.5 * total_days * 86400.0, keep=3)
    sim.add_output_writer(ckpt)
    return sim, ckpt


def state_stats(state):
    """max|u|, the range of T and whether every field is finite (reduced on
    the device)."""
    import torch

    from gb25_tpu_torch.models.device_loop import _tensors

    T = state.tracers["T"]
    finite = all(bool(torch.isfinite(t).all()) for t in _tensors(state).values())
    return {"max_abs_u": float(state.u.abs().max()), "T_min": float(T.min()),
            "T_max": float(T.max()), "finite": finite}


def run_phase(args, stop_days, final_dir, restore_from=None, tag="full"):
    import torch

    from gb25_tpu_torch.io import restore_state, save_sharded_state
    from gb25_tpu_torch.models import device_loop

    ccfg, grid, state, step_fn = build(args.nx, args.nz, args.device)
    if restore_from:
        state = restore_state(state, restore_from)
        print(f"restored from {restore_from}: iter={state.iteration} "
              f"t={float(state.time) / 86400.0:.2f} days", flush=True)
    start_iteration = state.iteration
    sim, ckpt = make_sim(grid, state, step_fn, args.dt, stop_days, args.out, ccfg, tag,
                         total_days=args.days)
    device_loop.STATS.reset()
    t0 = time.perf_counter()
    sim.run()
    if sim.state.u.is_cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = state_stats(sim.state)
    if final_dir:
        save_sharded_state(sim.state, final_dir)
    steps = sim.iteration - start_iteration
    ckpt_s = sum(ckpt.write_seconds)
    info = {"iteration": sim.iteration, "t_days": sim.time / 86400.0, "wall_s": wall,
            "ms_per_step": 1e3 * wall / max(steps, 1),
            "ms_per_step_without_checkpoints": 1e3 * (wall - ckpt_s) / max(steps, 1),
            "checkpoint_write_s": ckpt.write_seconds,
            "eager_steps": device_loop.STATS.eager_steps,
            "replayed_steps": device_loop.STATS.replayed_steps,
            "checkpoints": sorted(glob.glob(os.path.join(args.out, f"ckpt_{tag}",
                                                         "ckpt_iter*"))),
            **stats}
    print("PHASE_RESULT " + json.dumps(info), flush=True)
    return info


def compare(args):
    """Every field of the resumed final state against the uninterrupted
    one, bit for bit."""
    from gb25_tpu_torch.io.checkpoint import load_all_fields

    a = load_all_fields(os.path.join(args.out, "full_final"))
    b = load_all_fields(os.path.join(args.out, "resume_final"))
    mism = {}
    for k in a:
        if not np.array_equal(a[k], b[k]):
            d = np.abs(np.asarray(a[k], np.float64) - np.asarray(b[k], np.float64))
            mism[k] = float(d.max())
    return {"bitwise_equal": not mism and list(a) == list(b), "mismatched_fields": mism,
            "n_fields": len(a)}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--phase", default="all",
                   choices=["all", "full", "interrupt", "resume", "compare"])
    p.add_argument("--nx", type=int, default=1536)
    p.add_argument("--nz", type=int, default=64)
    p.add_argument("--dt", type=float, default=60.0,
                   help="60 s clears the unbalanced start's w-CFL at 1/4 degree")
    p.add_argument("--days", type=float, default=10.0)
    p.add_argument("--out", default=str(REPO / "run10day_out"))
    p.add_argument("--json-out", default=str(REPO / "chiprun_out" / "RUN_10DAY_torch.json"))
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    if args.phase == "full":
        run_phase(args, args.days, os.path.join(args.out, "full_final"), tag="full")
    elif args.phase == "interrupt":
        # to half time, the checkpoint there, then this process exits: the kill
        run_phase(args, args.days / 2.0, None, tag="interrupt")
    elif args.phase == "resume":
        cks = sorted(glob.glob(os.path.join(args.out, "ckpt_interrupt", "ckpt_iter*")))
        if not cks:
            raise SystemExit("no checkpoint to resume from: run --phase interrupt first")
        run_phase(args, args.days, os.path.join(args.out, "resume_final"),
                  restore_from=cks[-1], tag="resume")
    elif args.phase == "compare":
        print(json.dumps(compare(args)))
    else:
        results = {"grid": f"{args.nx}x{args.nx // 2}x{args.nz}", "dt_s": args.dt,
                   "days": args.days, "device": args.device,
                   "config": "data-free climate ocean (tripolar + islands + CATKE + coupled "
                             "fluxes)",
                   "protocol": f"progress@10it, surface writer@{0.3 * args.days:g}d, "
                               f"checkpoint@{0.5 * args.days:g}d, kill at day "
                               f"{args.days / 2:g}, restore in a new process, bitwise compare "
                               f"at day {args.days:g}"}
        for phase in ["full", "interrupt", "resume"]:
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "gb25_tpu_torch.scripts.run_10day", "--phase", phase,
                 "--nx", str(args.nx), "--nz", str(args.nz), "--dt", str(args.dt),
                 "--days", str(args.days), "--out", args.out, "--device", args.device],
                capture_output=True, text=True, timeout=14400, cwd=REPO)
            lines = [ln for ln in r.stdout.splitlines() if ln.startswith("PHASE_RESULT ")]
            if r.returncode != 0 or not lines:
                results[phase] = {"error": (r.stderr or r.stdout).strip()[-2000:]}
                print(json.dumps(results, indent=1))
                sys.exit(1)
            results[phase] = json.loads(lines[-1][len("PHASE_RESULT "):])
            results[phase]["process_s"] = time.perf_counter() - t0
            print(f"phase {phase}: {json.dumps(results[phase])}", flush=True)
        results["comparison"] = compare(args)
        os.makedirs(os.path.dirname(args.json_out) or ".", exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(results, f, indent=1)
        print(json.dumps(results["comparison"]))
        if not results["comparison"]["bitwise_equal"]:
            sys.exit(1)


if __name__ == "__main__":
    main()
