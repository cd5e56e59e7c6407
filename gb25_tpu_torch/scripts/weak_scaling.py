"""Weak-scaling sweep (port of the JAX package's ``scripts/weak_scaling.py``,
the reference's sharding/*_scaling_test.jl): a fixed tile a rank, growing
rank counts, ms/step, the efficiency of cell-steps per second per rank
against the first count's, and the halo exchange's exchanges and kilobytes
per step per rank (``analysis.comm.step_traffic``, one step launched from
the host; the largest over the ranks).

    torchrun --nproc-per-node 4 -m gb25_tpu_torch.scripts.weak_scaling \\
        --counts 1,2,4 --tile 768x384 --Nz 64 --steps 32      # NCCL ranks on cards
    python -m gb25_tpu_torch.scripts.weak_scaling --cpu-ranks --counts 1,2,4 --tile 16

Under torchrun each count n runs on the group's first n ranks (a
subgroup; the others wait); ``--cpu-ranks`` runs each count on its own
``parallel.spawn`` gloo group of CPU processes (CPU ranks share the host's
cores: the rows check the exchange pattern, not the rate). Each count
times the second of two ``--steps``-step calls of one ``sharded_step_fn``
(a single rank runs the serial route). With ``--compute-ms``,
``--link-bytes-per-sec`` and ``--latency-s`` it adds the projection of
``analysis.comm.project_weak_scaling`` over ``--project-chips``. The JAX
script's ``--ablate-overlap`` (its interior/boundary overlap split) is
TPU-only and not ported. Writes the runs and the projection to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import time


def run_once(mesh, tile, Nz, steps, dtype_name, device):
    """One count on this rank of ``mesh``: the global grid of ``tile`` per
    rank, the flagship config, a warm call and a timed call of ``steps``
    steps; this rank's record."""
    import torch

    from gb25_tpu_torch.analysis.comm import step_traffic
    from gb25_tpu_torch.grids import simple_latitude_longitude_grid
    from gb25_tpu_torch.models import baroclinic_instability_config, baroclinic_instability_state
    from gb25_tpu_torch.parallel import shard_state, sharded_step_fn

    tx, ty = tile
    Nx, Ny = tx * mesh.Rx, ty * mesh.Ry
    grid = simple_latitude_longitude_grid(Nx, Ny, Nz, device=device,
                                          dtype=getattr(torch, dtype_name))
    cfg = baroclinic_instability_config()
    state = shard_state(baroclinic_instability_state(grid), mesh)
    fn = sharded_step_fn(cfg, grid, mesh, n_inner=steps)
    dt = 1.0
    comm = step_traffic(fn, state, dt)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    s = fn(state, dt)  # warm: builds, fills caches, captures where it replays
    sync()
    t0 = time.perf_counter()
    s = fn(s, dt)
    sync()
    el = time.perf_counter() - t0
    return {"devices": mesh.size, "mesh": [mesh.Rx, mesh.Ry], "global": [Nx, Ny, Nz],
            "seconds": el, "ms_per_step": 1e3 * el / steps,
            "cell_steps_per_sec_per_device": Nx * Ny * Nz * steps / el / mesh.size,
            "exchanges_per_step": comm.permute_count,
            "comm_bytes_per_step_per_device": comm.bytes_per_step}


def combine(records):
    """One row from the ranks' records: the slowest rank's time and the
    largest traffic."""
    row = dict(max(records, key=lambda r: r["seconds"]))
    row["exchanges_per_step"] = max(r["exchanges_per_step"] for r in records)
    row["comm_bytes_per_step_per_device"] = max(r["comm_bytes_per_step_per_device"]
                                                for r in records)
    return row


def _spawned(mesh, tile, Nz, steps, dtype_name):
    import torch

    return run_once(mesh, tile, Nz, steps, dtype_name, torch.device("cpu"))


def sweep_cpu(counts, tile, Nz, steps, dtype_name):
    """Each count on a gloo group of its own spawned CPU ranks."""
    from gb25_tpu_torch.parallel import factors, spawn

    return [combine(spawn(_spawned, n, tile, Nz, steps, dtype_name, shape=factors(n)))
            for n in counts]


def sweep_group(counts, tile, Nz, steps, dtype_name, device):
    """Each count on the first n ranks of the joined group; every rank gets
    the rows."""
    import torch.distributed as dist

    from gb25_tpu_torch.parallel import factors
    from gb25_tpu_torch.parallel.mesh import Mesh

    world, rank = dist.get_world_size(), dist.get_rank()
    rows = []
    for n in counts:
        if n > world:
            raise ValueError(f"count {n} exceeds the group's {world} ranks")
        group = dist.new_group(list(range(n)))  # every rank takes part in making it
        rec = None
        if rank < n:
            rx, ry = factors(n)
            rec = run_once(Mesh(rx, ry, rank, group), tile, Nz, steps, dtype_name, device)
        gathered = [None] * world
        dist.all_gather_object(gathered, rec)
        rows.append(combine([r for r in gathered if r is not None]))
        dist.destroy_process_group(group)
    return rows


def report(rows, args):
    """Print the table and, where its inputs are given, the projection;
    returns the projection (None without it)."""
    from gb25_tpu_torch.analysis.comm import CommStats, project_weak_scaling

    base = rows[0]["cell_steps_per_sec_per_device"]
    print(f"{'devs':>5} {'mesh':>8} {'global':>18} {'s/loop':>8} {'ms/step':>8} "
          f"{'eff':>6} {'exch/st':>8} {'KB/st/dev':>10}")
    for r in rows:
        r["efficiency"] = r["cell_steps_per_sec_per_device"] / base
        print(f"{r['devices']:>5} {str(r['mesh']):>8} {str(r['global']):>18} "
              f"{r['seconds']:>8.2f} {r['ms_per_step']:>8.2f} {r['efficiency']:>6.3f} "
              f"{r['exchanges_per_step']:>8} {r['comm_bytes_per_step_per_device'] / 1e3:>10.1f}")
    if None in (args.compute_ms, args.link_bytes_per_sec, args.latency_s):
        return None
    last = rows[-1]
    stats = CommStats(last["exchanges_per_step"], int(last["comm_bytes_per_step_per_device"]))
    chips = [int(c) for c in args.project_chips.split(",")]
    projection = {("overlap" if ovl else "ablated"): project_weak_scaling(
        args.compute_ms, stats, bytes_per_sec=args.link_bytes_per_sec,
        latency_per_exchange=args.latency_s, chip_counts=chips, overlap=ovl)
        for ovl in (True, False)}
    print(f"\nweak-scaling projection (tile fixed; compute {args.compute_ms:.2f} ms/step, "
          f"{stats.permute_count} exchanges and {stats.bytes_per_step / 1e6:.3f} MB a step a "
          f"rank at {args.link_bytes_per_sec:.3e} B/s and {args.latency_s:.2e} s an exchange; "
          "ranges: the comm term x1 to x2):")
    print(f"{'chips':>6} {'overlap eff':>12} {'ablated eff':>12} {'ablated eff range':>20} "
          f"{'comm ms':>20}")
    for n in chips:
        po, pa = projection["overlap"][n], projection["ablated"][n]
        er, cr = pa["efficiency_range"], pa["comm_ms_range"]
        print(f"{n:>6} {po['efficiency']:>12.3f} {pa['efficiency']:>12.3f} "
              f"{f'[{er[0]:.3f}, {er[1]:.3f}]':>20} {f'[{cr[0]:.3f}, {cr[1]:.3f}]':>20}")
    return projection


def main(argv=None):
    """Run the sweep; returns {"runs", "projection"} (written to --out by
    rank 0)."""
    import torch
    import torch.distributed as dist

    from gb25_tpu_torch.parallel.mesh import join_group
    from gb25_tpu_torch.utils.args import device_of

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tile", default="64",
                   help="tile a rank: N or NXxNY (768x384: the flagship's tile on a 2x2 mesh)")
    p.add_argument("--Nz", type=int, default=8)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--counts", default="1,2,4,8")
    p.add_argument("--cpu-ranks", action="store_true",
                   help="each count on spawned gloo CPU ranks (else the torchrun group's ranks)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu, under torchrun")
    p.add_argument("--project-chips", default="8,16,32,64,128,256")
    p.add_argument("--compute-ms", type=float, default=None,
                   help="the projection's compute term: a measured ms/step at this tile")
    p.add_argument("--link-bytes-per-sec", type=float, default=None,
                   help="the projection's link rate a rank")
    p.add_argument("--latency-s", type=float, default=None,
                   help="the projection's latency of one exchange")
    p.add_argument("--out", default="weak_scaling_results.json")
    args = p.parse_args(argv)
    counts = [int(c) for c in args.counts.split(",")]
    tile = tuple(int(v) for v in args.tile.split("x")) if "x" in args.tile else \
        (int(args.tile),) * 2

    if args.cpu_ranks:
        rows, rank, where = sweep_cpu(counts, tile, args.Nz, args.steps, args.dtype), 0, "cpu"
    else:
        device = join_group(device_of(args))
        try:
            rows = sweep_group(counts, tile, args.Nz, args.steps, args.dtype, device)
            rank = dist.get_rank()
        finally:
            dist.destroy_process_group()
        where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    out = {"runs": rows, "projection": None, "device": where}
    if rank == 0:
        out["projection"] = report(rows, args)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
