"""The sharded baroclinic-instability benchmark run (port of the JAX
package's ``scripts/sharded_baroclinic_instability_run.py``, the
reference's sharded_baroclinic_instability_simulation_run.jl): one process
per rank, the 2-D mesh ``factors(n)`` of the group's n ranks, a fixed tile
per rank (512 x 512 x 64 by default), dt 1 s, 256-step loops.

    torchrun --nproc-per-node 4 -m gb25_tpu_torch.scripts.sharded_baroclinic_instability_run \\
        --distributed --tile-x 768 --tile-y 768
    python -m gb25_tpu_torch.scripts.sharded_baroclinic_instability_run \\
        --tile-x 1536 --tile-y 768 --steps 64 --save-dir DIR     # a group of one rank

``--distributed`` joins the group ``torchrun`` describes (env://; NCCL on
the cards, one card a rank by ``LOCAL_RANK``; gloo with ``--device
cpu``); without it the script runs on a group of one rank, where the tile
is the whole grid and the step takes the serial route (kernels K1 and K2),
unless a group is already joined (``parallel.spawn``'s gloo ranks). Every
rank prints the JAX script's phase lines, ``[rank] <label>: X seconds``:
``compile first`` (one step of the tile's step function on a copy of the
tile, which builds or loads the kernels it launches, without advancing the
state: ``models.device_loop.warm``; nothing on the CPU), ``compile loop``
(capturing the loop's CUDA graph from that copy where one card holds the
mesh: ``models.device_loop.prepare``; a mesh of several ranks runs its
loop from the host, so nothing), ``first time
step``, ``first loop`` and ``second loop`` (``--steps`` steps each, through
one ``sharded_step_fn``), the allocator's stats after the compile phases
and after the run, and with ``--save-dir`` ``sharded state dump``: each
rank's tile with its global slices (``io.save_sharded_state``, the JAX
package's format).
"""

from __future__ import annotations

import functools


def parse_args(argv=None):
    from gb25_tpu_torch.utils.args import benchmark_parser

    p = benchmark_parser("sharded baroclinic instability benchmark")
    p.add_argument("--tile-x", type=int, default=512, help="per-rank tile in x")
    p.add_argument("--tile-y", type=int, default=512)
    p.add_argument("--n-devices", type=int, default=None,
                   help="ranks of the mesh (the group's size, which it must equal)")
    p.add_argument("--distributed", action="store_true",
                   help="join the torchrun group (env://): NCCL on cards, gloo on the CPU")
    p.add_argument("--save-dir", default=None, help="per-rank sharded state dumps")
    p.set_defaults(steps=256, dt=1.0, Nz=64)
    return p.parse_args(argv)


def run(args, device):
    """The run on this rank; returns {"cfg", "grid", "mesh", "fn", "state",
    "times"} ("state": this rank's tile after the run)."""
    import torch

    from gb25_tpu_torch.grids import simple_latitude_longitude_grid
    from gb25_tpu_torch.models import baroclinic_instability_state, device_loop
    from gb25_tpu_torch.parallel import make_mesh, shard_state, sharded_step_fn
    from gb25_tpu_torch.utils.args import build_config, check_mesh, float_type
    from gb25_tpu_torch.utils.profiling import Timer, allocator_stats, with_profiler

    mesh = check_mesh(make_mesh(), args)
    rx, ry = mesh.Rx, mesh.Ry
    Nx, Ny, Nz = args.tile_x * rx, args.tile_y * ry, args.Nz
    dtype = float_type(args.float_type)
    rank = mesh.rank
    timer = Timer(rank)
    print(f"[{rank}] mesh {rx}x{ry}, global grid {Nx}x{Ny}x{Nz}, {args.steps}-step loop",
          flush=True)

    grid = simple_latitude_longitude_grid(Nx, Ny, Nz, device=device, dtype=dtype)
    cfg = build_config(args)
    # the global initial state (its noise drawn as the serial run draws it),
    # cut to this rank's tile
    state = shard_state(baroclinic_instability_state(grid, tracers=cfg.tracers), mesh)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    dt = args.dt
    fn = sharded_step_fn(cfg, grid, mesh, n_inner=args.steps)

    step = functools.partial(fn.step, dt=dt)
    with timer("compile first"):
        warmed = device_loop.warm(step, state)
    with timer("compile loop"):
        if not device_loop.spans_ranks(fn.comm):
            device_loop.prepare(step, warmed, fn.grid.cache)
    del warmed
    print(f"[{rank}] allocator after compile:", allocator_stats(), flush=True)

    with with_profiler(args.profile_dir):
        with timer("first time step"):
            state = fn(state, dt, 1)
        with timer("first loop"):
            state = fn(state, dt)
        with timer("second loop"):
            state = fn(state, dt)

    print(f"[{rank}] allocator after run:", allocator_stats(), flush=True)
    if args.save_dir:
        from gb25_tpu_torch.io import save_sharded_state

        with timer("sharded state dump"):
            save_sharded_state(state, args.save_dir, mesh=mesh)

    print(f"[{rank}] done iteration={state.iteration} cells={Nx * Ny * Nz}", flush=True)
    return {"cfg": cfg, "grid": grid, "mesh": mesh, "fn": fn, "state": state,
            "times": timer.times}


def main(argv=None):
    """Run the script on this rank; returns ``run``'s record."""
    import torch.distributed as dist

    from gb25_tpu_torch.parallel.mesh import join_group
    from gb25_tpu_torch.utils.args import device_of

    args = parse_args(argv)
    device = device_of(args)
    if not args.distributed:
        return run(args, device)
    device = join_group(device)
    try:
        return run(args, device)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
