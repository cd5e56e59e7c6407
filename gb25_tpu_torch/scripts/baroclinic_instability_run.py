"""The serial baroclinic-instability run (port of the JAX package's
``scripts/baroclinic_instability_run.py``, the reference's
baroclinic_instability_simulation_run.jl): resolution 8 degrees, Nz 10,
dt 60 s, 64-step loops by default.

    python -m gb25_tpu_torch.scripts.baroclinic_instability_run \\
        [--grid-x 1536 --grid-y 768 --grid-z 64] [--steps 64] [--kernels pallas] \\
        [--profile-dir DIR] [--device cpu]

It prints the five phase lines the reference's scrapers read, each
``[0] <label>: X seconds``, the card synchronized at both ends:
  - ``compile first_time_step``: one step on a copy of the initial state
    (``models.device_loop.warm``), which builds, or loads from the build
    directory, the kernels the step's dispatch launches and fills every
    cache; the state the later phases step is not advanced; nothing on the
    CPU;
  - ``compile loop``: capturing the loop's CUDA graph from that copy
    (``models.device_loop.prepare``: 16 steps recorded, not run); nothing
    on the CPU, whose loop runs from the host;
  - ``first time step``: the Euler step (``loop`` of one step, launched
    from the host);
  - ``first loop`` and ``second loop``: ``--steps`` steps each through
    ``loop``, replayed from that graph on the card.
Then ``allocator stats:`` (``torch.cuda.memory_stats`` of each card) and
``done: iteration=... max|u|=...``. ``--profile-dir`` writes a
``torch.profiler`` Chrome trace of the three run phases
(``python -m gb25_tpu_torch.analysis.trace DIR`` summarizes it).
"""

from __future__ import annotations


def main(argv=None):
    """Run the script; returns {"cfg", "grid", "state", "times"} for a
    caller in the same process ("times": each label's seconds)."""
    from gb25_tpu_torch.grids import simple_latitude_longitude_grid
    from gb25_tpu_torch.models import baroclinic_instability_state, device_loop, loop
    from gb25_tpu_torch.models.hydrostatic import loop_step
    from gb25_tpu_torch.utils.args import (
        benchmark_parser,
        build_config,
        device_of,
        float_type,
        resolve_grid_size,
    )
    from gb25_tpu_torch.utils.profiling import Timer, allocator_stats, with_profiler

    p = benchmark_parser("serial baroclinic instability run")
    p.set_defaults(resolution=8.0, Nz=10, steps=64)
    args = p.parse_args(argv)
    device = device_of(args)
    dtype = float_type(args.float_type)
    Nx, Ny, Nz = resolve_grid_size(args)

    grid = simple_latitude_longitude_grid(Nx, Ny, Nz, device=device, dtype=dtype)
    cfg = build_config(args)
    state = baroclinic_instability_state(grid, tracers=cfg.tracers)
    dt = args.dt

    step = loop_step(cfg, grid, dt)
    timer = Timer()
    with timer("compile first_time_step"):
        warmed = device_loop.warm(step, state)
    with timer("compile loop"):
        device_loop.prepare(step, warmed, grid.cache)
    del warmed

    with with_profiler(args.profile_dir):
        with timer("first time step"):
            state = loop(cfg, grid, state, dt, 1)
        with timer("first loop"):
            state = loop(cfg, grid, state, dt, args.steps)
        with timer("second loop"):
            state = loop(cfg, grid, state, dt, args.steps)

    print("allocator stats:", allocator_stats())
    print(f"done: iteration={state.iteration} max|u|={float(state.u.abs().max()):.4f}")
    return {"cfg": cfg, "grid": grid, "state": state, "times": timer.times}


if __name__ == "__main__":
    main()
