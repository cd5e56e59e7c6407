"""The differential correctness run (port of the JAX package's
``scripts/correctness_baroclinic_instability_run.py``, the reference's
correctness_baroclinic_instability_simulation_run.jl): the decomposed
model against the serial one from the same state (random ~1e-3 m/s
velocities, dt = 1e-9 s), compared at rtol = sqrt(eps) of the state's
dtype (atol 0) at five checkpoints: post-init, after the first step, after
10 steps, after a re-sync (``sync_states``, compared at rtol 0), after a
100-step loop.

    torchrun --nproc-per-node 4 -m gb25_tpu_torch.scripts.correctness_baroclinic_instability_run \\
        --distributed
    python -m gb25_tpu_torch.scripts.correctness_baroclinic_instability_run --force-comm local

The decomposed model runs on the group's ranks (``--distributed`` joins the
torchrun group, as the sharded run script does); on one rank
``--force-comm local`` or ``ring`` keeps the decomposed program on the one
device (without it the 1x1 mesh takes the serial route and the run
compares the model with itself). ``protocol`` is the run itself, for a
caller that brings its own mesh.
"""

from __future__ import annotations

CHECKPOINTS = ("post-init", "post first step", "after 10 steps", "re-sync", "after the loop")


def protocol(mesh, cfg, grid, state, dt, loop_steps=100, force_comm=False, keep_states=False):
    """The five checkpoints on this rank: the serial model on ``grid``
    (``time_step``, ``loop``) against the model decomposed over ``mesh``
    (``sharded_step_fn``, forced onto a 1x1 mesh by ``force_comm``), both
    from the global ``state``, the decomposed state gathered for each
    comparison, at rtol sqrt(eps) of the state's dtype (``default_rtol``).
    Raises at the first checkpoint outside it; returns [(checkpoint, report,
    serial state as JAX-layout numpy arrays where ``keep_states``)],
    ``report`` ``utils.correctness.compare_states``'s (name, max|serial|,
    max|difference|, argmax) per field."""
    from gb25_tpu_torch.convert import state_to_numpy
    from gb25_tpu_torch.models import loop, time_step
    from gb25_tpu_torch.parallel import gather_state, shard_state, sharded_step_fn
    from gb25_tpu_torch.utils.correctness import compare_states, default_rtol, sync_states

    rtol = default_rtol(state.u.dtype)
    fn = sharded_step_fn(cfg, grid, mesh, n_inner=loop_steps, force_comm=force_comm)
    s_ref, s_sh = state, shard_state(state, mesh)
    out = []

    def check(name, tol=rtol):
        print(f"== {name} ==", flush=True)
        report = compare_states(s_ref, gather_state(s_sh, mesh), rtol=tol)
        out.append((name, report, state_to_numpy(s_ref) if keep_states else None))

    check(CHECKPOINTS[0])
    s_ref, s_sh = time_step(cfg, grid, s_ref, dt), fn(s_sh, dt, 1)
    check(CHECKPOINTS[1])
    for _ in range(10):
        s_ref, s_sh = time_step(cfg, grid, s_ref, dt), fn(s_sh, dt, 1)
    check(CHECKPOINTS[2])
    s_sh = sync_states(s_ref, s_sh, mesh)
    check(CHECKPOINTS[3], tol=0.0)
    s_ref, s_sh = loop(cfg, grid, s_ref, dt, loop_steps), fn(s_sh, dt)
    check(CHECKPOINTS[4])
    return out


def parse_args(argv=None):
    from gb25_tpu_torch.utils.args import benchmark_parser

    p = benchmark_parser("sharded-vs-serial correctness")
    p.set_defaults(resolution=8.0, Nz=10, dt=1e-9)
    p.add_argument("--n-devices", type=int, default=None,
                   help="ranks of the mesh (the group's size, which it must equal)")
    p.add_argument("--distributed", action="store_true",
                   help="join the torchrun group (env://): NCCL on cards, gloo on the CPU")
    p.add_argument("--force-comm", default="none", choices=["none", "local", "ring"],
                   help="on a 1x1 mesh, keep the decomposed program on the one device")
    return p.parse_args(argv)


def run(args, device, loop_steps=100, keep_states=False):
    """The protocol of ``args`` on this rank's mesh, its last loop
    ``loop_steps`` long; returns ``protocol``'s list."""
    from gb25_tpu_torch.grids import simple_latitude_longitude_grid
    from gb25_tpu_torch.models import baroclinic_instability_state
    from gb25_tpu_torch.parallel import make_mesh
    from gb25_tpu_torch.utils.args import build_config, check_mesh, float_type, resolve_grid_size

    Nx, Ny, Nz = resolve_grid_size(args)
    grid = simple_latitude_longitude_grid(Nx, Ny, Nz, device=device,
                                          dtype=float_type(args.float_type))
    cfg = build_config(args)
    state = baroclinic_instability_state(grid, noise_velocity=1e-3, tracers=cfg.tracers)
    force = False if args.force_comm == "none" else args.force_comm
    out = protocol(check_mesh(make_mesh(), args), cfg, grid, state, args.dt, loop_steps, force,
                   keep_states=keep_states)
    print("CORRECTNESS OK", flush=True)
    return out


def main(argv=None):
    """Run the protocol on this rank; returns ``protocol``'s list."""
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
