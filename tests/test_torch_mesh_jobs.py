"""The work of gloo spawns whose worker the port does not hold: the one
2x1 spawn that the production path's decomposed test cases share
(tests/test_torch_data.py: each rank runs every case, so the ranks start
and join once), the halo extension's traffic
(tests/test_torch_diagnostics.py) and the run scripts on a rank
(tests/test_torch_run_scripts.py). It holds no test of its own, and
imports the port alone, which keeps the spawned processes' start short."""

from gb25_tpu_torch.parallel.sharded import (
    checkpoint_decomposed,
    run_decomposed,
    run_decomposed_seaice_advect,
)


def production_cases(mesh, restoring_case, advect_cases, checkpoint_case):
    """``run_decomposed`` of ``restoring_case``, ``run_decomposed_seaice_advect``
    of each of ``advect_cases`` and ``checkpoint_decomposed`` of
    ``checkpoint_case`` on this rank's tile; the gathered results."""
    restoring = run_decomposed(mesh, *restoring_case)
    advect = [run_decomposed_seaice_advect(mesh, *case) for case in advect_cases]
    checkpoint_decomposed(mesh, *checkpoint_case)
    return {"restoring": restoring, "advect": advect}


def extension_traffic(mesh, shape):
    """The exchanges posted and the bytes sent by this rank of ``mesh`` in
    one halo extension of a 3-D float64 field on its tile of a lat-lon grid
    of ``shape`` (tests/test_torch_diagnostics.py)."""
    import torch

    from gb25_tpu_torch.grids import simple_latitude_longitude_grid
    from gb25_tpu_torch.ops.halos import extend_field
    from gb25_tpu_torch.parallel import localize_grid, make_comm

    Nx, Ny, Nz = shape
    grid = simple_latitude_longitude_grid(Nx, Ny, Nz, device="cpu", dtype=torch.float64)
    comm = make_comm(mesh, grid)
    lgrid = localize_grid(grid, comm, Nx // mesh.Rx, Ny // mesh.Ry)
    extend_field(lgrid, torch.zeros(lgrid.shape, dtype=torch.float64), "c", comm)
    return comm.traffic.exchanges, comm.traffic.bytes_sent, (mesh.ix, mesh.iy)


def sharded_script(mesh, argv):
    """The sharded run script's main on this rank of the spawned group
    (the script's mesh takes the group over); this rank's final tile as
    JAX-layout numpy arrays."""
    from gb25_tpu_torch.convert import state_to_numpy
    from gb25_tpu_torch.scripts.sharded_baroclinic_instability_run import main

    return state_to_numpy(main(argv)["state"])


def correctness_protocol(mesh, argv, loop_steps):
    """The correctness script's protocol of ``argv`` on this rank, its
    last loop ``loop_steps`` long, the serial state kept at each
    checkpoint."""
    from gb25_tpu_torch.scripts import correctness_baroclinic_instability_run as script
    from gb25_tpu_torch.utils.args import device_of

    args = script.parse_args(argv)
    return script.run(args, device_of(args), loop_steps, keep_states=True)


def sharding_checks(mesh):
    """The sharding checks on this rank (CPU tensors)."""
    import torch

    from gb25_tpu_torch.scripts.simple_sharding_checks import checks

    return checks(mesh, torch.device("cpu"))
