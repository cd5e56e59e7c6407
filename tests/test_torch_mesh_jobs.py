"""The work of the one 2x1 gloo spawn that the production path's
decomposed test cases share (tests/test_torch_data.py): each rank runs
every case, so the ranks start and join once. It holds no test of its
own, and imports the port alone, which keeps the spawned processes'
start short."""

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
