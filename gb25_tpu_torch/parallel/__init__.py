"""The decomposed (distributed) path: a 2-D process grid over
``torch.distributed``, halo exchange between neighbouring tiles, the
tripolar fold across the top rank row, per-tile grids and the sharded
step."""

from gb25_tpu_torch.parallel.halo import MeshComm, make_comm  # noqa: F401
from gb25_tpu_torch.parallel.localize import localize_atmosphere, localize_grid  # noqa: F401
from gb25_tpu_torch.parallel.mesh import Mesh, factors, make_mesh, spawn  # noqa: F401
from gb25_tpu_torch.parallel.sharded import (  # noqa: F401
    gather_state,
    run_decomposed,
    run_decomposed_sw,
    shard_state,
    sharded_coupled_step_fn,
    sharded_step_fn,
)
