"""Output writers and sharded checkpoints, in the JAX package's file
formats."""

from gb25_tpu_torch.io.checkpoint import (  # noqa: F401
    load_all_fields,
    load_global_field,
    load_metadata,
    restore_state,
    save_sharded_state,
)
from gb25_tpu_torch.io.output import (  # noqa: F401
    STANDARD_OUTPUTS,
    NetCDFOutputWriter,
    NPZOutputWriter,
    read_series,
)
