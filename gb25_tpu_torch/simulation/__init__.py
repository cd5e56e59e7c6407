"""The simulation driver: schedules, callbacks, writers, checkpoints."""

from gb25_tpu_torch.simulation.simulation import (  # noqa: F401
    CheckpointWriter,
    IterationInterval,
    Simulation,
    TimeInterval,
    progress_callback,
)
