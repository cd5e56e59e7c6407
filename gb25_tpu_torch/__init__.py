"""gb25_tpu_torch: the PyTorch / CUDA port of gb25_tpu for one NVIDIA H100.

Fields are stored (Z, Y, X) with x contiguous. The flagship step runs two
hand-written Hopper kernels (``csrc/``), built with ``nvcc`` at first use;
on CPU tensors their plain PyTorch versions run instead. The JAX package
``gb25_tpu`` is the reference the port is tested against.

    cfg, grid, state = baroclinic_instability_model(1536, 768, 64, device="cuda")
    state = loop(cfg, grid, state, 60.0, n)
"""

from gb25_tpu_torch.models import (  # noqa: F401
    baroclinic_instability_config,
    baroclinic_instability_model,
    baroclinic_instability_state,
    loop,
    time_step,
)
