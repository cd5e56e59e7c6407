"""gb25_tpu_torch: the PyTorch / CUDA port of gb25_tpu for one NVIDIA H100.

Fields are stored (Z, Y, X) with x contiguous. The steps run hand-written
Hopper kernels (``csrc/``), built with ``nvcc`` at first use; on CPU
tensors their plain PyTorch versions run instead. The JAX package
``gb25_tpu`` is the reference the port is tested against.

    # the flagship baroclinic-instability ocean
    cfg, grid, state = baroclinic_instability_model(1536, 768, 64)
    state = loop(cfg, grid, state, 60.0, n)

    # the coupled climate model: Gaussian islands, CATKE, air-sea fluxes
    ccfg, grid, atmos, state = data_free_ocean_climate_model(resolution=0.25, Nz=64)
    state = coupled_loop(ccfg, grid, atmos, state, 60.0, n)

    # the rotating shallow-water model (bench.py --config atmosphere)
    cfg, grid, state = shallow_water_model(1536, 768)
    state = sw_loop(cfg, grid, state, 60.0, n)

On the card each loop replays its steps from a captured CUDA graph
(``models.device_loop``), on the decomposed path too where the mesh is the
one card (the forced 1x1 modes); on the CPU and on a mesh of several
ranks it launches them step by step from the host.
"""

from gb25_tpu_torch.models import (  # noqa: F401
    baroclinic_instability_config,
    baroclinic_instability_model,
    baroclinic_instability_state,
    coupled_loop,
    coupled_time_step,
    data_free_ocean_climate_model,
    loop,
    shallow_water_model,
    sw_loop,
    sw_time_step,
    time_step,
)
