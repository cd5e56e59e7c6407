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

    # with the prognostic slab sea ice and T/S restoring
    ccfg, grid, atmos, state = data_free_ocean_climate_model(0.25, 64, sea_ice="slab")
    restoring = data.climatology_restoring(grid)
    state, ice = coupled_ice_loop(ccfg, grid, atmos, state, initial_ice_state(grid), 60.0, n,
                                  restoring=restoring)

    # the rotating shallow-water model (bench.py --config atmosphere)
    cfg, grid, state = shallow_water_model(1536, 768)
    state = sw_loop(cfg, grid, state, 60.0, n)

On the card each loop replays its steps from a captured CUDA graph
(``models.device_loop``), on the decomposed path too where the mesh is the
one card (the forced 1x1 modes); on the CPU and on a mesh of several
ranks it launches them step by step from the host.

The production-run path: ``simulation.Simulation`` (schedules, callbacks,
chunks replayed whole), ``io`` (NPZ and NetCDF surface writers, sharded
checkpoints in the JAX package's format), ``data`` (bathymetry,
climatology restoring and initialization, file atmospheres, NetCDF), and
the run scripts ``python -m gb25_tpu_torch.scripts.ocean_climate_simulation``
and ``python -m gb25_tpu_torch.scripts.run_10day``.
"""

from gb25_tpu_torch import data, io, simulation  # noqa: F401
from gb25_tpu_torch.models import (  # noqa: F401
    SeaIceState,
    SlabSeaIce,
    baroclinic_instability_config,
    baroclinic_instability_model,
    baroclinic_instability_state,
    coupled_ice_loop,
    coupled_ice_time_step,
    coupled_loop,
    coupled_time_step,
    data_free_ocean_climate_model,
    initial_ice_state,
    loop,
    shallow_water_model,
    sw_loop,
    sw_time_step,
    time_step,
)
