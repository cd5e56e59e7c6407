from gb25_tpu_torch.models.baroclinic import (  # noqa: F401
    balanced_jet_state,
    baroclinic_instability_config,
    baroclinic_instability_model,
    baroclinic_instability_state,
    buoyancy_tracer_state,
)
from gb25_tpu_torch.models.config import (  # noqa: F401
    EARTH_ROTATION_RATE,
    ExplicitFreeSurface,
    HydrostaticConfig,
    SplitExplicitFreeSurface,
    VerticalScalarDiffusivity,
)
from gb25_tpu_torch.models.coupled import (  # noqa: F401
    CoupledConfig,
    OceanIceState,
    coupled_ice_loop,
    coupled_ice_time_step,
    coupled_loop,
    coupled_time_step,
    data_free_ocean_climate_model,
)
from gb25_tpu_torch.models.hydrostatic import loop, time_step  # noqa: F401
from gb25_tpu_torch.models.seaice import (  # noqa: F401
    FreezingLimitedOceanTemperature,
    SeaIceState,
    SlabSeaIce,
    initial_ice_state,
)
from gb25_tpu_torch.models.shallow_water import (  # noqa: F401
    ShallowWaterConfig,
    shallow_water_model,
    shallow_water_state,
    sw_loop,
    sw_tendencies,
    sw_time_step,
)
from gb25_tpu_torch.models.state import (  # noqa: F401
    HydrostaticState,
    ShallowWaterState,
    advance_clock,
    initial_state,
)
