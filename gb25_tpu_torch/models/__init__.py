from gb25_tpu_torch.models.baroclinic import (  # noqa: F401
    baroclinic_instability_config,
    baroclinic_instability_model,
    baroclinic_instability_state,
)
from gb25_tpu_torch.models.config import (  # noqa: F401
    EARTH_ROTATION_RATE,
    HydrostaticConfig,
    SplitExplicitFreeSurface,
)
from gb25_tpu_torch.models.hydrostatic import loop, time_step  # noqa: F401
from gb25_tpu_torch.models.state import HydrostaticState, advance_clock, initial_state  # noqa: F401
