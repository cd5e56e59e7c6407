"""Dataset inputs: bathymetry, climatology restoring and initialization,
file-backed atmospheres, and the NetCDF reader and writer."""

from gb25_tpu_torch.data.datasets import (  # noqa: F401
    climatology_restoring,
    file_prescribed_atmosphere,
    initial_state_from_climatology,
    linearly_tapered_polar_mask,
    regrid_bathymetry,
)
