"""The plain reference of ``configs/ocean_climate_q.json``: the production
ocean-climate run on the tripolar grid with the Gaussian islands, CATKE,
T/S restoring to the synthetic climatology, the data-free atmosphere and
the slab sea ice, built and stepped by the frozen plain path
(``reference.ocean``) in its own dtype: its grid, masks, climatology,
restoring targets and atmosphere record are its own."""

from __future__ import annotations

import dataclasses

from benchmark.reference.model import Model
from benchmark.reference.ocean.data.datasets import (
    climatology_restoring,
    initial_state_from_climatology,
)
from benchmark.reference.ocean.grids.immersed import gaussian_islands_bottom
from benchmark.reference.ocean.grids.tripolar import tripolar_grid
from benchmark.reference.ocean.models.atmosphere import data_free_atmosphere
from benchmark.reference.ocean.models.baroclinic import baroclinic_instability_config
from benchmark.reference.ocean.models.catke import CATKEVerticalDiffusivity
from benchmark.reference.ocean.models.coupled import CoupledConfig, coupled_ice_time_step
from benchmark.reference.ocean.models.seaice import SeaIceState, SlabSeaIce, initial_ice_state


@dataclasses.dataclass(frozen=True)
class OceanIce:
    """The coupled state: the ocean's and the sea ice's."""

    ocean: object
    ice: SeaIceState


def build(config, route, device, dtype):
    """The reference ``Model`` of ``config`` on the ``route``."""
    grid = gaussian_islands_bottom(tripolar_grid(config["Nx"], config["Ny"], config["Nz"],
                                                 device=device, dtype=dtype))
    ocean = baroclinic_instability_config(closure=CATKEVerticalDiffusivity(), kernels=route)
    ccfg = CoupledConfig(ocean=ocean, sea_ice=SlabSeaIce())
    atmos = data_free_atmosphere(grid, dtype=dtype)
    restoring = climatology_restoring(grid, rate=1.0 / (config["restoring_days"] * 86400.0))
    state = OceanIce(initial_state_from_climatology(grid, ocean), initial_ice_state(grid))
    dt = config["dt"]

    def advance(s):
        ocean_state, ice = coupled_ice_time_step(ccfg, grid, atmos, s.ocean, s.ice, dt,
                                                 restoring=restoring)
        return OceanIce(ocean_state, ice)

    names = (("ocean/u", "ocean/v", "ocean/eta")
             + tuple(f"ocean/tracers/{k}" for k in ocean.tracers) + ("ice/v", "ice/a"))
    return Model(state, advance, names, ("ocean/u", "ocean/v"))
