"""The coupled ocean-atmosphere climate step as plain PyTorch (a frozen copy
of the port's ``models/coupled.py``, serial only).

Each coupled step: (1) the prescribed atmosphere at the model time,
(2) the similarity bulk fluxes against the ocean surface state, (3) the
radiation balance, (4) the kinematic fluxes deposited into the ocean's top
cells, (5) the ocean's hydrostatic step (with CATKE; optionally with T/S
restoring), then (6) the freezing limiter. With the prognostic
``SlabSeaIce`` (``coupled_ice_time_step``) the ice thermodynamics run
first, the open-water fluxes are shaded by the ice fraction and joined by
the ice's coupling fluxes and the ice-ocean drag, and the ice drifts
before the ocean steps.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.ocean.models.catke import CATKEVerticalDiffusivity, surface_tke_flux
from benchmark.reference.ocean.models.config import HydrostaticConfig
from benchmark.reference.ocean.models.fluxes import (
    Radiation,
    SimilarityTheoryFluxes,
    radiative_fluxes,
    similarity_fluxes,
)
from benchmark.reference.ocean.models.hydrostatic import time_step
from benchmark.reference.ocean.models.seaice import (
    FreezingLimitedOceanTemperature,
    SlabSeaIce,
    limit_ocean_temperature,
    seaice_advect,
    seaice_thermodynamics,
)
from benchmark.reference.ocean.ops.halos import extend2


@dataclasses.dataclass(frozen=True)
class CoupledConfig:
    ocean: HydrostaticConfig = None
    fluxes: SimilarityTheoryFluxes = SimilarityTheoryFluxes()
    radiation: Radiation = Radiation()
    # FreezingLimitedOceanTemperature (the reference's constructor default)
    # or the prognostic SlabSeaIce
    sea_ice: FreezingLimitedOceanTemperature | SlabSeaIce = FreezingLimitedOceanTemperature()
    rho_ocean: float = 1020.0
    cp_ocean: float = 3991.0
    rho_freshwater: float = 1000.0


def compute_interface_fluxes(ccfg: CoupledConfig, grid, atmos, state, ice_cover=None,
                             ice_coupling=None):
    """Air-sea fluxes on the ocean's centers, returned as the dict of
    (Ny, Nx) kinematic surface fluxes the ocean step deposits ({"u", "v",
    "T", "S"} and "e" with CATKE) and a dict of diagnostics. ``ice_cover`` and ``ice_coupling`` (the prognostic
    ``SlabSeaIce``, from ``seaice_thermodynamics``): the open-water fluxes
    shaded by 1 - a, the ice's coupling fluxes added, and under the ice
    fraction the ice-ocean drag in place of the wind stress."""
    return _interface_fluxes(ccfg, grid, atmos.at_time(state.time), state, ice_cover,
                             ice_coupling)


def _interface_fluxes(ccfg, grid, a, state, ice_cover=None, ice_coupling=None):
    """``compute_interface_fluxes`` of the atmosphere's fields ``a`` at the
    model time."""
    S_surf = state.tracers["S"][-1]
    # the bulk solve sees the freezing-limited surface temperature
    To_K = ccfg.sea_ice.limit(state.tracers["T"][-1], S_surf) + 273.15

    # the wind is taken relative to the surface currents at centers: the x
    # average of u (periodic), the y average of v (no flux through the
    # north wall, or the fold's ghost face on the tripolar grid)
    ue = extend2(grid, state.u[-1], "u")
    ve = extend2(grid, state.v[-1], "v")
    uo = 0.5 * (ue[1:-1, 2:] + ue[1:-1, 1:-1])
    vo = 0.5 * (ve[2:, 1:-1] + ve[1:-1, 1:-1])

    turb = similarity_fluxes(ccfg.fluxes, a, To_K, uo, vo)
    Q_rad = radiative_fluxes(ccfg.radiation, a, To_K)
    Q_net = Q_rad + turb["Q_sensible"] + turb["Q_latent"]

    rho0, cp0 = ccfg.rho_ocean, ccfg.cp_ocean
    # kinematic fluxes into the top cell (positive into the ocean)
    T_flux = Q_net / (rho0 * cp0)
    E = turb["evaporation"] / ccfg.rho_freshwater  # freshwater volume flux, m/s
    S_flux = S_surf * E  # virtual salinity flux (evaporation concentrates salt)

    # stress at centers, then at the velocity points
    taux_c = turb["tau_x"] / rho0
    tauy_c = turb["tau_y"] / rho0

    if ice_cover is not None:
        si = ccfg.sea_ice
        shade = 1.0 - ice_cover
        T_flux = T_flux * shade + ice_coupling["T_flux"]
        S_flux = S_flux * shade + ice_coupling["S_flux"]
        # under the ice fraction the ocean feels the free-drift ice-ocean
        # drag (relative velocity wind_drift_factor u_a), not the wind
        wdf2 = si.wind_drift_factor**2
        Ua = torch.sqrt(a["ua"] * a["ua"] + a["va"] * a["va"])
        taux_c = taux_c * shade + ice_cover * si.ice_ocean_drag * wdf2 * Ua * a["ua"]
        tauy_c = tauy_c * shade + ice_cover * si.ice_ocean_drag * wdf2 * Ua * a["va"]

    tx = extend2(grid, taux_c, "c")
    ty = extend2(grid, tauy_c, "c")
    taux_u = 0.5 * (tx[1:-1, 1:-1] + tx[1:-1, :-2])
    tauy_v = 0.5 * (ty[1:-1, 1:-1] + ty[:-2, 1:-1])

    fluxes = {"u": taux_u, "v": tauy_v, "T": T_flux, "S": S_flux}
    if isinstance(ccfg.ocean.closure, CATKEVerticalDiffusivity):
        # the closure's surface condition: TKE injection from u*
        fluxes["e"] = surface_tke_flux(ccfg.ocean.closure, taux_c, tauy_c)
    return fluxes, {"Q_net": Q_net, **turb}


def coupled_time_step(ccfg: CoupledConfig, grid, atmos, state, dt, premasked=False,
                      restoring=None):
    """One coupled step: interface fluxes, the ocean's step (with
    ``restoring``, T/S relaxed toward its targets), then the freezing
    limiter."""
    fluxes, _ = compute_interface_fluxes(ccfg, grid, atmos, state)
    state = time_step(ccfg.ocean, grid, state, dt, surface_fluxes=fluxes, premasked=premasked,
                      restoring=restoring)
    return limit_ocean_temperature(ccfg.sea_ice, state)


def coupled_ice_time_step(ccfg: CoupledConfig, grid, atmos, state, ice, dt, restoring=None,
                          premasked=False):
    """One coupled step with the prognostic ``SlabSeaIce``: the ice
    thermodynamics, the shaded and augmented interface fluxes, the ice's
    free drift, the ocean's step, the freezing limiter. Returns (state,
    ice)."""
    si = ccfg.sea_ice
    af = atmos.at_time(state.time)
    ice_th, coup = seaice_thermodynamics(si, grid, af, state, ice, dt)
    fluxes, _ = _interface_fluxes(ccfg, grid, af, state, ice_cover=coup["shade"],
                                  ice_coupling=coup)
    ice_new = seaice_advect(si, grid, state, ice_th, af, dt)
    state = time_step(ccfg.ocean, grid, state, dt, surface_fluxes=fluxes, premasked=premasked,
                      restoring=restoring)
    return limit_ocean_temperature(si, state), ice_new
