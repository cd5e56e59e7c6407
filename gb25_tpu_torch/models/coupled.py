"""The coupled ocean-atmosphere climate model (port of
``gb25_tpu.models.coupled``, without prognostic sea ice), on the whole
domain or on one tile of the decomposed path (``comm``).

Each coupled step: (1) the prescribed atmosphere at the model time,
(2) the similarity bulk fluxes against the ocean surface state, (3) the
radiation balance, (4) the kinematic fluxes deposited into the ocean's top
cells, (5) the ocean's hydrostatic step with CATKE, then (6) the freezing
limiter. The ocean runs CATKE, as the JAX package's data-free model does by
default.

The ocean runs on the lat-lon band with the two Gaussian islands
(``grid_type="gaussian_islands"``, the JAX package's default), without
bathymetry (``"latlon"``), or on the tripolar grid with the islands on its
two north poles (``"gaussian_islands_tripolar"``, the reference's
benchmark configuration).
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch.profiler import record_function

from gb25_tpu_torch.grids import resolution_to_points, simple_latitude_longitude_grid
from gb25_tpu_torch.grids.immersed import gaussian_islands_bottom
from gb25_tpu_torch.grids.tripolar import tripolar_grid
from gb25_tpu_torch.models.atmosphere import data_free_atmosphere
from gb25_tpu_torch.models.baroclinic import baroclinic_instability_config, smooth_step
from gb25_tpu_torch.models.catke import CATKEVerticalDiffusivity, surface_tke_flux
from gb25_tpu_torch.models.config import HydrostaticConfig
from gb25_tpu_torch.models.device_loop import run_loop
from gb25_tpu_torch.models.fluxes import (
    Radiation,
    SimilarityTheoryFluxes,
    radiative_fluxes,
    similarity_fluxes,
)
from gb25_tpu_torch.models.hydrostatic import premask_state, time_step
from gb25_tpu_torch.models.seaice import FreezingLimitedOceanTemperature, limit_ocean_temperature
from gb25_tpu_torch.models.state import initial_state
from gb25_tpu_torch.ops.halos import extend2


@dataclasses.dataclass(frozen=True)
class CoupledConfig:
    ocean: HydrostaticConfig = None
    fluxes: SimilarityTheoryFluxes = SimilarityTheoryFluxes()
    radiation: Radiation = Radiation()
    sea_ice: FreezingLimitedOceanTemperature = FreezingLimitedOceanTemperature()
    rho_ocean: float = 1020.0
    cp_ocean: float = 3991.0
    rho_freshwater: float = 1000.0


def compute_interface_fluxes(ccfg: CoupledConfig, grid, atmos, state, comm=None):
    """Air-sea fluxes on the ocean's centers, returned as the dict of
    (Ny, Nx) kinematic surface fluxes the ocean step deposits ({"u", "v",
    "T", "S"} and "e" with CATKE) and a dict of diagnostics. ``comm``: the
    tile's halo exchange (the width-1 extensions come from the
    neighbours)."""
    a = atmos.at_time(state.time)
    S_surf = state.tracers["S"][-1]
    # the bulk solve sees the freezing-limited surface temperature
    To_K = ccfg.sea_ice.limit(state.tracers["T"][-1], S_surf) + 273.15

    # the wind is taken relative to the surface currents at centers: the x
    # average of u (periodic), the y average of v (no flux through the
    # north wall, or the fold's ghost face on the tripolar grid)
    ue = extend2(grid, state.u[-1], "u", comm=comm)
    ve = extend2(grid, state.v[-1], "v", comm=comm)
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
    tx = extend2(grid, taux_c, "c", comm=comm)
    ty = extend2(grid, tauy_c, "c", comm=comm)
    taux_u = 0.5 * (tx[1:-1, 1:-1] + tx[1:-1, :-2])
    tauy_v = 0.5 * (ty[1:-1, 1:-1] + ty[:-2, 1:-1])

    # with CATKE, the closure's surface condition: TKE injection from u*
    fluxes = {"u": taux_u, "v": tauy_v, "T": T_flux, "S": S_flux,
              "e": surface_tke_flux(ccfg.ocean.closure, taux_c, tauy_c)}
    return fluxes, {"Q_net": Q_net, **turb}


def coupled_time_step(ccfg: CoupledConfig, grid, atmos, state, dt, premasked=False, comm=None):
    """One coupled step: interface fluxes, the ocean's step, then the
    freezing limiter; with ``comm``, of the tile ``grid``."""
    with record_function("step/interface_fluxes"):
        fluxes, _ = compute_interface_fluxes(ccfg, grid, atmos, state, comm)
    state = time_step(ccfg.ocean, grid, state, dt, surface_fluxes=fluxes, premasked=premasked,
                      comm=comm)
    with record_function("step/freezing_limiter"):
        return limit_ocean_temperature(ccfg.sea_ice, state)


def coupled_loop(ccfg: CoupledConfig, grid, atmos, state, dt, n, comm=None):
    """``n`` coupled steps (the immersed mask applied once, before the
    first): on the card replayed from a captured CUDA graph
    (``device_loop``), also with a ``comm`` whose mesh is the one card; on
    the CPU and with a ``comm`` of several ranks from the host."""
    state = premask_state(grid, state)
    step = functools.partial(coupled_time_step, ccfg, grid, atmos, dt=dt, premasked=True,
                             comm=comm)
    return run_loop(step, state, n, comm, grid.cache)


def data_free_ocean_climate_model(resolution=2.0, Nz=20, *, device="cuda", dtype=torch.float32,
                                  grid_type="gaussian_islands", kernels="auto"):
    """Config, grid, atmosphere and initial state of the data-free coupled
    climate model: the lat-lon band at ``resolution`` degrees
    (384/resolution x 192/resolution cells) with the two Gaussian islands,
    CATKE, 30 barotropic substeps, the analytic atmosphere and the
    freezing limiter; T = (30 + 1e-3 z) smooth_step(phi), S = -5e-3 z,
    e = 1e-6, at rest.

    ``grid_type``: "gaussian_islands", "latlon" (no bathymetry) or
    "gaussian_islands_tripolar" (the islands on the tripolar grid, whose
    initial T follows the true 2-D latitude)."""
    Nx, Ny = resolution_to_points(resolution)
    if grid_type == "gaussian_islands_tripolar":
        grid = gaussian_islands_bottom(tripolar_grid(Nx, Ny, Nz, device=device, dtype=dtype))
    elif grid_type in ("gaussian_islands", "latlon"):
        grid = simple_latitude_longitude_grid(Nx, Ny, Nz, device=device, dtype=dtype)
        if grid_type == "gaussian_islands":
            grid = gaussian_islands_bottom(grid)
    else:
        raise ValueError(f"unknown grid_type {grid_type!r}: 'gaussian_islands', 'latlon' or "
                         "'gaussian_islands_tripolar'")

    ocean_cfg = baroclinic_instability_config(kernels=kernels, closure=CATKEVerticalDiffusivity())
    ccfg = CoupledConfig(ocean=ocean_cfg)

    state = initial_state(grid, ocean_cfg.tracers)
    phi = grid.phi2_c[None] if grid.north_fold else grid.phi_c_i.reshape(1, -1, 1)
    z = grid.z_c_i.reshape(-1, 1, 1)
    tr = dict(state.tracers)
    tr["T"] = ((30.0 + 1e-3 * z) * smooth_step(phi)).expand(grid.shape).contiguous()
    tr["S"] = (-5e-3 * z + 0.0 * phi).expand(grid.shape).contiguous()
    tr["e"] = torch.full(grid.shape, 1e-6, dtype=dtype, device=grid.device)
    state = state.replace(tracers=tr)
    return ccfg, grid, data_free_atmosphere(grid, dtype=dtype), state
