"""The coupled ocean-atmosphere climate model (port of
``gb25_tpu.models.coupled``), on the whole domain or on one tile of the
decomposed path (``comm``).

Each coupled step: (1) the prescribed atmosphere at the model time,
(2) the similarity bulk fluxes against the ocean surface state, (3) the
radiation balance, (4) the kinematic fluxes deposited into the ocean's top
cells, (5) the ocean's hydrostatic step (with CATKE by default; optionally
with T/S restoring), then (6) the freezing limiter. With the prognostic
``SlabSeaIce`` (``coupled_ice_time_step``) the ice thermodynamics run
first, the open-water fluxes are shaded by the ice fraction and joined by
the ice's coupling fluxes and the ice-ocean drag, and the ice drifts
before the ocean steps.

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
from gb25_tpu_torch.models.hydrostatic import ocean_step, premask_state
from gb25_tpu_torch.models.seaice import (
    FreezingLimitedOceanTemperature,
    SeaIceState,
    SlabSeaIce,
    limit_ocean_temperature,
    seaice_advect,
    seaice_thermodynamics,
)
from gb25_tpu_torch.models.state import initial_state
from gb25_tpu_torch.ops.halos import extend2
from gb25_tpu_torch.utils.tracing import span


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


def compute_interface_fluxes(ccfg: CoupledConfig, grid, atmos, state, comm=None,
                             ice_cover=None, ice_coupling=None):
    """Air-sea fluxes on the ocean's centers, returned as the dict of
    (Ny, Nx) kinematic surface fluxes the ocean step deposits ({"u", "v",
    "T", "S"} and "e" with CATKE) and a dict of diagnostics. ``comm``: the
    tile's halo exchange (the width-1 extensions come from the
    neighbours). ``ice_cover`` and ``ice_coupling`` (the prognostic
    ``SlabSeaIce``, from ``seaice_thermodynamics``): the open-water fluxes
    shaded by 1 - a, the ice's coupling fluxes added, and under the ice
    fraction the ice-ocean drag in place of the wind stress."""
    return _interface_fluxes(ccfg, grid, atmos.at_time(state.time), state, comm, ice_cover,
                             ice_coupling)


def _interface_fluxes(ccfg, grid, a, state, comm, ice_cover=None, ice_coupling=None):
    """``compute_interface_fluxes`` of the atmosphere's fields ``a`` at the
    model time."""
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

    tx = extend2(grid, taux_c, "c", comm=comm)
    ty = extend2(grid, tauy_c, "c", comm=comm)
    taux_u = 0.5 * (tx[1:-1, 1:-1] + tx[1:-1, :-2])
    tauy_v = 0.5 * (ty[1:-1, 1:-1] + ty[:-2, 1:-1])

    fluxes = {"u": taux_u, "v": tauy_v, "T": T_flux, "S": S_flux}
    if isinstance(ccfg.ocean.closure, CATKEVerticalDiffusivity):
        # the closure's surface condition: TKE injection from u*
        fluxes["e"] = surface_tke_flux(ccfg.ocean.closure, taux_c, tauy_c)
    return fluxes, {"Q_net": Q_net, **turb}


def coupled_time_step(ccfg: CoupledConfig, grid, atmos, state, dt, premasked=False, comm=None,
                      restoring=None):
    """One coupled step: interface fluxes, the ocean's step (with
    ``restoring``, T/S relaxed toward its targets), then the freezing
    limiter; with ``comm``, of the tile ``grid``."""
    with span("step"):
        with span("step/interface_fluxes"):
            fluxes, _ = compute_interface_fluxes(ccfg, grid, atmos, state, comm)
        state = ocean_step(ccfg.ocean, grid, state, dt, surface_fluxes=fluxes,
                           premasked=premasked, comm=comm, restoring=restoring)
        with span("step/freezing_limiter"):
            return limit_ocean_temperature(ccfg.sea_ice, state)


def coupled_ice_time_step(ccfg: CoupledConfig, grid, atmos, state, ice, dt, comm=None,
                          restoring=None, premasked=False):
    """One coupled step with the prognostic ``SlabSeaIce``: the ice
    thermodynamics, the shaded and augmented interface fluxes, the ice's
    free drift, the ocean's step, the freezing limiter. Returns (state,
    ice)."""
    si = ccfg.sea_ice
    with span("step"):
        with span("step/seaice"):
            af = atmos.at_time(state.time)
            ice_th, coup = seaice_thermodynamics(si, grid, af, state, ice, dt)
        with span("step/interface_fluxes"):
            fluxes, _ = _interface_fluxes(ccfg, grid, af, state, comm, ice_cover=coup["shade"],
                                          ice_coupling=coup)
        with span("step/seaice"):
            ice_new = seaice_advect(si, grid, state, ice_th, af, dt, comm)
        state = ocean_step(ccfg.ocean, grid, state, dt, surface_fluxes=fluxes,
                           premasked=premasked, comm=comm, restoring=restoring)
        with span("step/freezing_limiter"):
            return limit_ocean_temperature(si, state), ice_new


@dataclasses.dataclass(frozen=True)
class OceanIceState:
    """The (ocean, ice) carry of ``coupled_ice_loop``: a state the device
    loop can capture and replay (its tensors are the ocean's and the
    ice's; its iteration the ocean's)."""

    ocean: object
    ice: SeaIceState

    @property
    def iteration(self) -> int:
        return self.ocean.iteration

    def replace(self, iteration=None, **kw):
        if iteration is not None:
            kw["ocean"] = kw.get("ocean", self.ocean).replace(iteration=iteration)
        return dataclasses.replace(self, **kw)


def _ice_pair_step(ccfg, grid, atmos, pair, dt, comm=None, restoring=None, premasked=False):
    state, ice = coupled_ice_time_step(ccfg, grid, atmos, pair.ocean, pair.ice, dt, comm,
                                       restoring, premasked)
    return OceanIceState(state, ice)


def coupled_ice_loop(ccfg: CoupledConfig, grid, atmos, state, ice, dt, n, comm=None,
                     restoring=None, chunk=None):
    """``n`` coupled steps carrying (ocean state, sea-ice state), the
    immersed mask applied once before the first; replayed on the card as
    ``coupled_loop`` is (``chunk``: see ``models.hydrostatic.loop``).
    Returns (state, ice)."""
    state = premask_state(grid, state)
    step = functools.partial(_ice_pair_step, ccfg, grid, atmos, dt=dt, comm=comm,
                             restoring=restoring, premasked=True)
    out = run_loop(step, OceanIceState(state, ice), n, comm, grid.cache, chunk)
    return out.ocean, out.ice


def coupled_loop(ccfg: CoupledConfig, grid, atmos, state, dt, n, comm=None, restoring=None,
                 chunk=None):
    """``n`` coupled steps (the immersed mask applied once, before the
    first): on the card replayed from a captured CUDA graph
    (``device_loop``), also with a ``comm`` whose mesh is the one card; on
    the CPU and with a ``comm`` of several ranks from the host. ``chunk``:
    see ``models.hydrostatic.loop``."""
    state = premask_state(grid, state)
    step = functools.partial(coupled_time_step, ccfg, grid, atmos, dt=dt, premasked=True,
                             comm=comm, restoring=restoring)
    return run_loop(step, state, n, comm, grid.cache, chunk)


def data_free_ocean_climate_model(resolution=2.0, Nz=20, *, device="cuda", dtype=torch.float32,
                                  closure="catke", grid_type="gaussian_islands",
                                  sea_ice="freezing_limited", kernels="auto"):
    """Config, grid, atmosphere and initial state of the data-free coupled
    climate model: the lat-lon band at ``resolution`` degrees
    (384/resolution x 192/resolution cells) with the two Gaussian islands,
    CATKE, 30 barotropic substeps, the analytic atmosphere and the
    freezing limiter; T = (30 + 1e-3 z) smooth_step(phi), S = -5e-3 z,
    e = 1e-6, at rest.

    ``closure``: "catke" or None (no closure: T and S alone, K1's fused
    two-tracer instance and no K3 or K4). ``grid_type``:
    "gaussian_islands", "latlon" (no bathymetry) or
    "gaussian_islands_tripolar" (the islands on the tripolar grid, whose
    initial T follows the true 2-D latitude). ``sea_ice``:
    "freezing_limited" (the reference's constructor default) or "slab"
    (the prognostic ``SlabSeaIce``: drive it with ``coupled_ice_loop`` and
    ``initial_ice_state(grid)``)."""
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
    if closure not in ("catke", None):
        raise ValueError(f"closure must be 'catke' or None, got {closure!r}")
    if sea_ice not in ("freezing_limited", "slab"):
        raise ValueError(f"sea_ice must be 'freezing_limited' or 'slab', got {sea_ice!r}")

    ocean_cfg = baroclinic_instability_config(
        kernels=kernels, closure=CATKEVerticalDiffusivity() if closure == "catke" else None)
    ice = SlabSeaIce() if sea_ice == "slab" else FreezingLimitedOceanTemperature()
    ccfg = CoupledConfig(ocean=ocean_cfg, sea_ice=ice)

    state = initial_state(grid, ocean_cfg.tracers)
    phi = grid.phi2_c[None] if grid.north_fold else grid.phi_c_i.reshape(1, -1, 1)
    z = grid.z_c_i.reshape(-1, 1, 1)
    tr = dict(state.tracers)
    tr["T"] = ((30.0 + 1e-3 * z) * smooth_step(phi)).expand(grid.shape).contiguous()
    tr["S"] = (-5e-3 * z + 0.0 * phi).expand(grid.shape).contiguous()
    if "e" in tr:
        tr["e"] = torch.full(grid.shape, 1e-6, dtype=dtype, device=grid.device)
    state = state.replace(tracers=tr)
    return ccfg, grid, data_free_atmosphere(grid, dtype=dtype), state
