"""The coupled model's sea-ice slot (port of ``gb25_tpu.models.seaice``).

Two tiers, as in the JAX package:

1. ``FreezingLimitedOceanTemperature``: no prognostic ice, but seawater is
   never colder than its salinity-dependent freezing point, and the bulk
   fluxes see the limited surface temperature (the reference's
   constructor default).
2. ``SlabSeaIce``: prognostic zero-layer (Semtner 1976) thermodynamic
   ice, cell-mean volume ``v`` and concentration ``a`` on the ocean's
   centers. The skin temperature balances the surface energy budget
   (Newton iterations); the ice grows and melts at its base against the
   conductive flux and the ocean-ice heat flux, and on top where a melting
   surface leaves a residual; supercooled top cells freeze to frazil ice;
   leads close after Hibler (1979); the ice drifts freely (first-order
   upwind in flux form, one width-1 halo extension a field, which gives
   the fold's ghosts on the tripolar grid and the neighbours' on a tile).
   It couples back through the shaded (1 - a) open-water fluxes, the basal
   heat extraction, and the brine-rejection or meltwater salt flux
   (``models.coupled.coupled_ice_time_step``).

Liquidus: T_f(S) = -0.054 S (degC, psu). The planes of a ``SeaIceState``
are stored (Ny, Nx), as the port's fields are; the JAX package's are
(Nx, Ny) (``convert.ice_state_from_numpy`` crosses).
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.ocean.ops.halos import extend2


@dataclasses.dataclass(frozen=True)
class LinearLiquidus:
    """Freezing temperature T_f(S) = -slope * S (degC, psu)."""

    slope: float = 0.054

    def freezing_temperature(self, S):
        return -self.slope * S


@dataclasses.dataclass(frozen=True)
class FreezingLimitedOceanTemperature:
    """Clamp the ocean temperature at or above the local freezing point,
    after each coupled step and in the surface temperature of the bulk
    fluxes."""

    liquidus: LinearLiquidus = LinearLiquidus()

    def limit(self, T, S):
        return torch.maximum(T, self.liquidus.freezing_temperature(S))


def limit_ocean_temperature(sea_ice, state):
    """``state`` with tracers["T"] clamped to the freezing point."""
    T = sea_ice.limit(state.tracers["T"], state.tracers["S"])
    return state.replace(tracers={**state.tracers, "T": T})


@dataclasses.dataclass(frozen=True)
class SeaIceState:
    """Prognostic sea ice on the ocean's centers, (Ny, Nx) planes: ``v`` the
    cell-mean volume per unit area (m), the advected quantity; ``a`` the
    concentration in [0, 1]. The floe thickness is v / max(a, a_min)."""

    v: torch.Tensor
    a: torch.Tensor

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def initial_ice_state(grid, dtype=None):
    """No ice: v = a = 0 on ``grid``'s device, in ``dtype`` (the grid's by
    default)."""
    def zero():
        return torch.zeros((grid.Ny, grid.Nx), dtype=dtype or grid.dtype, device=grid.device)

    return SeaIceState(v=zero(), a=zero())


@dataclasses.dataclass(frozen=True)
class SlabSeaIce:
    """Zero-layer thermodynamic slab sea ice with free-drift advection, its
    constants those of the JAX package (Semtner 1976; Hibler 1979 lead
    closing; CICE-magnitude exchange coefficients)."""

    liquidus: LinearLiquidus = LinearLiquidus()
    rho_ice: float = 917.0          # kg/m^3
    latent_fusion: float = 334e3    # J/kg
    conductivity: float = 2.1       # W/m/K (pure ice, no snow layer)
    albedo: float = 0.7             # bare ice shortwave albedo
    emissivity: float = 0.98
    ice_salinity: float = 4.0       # psu, bulk ice salinity (brine pockets)
    transfer_coefficient: float = 1e-3   # ice-air sensible-heat bulk coefficient
    basal_exchange_velocity: float = 1e-4  # m/s, ocean-ice thermal exchange
    lead_closing_thickness: float = 0.5    # m, h0 of Hibler (1979)
    wind_drift_factor: float = 0.02        # free drift: u_i = u_o + 0.02 u_a
    min_concentration: float = 1e-3
    min_thickness: float = 0.05     # m, floor of h in the 1/h terms
    newton_iterations: int = 3      # skin-temperature balance solves
    rho_air: float = 1.2
    cp_air: float = 1004.0
    stefan_boltzmann: float = 5.67e-8
    rho_ocean: float = 1020.0       # must match CoupledConfig.rho_ocean
    cp_ocean: float = 3991.0
    ice_ocean_drag: float = 5.5e-3  # momentum exchange coefficient

    def limit(self, T, S):
        """The freezing-point clamp: the prognostic model still keeps
        seawater from supercooling; the heat removed appears as frazil ice
        in ``seaice_thermodynamics``."""
        return torch.maximum(T, self.liquidus.freezing_temperature(S))


# Powers are written as the JAX package's ``x ** k`` evaluates them
# (repeated squaring), so the two agree to rounding of the same products.
def _sq(x):
    return x * x


def _cube(x):
    return x * (x * x)


def _fourth(x):
    x2 = x * x
    return x2 * x2


def _wind_speed(atmos):
    return torch.sqrt(_sq(atmos["ua"]) + _sq(atmos["va"])) + 0.1


def _skin_temperature(si: SlabSeaIce, h_eff, T_f, atmos):
    """The ice skin temperature (degC) of the zero-layer surface balance
    Q_atm(Ts) + k (T_f - Ts) / h = 0 (Newton iterations, both terms
    positive into the surface), clamped at 0 degC (a melting surface)."""
    sig, eps_lw = si.stefan_boltzmann, si.emissivity
    cs = si.rho_air * si.cp_air * si.transfer_coefficient * _wind_speed(atmos)
    sw = (1.0 - si.albedo) * atmos["Qsw"]
    k_h = si.conductivity / h_eff

    Ts = torch.clamp(T_f, max=0.0)
    for _ in range(si.newton_iterations):
        Ts_K = Ts + 273.15
        F = (sw + eps_lw * (atmos["Qlw"] - sig * _fourth(Ts_K))
             + cs * (atmos["Ta"] - Ts_K) + k_h * (T_f - Ts))
        dF = -4.0 * eps_lw * sig * _cube(Ts_K) - cs - k_h
        Ts = Ts - F / dF
    return torch.clamp(Ts, max=0.0)


def seaice_thermodynamics(si: SlabSeaIce, grid, atmos, ocean_state, ice, dt):
    """Zero-layer growth and melt plus frazil: (ice', coupling). The
    coupling dict holds the kinematic flux adjustments of the ocean surface
    (positive into the ocean): ``T_flux`` (basal heat extraction and frazil
    heat release), ``S_flux`` (brine rejection or meltwater), ``shade`` = a
    (the open-water flux fraction is 1 - a), and the diagnostics ``Ts``,
    ``Q_conductive`` and ``Q_basal``. ``atmos``: the atmosphere's fields at
    the model time, (Ny, Nx) each."""
    rhoL = si.rho_ice * si.latent_fusion
    SST = ocean_state.tracers["T"][-1]
    S_surf = ocean_state.tracers["S"][-1]
    T_f = si.liquidus.freezing_temperature(S_surf)
    dz_top = grid.dz_c[grid.hz + grid.Nz - 1, 0, 0]
    rho_w_cw = si.rho_ocean * si.cp_ocean

    a, v = ice.a, ice.v
    h_eff = torch.clamp(v / torch.clamp(a, min=si.min_concentration), min=si.min_thickness)

    # the surface balance over the ice fraction
    Ts = _skin_temperature(si, h_eff, T_f, atmos)
    Q_c = si.conductivity * (T_f - Ts) / h_eff  # > 0: freezing (heat drawn up)
    sig, eps_lw = si.stefan_boltzmann, si.emissivity
    cs = si.rho_air * si.cp_air * si.transfer_coefficient * _wind_speed(atmos)
    Ts_K = Ts + 273.15
    Q_atm = ((1.0 - si.albedo) * atmos["Qsw"]
             + eps_lw * (atmos["Qlw"] - sig * _fourth(Ts_K))
             + cs * (atmos["Ta"] - Ts_K))
    # a clamped (melting) surface leaves a positive residual: surface melt
    dh_surf = -torch.clamp(Q_atm + Q_c, min=0.0) * dt / rhoL

    # basal growth and melt against the ocean-ice heat flux
    Q_oi = rho_w_cw * si.basal_exchange_velocity * (SST - T_f)  # > 0 melts
    dh_base = (Q_c - Q_oi) * dt / rhoL

    # frazil: a supercooled top cell freezes back to T_f
    deficit = torch.clamp(T_f - SST, min=0.0) * rho_w_cw * dz_top  # J/m^2
    dv_frazil = deficit / rhoL

    dh = dh_surf + dh_base
    v_new = torch.clamp(v + a * dh + dv_frazil, min=0.0)
    dv_actual = v_new - v  # the ice made this step (cell mean, >= 0 grows)

    # concentration: Hibler lead closing and proportional melt
    da_frz = ((1.0 - a) * torch.clamp(dv_frazil + a * torch.clamp(dh, min=0.0), min=0.0)
              / si.lead_closing_thickness)
    da_melt = torch.where(dh < 0, a * dh / (2.0 * h_eff), torch.zeros_like(dh))
    a_new = torch.clamp(a + da_frz + da_melt, 0.0, 1.0)
    a_new = torch.where(v_new <= 0.0, torch.zeros_like(a_new),
                        torch.clamp(a_new, min=si.min_concentration))

    # the ocean coupling: the basal exchange cools or warms the top cell
    # under the ice fraction, frazil formation releases exactly the latent
    # heat that restores SST to T_f; the virtual salt flux of brine (growth)
    # or meltwater, scaled by the water-equivalent volume rate
    T_flux = -a * Q_oi / rho_w_cw + deficit / (rho_w_cw * dt)
    S_flux = (S_surf - si.ice_salinity) * (si.rho_ice / si.rho_ocean) * dv_actual / dt

    coupling = {"T_flux": T_flux, "S_flux": S_flux, "shade": a,
                "Ts": Ts, "Q_conductive": Q_c, "Q_basal": Q_oi}
    return SeaIceState(v=v_new, a=a_new), coupling


def _metrics2(grid):
    """The width-1 extended 2-D metrics (dyc, dxf, azc): (Ny+2, Nx+2)
    planes on the tripolar grid and on a tile of it, (Ny+2, 1) columns on
    the lat-lon grid."""
    hx, hy = grid.hx, grid.hy
    ys = slice(hy - 1, hy + grid.Ny + 1)

    def sl2(m):
        xs = slice(hx - 1, hx + grid.Nx + 1) if m.shape[2] > 1 else slice(None)
        return m[0, ys, xs]

    return sl2(grid.dyc), sl2(grid.dxf), sl2(grid.azc)


def seaice_advect(si: SlabSeaIce, grid, ocean_state, ice, atmos, dt):
    """Free-drift advection of (v, a): first-order upwind in flux form on
    the C grid, the ice velocity the surface current plus
    ``wind_drift_factor`` times the wind (taken at the velocity points
    from the centers: a one-sided shift, within the scheme's order). One
    width-1 extension a field (``ops.halos.extend2``: the fold's ghosts on
    the tripolar grid). Land
    columns of an immersed grid stay free of ice."""
    dyc2, dxf2, azc2 = _metrics2(grid)
    wdf = si.wind_drift_factor
    ue = extend2(grid, ocean_state.u[-1] + wdf * atmos["ua"], "u")
    ve = extend2(grid, ocean_state.v[-1] + wdf * atmos["va"], "v")

    def upwind_div(q):
        qe = extend2(grid, q, "c")
        qx = torch.where(ue > 0, torch.roll(qe, 1, dims=1), qe)  # at u faces
        qy = torch.where(ve > 0, torch.roll(qe, 1, dims=0), qe)  # at v faces
        Fx = ue * qx * dyc2
        Fy = ve * qy * dxf2
        div = ((torch.roll(Fx, -1, dims=1) - Fx) + (torch.roll(Fy, -1, dims=0) - Fy)) / azc2
        return div[1 : 1 + grid.Ny, 1 : 1 + grid.Nx]

    v_new = torch.clamp(ice.v - dt * upwind_div(ice.v), min=0.0)
    a_new = torch.clamp(ice.a - dt * upwind_div(ice.a), 0.0, 1.0)
    a_new = torch.where(v_new <= 0.0, torch.zeros_like(a_new), a_new)
    if grid.immersed:
        # the bottom is clamped to [z_bottom, 0]: land columns sit at 0
        wet = (grid.bottom_height < 0.0).to(v_new.dtype)
        v_new, a_new = v_new * wet, a_new * wet
    return SeaIceState(v=v_new, a=a_new)
