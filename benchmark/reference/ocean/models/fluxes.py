"""Air-sea turbulent and radiative fluxes (port of
``gb25_tpu.models.fluxes``).

A COARE-style bulk algorithm with a fixed number of Monin-Obukhov
iterations: Charnock plus smooth-flow roughness, Businger-Dyer stability
functions, a gustiness floor; and the surface radiation balance (shortwave
albedo, graybody longwave emission). Everything is elementwise over
``(Ny, Nx)`` planes; there is no kernel here, as there is no Pallas kernel
in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import torch

VON_KARMAN = 0.4
GRAVITY = 9.80665


@dataclasses.dataclass(frozen=True)
class SimilarityTheoryFluxes:
    iterations: int = 5          # fixed iteration count
    charnock: float = 0.011
    gustiness: float = 0.5       # minimum wind speed scale [m/s]
    measurement_height: float = 10.0
    rho_air: float = 1.225
    cp_air: float = 1004.0
    latent_heat: float = 2.5e6


@dataclasses.dataclass(frozen=True)
class Radiation:
    """Ocean albedo, emissivity and the Stefan-Boltzmann constant."""

    ocean_albedo: float = 0.03
    ocean_emissivity: float = 0.97
    stefan_boltzmann: float = 5.670374419e-8


def saturation_specific_humidity(T, p):
    """Over seawater (98% of pure-water saturation), T in K, p in Pa."""
    Tc = T - 273.15
    es = 611.2 * torch.exp(17.67 * Tc / torch.clamp(Tc + 243.5, min=1.0))  # Pa
    return 0.98 * 0.622 * es / torch.clamp(p - 0.378 * es, min=1e3)


def _psi_m(zeta):
    """Businger-Dyer momentum stability function."""
    zeta = torch.clamp(zeta, -10.0, 10.0)
    x = (1.0 - 16.0 * torch.clamp(zeta, max=0.0)) ** 0.25
    unstable = (
        2.0 * torch.log((1.0 + x) / 2.0)
        + torch.log((1.0 + x * x) / 2.0)
        - 2.0 * torch.atan(x)
        + math.pi / 2.0
    )
    stable = -5.0 * zeta
    return torch.where(zeta < 0.0, unstable, stable)


def _psi_h(zeta):
    """Businger-Dyer scalar stability function."""
    zeta = torch.clamp(zeta, -10.0, 10.0)
    x = (1.0 - 16.0 * torch.clamp(zeta, max=0.0)) ** 0.25
    unstable = 2.0 * torch.log((1.0 + x * x) / 2.0)
    stable = -5.0 * zeta
    return torch.where(zeta < 0.0, unstable, stable)


def similarity_fluxes(cfg: SimilarityTheoryFluxes, atmos, To_K, uo, vo):
    """Turbulent fluxes from the atmosphere fields (Ta, ua, va, qa, pa) and
    the ocean surface state on ocean centers (To_K in K, currents uo, vo).
    Returns tau_x, tau_y [N/m^2], Q_sensible, Q_latent [W/m^2, positive =
    ocean heating], evaporation [kg/m^2/s] and u_star."""
    kappa = VON_KARMAN
    h = cfg.measurement_height
    nu_air = 1.5e-5

    du = atmos["ua"] - uo
    dv = atmos["va"] - vo
    qs = saturation_specific_humidity(To_K, atmos["pa"])
    dtheta = atmos["Ta"] - To_K
    dq = atmos["qa"] - qs
    Tv = atmos["Ta"] * (1.0 + 0.61 * atmos["qa"])

    U = torch.sqrt(du * du + dv * dv + cfg.gustiness**2)

    # neutral first guess, then a fixed number of iterations
    ustar = kappa * U / math.log(h / 1e-4)
    tstar = torch.zeros_like(U)
    qstar = torch.zeros_like(U)
    for _ in range(cfg.iterations):
        ustar = torch.clamp(ustar, min=1e-4)
        # Obukhov length
        bstar = (GRAVITY / Tv) * (tstar + 0.61 * Tv * qstar / (1.0 + 0.61 * atmos["qa"]))
        Linv = kappa * bstar / (ustar * ustar)
        zeta = torch.clamp(h * Linv, -10.0, 10.0)
        # roughness lengths (Charnock + smooth flow)
        z0 = cfg.charnock * ustar * ustar / GRAVITY + 0.11 * nu_air / ustar
        z0 = torch.clamp(z0, 1e-8, 1.0)
        z0t = torch.clamp(0.4 * nu_air / ustar, 1e-9, 1e-2)
        lnm = torch.log(h / z0) - _psi_m(zeta) + _psi_m(z0 / h * zeta)
        lnh = torch.log(h / z0t) - _psi_h(zeta) + _psi_h(z0t / h * zeta)
        ustar, tstar, qstar = (kappa * U / torch.clamp(lnm, min=1.0),
                               kappa * dtheta / torch.clamp(lnh, min=1.0),
                               kappa * dq / torch.clamp(lnh, min=1.0))

    rho = cfg.rho_air
    tau = rho * ustar * ustar
    evap = -rho * ustar * qstar  # positive = ocean loses water
    return {
        "tau_x": tau * du / U, "tau_y": tau * dv / U,
        "Q_sensible": rho * cfg.cp_air * ustar * tstar,
        "Q_latent": -cfg.latent_heat * evap,
        "evaporation": evap,
        "u_star": ustar,
    }


def radiative_fluxes(rad: Radiation, atmos, To_K):
    """Net radiative heating of the ocean surface [W/m^2, positive =
    heating]."""
    sw = (1.0 - rad.ocean_albedo) * atmos["Qsw"]
    lw = rad.ocean_emissivity * (atmos["Qlw"] - rad.stefan_boltzmann * To_K**4)
    return sw + lw
