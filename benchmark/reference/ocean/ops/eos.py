"""Seawater equations of state (port of ``gb25_tpu.ops.eos``): TEOS-10
and the linear one.

The 55-term Boussinesq polynomial ``polyTEOS10_bsq`` (Roquet, Madec,
McDougall & Barker 2015, Ocean Modelling), evaluated with reduced
variables and grouped by powers of depth, in the same Horner order as the
JAX package. S = absolute salinity [g/kg], T = conservative temperature
[deg C], z = height [m] (negative below the surface).
"""

from __future__ import annotations

import dataclasses

import torch

_SAU = 40.0 * 35.16504 / 35.0
_CTU = 40.0
_ZU = 1.0e4
_DELTAS = 32.0

# vertical reference profile r0(z) = sum R0k * zz^(k+1), zz = -z/Zu
_R0 = (
    4.6494977072e01,
    -5.2099962525e00,
    2.2601900708e-01,
    6.4326772569e-02,
    1.5616995503e-02,
    -1.7243708991e-03,
)

# anomaly coefficients (i, j, k, c) for ss^i tt^j zz^k
_EOS = (
    (0, 0, 0, 8.0189615746e02),
    (1, 0, 0, 8.6672408165e02),
    (2, 0, 0, -1.7864682637e03),
    (3, 0, 0, 2.0375295546e03),
    (4, 0, 0, -1.2849161071e03),
    (5, 0, 0, 4.3227585684e02),
    (6, 0, 0, -6.0579916612e01),
    (0, 1, 0, 2.6010145068e01),
    (1, 1, 0, -6.5281885265e01),
    (2, 1, 0, 8.1770425108e01),
    (3, 1, 0, -5.6888046321e01),
    (4, 1, 0, 1.7681814114e01),
    (5, 1, 0, -1.9193502195e00),
    (0, 2, 0, -3.7074170417e01),
    (1, 2, 0, 6.1548258127e01),
    (2, 2, 0, -6.0362551501e01),
    (3, 2, 0, 2.9130021253e01),
    (4, 2, 0, -5.4723692739e00),
    (0, 3, 0, 2.1661789529e01),
    (1, 3, 0, -3.3449108469e01),
    (2, 3, 0, 1.9717078466e01),
    (3, 3, 0, -3.1742946532e00),
    (0, 4, 0, -8.3627885467e00),
    (1, 4, 0, 1.1311538584e01),
    (2, 4, 0, -5.3563304045e00),
    (0, 5, 0, 5.4048723791e-01),
    (1, 5, 0, 4.8169980163e-01),
    (0, 6, 0, -1.9083568888e-01),
    (0, 0, 1, 1.9681925209e01),
    (1, 0, 1, -4.2549998214e01),
    (2, 0, 1, 5.0774768218e01),
    (3, 0, 1, -3.0938076334e01),
    (4, 0, 1, 6.6051753097e00),
    (0, 1, 1, -1.3336301113e01),
    (1, 1, 1, -4.4870114575e00),
    (2, 1, 1, 5.0042598061e00),
    (3, 1, 1, -6.5399043664e-01),
    (0, 2, 1, 6.7080479603e00),
    (1, 2, 1, 3.5063081279e00),
    (2, 2, 1, -1.8795372996e00),
    (0, 3, 1, -2.4649669534e00),
    (1, 3, 1, -5.5077101279e-01),
    (0, 4, 1, 5.5927935970e-01),
    (0, 0, 2, 2.0660924175e00),
    (1, 0, 2, -4.9527603989e00),
    (2, 0, 2, 2.5019633244e00),
    (0, 1, 2, 2.0564311499e00),
    (1, 1, 2, -2.1311365518e-01),
    (0, 2, 2, -1.2419983026e00),
    (0, 0, 3, -2.3342758797e-02),
    (1, 0, 3, -1.8507636718e-02),
    (0, 1, 3, 3.7969820455e-01),
)


def _const(c, like):
    """The number ``c`` as ``like``'s dtype rounds it, for a bfloat16 or
    float16 ``like`` (the JAX package's weak-typed constants): a tensor of
    those dtypes plus a Python number rounds the number first on the CPU
    and not on the card, and at bfloat16's ulp of 8 kg/m^3 in rho' that
    moves b by a whole step (0.077 m/s^2) between the two; ``c`` itself
    for float32 and float64, and for a ``TwoFloat`` (bfloat16 limbs, which
    split the number into a limb pair as the JAX package's do)."""
    if isinstance(like, torch.Tensor) and like.dtype in (torch.bfloat16, torch.float16):
        return float(torch.tensor(c, dtype=like.dtype))
    return c


def _horner_2d(ss, tt, coeffs_k):
    """sum c_ij ss^i tt^j for one power of zz: Horner in tt of Horner in ss."""
    by_j = {}
    for i, j, c in coeffs_k:
        by_j.setdefault(j, []).append((i, _const(c, ss)))
    out = None
    for j in range(max(by_j), -1, -1):
        poly_s = 0.0
        if j in by_j:
            cs = dict(by_j[j])
            imax = max(cs)
            acc = cs[imax]
            for i in range(imax - 1, -1, -1):
                acc = acc * ss + cs.get(i, 0.0)
            poly_s = acc
        out = poly_s if out is None else out * tt + poly_s
    return out


def rho_anomaly_teos10(S, T, z):
    """In-situ Boussinesq density anomaly r'(S, T, z) [kg/m^3]
    (polyTEOS10_bsq 'rdot', without the vertical reference profile)."""
    ss = torch.sqrt((S + _const(_DELTAS, S)) / _SAU)
    tt = T / _CTU
    zz = -z / _ZU
    by_k = {}
    for i, j, k, c in _EOS:
        by_k.setdefault(k, []).append((i, j, c))
    out = None
    for k in range(max(by_k), -1, -1):
        term = _horner_2d(ss, tt, by_k[k])
        out = term if out is None else out * zz + term
    return out


def rho_vertical_reference(z):
    """r0(z): the depth-only part of the polyTEOS10_bsq density."""
    zz = -z / _ZU
    acc = _const(_R0[-1], zz)
    for c in _R0[-2::-1]:
        acc = acc * zz + _const(c, zz)
    return acc * zz


@dataclasses.dataclass(frozen=True)
class TEOS10EquationOfState:
    """Buoyancy b = -g (rho' - rho0) / rho0 from the TEOS-10 anomaly. The
    depth-only r0 is left out: its horizontal gradient vanishes."""

    rho0: float = 1020.0
    g: float = 9.80665

    def buoyancy(self, T, S, z):
        rprime = rho_anomaly_teos10(S, T, z)
        return -self.g * (rprime - _const(self.rho0, rprime)) / self.rho0


@dataclasses.dataclass(frozen=True)
class LinearEquationOfState:
    """b = g (alpha (T - T0) - beta (S - S0)), in that operation order; each
    constant rounded as ``_const`` rounds it for the fields' dtype."""

    alpha: float = 1.67e-4
    beta: float = 7.80e-4
    T0: float = 10.0
    S0: float = 35.0
    g: float = 9.80665

    def buoyancy(self, T, S, z):
        def c(x):
            return _const(x, T)

        return c(self.g) * (c(self.alpha) * (T - c(self.T0)) - c(self.beta) * (S - c(self.S0)))
