"""The tendency stage in one pass, the buoyancy inside, as plain PyTorch (a
frozen copy of the port's ``ops/pallas_tendency.py`` plain version; kernel
K6 computes it on the card on the ``kernels="pallas"`` route): from the
halo-extended u, v and tracers, continuity w, the buoyancy, the
hydrostatic pressure summed up each column (``sequential_pressure``), and
the interior momentum and tracer tendencies.
"""

from __future__ import annotations

import torch

from benchmark.reference.ocean.ops.operators import diagnose_w


def pallas_tendencies(cfg, grid, f_ff, ue, ve, tr_e):
    """Interior (Gu, Gv, {tracer: G}) from the extended (Nz+2hz, Ny+2hy,
    Nx+2hx) ue, ve and tracers ``tr_e``; ``f_ff``: the Coriolis parameter at
    corners, ``operators.coriolis_ff``."""
    return pallas_tendencies_plain(cfg, grid, f_ff, ue, ve, tr_e)


def pallas_tendencies_plain(cfg, grid, f_ff, ue, ve, tr_e):
    """``tendency_math`` on the extended tensors, cut to the interior, with
    the hydrostatic pressure of ``sequential_pressure``."""
    from benchmark.reference.ocean.models.hydrostatic import (
        buoyancy_field,
        momentum_tendency_math,
        tracer_tendency_math,
    )

    we = diagnose_w(grid, ue, ve)
    pe = sequential_pressure(grid, buoyancy_field(cfg, grid, tr_e))
    Gu_e, Gv_e = momentum_tendency_math(cfg, grid, f_ff, ue, ve, we, pe)
    Gtr_e = tracer_tendency_math(cfg, grid, ue, ve, we, tr_e)

    def inner(a):
        return grid.interior(a).contiguous()

    return inner(Gu_e), inner(Gv_e), {k: inner(g) for k, g in Gtr_e.items()}


def sequential_pressure(grid, be):
    """``operators.hydrostatic_pressure`` with the column total taken as the
    last running sum: the kernel sums each column up from the floor, as
    ``torch.cumsum`` along z does on the card, where torch's reduction of
    the total (the other operator's) adds in another order. p = csum -
    total cancels two sums of ~300 m^2/s^2, so in float32 that order alone
    moves Gu and Gv by ~1e-9."""
    hz, Nz = grid.hz, grid.Nz
    bdz = be[hz : hz + Nz] * grid.dz_c[hz : hz + Nz]
    csum = torch.cumsum(bdz, dim=0)
    p_int = csum - csum[-1:] - 0.5 * bdz
    return torch.cat([p_int[:1]] * hz + [p_int] + [p_int[-1:]] * hz, dim=0)
