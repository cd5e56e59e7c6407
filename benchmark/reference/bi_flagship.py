"""The plain reference of ``configs/bi_flagship.json``: the baroclinic-
instability ocean, built and stepped by the frozen plain path
(``reference.ocean``) in its own dtype."""

from __future__ import annotations

import functools

from benchmark.reference.model import Model
from benchmark.reference.ocean.grids import simple_latitude_longitude_grid
from benchmark.reference.ocean.models.baroclinic import (
    baroclinic_instability_config,
    baroclinic_instability_state,
)
from benchmark.reference.ocean.models.hydrostatic import time_step


def build(config, route, device, dtype):
    """The reference ``Model`` of ``config`` on the ``route`` ("auto" or
    "torch": the fused step; "pallas": the unfused step with the blocked
    free surface)."""
    grid = simple_latitude_longitude_grid(config["Nx"], config["Ny"], config["Nz"], device=device,
                                          halo=tuple(config["halo"]), dtype=dtype)
    cfg = baroclinic_instability_config(kernels=route)
    state = baroclinic_instability_state(grid, tracers=cfg.tracers)
    advance = functools.partial(time_step, cfg, grid, dt=config["dt"])
    names = ("u", "v", "eta") + tuple(f"tracers/{k}" for k in cfg.tracers)
    return Model(state, advance, names)
