"""Flagship setup: the baroclinic-instability ocean (a frozen copy of the
port's ``models/baroclinic.py``: its configuration and initial state).

Split-explicit free surface with 30 substeps, TEOS-10 buoyancy, spherical
Coriolis, WENO vector-invariant momentum and WENO-5 tracer advection on the
simple lat-lon grid; T = (30 + 1e-3 z) smooth_step(phi), S = -5e-3 z, and
velocities that the caller draws.
"""

from __future__ import annotations

import torch

from benchmark.reference.ocean.models.config import HydrostaticConfig, SplitExplicitFreeSurface
from benchmark.reference.ocean.models.state import HydrostaticState, initial_state
from benchmark.reference.ocean.ops.eos import TEOS10EquationOfState


def smooth_step(phi):
    """(1 - tanh((|phi| - 40) / 5)) / 2."""
    return (1.0 - torch.tanh((torch.abs(phi) - 40.0) / 5.0)) / 2.0


def baroclinic_instability_config(kernels="auto", closure=None, free_surface=None,
                                  momentum_advection="weno_vector_invariant",
                                  tracer_advection="weno5", eos=None) -> HydrostaticConfig:
    """The flagship configuration; with ``closure`` the tracer set gains
    the closure's ("e" with CATKE, "e" and "eps" with k-epsilon), as in the
    JAX package. ``free_surface``: the split-explicit one with 30 substeps
    unless given; ``eos``: TEOS-10 unless given; the advection schemes as
    ``HydrostaticConfig`` names them."""
    tracers = ("T", "S") + tuple(getattr(closure, "tracer_names", ()))
    return HydrostaticConfig(
        tracers=tracers,
        momentum_advection=momentum_advection,
        tracer_advection=tracer_advection,
        eos=eos or TEOS10EquationOfState(),
        free_surface=free_surface or SplitExplicitFreeSurface(substeps=30),
        closure=closure,
        kernels=kernels,
    )


def baroclinic_instability_state(grid, tracers=("T", "S")) -> HydrostaticState:
    """Initial state on ``grid``'s device and in its dtype, at rest: the
    analytic T/S (over the true 2-D latitude of a tripolar grid), a
    closure's e at 1e-6 and eps at 1e-9."""
    dtype = grid.dtype
    state = initial_state(grid, tracers)
    phi = (grid.phi2_c[None] if grid.north_fold else grid.phi_c_i.reshape(1, -1, 1)).to(dtype)
    z = grid.z_c_i.reshape(-1, 1, 1).to(dtype)
    shape = grid.shape

    T = ((30.0 + 1e-3 * z) * smooth_step(phi)).expand(shape).contiguous()
    S = (-5e-3 * z + 0.0 * phi).expand(shape).contiguous()
    floors = {"e": 1e-6, "eps": 1e-9}
    closure = {k: torch.full(shape, floors[k], dtype=dtype, device=grid.device)
               for k in tracers if k in floors}
    return state.replace(tracers={"T": T, "S": S, **closure})
