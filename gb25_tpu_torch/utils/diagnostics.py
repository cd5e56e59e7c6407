"""Diagnostic fields of a model state (port of
``gb25_tpu.utils.diagnostics``): surface vorticity and speed, kinetic
energy, its eddy / zonal-mean split, w and the mixed-layer depth.

On the port's layouts: 3-D fields ``(Nz, Ny, Nx)``, surface planes
``(Ny, Nx)``. ``comm`` (a tile's exchange, ``parallel.halo.MeshComm``) is
threaded where the JAX package threads it, into the halo extensions; the
sums are the tile's own.
"""

from __future__ import annotations

import torch

from gb25_tpu_torch.ops.halos import extend_field
from gb25_tpu_torch.ops.operators import diagnose_w, vertical_vorticity


def surface_vorticity(grid, state, comm=None):
    """Relative vorticity at the corners of the surface layer, (Ny, Nx)."""
    ue = extend_field(grid, state.u, "u", comm)
    ve = extend_field(grid, state.v, "v", comm)
    return grid.interior(vertical_vorticity(grid, ue, ve))[-1]


def surface_speed(state):
    return torch.sqrt(state.u[-1] ** 2 + state.v[-1] ** 2)


def _volume_weights(grid):
    """Cell area times thickness, (Nz, Ny, 1) on the x-uniform grid."""
    hy, hz = grid.hy, grid.hz
    return grid.azc[:, hy : hy + grid.Ny, :] * grid.dz_c[hz : hz + grid.Nz]


def total_kinetic_energy(grid, state):
    """Volume-integrated kinetic energy [m^5/s^2, per rho0]."""
    ke = 0.5 * (state.u ** 2 + state.v ** 2)
    return torch.sum(ke * _volume_weights(grid))


def eddy_mean_kinetic_energy(grid, state):
    """(EKE, MKE): the volume-weighted mean eddy and zonal-mean kinetic
    energy of the zonal Reynolds decomposition u = [u] + u' (brackets: the
    mean along x, the benchmark grid's periodic direction). During the
    linear phase of the baroclinic instability EKE grows as exp(2 sigma t)
    (``scripts.eddy_statistics``)."""
    w = _volume_weights(grid)
    wsum = torch.sum(w) * grid.Nx
    um = torch.mean(state.u, dim=-1, keepdim=True)
    vm = torch.mean(state.v, dim=-1, keepdim=True)
    up, vp = state.u - um, state.v - vm
    eke = torch.sum(0.5 * (up ** 2 + vp ** 2) * w) / wsum
    mke = torch.sum(0.5 * (um ** 2 + vm ** 2) * w) * grid.Nx / wsum
    return eke, mke


def vertical_velocity(grid, state, comm=None):
    """Diagnostic w at the z faces, (Nz, Ny, Nx)."""
    ue = extend_field(grid, state.u, "u", comm)
    ve = extend_field(grid, state.v, "v", comm)
    return grid.interior(diagnose_w(grid, ue, ve))


def mixed_layer_depth(grid, state, delta_T=0.2):
    """Depth of the first cell below the surface whose T lies ``delta_T``
    below the surface T, (Ny, Nx); the deepest cell centre's depth where
    none does."""
    T = state.tracers["T"]
    zc = grid.z_c_i
    below = T < (T[-1:] - delta_T)
    # levels counted from the surface down: the first that holds
    idx = torch.argmax(below.flip(0).to(torch.uint8), dim=0)
    hit = below.any(dim=0)
    return torch.where(hit, -zc.flip(0)[idx], -zc[0])
