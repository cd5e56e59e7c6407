"""Immersed bathymetry, a grid-fitted bottom (port of
``gb25_tpu.grids.immersed``).

Cells are fluid where their center lies strictly above the local bottom
(``z_c > bottom``); a face is fluid where its center lies above the higher
of its two neighbouring bottoms. The geometry a step reads (the extended
face masks, the face bottoms, the face depths) is static: it is built once,
when the bathymetry is set, and kept on the grid as ``grid.geometry``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.ocean.ops.halos import extend_field_xy
from benchmark.reference.ocean.ops.stencils import sm


@dataclasses.dataclass(frozen=True)
class ImmersedGeometry:
    """The static geometry of an immersed grid."""

    bottom_e: torch.Tensor  # (1, Ny+2hy, Nx+2hx) extended bottom height
    u_mask: torch.Tensor    # (Z, Y, X) extended u-face mask, 1 fluid, 0 solid
    v_mask: torch.Tensor    # (Z, Y, X) extended v-face mask
    bu: torch.Tensor        # (Ny, Nx) u-face bottom max(b, b_west)
    bv: torch.Tensor        # (Ny, Nx) v-face bottom max(b, b_south)
    Hu: torch.Tensor        # (Ny, Nx) fluid depth of the u faces
    Hv: torch.Tensor        # (Ny, Nx) fluid depth of the v faces
    mu: torch.Tensor        # (Ny, Nx) 1 where Hu > 0, else 0
    mv: torch.Tensor        # (Ny, Nx) 1 where Hv > 0, else 0


def with_bathymetry(grid, bottom_height):
    """A copy of ``grid`` carrying ``bottom_height`` ((Ny, Nx), meters,
    negative) clamped to the grid's depth range, and its geometry."""
    bh = torch.as_tensor(bottom_height, dtype=grid.dtype, device=grid.device)
    if tuple(bh.shape) != (grid.Ny, grid.Nx):
        raise ValueError(f"bottom_height must be ({grid.Ny}, {grid.Nx}), got {tuple(bh.shape)}")
    bh = torch.clamp(bh, float(grid.z_f_i[0]), 0.0)
    if grid.immersed:
        bh = torch.maximum(bh, grid.bottom_height)  # keep land already there
    grid = dataclasses.replace(grid, bottom_height=bh, geometry=None)
    return dataclasses.replace(grid, geometry=build_geometry(grid))


def build_geometry(grid):
    """The ``ImmersedGeometry`` of ``grid``'s bottom."""
    # the grid's halos: the fold rows on the tripolar grid
    be = extend_field_xy(grid, grid.bottom_height, "c")[None]
    bu_e = torch.maximum(be, sm(be, "x"))
    bv_e = torch.maximum(be, sm(be, "y"))
    hx, hy, hz = grid.halo
    Nz = grid.Nz
    bu = bu_e[0, hy : hy + grid.Ny, hx : hx + grid.Nx].contiguous()
    bv = bv_e[0, hy : hy + grid.Ny, hx : hx + grid.Nx].contiguous()
    # the discrete depth: dz summed over the cells above the face bottom
    zc = grid.z_c[hz : hz + Nz]
    dzc = grid.dz_c[hz : hz + Nz]
    zero = torch.zeros((), dtype=dzc.dtype, device=dzc.device)
    Hu = torch.where(zc > bu, dzc, zero).sum(dim=0)
    Hv = torch.where(zc > bv, dzc, zero).sum(dim=0)
    return ImmersedGeometry(
        bottom_e=be, u_mask=(grid.z_c > bu_e).to(grid.dtype),
        v_mask=(grid.z_c > bv_e).to(grid.dtype), bu=bu, bv=bv, Hu=Hu, Hv=Hv,
        mu=(Hu > 0).to(grid.dtype), mv=(Hv > 0).to(grid.dtype))


def gaussian_islands_bottom(grid):
    """The two Gaussian islands: bottom = zb + h (mtn1 + mtn2), zb the
    deepest z face, h = -zb + 100 m. Evaluated in numpy on the grid's
    coordinates (the 2-D centres of a tripolar grid) in the grid's dtype,
    operation for operation as the JAX package does, so the bathymetry
    equals its bit for bit; land already there (the tripolar pole caps)
    stays land."""
    if grid.north_fold:
        lam = grid.lam2_c.cpu().numpy()
        phi = grid.phi2_c.cpu().numpy()
    else:
        lam = grid.lam_c_i.cpu().numpy()[None, :]
        phi = grid.phi_c_i.cpu().numpy()[:, None]
    zb = float(grid.z_f_i[0])
    h = -zb + 100.0

    def mtn(lam0, phi0, dphi=5.0):
        return np.exp(-((lam - lam0) ** 2 + (phi - phi0) ** 2) / (2 * dphi**2))

    bottom = zb + h * (mtn(70.0, 55.0) + mtn(250.0, 55.0))
    return with_bathymetry(grid, bottom)


def immersed_masks(grid):
    """(c_mask, u_mask, v_mask) on extended ``(Z, Y, X)`` tensors, 1 on
    fluid and 0 on solid, in the grid's dtype."""
    geo = grid.geometry
    return (grid.z_c > geo.bottom_e).to(grid.dtype), geo.u_mask, geo.v_mask


def face_masks(grid):
    """(u_mask, v_mask) of ``immersed_masks`` alone, the two a step uses."""
    return grid.geometry.u_mask, grid.geometry.v_mask


def face_bottom_planes(grid):
    """(bu, bv): the face bottom heights ``max(b, b_neighbour)`` on the
    interior ``(Ny, Nx)``, the comparands of ``immersed_masks``: ``z_c > bu``
    reproduces the interior u mask bit for bit."""
    return grid.geometry.bu, grid.geometry.bv


def interior_masks(grid):
    """(u_mask, v_mask) cropped to the interior ``(Nz, Ny, Nx)`` (views)."""
    u, v = face_masks(grid)
    return grid.interior(u), grid.interior(v)
