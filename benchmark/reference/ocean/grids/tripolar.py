"""Tripolar grid: a lat-lon band below a conformal bipolar cap whose two
displaced north poles sit on land, and the T-pivot north fold (port of
``gb25_tpu.grids.tripolar``).

South of the pole latitude the rows are lat-lon; north of it a bipolar map
sends the circles through both poles to rows uniform in tau, from tau =
pi/2 at the junction face to tau = pi on the seam, which passes through
the centres of the last row. Metrics are great-circle distances between
the staggered coordinates. Cells touching the pole singularities are
floored and buried in land (the immersed bottom at 0 m).

The grid is built in float64 numpy with the JAX package's arithmetic,
operation for operation, in its (x, y) orientation, and only then cast and
stored in the port's layout: the metrics and the corner latitude as
``(1, Ny+2hy, Nx+2hx)`` planes, the centre coordinates as ``(Ny, Nx)``.

The fold, in the port's layout (x the last dimension), with pole column
p: ghost row ``Ny+m`` of a centre field is row ``Ny-2-m`` at ``x -> (2p -
x) mod Nx``; of u (x faces) the same rows at ``x -> (2p + 1 - x) mod Nx``,
sign flipped; v ghost face ``j`` is face ``2Ny-1-j`` at the centre map,
sign flipped.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.ocean.grids.immersed import with_bathymetry
from benchmark.reference.ocean.grids.latlon import (
    DEG2RAD,
    EARTH_RADIUS,
    LatitudeLongitudeGrid,
    extended_z_profiles,
    z_face_positions,
)
from benchmark.reference.ocean.ops.halos import FIELD_BCS, ghost_blocks


def _great_circle(lam1, phi1, lam2, phi2):
    """Great-circle distance [m] between points given in degrees."""
    l1, p1, l2, p2 = (np.asarray(a) * DEG2RAD for a in (lam1, phi1, lam2, phi2))
    dphi = p2 - p1
    dlam = l2 - l1
    h = np.sin(dphi / 2) ** 2 + np.cos(p1) * np.cos(p2) * np.sin(dlam / 2) ** 2
    return 2 * EARTH_RADIUS * np.arcsin(np.minimum(np.sqrt(h), 1.0))


def _cap_map(sigma, tau, r_p, lam_p):
    """Inverse bipolar map -> (lam, phi) in degrees, upper branch:
    z = r_p (1 + e^w) / (1 - e^w), w = sigma + i tau."""
    w = sigma + 1j * tau
    ew = np.exp(w)
    z = r_p * (1.0 + ew) / (1.0 - ew)
    rho = np.abs(z)
    lam = (np.angle(z) / DEG2RAD + lam_p) % 360.0
    phi = 90.0 - 2.0 * np.arctan(rho) / DEG2RAD
    return lam, phi


@dataclasses.dataclass(frozen=True)
class TripolarGrid(LatitudeLongitudeGrid):
    """A ``LatitudeLongitudeGrid`` whose metrics are 2-D planes, with the
    true centre coordinates, the halo-extended corner latitude and the fold
    column. Always immersed: the pole caps are land."""

    pole_index: int = 0            # p: the fold maps centre x to (2p - x) mod Nx
    lam2_c: torch.Tensor = None    # (Ny, Nx) centre longitude, degrees
    phi2_c: torch.Tensor = None    # (Ny, Nx) centre latitude
    phi2_ff: torch.Tensor = None   # (1, Ny+2hy, Nx+2hx) corner latitude

    north_fold = True


def _staggered_coords(Nx, Ny, lat0, phi_p, lam_p_target):
    """(lam, phi) at the half-integer nodes, (2Nx+1, 2Ny+1): index (2i, 2j)
    is the corner (f, f) of cell (i, j); also the pole column p and the
    number of lat-lon rows."""
    # snap the pole longitude to a cell center: lam_c(p) = (p + .5) dlam
    dlam = 360.0 / Nx
    p = int(round(lam_p_target / dlam - 0.5)) % Nx
    lam_p = (p + 0.5) * dlam

    # the lat-lon band takes a share of the rows proportional to its nominal
    # extent; the cap the rest, its last centre row on the seam (tau = pi)
    south_extent = phi_p - lat0
    cap_extent = 90.0 - phi_p
    n_south = int(round(Ny * south_extent / (south_extent + cap_extent)))
    n_south = min(max(n_south, 1), Ny - 2)
    dphi = south_extent / n_south

    ii = np.arange(2 * Nx + 1) / 2.0
    jj = np.arange(2 * Ny + 1) / 2.0
    lam = np.empty((2 * Nx + 1, 2 * Ny + 1))
    phi = np.empty((2 * Nx + 1, 2 * Ny + 1))

    lam_nodes = ii * dlam
    r_p = np.tan((90.0 - phi_p) * DEG2RAD / 2.0)

    # sigma per x node from the angular offset to the pole longitude
    theta = (lam_nodes - lam_p) % 360.0
    theta_eff = np.where(theta <= 180.0, theta, 360.0 - theta)
    theta_eff = np.clip(theta_eff, 1e-9, 180.0 - 1e-9)
    sigma = np.log(np.tan(theta_eff * DEG2RAD / 2.0))
    upper = theta <= 180.0

    # tau from pi/2 at the junction face (j = n_south) to pi at the last
    # centre row (jj = Ny - 0.5)
    j_junction = float(n_south)
    j_seam = Ny - 0.5
    dtau = (np.pi - np.pi / 2) / (j_seam - j_junction)

    for col, jval in enumerate(jj):
        if jval <= j_junction + 1e-12:
            lam[:, col] = lam_nodes % 360.0
            phi[:, col] = lat0 + jval * dphi
        else:
            tau = np.pi / 2 + (jval - j_junction) * dtau
            tau = min(tau, np.pi - 1e-12)
            lam_u, phi_u = _cap_map(sigma, tau, r_p, lam_p)
            # lower branch: the conjugate, mirrored about lam_p
            lam_l = (2 * lam_p - lam_u) % 360.0
            lam[:, col] = np.where(upper, lam_u, lam_l)
            phi[:, col] = phi_u
    return lam, phi, p, n_south


def tripolar_grid(Nx, Ny, Nz, *, device="cuda", southernmost_latitude=-80.0,
                  north_poles_latitude=55.0, first_pole_longitude=70.0, z_faces=None,
                  depth=4000.0, surface_dz=30.0, halo=(4, 4, 4),
                  dtype=torch.float32) -> TripolarGrid:
    """Build a TripolarGrid on ``device`` (the arguments and defaults of
    ``gb25_tpu.grids.tripolar_grid``), immersed with the pole caps as
    land."""
    hx, hy, hz = halo
    lam, phi, p, _ = _staggered_coords(
        Nx, Ny, southernmost_latitude, north_poles_latitude, first_pole_longitude)

    # (Nx, Ny) samples: di, dj = 0 on faces, 1 on centres
    def at(di, dj):
        return lam[di::2, dj::2][:Nx, :Ny], phi[di::2, dj::2][:Nx, :Ny]

    lam_ff, phi_ff = at(0, 0)
    lam_cc, phi_cc = at(1, 1)
    lam_fc, phi_fc = at(0, 1)
    lam_cf, phi_cf = at(1, 0)

    def xdiff(lams, phis):
        lam_e = np.concatenate([lams, lams[:1]], axis=0)
        phi_e = np.concatenate([phis, phis[:1]], axis=0)
        return _great_circle(lam_e[:-1], phi_e[:-1], lam_e[1:], phi_e[1:])

    dxc_i = xdiff(lam_fc, phi_fc)  # between the (f, c) nodes bounding a centre
    dxf_i = xdiff(lam_ff, phi_ff)  # between adjacent corners along a y-face row
    dyc_full = _great_circle(lam_cf[:, :-1], phi_cf[:, :-1], lam_cf[:, 1:], phi_cf[:, 1:])
    dyc_i = np.concatenate([dyc_full, dyc_full[:, -1:]], axis=1)
    dyf_full = _great_circle(lam_cc[:, :-1], phi_cc[:, :-1], lam_cc[:, 1:], phi_cc[:, 1:])
    dyf_i = np.concatenate([dyf_full[:, :1], dyf_full], axis=1)

    # Cells touching the pole singularities degenerate to zero size: floor
    # the metrics at 1e-3 of the largest spacing, and make the degenerate
    # columns (padded by one cell) land
    dx_floor = 1e-3 * dxc_i.max()
    dy_floor = 1e-3 * dyc_i.max()
    degenerate = (dxc_i < dx_floor) | (dyc_i < dy_floor) | (dxf_i < dx_floor) | (dyf_i < dy_floor)
    deg_pad = degenerate.copy()
    deg_pad |= np.roll(degenerate, 1, 0) | np.roll(degenerate, -1, 0)
    deg_pad[:, 1:] |= degenerate[:, :-1]
    deg_pad[:, :-1] |= degenerate[:, 1:]

    dxc_i = np.maximum(dxc_i, dx_floor)
    dxf_i = np.maximum(dxf_i, dx_floor)
    dyc_i = np.maximum(dyc_i, dy_floor)
    dyf_i = np.maximum(dyf_i, dy_floor)
    azc_i = dxc_i * dyc_i
    azf_i = dxf_i * dyf_i

    def extend_metric(m, yface=False, xface=False):
        """x wrap, south mirror and the fold of the metric VALUES (no sign):
        centre rows ghost(i, P+k) = m(fold(i), P-k), y-face rows
        ghost(i, Ny-1+k) = m(fold(i), Ny-k); fold(i) = (2p - i) mod Nx on
        centres, (2p + 1 - i) on x faces."""
        fold = np.roll(m[::-1, :], (2 * p + (2 if xface else 1)) % Nx, axis=0)
        if yface:
            north = fold[:, Ny - hy : Ny][:, ::-1]
        else:
            north = fold[:, Ny - 1 - hy : Ny - 1][:, ::-1]
        south = m[:, :hy][:, ::-1]
        me = np.concatenate([south, m, north], axis=1) if hy else m
        return np.concatenate([me[-hx:], me, me[:hx]], axis=0) if hx else me

    # dxf, dyf, azf live on y-face rows, phi_ff on corners, the rest on centres
    metrics = {
        "dxc": extend_metric(dxc_i), "dxf": extend_metric(dxf_i, yface=True),
        "dyc": extend_metric(dyc_i), "dyf": extend_metric(dyf_i, yface=True),
        "azc": extend_metric(azc_i), "azf": extend_metric(azf_i, yface=True),
    }
    phi_ff_e = extend_metric(phi_ff, yface=True, xface=True)

    zf = z_face_positions(Nz, z_faces, depth, surface_dz)
    z_c_full, z_f_e, dz_c, dz_f = extended_z_profiles(zf, hz)

    # nominal 1-D coordinates: uniform longitude, the mean latitude of a row
    dlam = 360.0 / Nx
    lam_c_1d = np.concatenate([np.arange(-hx, 0), np.arange(Nx), np.arange(Nx, Nx + hx)]) \
        * dlam + 0.5 * dlam
    lam_f_1d = lam_c_1d - 0.5 * dlam
    phi_row = phi_cc.mean(axis=0)
    phi_c_1d = np.concatenate([phi_row[:hy][::-1], phi_row, phi_row[-hy:][::-1]])

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    def plane(a):  # (x, y) numpy -> (1, Y, X)
        return t(np.transpose(a))[None]

    def zcol(a):
        return t(a).reshape(-1, 1, 1)

    # land at the pole singularities (bottom at sea level: a dry column)
    cap = np.where(deg_pad, 0.0, zf[0])
    grid = TripolarGrid(
        Nx=Nx, Ny=Ny, Nz=Nz, halo=(hx, hy, hz), x_periodic=True,
        lam_c=t(lam_c_1d), lam_f=t(lam_f_1d), phi_c=t(phi_c_1d), phi_f=t(phi_c_1d),
        z_c=zcol(z_c_full), z_f=zcol(z_f_e), dz_c=zcol(dz_c), dz_f=zcol(dz_f),
        **{name: plane(m) for name, m in metrics.items()},
        bottom_height=t(np.transpose(cap)),
        pole_index=p, lam2_c=t(np.transpose(lam_cc)), phi2_c=t(np.transpose(phi_cc)),
        phi2_ff=plane(phi_ff_e),
    )
    return with_bathymetry(grid, grid.bottom_height)


# ---------------------------------------------------------------------------
# the north fold (single device)
# ---------------------------------------------------------------------------

def fold_x(a, p: int, face: bool):
    """The x fold along the last dimension: centres x -> (2p - x) mod Nx,
    x faces x -> (2p + 1 - x) mod Nx (a gather, exact)."""
    Nx = a.shape[-1]
    src = (2 * p + int(face) - torch.arange(Nx, device=a.device)) % Nx
    return a.index_select(-1, src)


def fold_ghosts_north(a, h: int, kind: str, p: int):
    """The ``h`` ghost rows beyond the seam of a ``(..., Ny, Nx)`` field, in
    ghost order (rows Ny, Ny+1, ...): centres (c, w, eta) ghost(P+m) =
    c(fold_c, P-m); u ghost(P+m) = -u(fold_u, P-m); v ghost face Ny+m =
    -v(fold_c, Ny-1-m). Only the thin slab is folded."""
    Ny = a.shape[-2]
    if kind == "v":
        thin = a[..., Ny - h : Ny, :]
    else:
        thin = a[..., Ny - 1 - h : Ny - 1, :]
    g = fold_x(thin.flip(-2), p, face=kind == "u")
    return -g if kind in ("u", "v") else g


def fill_fold_halos(grid, e, kind: str, hx: int, hy: int):
    """Write the x and y ghosts of ``e`` (``(..., Ny+2hy, Nx+2hx)``, the
    interior already in place) in the JAX package's order: the fold rows,
    the south boundary, then the x wrap of whole columns, so the corners
    agree bit for bit."""
    Ny, Nx = grid.Ny, grid.Nx
    a = e[..., hy : hy + Ny, hx : hx + Nx]
    e[..., hy + Ny :, hx : hx + Nx] = fold_ghosts_north(a, hy, kind, grid.pole_index)
    lo, _ = ghost_blocks(a, hy, a.dim() - 2, FIELD_BCS[kind][1][0], "zerograd")
    e[..., :hy, hx : hx + Nx] = lo
    e[..., :hx] = e[..., Nx : hx + Nx]
    e[..., hx + Nx :] = e[..., hx : 2 * hx]
    return e


def extend_field_tripolar(grid, a, kind: str, hx: int, hy: int):
    """Extend a ``(..., Ny, Nx)`` field by ``hx``, ``hy`` ghosts: the fold,
    the south boundary and the x wrap."""
    Ny, Nx = a.shape[-2:]
    e = a.new_empty((*a.shape[:-2], Ny + 2 * hy, Nx + 2 * hx))
    e[..., hy : hy + Ny, hx : hx + Nx] = a
    return fill_fold_halos(grid, e, kind, hx, hy)


def north_fold_projection(grid, u, eta, tracers):
    """Make the seam row its own mirror image (the T-pivot consistency):
    centre fields take the mean of the row and its fold, u the
    antisymmetric part; v keeps both of its representations. Writes the
    seam row of each field in place and returns nothing."""
    p, P = grid.pole_index, grid.Ny - 1
    row = u[..., P, :]
    u[..., P, :] = 0.5 * (row - fold_x(row, p, face=True))
    for c in (eta, *tracers.values()):
        row = c[..., P, :]
        c[..., P, :] = 0.5 * (row + fold_x(row, p, face=False))
