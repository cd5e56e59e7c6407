"""Latitude-longitude grid with staggered (Arakawa C) finite-volume metrics.

The port of ``gb25_tpu.grids.latlon``. The metrics are built in float64
numpy with the JAX package's arithmetic, operation for operation, and only
then cast, so they equal JAX's bit for bit in float64.

Layout: fields are stored ``(Z, Y, X)`` with x contiguous (threads along x
coalesce on the GPU). So the metric tensors are shaped to broadcast against
extended ``(Z, Y, X)`` fields: ``dx*/dy*/az*`` are ``(1, Ny+2hy, 1)`` (full
``(1, Ny+2hy, Nx+2hx)`` planes on the tripolar grid, ``grids.tripolar``) and
``dz*``/``z*`` are ``(Nz+2hz, 1, 1)``. 2-D fields (free surface, bathymetry)
are ``(Y, X)``.

Staggering (as in the JAX package): u at the west face of cell i, v at the
south face of cell j, w at the bottom face of cell k.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.ocean.grids.vertical import exponential_z_faces, uniform_z_faces

EARTH_RADIUS = 6.371e6  # meters
DEG2RAD = np.pi / 180.0


def _extend_wrap_coord(a: np.ndarray, h: int, period: float) -> np.ndarray:
    if h == 0:
        return a
    return np.concatenate([a[-h:] - period, a, a[:h] + period])


def _extend_mirror_centers(a: np.ndarray, h: int, lo_pivot: float, hi_pivot: float) -> np.ndarray:
    if h == 0:
        return a
    below = (2 * lo_pivot - a[:h])[::-1]
    above = (2 * hi_pivot - a[-h:])[::-1]
    return np.concatenate([below, a, above])


def _extend_mirror_faces(a: np.ndarray, h: int, lo_pivot: float, hi_pivot: float) -> np.ndarray:
    if h == 0:
        return a
    below = 2 * lo_pivot - a[1 : h + 1][::-1]
    above = 2 * hi_pivot - a[-h - 1 : -1][::-1]
    return np.concatenate([below, a, above])


def z_face_positions(Nz, z_faces=None, depth=4000.0, surface_dz=30.0) -> np.ndarray:
    """The ``Nz+1`` z faces (float64): ``z_faces`` as given, else uniform
    over ``depth`` (``surface_dz=None``) or stretched to ``surface_dz`` at
    the surface."""
    if z_faces is None:
        if surface_dz is None:
            z_faces = uniform_z_faces(Nz, depth)
        else:
            z_faces = exponential_z_faces(Nz, depth=depth, h=surface_dz)
    z_faces = np.asarray(z_faces, dtype=np.float64)
    if z_faces.shape != (Nz + 1,):
        raise ValueError(f"z_faces must have shape ({Nz + 1},), got {z_faces.shape}")
    return z_faces


def extended_z_profiles(zf: np.ndarray, hz: int):
    """(z_c, z_f, dz_c, dz_f) over ``Nz+2hz`` levels: the extension
    continues the edge spacing outward."""
    Nz = len(zf) - 1
    dz_bot = zf[1] - zf[0]
    dz_top = zf[-1] - zf[-2]
    z_f_full = np.concatenate(
        [zf[0] + dz_bot * np.arange(-hz, 0), zf, zf[-1] + dz_top * np.arange(1, hz + 1)]
    )
    z_c_full = 0.5 * (z_f_full[:-1] + z_f_full[1:])
    dz_c = z_f_full[1:] - z_f_full[:-1]
    dz_f = np.empty(Nz + 2 * hz)
    dz_f[1:] = z_c_full[1:] - z_c_full[:-1]
    dz_f[0] = dz_f[1]
    return z_c_full, z_f_full[: Nz + 2 * hz], dz_c, dz_f


@dataclasses.dataclass(frozen=True)
class LatitudeLongitudeGrid:
    """Spherical-shell staggered grid; every metric tensor is halo-extended."""

    Nx: int
    Ny: int
    Nz: int
    halo: tuple  # (hx, hy, hz)
    x_periodic: bool

    lam_c: torch.Tensor  # (Nx+2hx,) cell-center longitude, degrees
    lam_f: torch.Tensor  # (Nx+2hx,) west-face longitude
    phi_c: torch.Tensor  # (Ny+2hy,) cell-center latitude
    phi_f: torch.Tensor  # (Ny+2hy,) south-face latitude
    z_c: torch.Tensor    # (Nz+2hz, 1, 1) cell-center z (m, negative below the surface)
    z_f: torch.Tensor    # (Nz+2hz, 1, 1) bottom-face z
    dz_c: torch.Tensor   # (Nz+2hz, 1, 1) cell thickness
    dz_f: torch.Tensor   # (Nz+2hz, 1, 1) center-to-center spacing at bottom face k
    dxc: torch.Tensor    # (1, Ny+2hy, 1) zonal spacing at phi-centers
    dxf: torch.Tensor    # zonal spacing at phi-faces
    dyc: torch.Tensor    # meridional spacing at phi-centers
    dyf: torch.Tensor    # meridional spacing at phi-faces
    azc: torch.Tensor    # cell area at phi-centers (exact spherical)
    azf: torch.Tensor    # corner-cell area at phi-faces
    bottom_height: torch.Tensor  # (Ny, Nx), negative (m)
    # grids.immersed.ImmersedGeometry when bottom_height carries real
    # bathymetry (set by grids.immersed.with_bathymetry), else None
    geometry: object = None
    # constants derived from the grid on first use (the blocked solve's
    # statics, the barotropic loop's metric columns, the vertical solves'
    # coefficients); not copied by dataclasses.replace
    cache: dict = dataclasses.field(default_factory=dict, init=False, compare=False,
                                    repr=False)

    north_fold = False  # the tripolar grid (grids.tripolar) folds its north edge

    @property
    def immersed(self) -> bool:
        return self.geometry is not None

    @property
    def dtype(self) -> torch.dtype:
        return self.dxc.dtype

    @property
    def device(self) -> torch.device:
        return self.dxc.device

    @property
    def hx(self):
        return self.halo[0]

    @property
    def hy(self):
        return self.halo[1]

    @property
    def hz(self):
        return self.halo[2]

    @property
    def shape(self):
        """Storage shape of an interior 3-D field: ``(Nz, Ny, Nx)``."""
        return (self.Nz, self.Ny, self.Nx)

    def interior(self, ext: torch.Tensor) -> torch.Tensor:
        """Crop a halo-extended ``(Z, Y, X)`` tensor to the interior."""
        hx, hy, hz = self.halo
        return ext[hz : hz + self.Nz, hy : hy + self.Ny, hx : hx + self.Nx]

    @property
    def phi_c_i(self):
        return self.phi_c[self.hy : self.hy + self.Ny]

    @property
    def lam_c_i(self):
        return self.lam_c[self.hx : self.hx + self.Nx]

    @property
    def z_c_i(self):
        return self.z_c[self.hz : self.hz + self.Nz, 0, 0]

    @property
    def z_f_i(self):
        return self.z_f[self.hz : self.hz + self.Nz, 0, 0]


def latitude_longitude_grid(
    Nx: int,
    Ny: int,
    Nz: int,
    *,
    device="cuda",
    latitude=(-80.0, 80.0),
    longitude=(0.0, 360.0),
    z_faces: np.ndarray | None = None,
    depth: float = 4000.0,
    surface_dz: float = 30.0,
    halo=(4, 4, 4),
    dtype=torch.float32,
) -> LatitudeLongitudeGrid:
    """Build a LatitudeLongitudeGrid on ``device`` (same arguments and
    defaults as ``gb25_tpu.grids.latitude_longitude_grid``)."""
    hx, hy, hz = halo
    lat0, lat1 = latitude
    lon0, lon1 = longitude
    x_periodic = abs((lon1 - lon0) - 360.0) < 1e-12

    dlam = (lon1 - lon0) / Nx
    dphi = (lat1 - lat0) / Ny
    lam_f = lon0 + dlam * np.arange(Nx, dtype=np.float64)
    lam_c = lam_f + 0.5 * dlam
    phi_f = lat0 + dphi * np.arange(Ny, dtype=np.float64)
    phi_c = phi_f + 0.5 * dphi

    z_faces = z_face_positions(Nz, z_faces, depth, surface_dz)

    if x_periodic:
        lam_c_e = _extend_wrap_coord(lam_c, hx, 360.0)
        lam_f_e = _extend_wrap_coord(lam_f, hx, 360.0)
    else:
        lam_c_e = np.concatenate(
            [lam_c[0] + dlam * np.arange(-hx, 0), lam_c, lam_c[-1] + dlam * np.arange(1, hx + 1)]
        )
        lam_f_e = np.concatenate(
            [lam_f[0] + dlam * np.arange(-hx, 0), lam_f, lam_f[-1] + dlam * np.arange(1, hx + 1)]
        )

    # bounded y: coordinates mirror about the walls
    south_wall = phi_f[0]
    north_wall = phi_f[0] + Ny * dphi
    phi_c_e = _extend_mirror_centers(phi_c, hy, south_wall, north_wall)
    phi_f_full = np.append(phi_f, north_wall)  # Ny+1 faces
    phi_f_e = _extend_mirror_faces(phi_f_full, hy, south_wall, north_wall)[: Ny + 2 * hy]

    z_c_full, z_f_e, dz_c, dz_f = extended_z_profiles(z_faces, hz)

    # metric values on the interior (+walls), value-mirrored in bounded y
    R = EARTH_RADIUS
    dlam_r = dlam * DEG2RAD
    dphi_r = dphi * DEG2RAD
    dx_c_i = R * np.cos(phi_c * DEG2RAD) * dlam_r
    dx_f_i = R * np.cos(phi_f_full * DEG2RAD) * dlam_r
    az_c_i = R * R * dlam_r * (
        np.sin(phi_f_full[1:] * DEG2RAD) - np.sin(phi_f_full[:-1] * DEG2RAD)
    )
    az_f_i = R * R * dlam_r * np.abs(
        np.sin(np.minimum(phi_f_full + 0.5 * dphi, 90.0) * DEG2RAD)
        - np.sin(np.maximum(phi_f_full - 0.5 * dphi, -90.0) * DEG2RAD)
    )

    dx_c = np.concatenate([dx_c_i[:hy][::-1], dx_c_i, dx_c_i[-hy:][::-1]]) if hy else dx_c_i
    dx_f = (
        np.concatenate([dx_f_i[1 : hy + 1][::-1], dx_f_i, dx_f_i[-hy - 1 : -1][::-1]])[: Ny + 2 * hy]
        if hy
        else dx_f_i[:Ny]
    )
    az_c = np.concatenate([az_c_i[:hy][::-1], az_c_i, az_c_i[-hy:][::-1]]) if hy else az_c_i
    az_f = (
        np.concatenate([az_f_i[1 : hy + 1][::-1], az_f_i, az_f_i[-hy - 1 : -1][::-1]])[: Ny + 2 * hy]
        if hy
        else az_f_i[:Ny]
    )
    dy_c = np.full(Ny + 2 * hy, R * dphi_r)
    dy_f = np.full(Ny + 2 * hy, R * dphi_r)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    def col(a):  # (1, Ny+2hy, 1)
        return t(a).reshape(1, -1, 1)

    def zcol(a):  # (Nz+2hz, 1, 1)
        return t(a).reshape(-1, 1, 1)

    return LatitudeLongitudeGrid(
        Nx=Nx, Ny=Ny, Nz=Nz, halo=(hx, hy, hz), x_periodic=x_periodic,
        lam_c=t(lam_c_e), lam_f=t(lam_f_e), phi_c=t(phi_c_e), phi_f=t(phi_f_e),
        z_c=zcol(z_c_full), z_f=zcol(z_f_e), dz_c=zcol(dz_c), dz_f=zcol(dz_f),
        dxc=col(dx_c), dxf=col(dx_f), dyc=col(dy_c), dyf=col(dy_f),
        azc=col(az_c), azf=col(az_f),
        bottom_height=torch.full((Ny, Nx), float(z_faces[0]), dtype=dtype, device=device),
    )


def simple_latitude_longitude_grid(Nx, Ny, Nz, *, device="cuda", halo=(4, 4, 4),
                                   dtype=torch.float32):
    """The benchmark grid: lat (-80, 80), lon (0, 360), exponential z over
    4000 m with 30 m surface spacing."""
    return latitude_longitude_grid(
        Nx, Ny, Nz, device=device,
        latitude=(-80.0, 80.0), longitude=(0.0, 360.0),
        depth=4000.0, surface_dz=30.0, halo=halo, dtype=dtype,
    )


def resolution_to_points(resolution: float) -> tuple[int, int]:
    """(Nx, Ny) of the lat-lon band at ``resolution`` degrees (the JAX
    package's rule: 384 / resolution by 192 / resolution)."""
    return int(384 / resolution), int(192 / resolution)
