"""Data-driven inputs (port of ``gb25_tpu.data.datasets``): bathymetry
regridding, T/S restoring to a climatology, initialization from it, and
file-backed prescribed atmospheres.

The reference's run (ocean_climate_simulation.jl) regrids ETOPO1
bathymetry, restores T and S to the ECCO4 monthly climatology under a
linearly tapered polar mask at rate 1/(7 days), initializes from the ECCO
state and is forced by JRA55. The loaders read the JAX package's ``.npz``
layouts or NetCDF files (``data.netcdf``); without a dataset a synthetic
climatology keeps the pipeline runnable. Files, in the JAX package's
(lon, lat, ...) order:

  bathymetry.npz:  lat (Ma,), lon (Na,), z (Na, Ma) [m, negative under water]
  climatology.npz: lat, lon, z_levels (L,), T (Na, Ma, L), S (Na, Ma, L)
  atmosphere.npz:  lat, lon, times (Nt,) [s], Ta/ua/va/qa/Qsw/Qlw/pa (Na,Ma,Nt)

The regridding runs once, at load time, in numpy on the host, in the JAX
package's (Nx, Ny) order and arithmetic; the results cross to the port's
(Z, Y, X) layout and the grid's device at the end.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gb25_tpu_torch.grids.immersed import with_bathymetry
from gb25_tpu_torch.models.atmosphere import _bilinear_weights, gather_atmosphere

ATMOSPHERE_FIELDS = ("Ta", "ua", "va", "qa", "Qsw", "Qlw", "pa")


def _dst_coords(grid):
    """The ocean centers' (longitude, latitude), (Nx, Ny) numpy arrays in the
    grid's dtype: the 2-D centers of a tripolar grid, else the lat-lon
    product."""
    if grid.north_fold:
        return (np.transpose(grid.lam2_c.cpu().numpy()),
                np.transpose(grid.phi2_c.cpu().numpy()))
    lam = grid.lam_c_i.cpu().numpy()[:, None]
    phi = grid.phi_c_i.cpu().numpy()[None, :]
    return (np.broadcast_to(lam, (grid.Nx, grid.Ny)),
            np.broadcast_to(phi, (grid.Nx, grid.Ny)))


def _regrid2d(src_lon, src_lat, field, dst_lon, dst_lat):
    """Bilinear regrid of an (Na, Ma) field onto the (Nx, Ny) targets."""
    ix0, ix1, wx, iy0, iy1, wy = _bilinear_weights(src_lon, src_lat, dst_lon, dst_lat)
    f00 = field[ix0, iy0]
    f10 = field[ix1, iy0]
    f01 = field[ix0, iy1]
    f11 = field[ix1, iy1]
    return ((1 - wx) * (1 - wy) * f00 + wx * (1 - wy) * f10
            + (1 - wx) * wy * f01 + wx * wy * f11)


def _interp_z_columns(zc, zl, F):
    """Per-column linear interpolation in z with ``np.interp``'s semantics
    (the end values outside the levels): ``F`` (..., L) at ascending
    ``zl`` -> (..., len(zc)), one fancy-index expression for all columns."""
    zc = np.asarray(zc, dtype=np.float64)
    zl = np.asarray(zl, dtype=np.float64)
    if len(zl) == 1:  # a constant column
        return np.broadcast_to(F[..., 0:1], F.shape[:-1] + (len(zc),)).copy()
    idx = np.clip(np.searchsorted(zl, zc, side="right"), 1, len(zl) - 1)
    z0, z1 = zl[idx - 1], zl[idx]
    w = np.clip((zc - z0) / np.maximum(z1 - z0, 1e-30), 0.0, 1.0)
    return F[..., idx - 1] * (1.0 - w) + F[..., idx] * w


def _is_netcdf(path):
    if not os.path.exists(path):
        return False
    with open(path, "rb") as f:
        magic = f.read(4)
    return magic[:3] == b"CDF" or magic == b"\x89HDF"


def _to_port(a, grid):
    """A JAX-layout numpy array ((Nx, Ny) or (Nx, Ny, Nz)) as a port tensor
    ((Y, X) or (Z, Y, X)) in the grid's dtype on its device."""
    a = np.asarray(a).astype(np.dtype(str(grid.dtype).removeprefix("torch.")))
    return torch.as_tensor(np.ascontiguousarray(np.transpose(a)), device=grid.device)


def regrid_bathymetry(grid, path):
    """``grid`` with a bathymetry dataset (the ``.npz`` layout above, or a
    NetCDF file with ETOPO-style names) regridded onto its centers and
    attached through ``grids.immersed.with_bathymetry``."""
    if _is_netcdf(path):
        from gb25_tpu_torch.data.netcdf import load_bathymetry_nc

        lon, lat, z = load_bathymetry_nc(path)
    else:
        with np.load(path) as d:
            lon, lat, z = d["lon"], d["lat"], d["z"]
    dlon, dlat = _dst_coords(grid)
    bh = _regrid2d(lon, lat, z, dlon, dlat)
    return with_bathymetry(grid, _to_port(np.minimum(bh, 0.0), grid))


def linearly_tapered_polar_mask(grid, southern=(-80.0, -70.0), northern=(70.0, 90.0)):
    """The restoring rate's mask, ramping 0 -> 1 into the polar caps (the
    reference's LinearlyTaperedPolarMask): a (1, Ny, Nx) tensor."""
    _, phi = _dst_coords(grid)
    s0, s1 = southern
    n0, n1 = northern
    south = np.clip((s1 - phi) / max(s1 - s0, 1e-9), 0.0, 1.0)
    north = np.clip((phi - n0) / max(n1 - n0, 1e-9), 0.0, 1.0)
    return _to_port(np.maximum(south, north), grid)[None]


def climatology_restoring(grid, path=None, rate=1.0 / (7 * 86400.0), mask=None,
                          synthetic=True):
    """The ``restoring`` dict of the ocean step: T and S relaxed toward a
    climatology at ``rate`` under a polar mask (the reference's
    ECCORestoring): {"T": (target, rate mask), "S": (...)}, targets
    (Nz, Ny, Nx), the rate (1, Ny, Nx) (``mask``: the polar mask unless
    given, in the port's layout).

    ``path``: the climatology (``.npz`` or NetCDF), regridded per level
    and interpolated linearly in z; an explicit path that does not exist
    raises ``FileNotFoundError`` rather than fall back. With no path and
    ``synthetic`` a smooth analytic climatology stands in."""
    dlon, dlat = _dst_coords(grid)
    zc = grid.z_c_i.cpu().numpy()
    if path is not None and not os.path.exists(path):
        # a mistyped dataset must not quietly become the synthetic one
        raise FileNotFoundError(f"climatology dataset not found: {path}")
    if path is not None:
        if _is_netcdf(path):
            from gb25_tpu_torch.data.netcdf import load_climatology_nc

            d = load_climatology_nc(path)
            lon, lat, zl = d["lon"], d["lat"], d["z_levels"]
            Tsrc, Ssrc = d["T"], d["S"]
        else:
            with np.load(path) as d:
                lon, lat, zl = d["lon"], d["lat"], d["z_levels"]
                Tsrc, Ssrc = d["T"], d["S"]
        T = np.stack([_regrid2d(lon, lat, Tsrc[..., k], dlon, dlat)
                      for k in range(len(zl))], axis=-1)
        S = np.stack([_regrid2d(lon, lat, Ssrc[..., k], dlon, dlat)
                      for k in range(len(zl))], axis=-1)
        order = np.argsort(zl)
        Tg = _interp_z_columns(zc, zl[order], T[..., order])
        Sg = _interp_z_columns(zc, zl[order], S[..., order])
    elif synthetic:
        # an analytic stand-in with a realistic structure
        phi3 = dlat[:, :, None]
        z3 = zc[None, None, :]
        Tg = (2.0 + 26.0 * np.cos(np.deg2rad(phi3)) ** 2) * np.exp(z3 / 1000.0) + 2.0
        Sg = 35.0 - 1.5 * np.exp(z3 / 500.0) * np.cos(np.deg2rad(phi3))
    else:
        raise FileNotFoundError(f"climatology dataset not found: {path}")

    if mask is None:
        mask = linearly_tapered_polar_mask(grid)
    r = rate * mask
    return {"T": (_to_port(Tg, grid), r), "S": (_to_port(Sg, grid), r)}


def initial_state_from_climatology(grid, cfg, path=None):
    """An ocean at rest with T and S from the (file or synthetic)
    climatology (the reference's set!(ocean.model, T=ECCOMetadata(...))),
    a closure's e = 1e-6 and eps = 1e-9."""
    from gb25_tpu_torch.models.state import initial_state

    rest = climatology_restoring(grid, path=path, rate=0.0)
    st = initial_state(grid, cfg.tracers)
    tr = dict(st.tracers)
    tr["T"] = rest["T"][0]
    tr["S"] = rest["S"][0]
    if "e" in tr:
        tr["e"] = torch.full(grid.shape, 1e-6, dtype=grid.dtype, device=grid.device)
    if "eps" in tr:
        tr["eps"] = torch.full(grid.shape, 1e-9, dtype=grid.dtype, device=grid.device)
    return st.replace(tracers=tr)


def file_prescribed_atmosphere(grid, path, dtype=None, pre_regrid=True):
    """A ``PrescribedAtmosphere`` from a dataset file (the ``.npz`` layout
    above, or NetCDF with JRA55-style names): regridded onto the ocean
    centers at load time (``pre_regrid``), or kept on its own grid and
    gathered at each step (for records too large to hold at ocean
    resolution). Missing fields take the JAX package's defaults (va = qa =
    0, Qlw = 350 W/m^2, pa = 101325 Pa)."""
    if _is_netcdf(path):
        from gb25_tpu_torch.data.netcdf import load_atmosphere_nc

        d = load_atmosphere_nc(path)
        lon, lat, times = d["lon"], d["lat"], d["times"]
        fields = {k: d[k] for k in ATMOSPHERE_FIELDS if k in d}
    else:
        with np.load(path) as d:
            lon, lat, times = d["lon"], d["lat"], d["times"]
            fields = {k: d[k] for k in ATMOSPHERE_FIELDS if k in d}
    dlon, dlat = _dst_coords(grid)
    weights = _bilinear_weights(lon, lat, dlon, dlat)
    period = float(times[-1] + (times[1] - times[0]) - times[0]) if len(times) > 1 else 86400.0
    defaults = {"va": 0.0, "qa": 0.0, "Qlw": 350.0, "pa": 101325.0}
    shape = fields["Ta"].shape
    for k, v in defaults.items():
        if k not in fields:
            fields[k] = np.full(shape, v)
    atmos = gather_atmosphere(fields, times, period, weights, grid, dtype)
    return atmos.pre_regrid() if pre_regrid else atmos
