"""Prescribed atmosphere on the ocean grid (port of
``gb25_tpu.models.atmosphere``).

The data-free atmosphere of the coupled climate model: analytic, steady
surface fields sampled on a 360x180 lat-lon grid at 24 hourly times. Two
forms, as in the JAX package:
  - pre-regridded (the default): the record regridded bilinearly onto the
    ocean's cell centers once, at construction, in float64 numpy; each
    step only interpolates linearly in time, cyclically over the record.
    Fields are stored ``(Nt, Ny, Nx)``: one contiguous ocean plane a time;
  - the per-step gather form (``pre_regrid=False``, for records too large
    to hold at ocean resolution): fields stay on the atmosphere's grid,
    stored ``(Nt, Ma, Na)``, and each step interpolates in time there,
    then gathers the four neighbours of every ocean center (flat indices
    into the (Ma, Na) plane) and weights them bilinearly, on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

FIELD_NAMES = ("Ta", "ua", "va", "qa", "Qsw", "Qlw", "pa")


def _bilinear_weights(src_x, src_y, dst_x, dst_y, periodic_x=360.0):
    """Separable bilinear gather indices and weights (numpy):
    (ix0, ix1, wx, iy0, iy1, wy) for target points ``dst_x``, ``dst_y``
    on the source cell centers ``src_x`` (periodic), ``src_y``."""
    src_x = np.asarray(src_x, np.float64)
    src_y = np.asarray(src_y, np.float64)
    dx = np.asarray(dst_x, np.float64)
    dy = np.asarray(dst_y, np.float64)

    dxm = (dx - src_x[0]) % periodic_x + src_x[0]
    ext = np.concatenate([src_x, src_x[:1] + periodic_x])
    ix0 = np.clip(np.searchsorted(ext, dxm, side="right") - 1, 0, len(src_x) - 1)
    x0 = ext[ix0]
    x1 = ext[ix0 + 1]
    ix1 = (ix0 + 1) % len(src_x)
    wx = (dxm - x0) / (x1 - x0)

    iy0 = np.clip(np.searchsorted(src_y, dy, side="right") - 1, 0, len(src_y) - 2)
    iy1 = iy0 + 1
    wy = np.clip((dy - src_y[iy0]) / (src_y[iy1] - src_y[iy0]), 0.0, 1.0)
    return ix0, ix1, wx, iy0, iy1, wy


@dataclasses.dataclass(frozen=True)
class PrescribedAtmosphere:
    """A cyclic time series of surface fields, on the ocean's centers or,
    with ``gather``, on the atmosphere's own grid.

    fields: name -> (Nt, Ny, Nx) tensor, or (Nt, Ma, Na) with ``gather``.
    Names: Ta (K), ua, va (m/s), qa (kg/kg), Qsw, Qlw (W/m^2, downwelling),
    pa (Pa). ``gather``: None (pre-regridded), or (i00, i10, i01, i11, wx,
    wy), each (Ny, Nx): the flat indices into an (Ma, Na) plane of the
    (x0, y0), (x1, y0), (x0, y1) and (x1, y1) neighbours of each ocean
    center and the bilinear weights."""

    fields: dict
    times: torch.Tensor  # (Nt,) seconds
    period: float        # seconds; the time interpolation is cyclic
    gather: tuple | None = None

    @property
    def on_ocean_grid(self) -> bool:
        return self.gather is None

    def _time_weights(self, t):
        """(k0, k1, wt) at model time ``t`` (a 0-d tensor), as 0-d tensors
        on the device: no host synchronisation (indexing with a 0-d tensor
        would read it on the host), so a captured step reads the time of
        each replay."""
        times = self.times
        tt = torch.remainder(t, self.period)
        nt = times.shape[0]
        k0 = torch.clamp(torch.searchsorted(times, tt.reshape(1), right=True)[0] - 1, 0, nt - 1)
        last = k0 + 1 >= nt
        k1 = torch.where(last, torch.zeros_like(k0), k0 + 1)
        t0 = times.index_select(0, k0.reshape(1))[0]
        t1 = torch.where(last, t0 + (times[1] - times[0]),
                         times.index_select(0, k1.reshape(1))[0])
        wt = torch.clamp((tt - t0) / torch.clamp(t1 - t0, min=1e-30), 0.0, 1.0)
        return k0, k1, wt

    def at_time(self, t):
        """The fields at model time ``t`` on the ocean's centers: name ->
        (Ny, Nx)."""
        k0, k1, wt = self._time_weights(t)
        i0, i1 = k0.reshape(1), k1.reshape(1)
        out = {}
        for name, f in self.fields.items():
            ft = (1.0 - wt) * f.index_select(0, i0)[0] + wt * f.index_select(0, i1)[0]
            if self.gather is None:
                out[name] = ft
                continue
            i00, i10, i01, i11, wx, wy = self.gather
            out[name] = ((1 - wx) * (1 - wy) * torch.take(ft, i00)
                         + wx * (1 - wy) * torch.take(ft, i10)
                         + (1 - wx) * wy * torch.take(ft, i01)
                         + wx * wy * torch.take(ft, i11))
        return out

    def pre_regrid(self):
        """The pre-regridded atmosphere of this gather form: every time of
        the record regridded at once, in float64 on the fields' device, as
        the JAX package's ``pre_regrid`` does in numpy: the same products
        in the same order, each rounded once (one op a kernel), so the
        record equals its bit for bit; rounded to the fields' dtype at the
        end. Time and space interpolation are both linear, so the two
        forms agree to rounding."""
        if self.gather is None:
            return self
        i00, i10, i01, i11, wx, wy = self.gather
        wx, wy = wx.double()[None], wy.double()[None]
        fields = {}
        for name, f in self.fields.items():
            fn = f.double().reshape(f.shape[0], -1)

            def at(i):
                return fn.index_select(1, i.reshape(-1)).reshape(fn.shape[0], *i.shape)

            g = ((1 - wx) * (1 - wy) * at(i00) + wx * (1 - wy) * at(i10)
                 + (1 - wx) * wy * at(i01) + wx * wy * at(i11))
            fields[name] = g.to(f.dtype)
        return dataclasses.replace(self, fields=fields, gather=None)


def gather_atmosphere(fields, times, period, weights, ocean_grid, dtype=None):
    """A gather-form atmosphere on ``ocean_grid``'s device: ``fields`` name
    -> (Na, Ma, Nt) numpy record (the JAX package's layout), rounded to
    ``dtype``; ``weights`` = (ix0, ix1, wx, iy0, iy1, wy) of
    ``_bilinear_weights`` in the JAX package's (Nx, Ny) order."""
    dtype = dtype or ocean_grid.dtype
    np_dtype = np.dtype(str(dtype).removeprefix("torch."))
    device = ocean_grid.device
    ix0, ix1, wx, iy0, iy1, wy = (np.ascontiguousarray(np.transpose(w)) for w in weights)
    Na = next(iter(fields.values())).shape[0]

    def index(iy, ix):
        return torch.as_tensor((iy * Na + ix).astype(np.int64), device=device)

    def plane(w):
        return torch.as_tensor(w.astype(np_dtype), device=device)

    return PrescribedAtmosphere(
        fields={k: torch.as_tensor(np.ascontiguousarray(np.transpose(np.asarray(f))
                                                        .astype(np_dtype)), device=device)
                for k, f in fields.items()},
        times=torch.as_tensor(np.asarray(times).astype(np_dtype), device=device),
        period=float(period),
        gather=(index(iy0, ix0), index(iy0, ix1), index(iy1, ix0), index(iy1, ix1),
                plane(wx), plane(wy)),
    )


def zonal_wind(phi):
    """The analytic zonal wind (m/s) at latitude ``phi`` (degrees)."""
    return 4.0 * np.sin(np.deg2rad(2 * phi)) ** 2 - 2.0 * np.exp(-((np.abs(phi) - 12.0) ** 2) / 72.0)


def sunlight(phi):
    """The analytic downwelling shortwave (W/m^2, positive down)."""
    return 200.0 + 600.0 * np.cos(np.deg2rad(phi)) ** 2


def atmos_temperature(phi):
    """The analytic air temperature (K)."""
    return 30.0 * np.cos(np.deg2rad(phi)) + 273.15


def data_free_atmosphere(ocean_grid, Na=360, Ma=180, ntimes=24, dtype=None, pre_regrid=True):
    """The data-free atmosphere on ``ocean_grid``'s device: analytic steady
    fields on an Na x Ma grid at ``ntimes`` times over one day, regridded
    onto the ocean centers at construction (``pre_regrid``) or gathered at
    each step. The arithmetic is the JAX package's, operation for
    operation (the fields and weights rounded to ``dtype`` before the
    float64 regrid, the result rounded again), so the record equals its
    bit for bit."""
    dtype = dtype or ocean_grid.dtype
    np_dtype = np.dtype(str(dtype).removeprefix("torch."))
    lam_a = (np.arange(Na) + 0.5) * (360.0 / Na)
    phi_a = -90.0 + (np.arange(Ma) + 0.5) * (180.0 / Ma)
    times = np.linspace(0.0, 86400.0, ntimes, endpoint=False)

    zeros = np.zeros((Na, Ma, ntimes))
    src = {
        "Ta": np.broadcast_to(atmos_temperature(phi_a)[None, :, None], (Na, Ma, ntimes)),
        "ua": np.broadcast_to(zonal_wind(phi_a)[None, :, None], (Na, Ma, ntimes)),
        "va": zeros,
        "qa": zeros,
        "Qsw": np.broadcast_to(sunlight(phi_a)[None, :, None], (Na, Ma, ntimes)),
        "Qlw": zeros + 350.0,  # steady clear-sky downwelling longwave
        "pa": zeros + 101325.0,
    }

    # target points in the JAX package's (Nx, Ny) order: the 2-D centres of
    # a tripolar grid, else the lat-lon product
    if ocean_grid.north_fold:
        dst_lam = np.transpose(ocean_grid.lam2_c.cpu().numpy() % 360.0)
        dst_phi = np.transpose(ocean_grid.phi2_c.cpu().numpy())
    else:
        lam_o = ocean_grid.lam_c_i.cpu().numpy().astype(np_dtype)
        phi_o = ocean_grid.phi_c_i.cpu().numpy().astype(np_dtype)
        dst_lam = lam_o[:, None] + 0 * phi_o[None, :]
        dst_phi = 0 * dst_lam + phi_o[None, :]
    weights = _bilinear_weights(lam_a, phi_a, dst_lam, dst_phi)
    atmos = gather_atmosphere({name: src[name] for name in FIELD_NAMES}, times, 86400.0,
                              weights, ocean_grid, dtype)
    return atmos.pre_regrid() if pre_regrid else atmos
