"""NetCDF input and output in numpy alone (the port's own copy of
``gb25_tpu.data.netcdf``: the port imports nothing of the JAX package).

``read_netcdf`` reads classic NetCDF3 (magic ``CDF\\x01/\\x02``, through
``scipy.io.netcdf_file``) and NetCDF4 (HDF5, magic ``\\x89HDF``, through
``h5py`` where it is installed) into plain numpy arrays with the CF
conveniences applied (scale_factor, add_offset, _FillValue). The loaders
``load_{bathymetry,climatology,atmosphere}_nc`` map the variable names of
the real datasets (ETOPO-style bathymetry, ECCO-style climatologies,
JRA55-style atmospheres) onto the ``.npz`` layouts of ``data.datasets``,
in the JAX package's (lon, lat, ...) order. ``NetCDF3Writer`` writes a
classic file with an unlimited record axis, appended one record at a time
(``io.output.NetCDFOutputWriter``).
"""

from __future__ import annotations

import numpy as np


def _apply_cf(data, attrs):
    """Apply CF packing attributes: masked fill values, scale, offset."""
    a = np.asarray(data)
    fill = attrs.get("_FillValue", attrs.get("missing_value"))
    scale = attrs.get("scale_factor")
    offset = attrs.get("add_offset")
    if fill is not None or scale is not None or offset is not None:
        a = a.astype(np.float64, copy=True)
        if fill is not None:
            a[np.asarray(data) == np.asarray(fill)] = np.nan
        if scale is not None:
            a = a * float(np.asarray(scale))
        if offset is not None:
            a = a + float(np.asarray(offset))
    return a


def _attr_value(v):
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    return v


def read_netcdf(path):
    """Read a NetCDF file (classic or NetCDF4/HDF5).

    Returns (variables, dims_by_var, attrs_by_var):
      variables:   {name: numpy array, CF-unpacked}
      dims_by_var: {name: tuple of dimension names}
      attrs_by_var:{name: {attr: value}}
    """
    with open(path, "rb") as f:
        magic = f.read(4)

    variables, dims, attrs = {}, {}, {}
    if magic[:3] == b"CDF":
        from scipy.io import netcdf_file

        with netcdf_file(path, "r", mmap=False) as nc:
            for name, var in nc.variables.items():
                va = {k: _attr_value(v) for k, v in var._attributes.items()}
                variables[name] = _apply_cf(var.data, va)
                dims[name] = tuple(var.dimensions)
                attrs[name] = va
    elif magic == b"\x89HDF":
        import h5py

        def walk(g, prefix=""):
            for name, item in g.items():
                full = f"{prefix}{name}"
                if isinstance(item, h5py.Group):
                    walk(item, full + "/")
                else:
                    va = {k: _attr_value(v) for k, v in item.attrs.items()}
                    variables[full] = _apply_cf(item[()], va)
                    dlist = va.get("DIMENSION_LIST")
                    if dlist is None and "_Netcdf4Coordinates" not in va:
                        # fall back to the HDF5 dimension scales
                        try:
                            dims[full] = tuple(
                                d[0].name.lstrip("/") if len(d) else f"dim{k}"
                                for k, d in enumerate(item.dims)
                            )
                        except Exception:
                            dims[full] = tuple(f"dim{k}" for k in range(item.ndim))
                    else:
                        dims[full] = tuple(f"dim{k}" for k in range(item.ndim))
                    attrs[full] = va

        with h5py.File(path, "r") as f:
            walk(f)
    else:
        raise ValueError(f"{path}: not a NetCDF file (magic {magic!r})")
    return variables, dims, attrs


def find_var(variables, candidates):
    """First matching variable by exact then case-insensitive name."""
    for c in candidates:
        if c in variables:
            return c
    lower = {k.lower(): k for k in variables}
    for c in candidates:
        if c.lower() in lower:
            return lower[c.lower()]
    return None


# common names in the real datasets the reference consumes
LON_NAMES = ("lon", "longitude", "x", "XC", "nav_lon")
LAT_NAMES = ("lat", "latitude", "y", "YC", "nav_lat")
DEPTH_NAMES = ("z", "elevation", "Band1", "topo", "depth", "bathymetry")
TEMP_NAMES = ("THETA", "theta", "T", "temperature", "thetao", "Tinit")
SALT_NAMES = ("SALT", "salt", "S", "salinity", "so", "Sinit")
ZLEV_NAMES = ("z", "depth", "Z", "lev", "level", "RC")
TIME_NAMES = ("time", "times", "t")

ATMOS_VARS = {
    # framework name -> candidate dataset names (JRA55 / ERA5 conventions)
    "Ta": ("Ta", "tas", "t2m", "air_temperature"),
    "ua": ("ua", "uas", "u10", "eastward_wind"),
    "va": ("va", "vas", "v10", "northward_wind"),
    "qa": ("qa", "huss", "q2m", "specific_humidity"),
    "Qsw": ("Qsw", "rsds", "ssrd", "shortwave"),
    "Qlw": ("Qlw", "rlds", "strd", "longwave"),
    "pa": ("pa", "psl", "sp", "pressure"),
}


def _lonlat(variables):
    lon = find_var(variables, LON_NAMES)
    lat = find_var(variables, LAT_NAMES)
    if lon is None or lat is None:
        raise ValueError(f"no lon/lat coordinates found among {list(variables)}")
    return np.asarray(variables[lon]).ravel(), np.asarray(variables[lat]).ravel()


def _canonicalize_lonlat(lon, lat, *fields):
    """Normalize coordinates to the framework convention: lon ascending in
    [0, 360), lat ascending — permuting each field's leading (lon, lat) axes
    to match.

    Real products violate the convention in both ways: ETOPO1/ERA5 store
    longitudes in [-180, 180) (a plain ``% 360`` leaves the axis
    non-monotonic, which silently breaks the interpolation weights in
    datasets._bilinear_weights), and ERA5/JRA55-do variants store latitude
    descending 90 -> -90 (a silent north/south flip). Reference consumes the
    same files via ClimaOcean's readers
    (the reference's ocean_climate_simulation.jl).
    """
    lon = np.asarray(lon, dtype=np.float64) % 360.0
    roll = int(np.argmin(lon))  # first index of the ascending cycle
    lon = np.roll(lon, -roll)
    # grid-registered products (e.g. ETOPO1 *_g_gmt4) carry BOTH endpoints
    # -180 and +180, which alias to the same meridian after % 360 — drop the
    # later duplicate (the rows are the same physical data) instead of
    # rejecting the axis
    keep = np.concatenate([[True], np.diff(lon) > 0.0])
    lon = lon[keep]
    if np.any(np.diff(lon) <= 0):
        raise ValueError("longitude axis is not a single ascending cycle")
    flip = len(lat) > 1 and lat[1] < lat[0]
    lat = np.asarray(lat, dtype=np.float64)[::-1] if flip else np.asarray(lat, dtype=np.float64)
    out = []
    for f in fields:
        f = np.roll(f, -roll, axis=0)[keep]
        if flip:
            f = f[:, ::-1]
        out.append(f)
    return (lon, lat, *out)


def parse_time_units(times, units, calendar=None):
    """CF time axis -> seconds since the file's own epoch (relative).

    Handles "seconds|hours|days since YYYY-MM-DD[ hh:mm:ss]" (the JRA55-do
    and ERA5 conventions). The absolute epoch is irrelevant to the cyclic
    forcing interpolation (PrescribedAtmosphere wraps by period), so only
    the unit scale is applied; 360_day/noleap calendars differ only in the
    epoch mapping and need no special casing here.
    """
    times = np.asarray(times, dtype=np.float64).ravel()
    if not units:
        return times
    unit = str(units).split("since")[0].strip().lower()
    scale = {"second": 1.0, "seconds": 1.0, "sec": 1.0, "s": 1.0,
             "minute": 60.0, "minutes": 60.0, "min": 60.0,
             "hour": 3600.0, "hours": 3600.0, "h": 3600.0,
             "day": 86400.0, "days": 86400.0, "d": 86400.0}.get(unit)
    if scale is None:
        return times
    t = times * scale
    return t - t[0] if t.size else t


def _to_lonlat_leading(a, nlon, nlat):
    """Reorder a gridded array so (lon, lat) are the leading axes."""
    ax_lon = [i for i, s in enumerate(a.shape) if s == nlon]
    ax_lat = [i for i, s in enumerate(a.shape) if s == nlat]
    if not ax_lon or not ax_lat:
        raise ValueError(f"array shape {a.shape} does not match lon={nlon} lat={nlat}")
    il = ax_lon[-1]
    ia = ax_lat[0] if ax_lat[0] != il else ax_lat[-1]
    rest = [i for i in range(a.ndim) if i not in (il, ia)]
    return np.transpose(a, (il, ia, *rest))


def load_bathymetry_nc(path):
    """ETOPO-style file -> (lon, lat, z(lon, lat) [m, negative under water])."""
    variables, _, _ = read_netcdf(path)
    lon, lat = _lonlat(variables)
    zname = find_var(variables, DEPTH_NAMES)
    if zname is None:
        raise ValueError(f"no elevation variable found among {list(variables)}")
    z = _to_lonlat_leading(np.asarray(variables[zname]), len(lon), len(lat))
    z = np.nan_to_num(z, nan=0.0)
    return _canonicalize_lonlat(lon, lat, z)


def load_climatology_nc(path, salinity_path=None):
    """ECCO-style file(s) -> dict(lon, lat, z_levels, T, S) on (lon, lat, z)."""
    variables, _, _ = read_netcdf(path)
    if salinity_path is not None:
        sv, _, _ = read_netcdf(salinity_path)
        variables = {**variables, **{f"S::{k}": v for k, v in sv.items()}}
    lon, lat = _lonlat(variables)
    zlev = find_var(variables, ZLEV_NAMES)
    z_levels = np.asarray(variables[zlev]).ravel() if zlev else np.array([0.0])
    if z_levels.max() > 0:  # depths stored positive-down
        z_levels = -np.abs(z_levels)
    Tn = find_var(variables, TEMP_NAMES)
    Sn = find_var(variables, [f"S::{c}" for c in SALT_NAMES] + list(SALT_NAMES))
    if Tn is None or Sn is None:
        raise ValueError(f"missing T/S among {list(variables)}")

    def prep(a):
        a = np.asarray(a)
        if a.ndim == 4:  # (time, z, lat, lon) monthly -> annual mean
            a = np.nanmean(a, axis=0)
        a = _to_lonlat_leading(a, len(lon), len(lat))
        return np.nan_to_num(a, nan=0.0)

    lon_c, lat_c, T, S = _canonicalize_lonlat(lon, lat, prep(variables[Tn]), prep(variables[Sn]))
    return {"lon": lon_c, "lat": lat_c, "z_levels": z_levels, "T": T, "S": S}


def load_atmosphere_nc(path):
    """JRA55-style file -> dict(lon, lat, times, Ta/ua/va/qa/Qsw/Qlw/pa).

    Times are converted from the file's CF units ("hours since ...") to
    seconds relative to the first record; lon/lat canonicalized ascending.
    """
    variables, _, attrs = read_netcdf(path)
    lon, lat = _lonlat(variables)
    tname = find_var(variables, TIME_NAMES)
    times = np.asarray(variables[tname]).ravel() if tname else np.array([0.0])
    if tname is not None:
        ta = attrs.get(tname, {})
        times = parse_time_units(times, ta.get("units"), ta.get("calendar"))
    out = {"times": times}
    defaults = {"Ta": 288.15, "ua": 0.0, "va": 0.0, "qa": 0.0,
                "Qsw": 200.0, "Qlw": 350.0, "pa": 101325.0}
    fields = {}
    for name, cands in ATMOS_VARS.items():
        v = find_var(variables, cands)
        if v is None:
            fields[name] = np.full((len(lon), len(lat), len(times)), defaults[name])
            continue
        a = np.asarray(variables[v])
        a = _to_lonlat_leading(a, len(lon), len(lat))
        if a.ndim == 2:
            a = np.repeat(a[:, :, None], len(times), axis=2)
        fields[name] = np.nan_to_num(a, nan=defaults[name])
    names = list(fields)
    lon_c, lat_c, *canon = _canonicalize_lonlat(lon, lat, *(fields[n] for n in names))
    out["lon"], out["lat"] = lon_c, lat_c
    out.update(zip(names, canon))
    return out


# --------------------------------------------------------------------------
# Classic NetCDF writer (64-bit-offset CDF-2; public on-disk format, same
# spec family the reader above decodes).  Dependency-free so simulation
# outputs are CF-readable by any standard tool — the reference's analog
# surface writers are JLD2/NetCDF (simulations/ocean_climate_simulation.jl:
# 128-134).  Supports one unlimited (record) dimension with O(1) appends:
# classic record data lives interleaved at the file tail, so appending a
# record is a pure append plus a numrecs header patch.
# --------------------------------------------------------------------------

_NC_TYPES = {
    np.dtype("int8"): (1, 1), np.dtype("S1"): (2, 1),
    np.dtype(">i2"): (3, 2), np.dtype(">i4"): (4, 4),
    np.dtype(">f4"): (5, 4), np.dtype(">f8"): (6, 8),
}


def _nc_type(dtype):
    dt = np.dtype(dtype).newbyteorder(">")
    if dt.kind == "i" and dt.itemsize == 1:
        dt = np.dtype("int8")
    elif dt.kind == "i" and dt.itemsize == 8:
        dt = np.dtype(">i4")  # classic has no int64; narrow (attr/ints only)
    elif dt.kind == "b":
        dt = np.dtype("int8")
    if dt not in _NC_TYPES:
        raise TypeError(f"classic NetCDF cannot store dtype {dtype}")
    return dt, *_NC_TYPES[dt]


def _pad4(n):
    return (4 - n % 4) % 4


class NetCDF3Writer:
    """Minimal classic-NetCDF writer (CDF-2).

    Usage::

        w = NetCDF3Writer(path, dims={"time": None, "lat": 8, "lon": 16},
                          global_attrs={"title": "..."})
        w.define("lat", ("lat",), np.float64, {"units": "degrees_north"})
        w.define("sst", ("time", "lat", "lon"), np.float32,
                 {"units": "degC"})
        w.write("lat", lats)                 # non-record variables
        w.append(sst=frame0); w.append(sst=frame1)   # record variables
        w.close()

    ``dims`` is ordered; at most one dimension may be None (the record /
    unlimited dimension, which must be a variable's *first* dimension).
    """

    def __init__(self, path, dims, global_attrs=None):
        self.path = path
        self.dims = dict(dims)
        unlimited = [d for d, n in self.dims.items() if n is None]
        if len(unlimited) > 1:
            raise ValueError("classic NetCDF allows one unlimited dimension")
        self.rec_dim = unlimited[0] if unlimited else None
        self.gatts = dict(global_attrs or {})
        self._vars = {}  # name -> (dims, np_be_dtype, nc_type, attrs)
        self._static_data = {}
        self._f = None
        self.numrecs = 0

    def define(self, name, dim_names, dtype, attrs=None):
        if self._f is not None:
            raise RuntimeError("header already written")
        for d in dim_names:
            if d not in self.dims:
                raise KeyError(f"unknown dimension {d!r}")
        if self.rec_dim in dim_names and dim_names[0] != self.rec_dim:
            raise ValueError("record dimension must come first")
        dt, code, _ = _nc_type(dtype)
        self._vars[name] = (tuple(dim_names), dt, code, dict(attrs or {}))

    def write(self, name, array):
        if self._f is not None:
            # the static section was laid out (zero-filled for any variable
            # not yet written) when the first append() flushed the header —
            # accepting data now would silently discard it
            raise RuntimeError("header already written; write() statics before the first append()")
        dims, dt, _, _ = self._vars[name]
        if self.rec_dim in dims:
            raise ValueError(f"{name} is a record variable; use append()")
        shape = tuple(self.dims[d] for d in dims)
        a = np.ascontiguousarray(np.asarray(array), dt).reshape(shape)
        self._static_data[name] = a

    # -- header encoding ----------------------------------------------------
    @staticmethod
    def _name(s):
        b = s.encode()
        return _i4(len(b)) + b + b"\x00" * _pad4(len(b))

    def _atts(self, atts):
        if not atts:
            return _i4(0) + _i4(0)
        out = [_i4(0x0C), _i4(len(atts))]
        for k, v in atts.items():
            out.append(self._name(k))
            if isinstance(v, str):
                b = v.encode()
                out += [_i4(2), _i4(len(b)), b, b"\x00" * _pad4(len(b))]
            else:
                a = np.atleast_1d(np.asarray(v))
                dt, code, size = _nc_type(a.dtype)
                a = a.astype(dt)
                out += [_i4(code), _i4(a.size), a.tobytes(),
                        b"\x00" * _pad4(a.size * size)]
        return b"".join(out)

    def _vsize(self, name):
        dims, dt, _, _ = self._vars[name]
        n = 1
        for d in dims:
            if d != self.rec_dim:
                n *= self.dims[d]
        n *= dt.itemsize
        return n + _pad4(n)

    def _write_header(self):
        dim_ids = {d: i for i, d in enumerate(self.dims)}
        rec_vars = [n for n, v in self._vars.items() if self.rec_dim in v[0]]
        # single record variable: no per-record chunk padding (spec quirk)
        self._single_rec = len(rec_vars) == 1

        head = [b"CDF\x02", _i4(0)]
        head += [_i4(0x0A), _i4(len(self.dims))]
        for d, n in self.dims.items():
            head += [self._name(d), _i4(0 if n is None else n)]
        head.append(self._atts(self.gatts))

        # lay out variables: compute begins after the header; static first,
        # then the record block
        body = []
        for name, (dims, dt, code, atts) in self._vars.items():
            b = [self._name(name), _i4(len(dims))]
            b += [_i4(dim_ids[d]) for d in dims]
            b += [self._atts(atts), _i4(code), _i4(self._vsize(name))]
            body.append(b"".join(b))
        # header size with 8-byte begins (CDF-2)
        hsize = sum(len(h) for h in head) + _i4(0x0B).__len__() + 4
        hsize += sum(len(b) + 8 for b in body)

        offset = hsize
        begins = []
        for name in self._vars:
            if self.rec_dim in self._vars[name][0]:
                begins.append(None)
                continue
            begins.append(offset)
            offset += self._vsize(name)
        self._rec_begin = offset
        self._rec_offsets = {}
        self._recsize = 0
        for name in rec_vars:
            self._rec_offsets[name] = self._recsize
            vs = self._vsize(name)
            if self._single_rec:
                vs -= _pad4(self._vsize_raw(name))
            self._recsize += vs
        for i, name in enumerate(self._vars):
            if begins[i] is None:
                begins[i] = self._rec_begin + self._rec_offsets[name]

        f = open(self.path, "wb")
        for h in head:
            f.write(h)
        f.write(_i4(0x0B))
        f.write(_i4(len(self._vars)))
        for b, beg in zip(body, begins):
            f.write(b)
            f.write(beg.to_bytes(8, "big"))
        assert f.tell() == hsize, (f.tell(), hsize)
        for name, (dims, dt, _, _) in self._vars.items():
            if self.rec_dim in dims:
                continue
            a = self._static_data.get(name)
            if a is None:  # undefined static data: zero fill
                shape = tuple(self.dims[d] for d in dims)
                a = np.zeros(shape, dt)
            f.write(a.tobytes())
            f.write(b"\x00" * _pad4(a.nbytes))
        self._f = f

    def _vsize_raw(self, name):
        dims, dt, _, _ = self._vars[name]
        n = dt.itemsize
        for d in dims:
            if d != self.rec_dim:
                n *= self.dims[d]
        return n

    def append(self, **record_vars):
        """Append one record (all record variables at once, in any order)."""
        if self._f is None:
            self._write_header()
        f = self._f
        f.seek(self._rec_begin + self.numrecs * self._recsize)
        for name in self._vars:
            if name not in self._rec_offsets:
                continue
            dims, dt, _, _ = self._vars[name]
            if name not in record_vars:
                raise KeyError(f"record variable {name} missing from append()")
            shape = tuple(self.dims[d] for d in dims if d != self.rec_dim)
            a = np.ascontiguousarray(np.asarray(record_vars[name]), dt)
            a = a.reshape(shape)
            f.write(a.tobytes())
            if not self._single_rec:
                f.write(b"\x00" * _pad4(a.nbytes))
        self.numrecs += 1
        f.seek(4)
        f.write(_i4(self.numrecs))
        f.flush()

    def close(self):
        if self._f is None:
            self._write_header()
        self._f.close()
        self._f = None


def _i4(n):
    return int(n).to_bytes(4, "big", signed=False)
