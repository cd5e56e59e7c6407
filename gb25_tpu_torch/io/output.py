"""Output writers (port of ``gb25_tpu.io.output``): surface slices written
on a schedule of model time (the reference's JLD2OutputWriter of surface
fields every 3 days).

``NPZOutputWriter`` appends one record file ``<prefix>_iter<It>.npz`` a
firing (the diagnostics, time and iteration; ``read_series`` reassembles
a series); ``NetCDFOutputWriter`` appends one record a firing to a classic
NetCDF file with an unlimited time axis. Records are written in the JAX
package's (x, y) layout, so the same readers and tools read both
packages' output: each plane is cut on the device and crosses to the host
alone, transposed there.
"""

from __future__ import annotations

import glob
import os

import numpy as np


def surface_slice(field):
    """The top level of a (Z, Y, X) field; a plane as it is."""
    return field[-1] if field.ndim == 3 else field


STANDARD_OUTPUTS = {
    "u_surface": lambda s: surface_slice(s.u),
    "v_surface": lambda s: surface_slice(s.v),
    "T_surface": lambda s: surface_slice(s.tracers["T"]),
    "S_surface": lambda s: surface_slice(s.tracers["S"]),
    "eta": lambda s: s.eta,
}


def _host_plane(t):
    """A (Y, X) plane as an (x, y) numpy array, transposed on its device."""
    return t.detach().t().contiguous().cpu().numpy()


def _boundary_crossed(t, interval, last_k):
    """Whether a writer on ``interval`` seconds fires at model time ``t``:
    on the first call (the initial record) and whenever t crosses a
    multiple of the interval, so writes stay on the aligned boundaries.
    Returns (fire, new_last_k)."""
    k = int(np.floor(t / interval + 1e-9))
    if last_k is None or k > last_k:
        return True, k
    return False, last_k


class NPZOutputWriter:
    """Writes the ``outputs`` (name -> state -> plane) at every crossing of a
    multiple of ``interval_seconds`` of model time, plus one initial
    record."""

    def __init__(self, directory, outputs=None, interval_seconds=86400.0, prefix="out"):
        self.directory = directory
        self.outputs = outputs or STANDARD_OUTPUTS
        self.interval = interval_seconds
        self.prefix = prefix
        self._last_k = None
        os.makedirs(directory, exist_ok=True)

    def maybe_write(self, sim):
        t = sim.time
        fire, self._last_k = _boundary_crossed(t, self.interval, self._last_k)
        if not fire:
            return
        arrays = {k: _host_plane(fn(sim.state)) for k, fn in self.outputs.items()}
        arrays["time"] = np.float64(t)
        arrays["iteration"] = np.int64(sim.iteration)
        path = os.path.join(self.directory, f"{self.prefix}_iter{sim.iteration:09d}.npz")
        np.savez(path, **arrays)


def read_series(directory, name, prefix="out"):
    """One diagnostic across all records: (times, stacked array)."""
    files = sorted(glob.glob(os.path.join(directory, f"{prefix}_iter*.npz")))
    times, vals = [], []
    for f in files:
        with np.load(f) as d:
            times.append(float(d["time"]))
            vals.append(d[name])
    return np.asarray(times), np.stack(vals) if vals else np.empty((0,))


class NetCDFOutputWriter:
    """Surface diagnostics in one classic NetCDF file with an unlimited time
    axis, appended one record a firing (``data.netcdf.NetCDF3Writer``);
    the schedule of ``NPZOutputWriter``. ``grid`` gives the coordinates:
    2-D (x, y) lon and lat on the tripolar grid, 1-D on the lat-lon grid.
    2-D (x, y) diagnostics only (the standard surface set)."""

    def __init__(self, path, grid, outputs=None, interval_seconds=86400.0, attrs=None):
        from gb25_tpu_torch.data.netcdf import NetCDF3Writer

        self.outputs = outputs or STANDARD_OUTPUTS
        self.interval = interval_seconds
        self._last_k = None
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

        dims = {"time": None, "x": grid.Nx, "y": grid.Ny}
        w = NetCDF3Writer(path, dims, global_attrs={
            "title": "gb25_tpu_torch surface diagnostics",
            "source": "gb25_tpu_torch", **(attrs or {}),
        })
        w.define("time", ("time",), np.float64,
                 {"units": "seconds since simulation start", "axis": "T"})
        w.define("iteration", ("time",), np.int32, {})
        if grid.north_fold:
            w.define("lon", ("x", "y"), np.float64, {"units": "degrees_east"})
            w.define("lat", ("x", "y"), np.float64, {"units": "degrees_north"})
            w.write("lon", _host_plane(grid.lam2_c))
            w.write("lat", _host_plane(grid.phi2_c))
        else:
            w.define("lon", ("x",), np.float64, {"units": "degrees_east"})
            w.define("lat", ("y",), np.float64, {"units": "degrees_north"})
            w.write("lon", grid.lam_c_i.cpu().numpy())
            w.write("lat", grid.phi_c_i.cpu().numpy())
        for name in self.outputs:
            w.define(name, ("time", "x", "y"), np.float32, {"coordinates": "lon lat"})
        self._w = w

    def maybe_write(self, sim):
        t = sim.time
        fire, self._last_k = _boundary_crossed(t, self.interval, self._last_k)
        if not fire:
            return
        rec = {k: _host_plane(fn(sim.state)).astype(np.float32) for k, fn in self.outputs.items()}
        self._w.append(time=np.float64(t), iteration=np.int32(sim.iteration), **rec)

    def close(self):
        self._w.close()
