"""Conversion between the port and the JAX package's layout.

A state crosses as a flat dict of numpy arrays named like the JAX state's
leaves ("u", "v", "eta", "tracers/T", ..., "Gtracers/S", "time",
"time_lo", "iteration"), with 3-D fields in JAX's (X, Y, Z) and 2-D fields
in (X, Y); any tracer set crosses (T, S and, with CATKE, e). The port
stores (Z, Y, X) and (Y, X), so every array has its axes reversed on the
way in and out. The same holds for a bathymetry (X, Y) -> (Y, X), for
an atmosphere record (X, Y, T) -> (T, Y, X), one contiguous plane per time
(a gather-form record on the atmosphere's grid likewise, its gather
indices and weights (X, Y) planes -> flat indices and weights (Y, X)), for a
shallow-water state (leaves "u", "v", "h", "Gu", "Gv", "Gh", "time",
"iteration", planes (X, Y) -> (Y, X)), for a sea-ice state (leaves "v",
"a", planes) and for a restoring dict (name -> (target (X, Y, Z), rate
(X, Y, 1) or a field)).
"""

from __future__ import annotations

import numpy as np
import torch

from gb25_tpu_torch.grids.immersed import with_bathymetry
from gb25_tpu_torch.models.atmosphere import PrescribedAtmosphere
from gb25_tpu_torch.models.seaice import SeaIceState
from gb25_tpu_torch.models.state import HydrostaticState, ShallowWaterState

SW_PLANES = ("u", "v", "h", "Gu", "Gv", "Gh")


def _to_port(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(np.transpose(a))  # reverses the axes; a writable copy
    return torch.as_tensor(a, device=device)


def _to_jax(t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return np.ascontiguousarray(np.transpose(a)) if a.ndim >= 2 else a


def state_from_numpy(arrays: dict, device) -> HydrostaticState:
    """Build the port's state on ``device`` from JAX-layout numpy arrays."""
    tracers = sorted(k.split("/", 1)[1] for k in arrays if k.startswith("tracers/"))
    return HydrostaticState(
        u=_to_port(arrays["u"], device),
        v=_to_port(arrays["v"], device),
        eta=_to_port(arrays["eta"], device),
        tracers={k: _to_port(arrays[f"tracers/{k}"], device) for k in tracers},
        Gu=_to_port(arrays["Gu"], device),
        Gv=_to_port(arrays["Gv"], device),
        Geta=_to_port(arrays["Geta"], device),
        Gtracers={k: _to_port(arrays[f"Gtracers/{k}"], device) for k in tracers},
        time=_to_port(arrays["time"], device),
        time_lo=_to_port(arrays["time_lo"], device),
        iteration=int(arrays["iteration"]),
    )


def state_tensors(state: HydrostaticState) -> dict:
    """The port's state as tensors under the JAX leaf names, in the JAX leaf
    order, each in the port's layout where it lies (the iteration a 0-d
    int32 tensor)."""
    out = {"u": state.u, "v": state.v, "eta": state.eta}
    out.update({f"tracers/{k}": state.tracers[k] for k in sorted(state.tracers)})
    out.update({"Gu": state.Gu, "Gv": state.Gv, "Geta": state.Geta})
    out.update({f"Gtracers/{k}": state.Gtracers[k] for k in sorted(state.Gtracers)})
    out.update({"time": state.time, "time_lo": state.time_lo,
                "iteration": torch.tensor(state.iteration, dtype=torch.int32)})
    return out


def state_to_numpy(state: HydrostaticState) -> dict:
    """The port's state as JAX-layout numpy arrays, in the JAX leaf order."""
    return {k: _to_jax(t) for k, t in state_tensors(state).items()}


def sw_state_from_numpy(arrays: dict, device) -> ShallowWaterState:
    """The port's shallow-water state on ``device`` from JAX-layout numpy
    arrays."""
    return ShallowWaterState(**{k: _to_port(arrays[k], device) for k in SW_PLANES},
                             time=_to_port(arrays["time"], device),
                             iteration=int(arrays["iteration"]))


def sw_state_to_numpy(state: ShallowWaterState) -> dict:
    """The port's shallow-water state as JAX-layout numpy arrays, in the JAX
    leaf order."""
    out = {k: _to_jax(getattr(state, k)) for k in SW_PLANES}
    out.update({"time": _to_jax(state.time), "iteration": np.asarray(state.iteration, np.int32)})
    return out


def immersed_grid_from_numpy(grid, bottom_height: np.ndarray):
    """``grid`` carrying a JAX-layout (Nx, Ny) bathymetry and its geometry
    (the JAX package has clamped the values, so the clamp leaves them)."""
    return with_bathymetry(grid, _to_port(bottom_height, grid.device).to(grid.dtype))


def atmosphere_from_numpy(fields: dict, times: np.ndarray, period: float,
                          device) -> PrescribedAtmosphere:
    """A pre-regridded atmosphere from the JAX package's (Nx, Ny, Nt)
    record arrays and its (Nt,) times."""
    return PrescribedAtmosphere(
        fields={k: _to_port(f, device) for k, f in fields.items()},
        times=torch.as_tensor(np.array(times), device=device),
        period=float(period),
    )


def gather_atmosphere_from_numpy(fields: dict, times: np.ndarray, period: float,
                                 ix0, ix1, wx, iy0, iy1, wy, device) -> PrescribedAtmosphere:
    """A gather-form atmosphere from the JAX package's (Na, Ma, Nt) record
    arrays, its (Nt,) times and its (Nx, Ny) gather indices and weights."""
    Na = next(iter(fields.values())).shape[0]
    ix0, ix1, iy0, iy1 = (np.asarray(i).astype(np.int64) for i in (ix0, ix1, iy0, iy1))

    def index(iy, ix):
        return _to_port(iy * Na + ix, device)

    return PrescribedAtmosphere(
        fields={k: _to_port(f, device) for k, f in fields.items()},
        times=torch.as_tensor(np.array(times), device=device),
        period=float(period),
        gather=(index(iy0, ix0), index(iy0, ix1), index(iy1, ix0), index(iy1, ix1),
                _to_port(wx, device), _to_port(wy, device)),
    )


def ice_state_from_numpy(arrays: dict, device) -> SeaIceState:
    """The port's sea-ice state from the JAX package's (Nx, Ny) "v" and
    "a"."""
    return SeaIceState(v=_to_port(arrays["v"], device), a=_to_port(arrays["a"], device))


def ice_state_to_numpy(ice: SeaIceState) -> dict:
    """The port's sea-ice state as (Nx, Ny) numpy arrays "v", "a"."""
    return {"v": _to_jax(ice.v), "a": _to_jax(ice.a)}


def restoring_from_numpy(restoring: dict, device) -> dict:
    """The port's restoring dict from the JAX package's: name -> (target,
    rate) numpy arrays, axes reversed."""
    return {name: (_to_port(np.asarray(target), device), _to_port(np.asarray(rate), device))
            for name, (target, rate) in restoring.items()}
