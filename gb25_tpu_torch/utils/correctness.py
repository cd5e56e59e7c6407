"""Differential-correctness harness (port of ``gb25_tpu.utils.correctness``).

Field-by-field comparison of two states, each a port state or a flat dict
of numpy arrays (``convert.state_to_numpy``), with per-field max|psi|,
max|delta| and argmax reporting and ``rtol = sqrt(eps(dtype))``, ``atol = 0``
defaults, and ``sync_states`` to copy one state's values onto another's
tiles, devices and dtypes.
"""

from __future__ import annotations

import numpy as np
import torch

from gb25_tpu_torch.convert import state_tensors, state_to_numpy
from gb25_tpu_torch.models.state import HydrostaticState


def default_rtol(dtype) -> float:
    """sqrt(eps) of a numpy or torch floating dtype; 0 for integers."""
    if isinstance(dtype, torch.dtype):
        return float(torch.finfo(dtype).eps) ** 0.5 if dtype.is_floating_point else 0.0
    dtype = np.dtype(dtype)
    if not np.issubdtype(dtype, np.floating):
        return 0.0  # integers compare exactly
    return float(np.sqrt(np.finfo(dtype).eps))


def compare_states(a, b, rtol=None, atol=0.0, throw_error=True, verbose=True):
    """Compare two states field by field. Returns a list of
    (name, max_ref, max_err, argmax); raises on a field outside
    ``rtol * max|a| + atol`` when ``throw_error``. Two port states are
    compared where their tensors lie, in the port's layout (argmax in
    (Z, Y, X)); otherwise in the JAX package's layout."""
    if isinstance(a, HydrostaticState) and isinstance(b, HydrostaticState):
        la, lb = state_tensors(a), state_tensors(b)
    else:
        la = state_to_numpy(a) if isinstance(a, HydrostaticState) else a
        lb = state_to_numpy(b) if isinstance(b, HydrostaticState) else b
    if list(la) != list(lb):
        raise ValueError(f"state structures differ: {list(la)} vs {list(lb)}")
    report, failures = [], []
    for name, xa in la.items():
        xa = xa if torch.is_tensor(xa) else torch.as_tensor(np.array(xa))
        va = xa.to(torch.float64)
        xb = lb[name]
        vb = (xb if torch.is_tensor(xb) else torch.as_tensor(np.array(xb))).to(
            device=va.device, dtype=torch.float64)
        delta = torch.abs(va - vb)
        max_ref = float(va.abs().max()) if va.numel() else 0.0
        max_err = float(delta.max()) if delta.numel() else 0.0
        am = (tuple(int(i) for i in np.unravel_index(int(delta.argmax()), tuple(delta.shape)))
              if delta.numel() else ())
        report.append((name, max_ref, max_err, am))
        tol = rtol if rtol is not None else default_rtol(xa.dtype)
        if max_err > tol * max(max_ref, 1e-300) + atol:
            failures.append((name, max_ref, max_err, am))
        if verbose:
            print(f"  {name:24s} max|psi| = {max_ref:.6e}  max|delta| = {max_err:.6e} @ {am}")
    if failures and throw_error:
        lines = ", ".join(f"{n} (err {e:.3e})" for n, _, e, _ in failures)
        raise AssertionError(f"state comparison failed: {lines}")
    return report


def sync_states(src, dst, mesh=None):
    """``dst`` with every value taken from ``src``, on ``dst``'s devices, in
    its dtypes and on its tiles: with ``mesh``, ``dst`` is this rank's tile
    of the decomposed model and each field of ``src`` (the global state) is
    cut to the tile (the clock is replicated); the iteration comes from
    ``src``."""
    from gb25_tpu_torch.parallel.sharded import shard_state

    if mesh is not None:
        src = shard_state(src, mesh)

    def put(s, d):
        if s.shape != d.shape:
            raise ValueError(f"a field of shape {tuple(s.shape)} onto one of {tuple(d.shape)}: "
                             "pass the mesh of a decomposed state")
        return s.to(device=d.device, dtype=d.dtype, copy=True)

    return dst.replace(
        u=put(src.u, dst.u), v=put(src.v, dst.v), eta=put(src.eta, dst.eta),
        tracers={k: put(src.tracers[k], t) for k, t in dst.tracers.items()},
        Gu=put(src.Gu, dst.Gu), Gv=put(src.Gv, dst.Gv), Geta=put(src.Geta, dst.Geta),
        Gtracers={k: put(src.Gtracers[k], t) for k, t in dst.Gtracers.items()},
        time=put(src.time, dst.time), time_lo=put(src.time_lo, dst.time_lo),
        iteration=src.iteration)
