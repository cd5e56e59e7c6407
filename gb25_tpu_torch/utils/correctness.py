"""Differential-correctness harness (port of ``gb25_tpu.utils.correctness``).

Field-by-field comparison of two states, each a port state or a flat dict
of numpy arrays (``convert.state_to_numpy``), with per-field max|psi|,
max|delta| and argmax reporting and ``rtol = sqrt(eps(dtype))``, ``atol = 0``
defaults.
"""

from __future__ import annotations

import numpy as np

from gb25_tpu_torch.convert import state_to_numpy
from gb25_tpu_torch.models.state import HydrostaticState


def default_rtol(dtype) -> float:
    dtype = np.dtype(dtype)
    if not np.issubdtype(dtype, np.floating):
        return 0.0  # integers compare exactly
    return float(np.sqrt(np.finfo(dtype).eps))


def compare_states(a, b, rtol=None, atol=0.0, throw_error=True, verbose=True):
    """Compare two states field by field. Returns a list of
    (name, max_ref, max_err, argmax); raises on a field outside
    ``rtol * max|a| + atol`` when ``throw_error``."""
    la = state_to_numpy(a) if isinstance(a, HydrostaticState) else a
    lb = state_to_numpy(b) if isinstance(b, HydrostaticState) else b
    if list(la) != list(lb):
        raise ValueError(f"state structures differ: {list(la)} vs {list(lb)}")
    report, failures = [], []
    for name, xa in la.items():
        va = np.asarray(xa, dtype=np.float64)
        vb = np.asarray(lb[name], dtype=np.float64)
        delta = np.abs(va - vb)
        max_ref = float(np.abs(va).max()) if va.size else 0.0
        max_err = float(delta.max()) if delta.size else 0.0
        am = np.unravel_index(int(delta.argmax()), delta.shape) if delta.size else ()
        report.append((name, max_ref, max_err, am))
        tol = rtol if rtol is not None else default_rtol(np.asarray(xa).dtype)
        if max_err > tol * max(max_ref, 1e-300) + atol:
            failures.append((name, max_ref, max_err, am))
        if verbose:
            print(f"  {name:24s} max|psi| = {max_ref:.6e}  max|delta| = {max_err:.6e} @ {am}")
    if failures and throw_error:
        lines = ", ".join(f"{n} (err {e:.3e})" for n, _, e, _ in failures)
        raise AssertionError(f"state comparison failed: {lines}")
    return report
