"""Vertical coordinates (numpy, shared by every grid of the port).

Same construction as ``gb25_tpu.grids.vertical``: z faces spanning
[-depth, 0] with geometric stretching toward the surface,

    z_f[k] = -depth * (exp(gamma * (1 - k/Nz)) - 1) / (exp(gamma) - 1),

with ``gamma`` bisected so the top spacing equals ``h``. The arithmetic is
kept operation for operation so the faces equal the JAX package's bit for
bit in float64 (tests/test_torch_grid.py).
"""

from __future__ import annotations

import numpy as np


def exponential_z_faces(Nz: int, depth: float = 4000.0, h: float = 30.0) -> np.ndarray:
    """``Nz+1`` z-face positions in meters, ``z_f[0] = -depth`` (bottom) up to
    ``z_f[Nz] = 0`` (surface), refined toward the surface."""
    if Nz < 1:
        raise ValueError("Nz must be >= 1")
    uniform = depth / Nz
    k = np.arange(Nz + 1, dtype=np.float64)
    if h >= uniform or Nz == 1:
        return -depth * (1.0 - k / Nz)

    def top_spacing(gamma: float) -> float:
        return depth * np.expm1(gamma / Nz) / np.expm1(gamma)

    # bisection: top_spacing decreases with gamma
    lo, hi = 1e-8, 1.0
    while top_spacing(hi) > h:
        hi *= 2.0
        if hi > 1e4:  # pragma: no cover - pathological h
            break
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if top_spacing(mid) > h:
            lo = mid
        else:
            hi = mid
    gamma = 0.5 * (lo + hi)
    zf = -depth * (np.expm1(gamma * (1.0 - k / Nz))) / np.expm1(gamma)
    zf[0] = -depth
    zf[-1] = 0.0
    return zf


def uniform_z_faces(Nz: int, depth: float) -> np.ndarray:
    """Uniformly spaced z faces on [-depth, 0]."""
    return -depth * (1.0 - np.arange(Nz + 1, dtype=np.float64) / Nz)
