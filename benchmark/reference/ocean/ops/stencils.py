"""Shape-preserving staggered-grid stencil primitives (port of
``gb25_tpu.ops.stencils``).

Operators act on halo-extended tensors and preserve shape: a shift is a
``torch.roll``, so values within ``r`` cells of the extended edge are
garbage after a stencil of radius ``r`` and are cropped by the caller.

Axes are named: the port stores fields ``(Z, Y, X)``, so the default
``axis_order`` is z=0, y=1, x=2. Index convention: face ``i`` is the
west/south/bottom face of cell ``i``; ``_f`` results live on faces,
``_c`` results on centers.
"""

from __future__ import annotations

import contextlib

import torch

_AXIS = {"z": 0, "y": 1, "x": 2}


@contextlib.contextmanager
def axis_order(x: int, y: int, z: int):
    """Temporarily map the named axes to other tensor dimensions."""
    global _AXIS
    old = _AXIS
    _AXIS = {"x": x, "y": y, "z": z}
    try:
        yield
    finally:
        _AXIS = old


def sm(a, axis, n=1):
    """Value at index ``i - n`` along the named axis (shift 'minus')."""
    if n == 0:
        return a
    return torch.roll(a, n, dims=_AXIS[axis])


def sp(a, axis, n=1):
    """Value at index ``i + n`` along the named axis (shift 'plus')."""
    if n == 0:
        return a
    return torch.roll(a, -n, dims=_AXIS[axis])


def d_f(a, axis):
    """center -> face difference: out[i] = a[i] - a[i-1]."""
    return a - sm(a, axis)


def d_c(a, axis):
    """face -> center difference: out[i] = a[i+1] - a[i]."""
    return sp(a, axis) - a


def i_f(a, axis):
    """center -> face interpolation: out[i] = (a[i] + a[i-1]) / 2."""
    return 0.5 * (a + sm(a, axis))


def i_c(a, axis):
    """face -> center interpolation: out[i] = (a[i+1] + a[i]) / 2."""
    return 0.5 * (sp(a, axis) + a)


def dx_f(a):
    return d_f(a, "x")


def dx_c(a):
    return d_c(a, "x")


def dy_f(a):
    return d_f(a, "y")


def dy_c(a):
    return d_c(a, "y")


def dz_f(a):
    return d_f(a, "z")


def dz_c(a):
    return d_c(a, "z")


def ix_f(a):
    return i_f(a, "x")


def ix_c(a):
    return i_c(a, "x")


def iy_f(a):
    return i_f(a, "y")


def iy_c(a):
    return i_c(a, "y")


def iz_c(a):
    return i_c(a, "z")
