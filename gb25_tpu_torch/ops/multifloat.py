"""Paired-bfloat16 limbs (port of ``gb25_tpu.ops.multifloat``, its
``bf16x2`` half): ``compute_dtype="bf16x2"`` carries the tendency physics
(``models.hydrostatic.tendency_math``, unchanged) through values held as
the unevaluated sum ``hi + lo`` of two bfloat16 limbs.

Each operation promotes both operands' limbs to float32 and adds them
(exact: the limbs do not overlap and hold at most 17 mantissa bits
together), computes one float32 result in the JAX package's order of
operations and re-splits it: ``hi = bf16(s)``, ``lo = bf16(s - hi)``.
Comparisons act on the float32 value. A Python number meets a
``TwoFloat`` as the limb pair ``from_array`` makes of it (rounded to
float32, then split), as the JAX package's ``_coerce`` does; it is never
rounded once to bfloat16.

The ``torch.*`` functions the tendency code calls on its tensors
(``where``, ``roll``, ``cat``, ``cumsum``, ``zeros_like``, ``sqrt``), and
``broadcast_to`` and ``sum``, reach the ``mf_*`` helpers below through
``TwoFloat.__torch_function__``, as do a plain tensor's ``+ - * /`` with
limbs on their right (the tensor split first, as JAX's
``__array_priority__`` arranges); it raises ``TypeError`` on any other
function: a missed operation fails, it never drops ``lo`` in silence.

Left out: the float32 limbs (``f32x2``: ``_two_sum``, ``_split``,
``_two_prod``, ``_dd_scan_add``). The port computes ``"f32x2"`` in native
float64, which the H100 has (ROADMAP.md section 1, "Not to port").

Python numbers enter the float32 arithmetic as Python floats (each is
exact in float32) and stay on the host, so a step of this mode can be
captured into a CUDA graph; a division by a number divides by a 0-d
tensor of it, because PyTorch multiplies a CUDA tensor by the reciprocal
of a Python divisor where the JAX package divides.
"""

from __future__ import annotations

import functools
import numbers

import torch

_BF16, _F32 = torch.bfloat16, torch.float32


@functools.lru_cache(maxsize=4096)
def _number_value(c):
    """hi + lo of the limb pair ``from_array`` makes of the number ``c``,
    as a Python float (exact in float32)."""
    xw = torch.tensor(c, dtype=_F32)
    hi = xw.to(_BF16)
    lo = (xw - hi.to(_F32)).to(_BF16)
    return float(hi.to(_F32) + lo.to(_F32))


class TwoFloat:
    """A value held as the unevaluated sum ``hi + lo`` of two bfloat16
    limbs (|lo| <= ulp(hi) / 2)."""

    __slots__ = ("hi", "lo")

    def __init__(self, hi, lo):
        self.hi = hi
        self.lo = lo

    # --- construction / extraction ---
    @staticmethod
    def from_array(x):
        """Split ``x`` into limbs: rounded to float32 first (a float64
        tensor too), then ``hi = bf16(x)``, ``lo = bf16(x - hi)``."""
        if isinstance(x, numbers.Real):
            x = torch.tensor(float(x))
        xw = x.to(_F32)
        hi = xw.to(_BF16)
        return TwoFloat(hi, (xw - hi.to(_F32)).to(_BF16))

    def to_array(self, dtype=_F32):
        return (self.hi.to(_F32) + self.lo.to(_F32)).to(dtype)

    # --- metadata ---
    @property
    def shape(self):
        return self.hi.shape

    @property
    def ndim(self):
        return self.hi.ndim

    @property
    def dtype(self):
        return self.hi.dtype

    @property
    def device(self):
        return self.hi.device

    def _val(self):
        """The float32 value hi + lo."""
        return self.hi.to(_F32) + self.lo.to(_F32)

    @staticmethod
    def _restore(s):
        """Re-split a float32 result into limbs."""
        h = s.to(_BF16)
        return TwoFloat(h, (s - h.to(_F32)).to(_BF16))

    def _coerce(self, other):
        if isinstance(other, TwoFloat):
            return other
        return TwoFloat.from_array(other)

    def _other_val(self, other):
        """An operand's float32 value: a TwoFloat's, a number's limb pair
        summed (a Python float), a tensor's limbs summed."""
        if isinstance(other, numbers.Real):
            return _number_value(float(other))
        return self._coerce(other)._val()

    def _divisor(self, other):
        """``_other_val`` as something true division divides by: a
        number becomes a 0-d tensor on this value's device."""
        v = self._other_val(other)
        if isinstance(v, float):
            return torch.full((), v, dtype=_F32, device=self.hi.device)
        return v

    # --- arithmetic: (ah + al) op (bh + bl) in float32, re-split ---
    def __add__(self, other):
        return TwoFloat._restore(self._val() + self._other_val(other))

    __radd__ = __add__

    def __neg__(self):
        return TwoFloat(-self.hi, -self.lo)

    def __sub__(self, other):
        return TwoFloat._restore(self._val() - self._other_val(other))

    def __rsub__(self, other):
        return TwoFloat._restore(-self._val() + self._other_val(other))

    def __mul__(self, other):
        return TwoFloat._restore(self._val() * self._other_val(other))

    __rmul__ = __mul__

    def __truediv__(self, other):
        return TwoFloat._restore(self._val() / self._divisor(other))

    def __rtruediv__(self, other):
        num = self._other_val(other)
        if isinstance(num, float):
            num = torch.full((), num, dtype=_F32, device=self.hi.device)
        return TwoFloat._restore(num / self._val())

    def __pow__(self, n):
        if n == 2:
            return self * self
        out = self
        for _ in range(int(n) - 1):
            out = out * self
        return out

    # --- comparisons, on the float32 value: boolean tensors ---
    def _cmp_other(self, other):
        return other._val() if isinstance(other, TwoFloat) else other

    def __gt__(self, other):
        return self._val() > self._cmp_other(other)

    def __lt__(self, other):
        return self._val() < self._cmp_other(other)

    def __ge__(self, other):
        return self._val() >= self._cmp_other(other)

    def __le__(self, other):
        return self._val() <= self._cmp_other(other)

    # --- indexing / shaping ---
    def __getitem__(self, idx):
        return TwoFloat(self.hi[idx], self.lo[idx])

    def reshape(self, *shape):
        return TwoFloat(self.hi.reshape(*shape), self.lo.reshape(*shape))

    def to(self, dtype):
        """The value as a tensor of ``dtype`` (the JAX package's
        ``astype``)."""
        return self.to_array(dtype)

    def sum(self, dim=None, keepdim=False):
        return mf_sum(self, dim, keepdim)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        impl = _TORCH_FUNCTIONS.get(func)
        if impl is None:
            raise TypeError(f"TwoFloat (bf16x2 limbs) has no rule for {func}: "
                            "add one to ops/multifloat.py")
        return impl(*args, **(kwargs or {}))


def is_twofloat(x):
    return isinstance(x, TwoFloat)


def _limbwise(f, a, *args, **kw):
    return TwoFloat(f(a.hi, *args, **kw), f(a.lo, *args, **kw))


# --- dispatched array functions (transparent for plain tensors) ---

def mf_roll(a, shifts, dims):
    if is_twofloat(a):
        return _limbwise(torch.roll, a, shifts, dims)
    return torch.roll(a, shifts, dims)


def mf_where(cond, a, b):
    if is_twofloat(a) or is_twofloat(b):
        a = a if is_twofloat(a) else b._coerce(a)
        b = b if is_twofloat(b) else a._coerce(b)
        return TwoFloat(torch.where(cond, a.hi, b.hi), torch.where(cond, a.lo, b.lo))
    return torch.where(cond, a, b)


def mf_zeros_like(a):
    if is_twofloat(a):
        return _limbwise(torch.zeros_like, a)
    return torch.zeros_like(a)


def mf_concatenate(arrs, dim=0):
    if any(is_twofloat(a) for a in arrs):
        arrs = [a if is_twofloat(a) else TwoFloat.from_array(a) for a in arrs]
        return TwoFloat(torch.cat([a.hi for a in arrs], dim=dim),
                        torch.cat([a.lo for a in arrs], dim=dim))
    return torch.cat(arrs, dim=dim)


def mf_cumsum(a, dim):
    """Cumulative sum: the float32 cumsums of both limbs, re-split."""
    if is_twofloat(a):
        hi = torch.cumsum(a.hi.to(_F32), dim=dim)
        lo = torch.cumsum(a.lo.to(_F32), dim=dim)
        return TwoFloat._restore(hi + lo)
    return torch.cumsum(a, dim=dim)


def mf_sum(a, dim=None, keepdim=False):
    """A reduction as the last running sum of ``mf_cumsum`` (a full
    reduction: successive single-axis ones, the last axis first)."""
    if is_twofloat(a):
        if dim is None:
            r = a
            for d in reversed(range(a.ndim)):
                r = mf_sum(r, d, keepdim)
            return r
        c = mf_cumsum(a, dim)
        idx = [slice(None)] * a.ndim
        idx[dim] = slice(-1, None) if keepdim else -1
        return c[tuple(idx)]
    return torch.sum(a, dim=dim, keepdim=keepdim)


def mf_sqrt(a):
    if is_twofloat(a):
        return TwoFloat._restore(torch.sqrt(a._val()))
    return torch.sqrt(a)


def mf_broadcast_to(a, shape):
    if is_twofloat(a):
        return _limbwise(torch.broadcast_to, a, shape)
    return torch.broadcast_to(a, shape)


def wrap_compute(x, compute_dtype="bf16x2"):
    """``x`` as limbs of the multi-limb mode (``"bf16x2"``, the only one the
    port computes with limbs)."""
    if compute_dtype != "bf16x2":
        raise ValueError(f"the port's limbs are bfloat16 ('bf16x2'), got {compute_dtype!r}")
    return TwoFloat.from_array(x)


def unwrap_compute(x, dtype):
    return x.to_array(dtype) if is_twofloat(x) else x.to(dtype)


def _coerced(op):
    """A tensor operator with a TwoFloat on its right (the JAX package's
    ``__array_priority__``): the tensor split into limbs first."""
    def apply(a, b):
        return op(TwoFloat.from_array(a), b)

    return apply


def _axis_args(f):
    """``f(a, dim)`` also called as torch calls it: ``dim`` by keyword."""
    def apply(a, dim=None, **kw):
        return f(a, dim, **kw)

    return apply


_TORCH_FUNCTIONS = {
    torch.where: mf_where,
    torch.roll: lambda a, shifts, dims=None: mf_roll(a, shifts, dims),
    torch.cat: lambda tensors, dim=0: mf_concatenate(tensors, dim),
    torch.cumsum: _axis_args(mf_cumsum),
    torch.zeros_like: mf_zeros_like,
    torch.sqrt: mf_sqrt,
    torch.broadcast_to: mf_broadcast_to,
    torch.sum: _axis_args(mf_sum),
    torch.Tensor.__add__: _coerced(lambda a, b: a + b),
    torch.Tensor.__sub__: _coerced(lambda a, b: a - b),
    torch.Tensor.__mul__: _coerced(lambda a, b: a * b),
    torch.Tensor.__truediv__: _coerced(lambda a, b: a / b),
}
