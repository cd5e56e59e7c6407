"""The tendency stage in one pass, TEOS-10 inside: kernel K6 (port of
``gb25_tpu.ops.pallas_tendency.pallas_tendencies``).

From the halo-extended ``(Z, Y, X)`` u, v and two to four tracers (T, S
and, with CATKE, e; with k-epsilon, e and eps) it computes continuity w,
the TEOS-10 buoyancy, the hydrostatic pressure, the WENO vector-invariant
momentum tendencies and the WENO-5 tracer tendencies, and returns the
interior ``(Gu, Gv, {tracer: G})``. b, p and w stay inside the kernel. On
the tripolar grid the metrics and f are 2-D planes. ``split=True`` runs the
same stage as two launches, momentum then tracers, each recomputing w.
The inputs come halo-filled and immersed-masked: K6 has no fold, mask or
wall logic, and no AB2 update (the ``kernels="pallas"`` route of
``models.hydrostatic`` applies those).

``pallas_tendencies`` launches the CUDA kernel (``csrc/tendencies.cu``) for
CUDA tensors under ``kernels="pallas"`` or ``"auto"`` and runs
``pallas_tendencies_plain`` for CPU tensors or ``kernels="torch"``; for a
CUDA tensor it launches or raises. Left out of the JAX module, as TPU
machinery: ``_TileGrid`` and ``_choose_tile`` (VMEM tiles: the CUDA kernel
tiles itself), ``kernel_cumsum`` (a triangular-matrix cumsum for Pallas,
which cannot lower a cumsum: the kernel sums its columns in a loop) and
``pallas_supported``'s ``GB25_ENABLE_PALLAS`` gate (an opt-in for a kernel
that was slow on a v5e: the port's ``"pallas"`` is explicit and raises
where the kernel cannot run).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gb25_tpu_torch.ops.eos import _CTU, _SAU, _ZU
from gb25_tpu_torch.ops.operators import diagnose_w
from gb25_tpu_torch.utils.cuda_build import CudaKernel, check_tensor, launch_info, uses_kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_MAX_TRACERS = 4
_PTRS = ctypes.c_void_p * _MAX_TRACERS  # one pointer per tracer slot, unused slots null
_PP = ctypes.POINTER(ctypes.c_void_p)
_MODES = {"all": 0, "momentum": 1, "tracers": 2}

KERNEL = CudaKernel(
    "tendencies.cu",
    {"tendencies_f32": [_P] * 4 + [_PP] + [_P] * 12 + [_PP] + [_I] * 9 + [_F] * 7 + [_P],
     "tendencies_info": [_I] * 3 + [ctypes.POINTER(_I)]},
    extra_flags=("-fmad=false",),
)
# the same library's TEOS-10 entry, for checks only (its own launch count)
EOS_KERNEL = CudaKernel(
    "tendencies.cu",
    {"teos10_buoyancy_f32": [_P] * 4 + [ctypes.c_longlong] * 2 + [_F] * 6 + [_P]},
    extra_flags=("-fmad=false",),
)


def eos_scalars(eos):
    """TEOS-10's scalars as torch applies them to a CUDA float32 tensor
    (ops/eos.py): a division by a Python number is a product with the
    float32 reciprocal of its float32 rounding. Returns (1 / SAU, 1 / CTU,
    1 / ZU, -g, rho0, 1 / rho0) as Python floats."""
    f, one = np.float32, np.float32(1.0)
    return tuple(float(x) for x in (one / f(_SAU), one / f(_CTU), one / f(_ZU), f(-eos.g),
                                    f(eos.rho0), one / f(eos.rho0)))


def pallas_tendencies(cfg, grid, f_ff, ue, ve, tr_e, split=False):
    """Interior (Gu, Gv, {tracer: G}) from the extended (Nz+2hz, Ny+2hy,
    Nx+2hx) ue, ve and tracers ``tr_e`` ({"T", "S"}, plus "e" with CATKE,
    plus "e", "eps" with k-epsilon); ``f_ff``: the Coriolis parameter at
    corners, ``operators.coriolis_ff``."""
    if not uses_kernel(cfg, ue):
        return pallas_tendencies_plain(cfg, grid, f_ff, ue, ve, tr_e, split)
    if split:
        Gu, Gv = tendency_kernel(cfg, grid, f_ff, ue, ve, tr_e, "momentum")
        return Gu, Gv, tendency_kernel(cfg, grid, f_ff, ue, ve, tr_e, "tracers")
    return tendency_kernel(cfg, grid, f_ff, ue, ve, tr_e, "all")


def pallas_tendencies_plain(cfg, grid, f_ff, ue, ve, tr_e, split=False):
    """The plain PyTorch version of K6 (any dtype, any device): the
    port's ``tendency_math`` on the extended tensors, cut to the interior,
    with the hydrostatic pressure of ``sequential_pressure``; with
    ``split``, the tracer half recomputes w, as the JAX kernel's does."""
    from gb25_tpu_torch.models.hydrostatic import (
        buoyancy_field,
        momentum_tendency_math,
        tracer_tendency_math,
    )

    we = diagnose_w(grid, ue, ve)
    pe = sequential_pressure(grid, buoyancy_field(cfg, grid, tr_e))
    Gu_e, Gv_e = momentum_tendency_math(cfg, grid, f_ff, ue, ve, we, pe)
    Gtr_e = tracer_tendency_math(cfg, grid, ue, ve, diagnose_w(grid, ue, ve) if split else we, tr_e)

    def inner(a):
        return grid.interior(a).contiguous()

    return inner(Gu_e), inner(Gv_e), {k: inner(g) for k, g in Gtr_e.items()}


def sequential_pressure(grid, be):
    """``operators.hydrostatic_pressure`` with the column total taken as the
    last running sum: the kernel sums each column up from the floor, as
    ``torch.cumsum`` along z does on the card, where torch's reduction of
    the total (the other operator's) adds in another order. p = csum -
    total cancels two sums of ~300 m^2/s^2, so in float32 that order alone
    moves Gu and Gv by ~1e-9."""
    hz, Nz = grid.hz, grid.Nz
    bdz = be[hz : hz + Nz] * grid.dz_c[hz : hz + Nz]
    csum = torch.cumsum(bdz, dim=0)
    p_int = csum - csum[-1:] - 0.5 * bdz
    return torch.cat([p_int[:1]] * hz + [p_int] + [p_int[-1:]] * hz, dim=0)


def tendency_kernel(cfg, grid, f_ff, ue, ve, tr_e, which="all"):
    """Launch the CUDA kernel alone on f32 CUDA tensors. ``which``: "all"
    returns (Gu, Gv, {tracer: G}), "momentum" (Gu, Gv), "tracers"
    {tracer: G}."""
    dev = ue.device
    f32 = torch.float32
    hx, hy, hz = grid.halo
    Nx, Ny, Nz = grid.Nx, grid.Ny, grid.Nz
    if min(hx, hy, hz) < 3:
        raise ValueError(f"K6 needs halos >= 3 (WENO-5 radius), got {grid.halo}")
    names = list(tr_e)
    if not 2 <= len(names) <= _MAX_TRACERS or not {"T", "S"} <= set(names):
        raise ValueError(f"K6 advects T, S and at most {_MAX_TRACERS - 2} more tracers, got {names}")
    ext = (Nz + 2 * hz, Ny + 2 * hy, Nx + 2 * hx)
    for name, t in (("ue", ue), ("ve", ve), *tr_e.items()):
        check_tensor(t, name, ext, f32, dev)

    # y profiles, or (Y, X) planes flattened on the tripolar grid
    prof = [m.reshape(-1).contiguous() for m in
            (grid.dxc, grid.dxf, grid.dyc, grid.dyf, grid.azc, grid.azf, f_ff)]
    zprof = [m.reshape(-1).contiguous() for m in (grid.dz_c, grid.dz_f, grid.z_c)]
    metric_len = ext[1] * ext[2] if grid.north_fold else ext[1]
    for name, t in zip(("dxc", "dxf", "dyc", "dyf", "azc", "azf", "f_ff"), prof):
        check_tensor(t, name, (metric_len,), f32, dev)
    for name, t in zip(("dz_c", "dz_f", "z_c"), zprof):
        check_tensor(t, name, (ext[0],), f32, dev)

    def new3():
        return torch.empty((Nz, Ny, Nx), dtype=f32, device=dev)

    Gu = Gv = None
    Gtr = {}
    if which != "tracers":
        Gu, Gv = new3(), new3()
    if which != "momentum":
        Gtr = {k: new3() for k in names}

    def ptrs(ts):
        return _PTRS(*[t.data_ptr() for t in ts])

    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        KERNEL.launch(
            "tendencies_f32",
            ue.data_ptr(), ve.data_ptr(), tr_e["T"].data_ptr(), tr_e["S"].data_ptr(),
            ptrs(tr_e.values()), *[t.data_ptr() for t in prof + zprof],
            None if Gu is None else Gu.data_ptr(), None if Gv is None else Gv.data_ptr(),
            ptrs(Gtr.values()) if Gtr else None,
            len(names), Nx, Ny, Nz, hx, hy, hz, int(grid.north_fold), _MODES[which],
            float(cfg.weno_eps), *eos_scalars(cfg.eos), stream,
        )
    if which == "momentum":
        return Gu, Gv
    if which == "tracers":
        return Gtr
    return Gu, Gv, Gtr


def kernel_info(ntr, which, metric2d):
    """One instance's launch shape on the current CUDA device (see
    ``pallas_zslab.kernel_info``)."""
    return launch_info(KERNEL, "tendencies_info", ntr, _MODES[which], int(metric2d))


def teos10_kernel(eos, T, S, z_c):
    """The kernel's own TEOS-10 buoyancy of extended f32 CUDA tensors T, S
    (z_c: the extended (Nz+2hz, 1, 1) profile): a check's entry, not on the
    step's path. Counts its launches on ``EOS_KERNEL``."""
    check_tensor(S, "S", tuple(T.shape), torch.float32, T.device)
    check_tensor(T, "T", tuple(T.shape), torch.float32, T.device)
    z = z_c.reshape(-1).contiguous()
    check_tensor(z, "z_c", (T.shape[0],), torch.float32, T.device)
    b = torch.empty_like(T)
    stream = torch.cuda.current_stream(T.device).cuda_stream
    with torch.cuda.device(T.device):
        EOS_KERNEL.launch("teos10_buoyancy_f32", T.data_ptr(), S.data_ptr(), z.data_ptr(),
                          b.data_ptr(), T.numel(), T[0].numel(), *eos_scalars(eos), stream)
    return b
