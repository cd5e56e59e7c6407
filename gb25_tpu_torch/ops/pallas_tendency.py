"""The tendency stage in one pass, the buoyancy inside: kernel K6 (port of
``gb25_tpu.ops.pallas_tendency.pallas_tendencies``).

From the halo-extended ``(Z, Y, X)`` u, v and one to four tracers (T, S
or b and, with CATKE, e; with k-epsilon, e and eps) it computes continuity
w, the buoyancy (TEOS-10 or the linear equation of state of T and S, or
the b tracer itself), the hydrostatic pressure, the vector-invariant
momentum tendencies and the flux-form tracer tendencies in the configured
schemes, and returns the interior ``(Gu, Gv, {tracer: G})``. b, p and w
stay inside the kernel. The flagship's schemes under TEOS-10 with two to
four tracers launch the instances compiled for them, anything else the
general instances (the scheme codes and the buoyancy's mode read at run
time); every instance is bit for bit with ``pallas_tendencies_plain``. On
the tripolar grid the metrics and f are 2-D planes. ``split=True`` runs the
same stage as two launches, momentum then tracers, each recomputing w.
On bfloat16 operands (the fields, f and the grid cast to bfloat16, as the
JAX package hands them to its kernel under ``compute_dtype="bfloat16"``)
the bfloat16 instances (general, one launch) widen them and the grid to
float32, compute in float32 and round each output to bfloat16 once; the
JAX kernel rounds every operation in bfloat16 (a deviation, ROADMAP.md
section 3). On float64 operands (a float64 state, or the fields, f and the
grid cast to float64 under ``compute_dtype="float64"``, as the JAX package
hands its kernel float64 operands on that route) the float64 instance
(general, one launch) computes in float64 throughout, bit for bit with
``pallas_tendencies_plain`` on the same operands.
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

from gb25_tpu_torch.ops.eos import _CTU, _SAU, _ZU, LinearEquationOfState, TEOS10EquationOfState
from gb25_tpu_torch.ops.operators import diagnose_w
from gb25_tpu_torch.utils.cuda_build import CudaKernel, check_tensor, launch_info, uses_kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
_MAX_TRACERS = 4
_PTRS = ctypes.c_void_p * _MAX_TRACERS  # one pointer per tracer slot, unused slots null
_PP = ctypes.POINTER(ctypes.c_void_p)
_MODES = {"all": 0, "momentum": 1, "tracers": 2}


def _stage(real):
    return [_P] * 4 + [_PP] + [_P] * 12 + [_PP] + [_I] * 9 + [real] * 12 + [_I] * 4 + [_P]


KERNEL = CudaKernel(
    "tendencies.cu",
    {"tendencies_f32": _stage(_F),
     "tendencies_bf16": _stage(_F),
     "tendencies_f64": _stage(_D),
     "tendencies_info": [_I] * 4 + [ctypes.POINTER(_I)],
     "tendencies_bf16_info": [_I] * 2 + [ctypes.POINTER(_I)],
     "tendencies_f64_info": [_I] * 2 + [ctypes.POINTER(_I)]},
    extra_flags=("-fmad=false",),
)
# the operand dtypes K6 has instances for, with their entry points: float32,
# bfloat16 (the "pallas" route under compute_dtype="bfloat16") and float64
# (a float64 state, or compute_dtype="float64", on that route)
_ENTRIES = {torch.float32: "tendencies_f32", torch.bfloat16: "tendencies_bf16",
            torch.float64: "tendencies_f64"}
DTYPES = tuple(_ENTRIES)
# the same library's TEOS-10 entry, for checks only (its own launch count)
EOS_KERNEL = CudaKernel(
    "tendencies.cu",
    {"teos10_buoyancy_f32": [_P] * 4 + [ctypes.c_longlong] * 2 + [_F] * 6 + [_P]},
    extra_flags=("-fmad=false",),
)


# where K6 takes b from (csrc/tendencies.cu)
EOS_TEOS10, EOS_LINEAR, EOS_TRACER = 0, 1, 2


def eos_scalars(eos, dtype=torch.float32):
    """TEOS-10's scalars as torch applies them to a CUDA tensor of
    ``dtype`` (ops/eos.py): a division by a Python number is a product
    with the reciprocal of its rounding, taken in the arithmetic's type
    (float32 for float32 and bfloat16 operands, float64 for float64).
    Returns (1 / SAU, 1 / CTU, 1 / ZU, -g, rho0, 1 / rho0) as Python floats
    (those of the default TEOS-10 for another equation of state: the kernel
    reads them only under TEOS-10)."""
    if not isinstance(eos, TEOS10EquationOfState):
        eos = TEOS10EquationOfState()
    f = np.float64 if dtype == torch.float64 else np.float32
    one = f(1.0)
    return tuple(float(x) for x in (one / f(_SAU), one / f(_CTU), one / f(_ZU), f(-eos.g),
                                    f(eos.rho0), one / f(eos.rho0)))


def linear_scalars(eos, dtype=torch.float32):
    """The linear equation of state's g, alpha, T0, beta and S0 as torch
    rounds a Python number for a tensor of ``dtype``: to float32, or as
    they are for float64 (zeros for another equation of state)."""
    if not isinstance(eos, LinearEquationOfState):
        return (0.0,) * 5
    f = np.float64 if dtype == torch.float64 else np.float32
    return tuple(float(f(x)) for x in (eos.g, eos.alpha, eos.T0, eos.beta, eos.S0))


def eos_mode(cfg, tr_e):
    """Where K6 takes b from: the b tracer, or the configured equation of
    state of T and S."""
    if "b" in tr_e:
        return EOS_TRACER
    return EOS_LINEAR if isinstance(cfg.eos, LinearEquationOfState) else EOS_TEOS10


def pallas_tendencies(cfg, grid, f_ff, ue, ve, tr_e, split=False):
    """Interior (Gu, Gv, {tracer: G}) from the extended (Nz+2hz, Ny+2hy,
    Nx+2hx) ue, ve and tracers ``tr_e`` ({"T", "S"} or {"b"}, plus "e"
    with CATKE, plus "e", "eps" with k-epsilon); ``f_ff``: the Coriolis
    parameter at corners, ``operators.coriolis_ff``."""
    if not uses_kernel(cfg, ue, DTYPES):
        return pallas_tendencies_plain(cfg, grid, f_ff, ue, ve, tr_e, split)
    if split:
        Gu, Gv = tendency_kernel(cfg, grid, f_ff, ue, ve, tr_e, "momentum")
        return Gu, Gv, tendency_kernel(cfg, grid, f_ff, ue, ve, tr_e, "tracers")
    return tendency_kernel(cfg, grid, f_ff, ue, ve, tr_e, "all")


def pallas_tendencies_plain(cfg, grid, f_ff, ue, ve, tr_e, split=False):
    """The plain PyTorch version of K6 (any dtype, any device): the
    port's ``tendency_math`` on the extended tensors, cut to the interior,
    with the hydrostatic pressure of ``sequential_pressure``; with
    ``split``, the tracer half recomputes w, as the JAX kernel's does. On
    bfloat16 operands the twin of the bfloat16 instances: the float32
    version on the widened operands and grid (``grid.cast``, kept in the
    grid's cache), each output rounded to bfloat16."""
    from gb25_tpu_torch.models.hydrostatic import (
        buoyancy_field,
        momentum_tendency_math,
        tracer_tendency_math,
    )

    if ue.dtype == torch.bfloat16:
        bf = torch.bfloat16
        Gu, Gv, Gtr = pallas_tendencies_plain(
            cfg, grid.cast(torch.float32), f_ff.float(), ue.float(), ve.float(),
            {k: c.float() for k, c in tr_e.items()}, split)
        return Gu.to(bf), Gv.to(bf), {k: g.to(bf) for k, g in Gtr.items()}

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
    """Launch the CUDA kernel alone on float32 CUDA tensors, on bfloat16
    ones (the bfloat16 instances, ``which="all"`` only; the grid and f are
    widened to float32 and the outputs are bfloat16) or on float64 ones
    (the float64 instance, ``which="all"`` only; the grid and f float64).
    ``which``: "all" returns (Gu, Gv, {tracer: G}), "momentum" (Gu, Gv),
    "tracers" {tracer: G}."""
    dev = ue.device
    dtype = ue.dtype
    if dtype not in DTYPES:
        raise ValueError(f"K6 reads float32, bfloat16 or float64 fields, got {dtype}")
    if dtype != torch.float32 and which != "all":
        raise ValueError(f"K6's {dtype} instances compute the whole stage in one launch")
    real = torch.float64 if dtype == torch.float64 else torch.float32  # the metrics' dtype
    if grid.dtype == torch.bfloat16:  # the bfloat16 grid's metrics, widened
        grid, f_ff = grid.cast(torch.float32), f_ff.float()
    hx, hy, hz = grid.halo
    Nx, Ny, Nz = grid.Nx, grid.Ny, grid.Nz
    if min(hx, hy, hz) < 3:
        raise ValueError(f"K6 needs halos >= 3 (WENO-5 radius), got {grid.halo}")
    names = list(tr_e)
    mode = eos_mode(cfg, tr_e)
    buoyant = ("b",) if mode == EOS_TRACER else ("T", "S")
    if not 1 <= len(names) <= _MAX_TRACERS or not set(buoyant) <= set(names):
        raise ValueError(f"K6 advects T and S, or b, and at most {_MAX_TRACERS} tracers in all, "
                         f"got {names}")
    ext = (Nz + 2 * hz, Ny + 2 * hy, Nx + 2 * hx)
    for name, t in (("ue", ue), ("ve", ve), *tr_e.items()):
        check_tensor(t, name, ext, dtype, dev)

    # y profiles, or (Y, X) planes flattened on the tripolar grid
    prof = [m.reshape(-1).contiguous() for m in
            (grid.dxc, grid.dxf, grid.dyc, grid.dyf, grid.azc, grid.azf, f_ff)]
    zprof = [m.reshape(-1).contiguous() for m in (grid.dz_c, grid.dz_f, grid.z_c)]
    metric_len = ext[1] * ext[2] if grid.north_fold else ext[1]
    for name, t in zip(("dxc", "dxf", "dyc", "dyf", "azc", "azf", "f_ff"), prof):
        check_tensor(t, name, (metric_len,), real, dev)
    for name, t in zip(("dz_c", "dz_f", "z_c"), zprof):
        check_tensor(t, name, (ext[0],), real, dev)

    def new3():
        return torch.empty((Nz, Ny, Nx), dtype=dtype, device=dev)

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
            _ENTRIES[dtype],
            ue.data_ptr(), ve.data_ptr(), tr_e[buoyant[0]].data_ptr(),
            tr_e[buoyant[-1]].data_ptr(), ptrs(tr_e.values()),
            *[t.data_ptr() for t in prof + zprof],
            None if Gu is None else Gu.data_ptr(), None if Gv is None else Gv.data_ptr(),
            ptrs(Gtr.values()) if Gtr else None,
            len(names), Nx, Ny, Nz, hx, hy, hz, int(grid.north_fold), _MODES[which],
            float(cfg.weno_eps), *eos_scalars(cfg.eos, dtype), *linear_scalars(cfg.eos, dtype),
            *cfg.scheme_codes, mode, stream,
        )
    if which == "momentum":
        return Gu, Gv
    if which == "tracers":
        return Gtr
    return Gu, Gv, Gtr


def kernel_info(ntr, which, metric2d, general=False, dtype=torch.float32):
    """One instance's launch shape on the current CUDA device (see
    ``pallas_zslab.kernel_info``); for ``which="momentum"`` ``ntr`` counts
    the launch's buoyancy fields (2: T and S; 1: b). ``dtype`` bfloat16 or
    float64: that dtype's instance (general, ``which="all"``)."""
    if dtype != torch.float32:
        if which != "all" or not general:
            raise ValueError(f"K6's {dtype} instances are general and one launch")
        return launch_info(KERNEL, _ENTRIES[dtype] + "_info", ntr, int(metric2d))
    return launch_info(KERNEL, "tendencies_info", ntr, _MODES[which], int(metric2d),
                       int(general))


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
