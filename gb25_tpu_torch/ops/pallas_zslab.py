"""The tendency stage with the quasi-AB2 update fused in: kernel K1
(port of ``gb25_tpu.ops.pallas_zslab.zslab_tendencies`` with ``ab2``,
``wall_v`` and ``integrals=True``), or unfused (no ``ab2``, no integrals),
with float32 or bfloat16 storage of the streamed fields.

From the halo-extended ``(Z, Y, X)`` u, v and one to four tracers (T, S or
b and, with CATKE, e; with k-epsilon, e and eps) it computes the momentum
and tracer tendencies in the configured schemes, the
updated fields x* = x + dt c1 G + dt c2 G_prev with the south-wall row of
Gv and v* zeroed (``wall_v``: serially, and on the south-most tiles of the
decomposed path; elsewhere local row 0 is an interior row), and the depth
integrals of u, v, u*, v*. On immersed
grids the u*, v* integrals count fluid faces only (``face_bottoms``). On
the tripolar grid the metrics and f are 2-D planes. The buoyancy (the
equation of state of T and S, or the b tracer) and its column total come
from one of two places. A caller that needs b elsewhere too (a closure:
CATKE or k-epsilon, whose N^2 must read the same b to the ulp) computes
them once (``column_buoyancy``, torch ops, as in the JAX package) and
passes them in. Without them the float32 instances of one and two tracers
(T and S, or b) make b themselves, as kernel K6 does: TEOS-10 or the linear
equation of state of the staged T and S, bit for bit with torch's float32
b, and each column's total of b dz summed from the floor in the kernel
(where torch's ``sum`` adds in another order); no b field is written or
read. Which calls make b is ``makes_b``: the instance compiled for the
flagship's schemes makes it under TEOS-10 alone, so the linear equation of
state with those schemes keeps reading b, on the compiled instance. The
launches that make b count under the flag ``"own_b"`` on ``KERNEL``
(``b_own_share``).
The flagship's schemes with two to four tracers launch the instances
compiled for them; other schemes and one tracer the general instances,
which read the scheme codes (``HydrostaticConfig.scheme_codes``) and the
source of b at run time.

Unfused (``ab=None``), the stage writes the tendencies and zeroes the
wall row of Gv, nothing else: the step's route under a ``compute_dtype``
or the explicit free surface, which applies the AB2 update itself. With
``storage=torch.bfloat16`` (``compute_dtype="bf16s"``) u, v and the tracers
are rounded to bfloat16, b is the equation of state in float32 of the
rounded T and S, rounded to bfloat16 (or the rounded b tracer), and its
column total is summed in float32 (``bf16_operands``); the arithmetic
stays float32, as the JAX kernel's bf16-storage mode widens its windows.
The unfused instances, float32 and bf16-storage, take one to four tracers
on lat-lon metric columns or on the tripolar grid's planes.

``zslab_tendencies`` launches the CUDA kernel (``csrc/zslab_tendencies.cu``)
for CUDA tensors under ``kernels="auto"`` and runs ``zslab_tendencies_plain``
for CPU tensors or ``kernels="torch"``. There is no fallback from a CUDA
tensor to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from gb25_tpu_torch.ops.operators import coriolis_ff
from gb25_tpu_torch.ops.pallas_tendency import (
    EOS_TEOS10,
    EOS_TRACER,
    eos_mode,
    eos_scalars,
    linear_scalars,
    sequential_pressure,
)
from gb25_tpu_torch.utils.cuda_build import CudaKernel, check_tensor, launch_info, uses_kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_MAX_TRACERS = 4
_PTRS = ctypes.c_void_p * _MAX_TRACERS  # one pointer per tracer slot, unused slots null
_PP = ctypes.POINTER(ctypes.c_void_p)


class OwnB(ctypes.Structure):
    """Where K1 makes b itself (``csrc/zslab_tendencies.cu``'s ``OwnB``):
    the source (K6's ``EOS_*`` codes), the indices of T and S among the
    tracers (b's twice in b mode) and the equations' scalars."""

    _fields_ = ([("mode", _I), ("iT", _I), ("iS", _I)]
                + [(n, _F) for n in ("inv_sau", "inv_ctu", "inv_zu", "neg_g", "rho0", "inv_rho0",
                                     "lin_g", "lin_alpha", "lin_T0", "lin_beta", "lin_S0")])


_OWN = ctypes.POINTER(OwnB)
_UNFUSED = ([_P] * 3 + [_PP] + [_P] + [_OWN] + [_P] * 12 + [_PP] + [_I] * 9 + [_F] + [_I] * 3
            + [_P])
KERNEL = CudaKernel(
    "zslab_tendencies.cu",
    {"zslab_tendencies_f32": [_P] * 3 + [_PP] + [_P] + [_OWN] + [_P] * 14 + [_PP] + [_P] * 2
     + [_PP] + [_P] * 2 + [_PP] + [_P] * 4 + [_I] * 9 + [_F] * 3 + [_I] * 3 + [_P],
     "zslab_tendencies_unfused_f32": _UNFUSED,
     "zslab_tendencies_unfused_bf16": _UNFUSED,
     "zslab_tendencies_info": [_I] * 6 + [ctypes.POINTER(_I)]},
)
FORMS = ("fused", "unfused", "unfused_bf16")  # the instances' forms, in the kernel's numbering
MADE_TRACERS = 2  # the most tracers of an instance that makes b


def makes_b(cfg, tr_e, storage=None):
    """Whether K1 makes b itself when its caller hands it none: the fields
    are float32 (the bf16-storage instance reads the b of the rounded T
    and S), there are at most ``MADE_TRACERS`` tracers, and the instance
    that makes it is the one that reads it: the compiled flagship instance
    makes TEOS-10's b alone, so the linear equation of state under the
    flagship's schemes reads b (``column_buoyancy``)."""
    if storage is not None or len(tr_e) > MADE_TRACERS:
        return False
    compiled = not any(cfg.scheme_codes) and len(tr_e) > 1
    return not compiled or eos_mode(cfg, tr_e) == EOS_TEOS10


def b_launches():
    """K1's launches so far: (those whose b the kernel made, all)."""
    return KERNEL.flagged["own_b"], KERNEL.launches


def b_own_share(since=(0, 0)):
    """The share of K1's launches since the reading ``since`` (of
    ``b_launches``) whose b the kernel made; None where it launched none.
    Each wrapper call is one launch, and a captured graph's replays repeat
    its capture's, so the share of the calls a capture recorded holds for
    its replays too."""
    made, total = (now - then for now, then in zip(b_launches(), since))
    return None if total == 0 else made / total


def own_b(cfg, tr_e):
    """K1's ``OwnB`` for the tracers ``tr_e``: the b tracer, or the
    configured equation of state of T and S with its scalars as K6 takes
    them."""
    mode = eos_mode(cfg, tr_e)
    names = list(tr_e)
    iT, iS = (names.index("b"),) * 2 if mode == EOS_TRACER else (names.index("T"),
                                                                  names.index("S"))
    return OwnB(mode, iT, iS, *eos_scalars(cfg.eos), *linear_scalars(cfg.eos))


def column_buoyancy(cfg, grid, tr_e):
    """Extended buoyancy ``be`` (``hydrostatic.buoyancy_field``: the b
    tracer itself, or the equation of state) and its column total of b dz
    ``(Ny+2hy, Nx+2hx)``, the two buoyancy operands of K1."""
    from gb25_tpu_torch.models.hydrostatic import buoyancy_field

    hz, Nz = grid.hz, grid.Nz
    be = buoyancy_field(cfg, grid, tr_e).contiguous()
    b_total = (be[hz : hz + Nz] * grid.dz_c[hz : hz + Nz]).sum(dim=0).contiguous()
    return be, b_total


def bf16_operands(cfg, grid, ue, ve, tr_e):
    """The bf16-storage operands of K1 (the JAX package's raw path,
    ``gb25_tpu/ops/pallas_zslab.py:187-213``): u, v and the tracers rounded
    to bfloat16; b, the rounded b tracer or the equation of state in
    float32 of the rounded T and S, rounded to bfloat16; its column total
    of float32(b) dz in float32. Returns (ub, vb, {tracer: bfloat16}, bb,
    b_total)."""
    hz, Nz = grid.hz, grid.Nz
    bf = torch.bfloat16
    ub, vb = ue.to(bf).contiguous(), ve.to(bf).contiguous()
    trb = {k: c.to(bf).contiguous() for k, c in tr_e.items()}
    if "b" in trb:
        bb = trb["b"]
    else:
        bb = cfg.eos.buoyancy(trb["T"].float(), trb["S"].float(), grid.z_c).to(bf).contiguous()
    b_total = (bb[hz : hz + Nz].float() * grid.dz_c[hz : hz + Nz]).sum(dim=0).contiguous()
    return ub, vb, trb, bb, b_total


def zslab_tendencies(cfg, grid, ue, ve, tr_e, prev=None, ab=None, buoyancy=None,
                     face_bottoms=None, wall_v=True, storage=None):
    """Tendencies, AB2-updated fields and depth integrals of one step; or,
    with ``ab=None``, the tendencies alone.

    ue, ve, tr_e: extended (Nz+2hz, Ny+2hy, Nx+2hx) u, v and tracers
    ({"T", "S"} or {"b"}, plus "e" with CATKE, plus "e", "eps" with
    k-epsilon).
    prev: (Gu, Gv, {tracer: G}) previous tendencies, interior (Nz, Ny, Nx).
    ab: (dt c1, dt c2) as Python floats.
    buoyancy: optional (be, b_total) from ``column_buoyancy``; without it
    the kernel makes b where ``makes_b`` says so, else the wrapper calls
    ``column_buoyancy``.
    face_bottoms: optional interior (bu, bv) face bottom planes of an
    immersed grid; the u*, v* integrals then count fluid faces only.
    wall_v: local row 0 is the south wall (Gv, v* and its integral 0 there).
    storage: None, or torch.bfloat16 with ``ab=None`` (``bf16_operands``;
    ``buoyancy`` is then ignored: b comes from the rounded T and S).

    Returns ``(Gu, Gv, Gtr, u_new, v_new, tr_new, (U0, V0, Us, Vs))``; the
    integrals are (Ny, Nx). Unfused, ``(Gu, Gv, Gtr)``."""
    _check_storage(storage, ab)
    if not uses_kernel(cfg, ue):
        be = buoyancy[0] if buoyancy is not None and storage is None else None
        return zslab_tendencies_plain(cfg, grid, ue, ve, tr_e, prev, ab, be, face_bottoms, wall_v,
                                      storage)
    if storage is not None:
        ub, vb, trb, bb, b_total = bf16_operands(cfg, grid, ue, ve, tr_e)
        return zslab_kernel_unfused(cfg, grid, ub, vb, trb, bb, b_total, wall_v)
    if buoyancy is None and not makes_b(cfg, tr_e):
        buoyancy = column_buoyancy(cfg, grid, tr_e)
    be, b_total = (None, None) if buoyancy is None else buoyancy
    if ab is None:
        return zslab_kernel_unfused(cfg, grid, ue, ve, tr_e, be, b_total, wall_v)
    return zslab_kernel(cfg, grid, ue, ve, tr_e, be, b_total, prev, ab, face_bottoms, wall_v)


def _check_storage(storage, ab):
    if storage is not None and (storage != torch.bfloat16 or ab is not None):
        raise ValueError("K1's storage mode is bfloat16 storage of the unfused form only: the "
                         "AB2 update must read the unrounded state")


def zslab_tendencies_plain(cfg, grid, ue, ve, tr_e, prev=None, ab=None, be=None,
                           face_bottoms=None, wall_v=True, storage=None, sequential=False):
    """The plain PyTorch version of K1: the port's ``tendency_math`` on the
    extended tensors, then the AB2 update, the wall row and the integrals
    (any dtype, any device); with ``ab=None`` the tendencies and the wall
    row alone. ``storage=torch.bfloat16``: on the widened
    ``bf16_operands`` (``be`` is then ignored), computed in float32, as the
    JAX kernel computes on its widened windows. ``sequential``: the column
    total of b dz summed up from the floor (``sequential_pressure``), as
    the kernel sums the totals it makes, where torch's reduction (the JAX
    package's, the default) adds in another order: the twin of the
    instances that make b. On the tripolar grid's floored spacings beside
    the fold that order alone moves Gu, Gv by more than K1's tolerance."""
    from gb25_tpu_torch.models.hydrostatic import hydrostatic_pressure, mask_v_wall, tendency_math

    _check_storage(storage, ab)
    if storage is not None:
        ub, vb, trb, bb, _ = bf16_operands(cfg, grid, ue, ve, tr_e)
        ue, ve, be = ub.float(), vb.float(), bb.float()
        tr_e = {k: c.float() for k, c in trb.items()}
    f_ff = coriolis_ff(grid, cfg.coriolis).to(ue.dtype)
    Gu_e, Gv_e, Gtr_e = tendency_math(cfg, grid, f_ff, ue, ve, tr_e, be,
                                      sequential_pressure if sequential else hydrostatic_pressure)
    Gu = grid.interior(Gu_e).contiguous()
    Gv = mask_v_wall(grid.interior(Gv_e).contiguous(), wall_v)
    Gtr = {k: grid.interior(g).contiguous() for k, g in Gtr_e.items()}
    if ab is None:
        return Gu, Gv, Gtr

    a, b = ab
    Gu_p, Gv_p, Gtr_p = prev
    u_new = grid.interior(ue) + a * Gu + b * Gu_p
    v_new = mask_v_wall(grid.interior(ve) + a * Gv + b * Gv_p, wall_v)
    tr_new = {k: grid.interior(tr_e[k]) + a * Gtr[k] + b * Gtr_p[k] for k in Gtr}

    dz = grid.dz_c[grid.hz : grid.hz + grid.Nz]

    def zint(f):
        return (f * dz).sum(dim=0)

    u_int, v_int = u_new, v_new
    if face_bottoms is not None:
        zc = grid.z_c[grid.hz : grid.hz + grid.Nz]
        bu, bv = face_bottoms
        u_int = u_new * (zc > bu).to(u_new.dtype)
        v_int = v_new * (zc > bv).to(v_new.dtype)
    ints = (zint(grid.interior(ue)), zint(grid.interior(ve)), zint(u_int), zint(v_int))
    return Gu, Gv, Gtr, u_new, v_new, tr_new, ints


def zslab_kernel(cfg, grid, ue, ve, tr_e, be, b_total, prev, ab, face_bottoms=None,
                 wall_v=True):
    """Launch the CUDA kernel alone on f32 CUDA tensors, given the extended
    buoyancy ``be`` and its column total ``b_total``, or with both None
    making them itself; returns what ``zslab_tendencies`` returns."""
    dev = ue.device
    f32 = torch.float32
    hx, hy, hz = grid.halo
    Nx, Ny, Nz = grid.Nx, grid.Ny, grid.Nz
    if min(hx, hy, hz) < 3:
        raise ValueError(f"K1 needs halos >= 3 (WENO-5 radius), got {grid.halo}")
    names = list(tr_e)
    if not 1 <= len(names) <= _MAX_TRACERS:
        raise ValueError(f"K1 advects 1 to {_MAX_TRACERS} tracers, got {names}")
    if grid.north_fold and face_bottoms is None:
        raise ValueError("K1 on the tripolar grid needs its face bottoms (it is immersed)")
    ext = (Nz + 2 * hz, Ny + 2 * hy, Nx + 2 * hx)
    shape = (Nz, Ny, Nx)
    Gu_p, Gv_p, Gtr_p = prev
    for name, t in (("ue", ue), ("ve", ve), *tr_e.items()):
        check_tensor(t, name, ext, f32, dev)
    b_ptr, total_ptr, own = _b_operands(cfg, tr_e, be, b_total, ext, f32, dev)
    for name, t in (("Gu_prev", Gu_p), ("Gv_prev", Gv_p),
                    *((f"G{k}_prev", Gtr_p[k]) for k in names)):
        check_tensor(t, name, shape, f32, dev)

    # y profiles, or (Y, X) planes flattened on the tripolar grid
    prof, zprof = _metric_profiles(cfg, grid, dev)
    if face_bottoms is not None:
        for name, t in zip(("bu", "bv"), face_bottoms):
            check_tensor(t, name, shape[1:], f32, dev)
        bu, bv = (t.data_ptr() for t in face_bottoms)
    else:
        bu = bv = None

    def new3():
        return torch.empty(shape, dtype=f32, device=dev)

    Gu, Gv, u_new, v_new = new3(), new3(), new3(), new3()
    Gtr = {k: new3() for k in names}
    tr_new = {k: new3() for k in names}
    ints = [torch.empty((Ny, Nx), dtype=f32, device=dev) for _ in range(4)]

    def ptrs(ts):
        return _PTRS(*[t.data_ptr() for t in ts])

    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        KERNEL.launch(
            "zslab_tendencies_f32",
            ue.data_ptr(), ve.data_ptr(), b_ptr, ptrs(tr_e.values()), total_ptr, own,
            *[t.data_ptr() for t in prof + zprof], bu, bv,
            Gu_p.data_ptr(), Gv_p.data_ptr(), ptrs(Gtr_p[k] for k in names),
            Gu.data_ptr(), Gv.data_ptr(), ptrs(Gtr.values()),
            u_new.data_ptr(), v_new.data_ptr(), ptrs(tr_new.values()),
            *[t.data_ptr() for t in ints],
            len(names), Nx, Ny, Nz, hx, hy, hz, int(grid.north_fold), int(wall_v),
            float(ab[0]), float(ab[1]), float(cfg.weno_eps), *cfg.scheme_codes, stream,
            flag=None if own is None else "own_b",
        )
    return Gu, Gv, Gtr, u_new, v_new, tr_new, tuple(ints)


def _b_operands(cfg, tr_e, be, b_total, ext, dtype, dev):
    """The kernel's b, column total and ``OwnB`` arguments: the pointers of
    ``be`` (``dtype``) and ``b_total`` (float32), checked, and None; or,
    with both None, two null pointers and the ``OwnB`` the kernel makes b
    by."""
    if (be is None) != (b_total is None):
        raise ValueError("K1 takes b and its column total together, or neither")
    if be is None:
        if len(tr_e) > MADE_TRACERS:
            raise ValueError(f"K1 makes b with at most {MADE_TRACERS} tracers, got {list(tr_e)}")
        return None, None, ctypes.byref(own_b(cfg, tr_e))
    check_tensor(be, "b", ext, dtype, dev)
    check_tensor(b_total, "b_total", ext[1:], torch.float32, dev)
    return be.data_ptr(), b_total.data_ptr(), None


def _metric_profiles(cfg, grid, dev):
    """K1's metric operands: the y profiles (or, on the tripolar grid, the
    flattened planes) dxc, dxf, dyc, dyf, azc, azf and f, and the z
    profiles dz_c, dz_f, z_c, each checked."""
    f32 = torch.float32
    hx, hy, hz = grid.halo
    ext = (grid.Nz + 2 * hz, grid.Ny + 2 * hy, grid.Nx + 2 * hx)
    prof = [m.reshape(-1).contiguous() for m in
            (grid.dxc, grid.dxf, grid.dyc, grid.dyf, grid.azc, grid.azf,
             coriolis_ff(grid, cfg.coriolis))]
    zprof = [m.reshape(-1).contiguous() for m in (grid.dz_c, grid.dz_f, grid.z_c)]
    metric_len = ext[1] * ext[2] if grid.north_fold else ext[1]
    for name, t in zip(("dxc", "dxf", "dyc", "dyf", "azc", "azf", "f_ff"), prof):
        check_tensor(t, name, (metric_len,), f32, dev)
    for name, t in zip(("dz_c", "dz_f", "z_c"), zprof):
        check_tensor(t, name, (ext[0],), f32, dev)
    return prof, zprof


def zslab_kernel_unfused(cfg, grid, ue, ve, tr_e, be, b_total, wall_v=True):
    """Launch an unfused instance alone on CUDA tensors: u, v, b and the
    tracers float32 (the float32 instances) or bfloat16 (the bf16-storage
    instances, on ``bf16_operands``), ``b_total`` float32; the float32
    instances make b and its total where both are None. One to four
    tracers, the metrics as columns or (tripolar) planes; returns (Gu, Gv,
    Gtr) in float32."""
    dev = ue.device
    f32 = torch.float32
    hx, hy, hz = grid.halo
    Nx, Ny, Nz = grid.Nx, grid.Ny, grid.Nz
    names = list(tr_e)
    if not 1 <= len(names) <= _MAX_TRACERS:
        raise ValueError(f"K1 advects 1 to {_MAX_TRACERS} tracers, got {names}")
    if min(hx, hy, hz) < 3:
        raise ValueError(f"K1 needs halos >= 3 (WENO-5 radius), got {grid.halo}")
    dtype = ue.dtype
    if dtype not in (f32, torch.bfloat16):
        raise ValueError(f"K1's unfused instances read float32 or bfloat16, got {dtype}")
    ext = (Nz + 2 * hz, Ny + 2 * hy, Nx + 2 * hx)
    shape = (Nz, Ny, Nx)
    for name, t in (("ue", ue), ("ve", ve), *tr_e.items()):
        check_tensor(t, name, ext, dtype, dev)
    if be is None and dtype != f32:
        raise ValueError("K1's bf16-storage instances read b (bf16_operands)")
    b_ptr, total_ptr, own = _b_operands(cfg, tr_e, be, b_total, ext, dtype, dev)
    prof, zprof = _metric_profiles(cfg, grid, dev)

    Gu, Gv = (torch.empty(shape, dtype=f32, device=dev) for _ in range(2))
    Gtr = {k: torch.empty(shape, dtype=f32, device=dev) for k in names}
    fn = "zslab_tendencies_unfused_f32" if dtype == f32 else "zslab_tendencies_unfused_bf16"
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        KERNEL.launch(
            fn, ue.data_ptr(), ve.data_ptr(), b_ptr,
            _PTRS(*[t.data_ptr() for t in tr_e.values()]), total_ptr, own,
            *[t.data_ptr() for t in prof + zprof],
            Gu.data_ptr(), Gv.data_ptr(), _PTRS(*[t.data_ptr() for t in Gtr.values()]),
            len(names), Nx, Ny, Nz, hx, hy, hz, int(grid.north_fold), int(wall_v),
            float(cfg.weno_eps), *cfg.scheme_codes, stream, flag=None if own is None else "own_b",
        )
    return Gu, Gv, Gtr


def kernel_info(ntr, immersed, metric2d, form="fused", general=False, own=False):
    """One instance's launch shape on the current CUDA device: registers
    per thread, shared memory per block (bytes), the tile (x, y) and the
    blocks one SM holds. ``form``: one of ``FORMS`` (the unfused forms
    have no immersed instance); ``general``: the general instance (other
    schemes, one tracer, or a made b of another source than TEOS-10);
    ``own``: the float32 instance that makes b (one or two tracers)."""
    return launch_info(KERNEL, "zslab_tendencies_info", ntr, int(immersed), int(metric2d),
                       FORMS.index(form), int(general), int(own))
