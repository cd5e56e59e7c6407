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
equation of state of T and S, or the b tracer) and its column total are
torch ops outside the kernel, as in the JAX package; a caller that needs b
elsewhere too (the CATKE closure) computes it once and passes it in.
The flagship's schemes with two to four tracers launch the instances
compiled for them; other schemes and one tracer the general instances,
which read the scheme codes (``HydrostaticConfig.scheme_codes``) at run
time.

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
from gb25_tpu_torch.utils.cuda_build import CudaKernel, check_tensor, launch_info, uses_kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_MAX_TRACERS = 4
_PTRS = ctypes.c_void_p * _MAX_TRACERS  # one pointer per tracer slot, unused slots null
_PP = ctypes.POINTER(ctypes.c_void_p)

_UNFUSED = [_P] * 3 + [_PP] + [_P] * 10 + [_P] * 2 + [_PP] + [_I] * 9 + [_F] + [_I] * 3 + [_P]
KERNEL = CudaKernel(
    "zslab_tendencies.cu",
    {"zslab_tendencies_f32": [_P] * 3 + [_PP] + [_P] * 15 + [_PP] + [_P] * 2 + [_PP]
     + [_P] * 2 + [_PP] + [_P] * 4 + [_I] * 9 + [_F] * 3 + [_I] * 3 + [_P],
     "zslab_tendencies_unfused_f32": _UNFUSED,
     "zslab_tendencies_unfused_bf16": _UNFUSED,
     "zslab_tendencies_info": [_I] * 5 + [ctypes.POINTER(_I)]},
)
FORMS = ("fused", "unfused", "unfused_bf16")  # the instances' forms, in the kernel's numbering


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
    buoyancy: optional (be, b_total) from ``column_buoyancy``.
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
    be, b_total = buoyancy if buoyancy is not None else column_buoyancy(cfg, grid, tr_e)
    if ab is None:
        return zslab_kernel_unfused(cfg, grid, ue, ve, tr_e, be, b_total, wall_v)
    return zslab_kernel(cfg, grid, ue, ve, tr_e, be, b_total, prev, ab, face_bottoms, wall_v)


def _check_storage(storage, ab):
    if storage is not None and (storage != torch.bfloat16 or ab is not None):
        raise ValueError("K1's storage mode is bfloat16 storage of the unfused form only: the "
                         "AB2 update must read the unrounded state")


def zslab_tendencies_plain(cfg, grid, ue, ve, tr_e, prev=None, ab=None, be=None,
                           face_bottoms=None, wall_v=True, storage=None):
    """The plain PyTorch version of K1: the port's ``tendency_math`` on the
    extended tensors, then the AB2 update, the wall row and the integrals
    (any dtype, any device); with ``ab=None`` the tendencies and the wall
    row alone. ``storage=torch.bfloat16``: on the widened
    ``bf16_operands`` (``be`` is then ignored), computed in float32, as the
    JAX kernel computes on its widened windows."""
    from gb25_tpu_torch.models.hydrostatic import mask_v_wall, tendency_math

    _check_storage(storage, ab)
    if storage is not None:
        ub, vb, trb, bb, _ = bf16_operands(cfg, grid, ue, ve, tr_e)
        ue, ve, be = ub.float(), vb.float(), bb.float()
        tr_e = {k: c.float() for k, c in trb.items()}
    f_ff = coriolis_ff(grid, cfg.coriolis).to(ue.dtype)
    Gu_e, Gv_e, Gtr_e = tendency_math(cfg, grid, f_ff, ue, ve, tr_e, be)
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
    buoyancy ``be`` and its column total ``b_total``; returns what
    ``zslab_tendencies`` returns."""
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
    for name, t in (("ue", ue), ("ve", ve), ("b", be), *tr_e.items()):
        check_tensor(t, name, ext, f32, dev)
    check_tensor(b_total, "b_total", ext[1:], f32, dev)
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
            ue.data_ptr(), ve.data_ptr(), be.data_ptr(), ptrs(tr_e.values()), b_total.data_ptr(),
            *[t.data_ptr() for t in prof + zprof], bu, bv,
            Gu_p.data_ptr(), Gv_p.data_ptr(), ptrs(Gtr_p[k] for k in names),
            Gu.data_ptr(), Gv.data_ptr(), ptrs(Gtr.values()),
            u_new.data_ptr(), v_new.data_ptr(), ptrs(tr_new.values()),
            *[t.data_ptr() for t in ints],
            len(names), Nx, Ny, Nz, hx, hy, hz, int(grid.north_fold), int(wall_v),
            float(ab[0]), float(ab[1]), float(cfg.weno_eps), *cfg.scheme_codes, stream,
        )
    return Gu, Gv, Gtr, u_new, v_new, tr_new, tuple(ints)


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
    instances, on ``bf16_operands``), ``b_total`` float32. One to four
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
    for name, t in (("ue", ue), ("ve", ve), ("b", be), *tr_e.items()):
        check_tensor(t, name, ext, dtype, dev)
    check_tensor(b_total, "b_total", ext[1:], f32, dev)
    prof, zprof = _metric_profiles(cfg, grid, dev)

    Gu, Gv = (torch.empty(shape, dtype=f32, device=dev) for _ in range(2))
    Gtr = {k: torch.empty(shape, dtype=f32, device=dev) for k in names}
    fn = "zslab_tendencies_unfused_f32" if dtype == f32 else "zslab_tendencies_unfused_bf16"
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        KERNEL.launch(
            fn, ue.data_ptr(), ve.data_ptr(), be.data_ptr(),
            _PTRS(*[t.data_ptr() for t in tr_e.values()]), b_total.data_ptr(),
            *[t.data_ptr() for t in prof + zprof[:2]],
            Gu.data_ptr(), Gv.data_ptr(), _PTRS(*[t.data_ptr() for t in Gtr.values()]),
            len(names), Nx, Ny, Nz, hx, hy, hz, int(grid.north_fold), int(wall_v),
            float(cfg.weno_eps), *cfg.scheme_codes, stream,
        )
    return Gu, Gv, Gtr


def kernel_info(ntr, immersed, metric2d, form="fused", general=False):
    """One instance's launch shape on the current CUDA device: registers
    per thread, shared memory per block (bytes), the tile (x, y) and the
    blocks one SM holds. ``form``: one of ``FORMS`` (the unfused forms
    have no immersed instance); ``general``: the general instance (other
    schemes, or one tracer)."""
    return launch_info(KERNEL, "zslab_tendencies_info", ntr, int(immersed), int(metric2d),
                       FORMS.index(form), int(general))
