"""The tendency stage with the quasi-AB2 update fused in: kernel K1
(port of ``gb25_tpu.ops.pallas_zslab.zslab_tendencies`` on the flagship
path: ``ab2``, ``wall_v=True``, ``integrals=True``).

From the halo-extended ``(Z, Y, X)`` u, v, T, S it computes the momentum
and tracer tendencies, the updated fields x* = x + dt c1 G + dt c2 G_prev
with the south-wall row of Gv and v* zeroed, and the depth integrals of
u, v, u*, v*. TEOS-10 buoyancy and its column total are torch ops outside
the kernel, as in the JAX package.

``zslab_tendencies`` launches the CUDA kernel (``csrc/zslab_tendencies.cu``)
for CUDA tensors under ``kernels="auto"`` and runs ``zslab_tendencies_plain``
for CPU tensors or ``kernels="torch"``. There is no fallback from a CUDA
tensor to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from gb25_tpu_torch.ops.operators import coriolis_ff
from gb25_tpu_torch.utils.cuda_build import CudaKernel, check_tensor, uses_kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

KERNEL = CudaKernel(
    "zslab_tendencies.cu",
    {"zslab_tendencies_f32": [_P] * 31 + [_I] * 6 + [_F] * 3 + [_P]},
)


def zslab_tendencies(cfg, grid, ue, ve, tr_e, prev, ab):
    """Tendencies, AB2-updated fields and depth integrals of one step.

    ue, ve, tr_e: extended (Nz+2hz, Ny+2hy, Nx+2hx) u, v, {"T", "S"}.
    prev: (Gu, Gv, {"T", "S"}) previous tendencies, interior (Nz, Ny, Nx).
    ab: (dt c1, dt c2) as Python floats.

    Returns ``(Gu, Gv, Gtr, u_new, v_new, tr_new, (U0, V0, Us, Vs))``; the
    integrals are (Ny, Nx)."""
    if uses_kernel(cfg, ue):
        return _zslab_cuda(cfg, grid, ue, ve, tr_e, prev, ab)
    return zslab_tendencies_plain(cfg, grid, ue, ve, tr_e, prev, ab)


def zslab_tendencies_plain(cfg, grid, ue, ve, tr_e, prev, ab):
    """The plain PyTorch version of K1: the port's ``tendency_math`` on the
    extended tensors, then the AB2 update, the wall row and the integrals
    (any dtype, any device)."""
    from gb25_tpu_torch.models.hydrostatic import mask_v_wall, tendency_math

    f_ff = coriolis_ff(grid, cfg.coriolis).to(ue.dtype)
    Gu_e, Gv_e, Gtr_e = tendency_math(cfg, grid, f_ff, ue, ve, tr_e)
    Gu = grid.interior(Gu_e).contiguous()
    Gv = mask_v_wall(grid.interior(Gv_e).contiguous())
    Gtr = {k: grid.interior(g).contiguous() for k, g in Gtr_e.items()}

    a, b = ab
    Gu_p, Gv_p, Gtr_p = prev
    u_new = grid.interior(ue) + a * Gu + b * Gu_p
    v_new = mask_v_wall(grid.interior(ve) + a * Gv + b * Gv_p)
    tr_new = {k: grid.interior(tr_e[k]) + a * Gtr[k] + b * Gtr_p[k] for k in Gtr}

    dz = grid.dz_c[grid.hz : grid.hz + grid.Nz]

    def zint(f):
        return (f * dz).sum(dim=0)

    ints = (zint(grid.interior(ue)), zint(grid.interior(ve)), zint(u_new), zint(v_new))
    return Gu, Gv, Gtr, u_new, v_new, tr_new, ints


def _zslab_cuda(cfg, grid, ue, ve, tr_e, prev, ab):
    # buoyancy and its column total of b dz, (Ny+2hy, Nx+2hx), stay torch
    # ops: the kernel streams b in and carries the running sum itself
    hz, Nz = grid.hz, grid.Nz
    be = cfg.eos.buoyancy(tr_e["T"], tr_e["S"], grid.z_c).contiguous()
    b_total = (be[hz : hz + Nz] * grid.dz_c[hz : hz + Nz]).sum(dim=0).contiguous()
    return zslab_kernel(cfg, grid, ue, ve, tr_e, be, b_total, prev, ab)


def zslab_kernel(cfg, grid, ue, ve, tr_e, be, b_total, prev, ab):
    """Launch the CUDA kernel alone on f32 CUDA tensors, given the extended
    buoyancy ``be`` and its column total ``b_total``; returns what
    ``zslab_tendencies`` returns."""
    dev = ue.device
    f32 = torch.float32
    hx, hy, hz = grid.halo
    Nx, Ny, Nz = grid.Nx, grid.Ny, grid.Nz
    if min(hx, hy, hz) < 3:
        raise ValueError(f"K1 needs halos >= 3 (WENO-5 radius), got {grid.halo}")
    ext = (Nz + 2 * hz, Ny + 2 * hy, Nx + 2 * hx)
    shape = (Nz, Ny, Nx)
    Gu_p, Gv_p, Gtr_p = prev
    for name, t in (("ue", ue), ("ve", ve), ("T", tr_e["T"]), ("S", tr_e["S"]), ("b", be)):
        check_tensor(t, name, ext, f32, dev)
    check_tensor(b_total, "b_total", ext[1:], f32, dev)
    for name, t in (("Gu_prev", Gu_p), ("Gv_prev", Gv_p), ("GT_prev", Gtr_p["T"]),
                    ("GS_prev", Gtr_p["S"])):
        check_tensor(t, name, shape, f32, dev)

    prof = [m.reshape(-1).contiguous() for m in
            (grid.dxc, grid.dxf, grid.dyc, grid.dyf, grid.azc, grid.azf,
             coriolis_ff(grid, cfg.coriolis))]
    zprof = [grid.dz_c.reshape(-1).contiguous(), grid.dz_f.reshape(-1).contiguous()]
    for name, t in zip(("dxc", "dxf", "dyc", "dyf", "azc", "azf", "f_ff"), prof):
        check_tensor(t, name, (ext[1],), f32, dev)
    for name, t in zip(("dz_c", "dz_f"), zprof):
        check_tensor(t, name, (ext[0],), f32, dev)

    outs3 = [torch.empty(shape, dtype=f32, device=dev) for _ in range(8)]
    outs2 = [torch.empty((Ny, Nx), dtype=f32, device=dev) for _ in range(4)]
    ins = [ue, ve, tr_e["T"], tr_e["S"], be, b_total, *prof, *zprof,
           Gu_p, Gv_p, Gtr_p["T"], Gtr_p["S"]]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        KERNEL.launch(
            "zslab_tendencies_f32",
            *[t.data_ptr() for t in ins + outs3 + outs2],
            Nx, Ny, Nz, hx, hy, hz, float(ab[0]), float(ab[1]), float(cfg.weno_eps), stream,
        )
    Gu, Gv, GT, GS, u_new, v_new, T_new, S_new = outs3
    return (Gu, Gv, {"T": GT, "S": GS}, u_new, v_new, {"T": T_new, "S": S_new},
            tuple(outs2))
