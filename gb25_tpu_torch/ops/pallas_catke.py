"""The column closures' diffusivities: kernel K4 (port of
``gb25_tpu.ops.pallas_catke.column_closure_kernel`` through its two
functions, ``catke_diffusivities_kernel`` and ``keps_diffusivities_kernel``).

CATKE: from the extended (masked) u, v, buoyancy b and TKE e, the interior
``(Nz, Ny, Nx)`` crops of ``models.catke.catke_math``: kappa_u, kappa_c,
kappa_e at the bottom face of each cell, the TKE source G_e and the
implicit dissipation rate lam_e at centers.

k-epsilon: from the extended u, v, b, e and eps, the interior crops of
``models.keps.keps_math``: kappa_u, kappa_c, kappa_e, kappa_eps at the
bottom faces, the sources G_e and G_eps at centers.

``catke_diffusivities_kernel`` launches ``csrc/catke_diffusivities.cu``
and ``keps_diffusivities_kernel`` ``csrc/keps_diffusivities.cu`` for CUDA
tensors under ``kernels="auto"``; each runs its plain version for CPU
tensors or ``kernels="torch"``. There is no fallback from a CUDA tensor to
the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from gb25_tpu_torch.models.catke import bottom_plane, catke_diffusivities
from gb25_tpu_torch.models.keps import keps_diffusivities
from gb25_tpu_torch.utils.cuda_build import CudaKernel, check_tensor, uses_kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

KERNEL = CudaKernel(
    "catke_diffusivities.cu",
    {"catke_diffusivities_f32": [_P] * 12 + [_I] * 6 + [_F] * 20 + [_P]},
    extra_flags=("-fmad=false",),
)
KEPS_KERNEL = CudaKernel(
    "keps_diffusivities.cu",
    {"keps_diffusivities_f32": [_P] * 12 + [_I] * 6 + [_F] * 11 + [_P]},
    extra_flags=("-fmad=false",),
)


def _constants(cl):
    """The closure's constants in the launcher's order; each stability
    function's (hi - lo) is taken in double here, as ``catke_math`` takes
    it in Python before it meets a tensor."""
    return [cl.C_lo_u, cl.C_hi_u - cl.C_lo_u, cl.C_lo_c, cl.C_hi_c - cl.C_lo_c,
            cl.C_lo_e, cl.C_hi_e - cl.C_lo_e, cl.Ri_0, cl.Ri_delta,
            cl.C_conv_c, cl.C_conv_u, cl.C_conv_e, cl.C_surf, cl.C_bot,
            cl.C_D_lo, cl.C_D_hi - cl.C_D_lo,
            cl.ell_min, cl.e_min, cl.N2_min, cl.S2_min, cl.kappa_max]


def catke_diffusivities_kernel(cfg, grid, ue, ve, be, ee):
    """Interior (kappa_u, kappa_c, kappa_e, G_e, lam_e) of ``cfg.closure``
    from extended ``(Nz+2hz, Ny+2hy, Nx+2hx)`` u, v, b, e."""
    if uses_kernel(cfg, ue):
        return _catke_cuda(cfg.closure, grid, ue, ve, be, ee)
    return catke_diffusivities_plain(cfg.closure, grid, ue, ve, be, ee)


def catke_diffusivities_plain(closure, grid, ue, ve, be, ee):
    """The plain PyTorch version of K4: ``catke_math`` on the extended
    tensors, cropped to the interior (any dtype, any device)."""
    return tuple(grid.interior(a).contiguous()
                 for a in catke_diffusivities(closure, grid, ue, ve, be, ee))


def _check_extended(grid, fields):
    """The extended shape, after checking each of ``fields`` (name ->
    tensor) against it."""
    hx, hy, hz = grid.halo
    if min(hx, hy, hz) < 1:
        raise ValueError(f"K4 needs halos >= 1 (stencil radius), got {grid.halo}")
    ext = (grid.Nz + 2 * hz, grid.Ny + 2 * hy, grid.Nx + 2 * hx)
    dev = next(iter(fields.values())).device
    for name, t in fields.items():
        check_tensor(t, name, ext, torch.float32, dev)
    return ext


def _catke_cuda(closure, grid, ue, ve, be, ee):
    dev = ue.device
    f32 = torch.float32
    hx, hy, hz = grid.halo
    Nx, Ny, Nz = grid.Nx, grid.Ny, grid.Nz
    ext = _check_extended(grid, {"ue": ue, "ve": ve, "be": be, "ee": ee})
    bot = bottom_plane(grid).expand(1, ext[1], ext[2]).reshape(ext[1:]).contiguous()
    dzf = grid.dz_f.reshape(-1).contiguous()
    zf = grid.z_f.reshape(-1).contiguous()
    check_tensor(bot, "bottom", ext[1:], f32, dev)
    check_tensor(dzf, "dz_f", (ext[0],), f32, dev)
    check_tensor(zf, "z_f", (ext[0],), f32, dev)

    outs = [torch.empty((Nz, Ny, Nx), dtype=f32, device=dev) for _ in range(5)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        KERNEL.launch(
            "catke_diffusivities_f32",
            *[t.data_ptr() for t in (ue, ve, be, ee, bot, dzf, zf, *outs)],
            Nx, Ny, Nz, hx, hy, hz,
            *[float(c) for c in _constants(closure)], stream,
        )
    return tuple(outs)


def _keps_constants(cl):
    """The k-epsilon constants in the launcher's order; the Prandtl and
    Schmidt numbers as the reciprocals that ``keps_math`` multiplies by."""
    return [cl.C_mu, cl.e_min, cl.eps_min, cl.kappa_max, 1.0 / cl.sigma_c, 1.0 / cl.sigma_k,
            1.0 / cl.sigma_eps, cl.C_eps1, cl.C_eps2, cl.C_eps3_unstable, cl.C_eps3_stable]


def keps_diffusivities_kernel(cfg, grid, ue, ve, be, ee, epse):
    """Interior (kappa_u, kappa_c, kappa_e, kappa_eps, G_e, G_eps) of
    ``cfg.closure`` (k-epsilon) from extended ``(Nz+2hz, Ny+2hy, Nx+2hx)``
    u, v, b, e, eps."""
    if uses_kernel(cfg, ue):
        return _keps_cuda(cfg.closure, grid, ue, ve, be, ee, epse)
    return keps_diffusivities_plain(cfg.closure, grid, ue, ve, be, ee, epse)


def keps_diffusivities_plain(closure, grid, ue, ve, be, ee, epse):
    """The plain PyTorch version of K4's k-epsilon function: ``keps_math``
    on the extended tensors, cropped to the interior (any dtype, any
    device)."""
    return tuple(grid.interior(a).contiguous()
                 for a in keps_diffusivities(closure, grid, ue, ve, be, ee, epse))


def _keps_cuda(closure, grid, ue, ve, be, ee, epse):
    dev = ue.device
    f32 = torch.float32
    Nx, Ny, Nz = grid.Nx, grid.Ny, grid.Nz
    ext = _check_extended(grid, {"ue": ue, "ve": ve, "be": be, "ee": ee, "epse": epse})
    dzf = grid.dz_f.reshape(-1).contiguous()
    check_tensor(dzf, "dz_f", (ext[0],), f32, dev)

    outs = [torch.empty((Nz, Ny, Nx), dtype=f32, device=dev) for _ in range(6)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        KEPS_KERNEL.launch(
            "keps_diffusivities_f32",
            *[t.data_ptr() for t in (ue, ve, be, ee, epse, dzf, *outs)],
            Nx, Ny, Nz, *grid.halo,
            *[float(c) for c in _keps_constants(closure)], stream,
        )
    return tuple(outs)
