"""The split-explicit barotropic substep loop: kernel K2 (port of
``gb25_tpu.ops.pallas_barotropic.pallas_barotropic_loop`` on the flat
lat-lon grid).

The loop advances (eta, Ud = U dyc, Vd = V dxf) through ``substeps``
forward-backward substeps: x periodic, eta mirrored at the y walls
(detay = 0 on row 0), no flux through the north wall face. The
pressure-gradient and forcing planes carry dtau folded in; the filtered
accumulators are un-weighted afterwards. Plane building and un-weighting
are torch ops, as in the JAX package.

``barotropic_loop`` launches ``csrc/barotropic_loop.cu`` once per substep
for CUDA tensors under ``kernels="auto"``, and runs
``barotropic_loop_plain`` for CPU tensors or ``kernels="torch"``.
"""

from __future__ import annotations

import ctypes

import torch

from gb25_tpu_torch.utils.cuda_build import CudaKernel, check_tensor, uses_kernel

_P = ctypes.c_void_p

KERNEL = CudaKernel(
    "barotropic_loop.cu",
    {"barotropic_substep_f32": [_P] * 14 + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [_P]},
)


def barotropic_loop(cfg, grid, eta0, U0, V0, GU, GV, Hu, Hv, dt):
    """All substeps of one model step on interior (Ny, Nx) planes.

    Returns the filtered (eta_b, U_b, V_b)."""
    from gb25_tpu_torch.models.free_surface import averaging_weights

    fs = cfg.free_surface
    M = fs.substeps
    weights = averaging_weights(M, fs.averaging)
    dtype = eta0.dtype
    hy, Ny = grid.hy, grid.Ny

    def prof(m):  # (1, Ny+2hy, 1) metric -> interior (Ny, 1) column
        return m[0, hy : hy + Ny, :].to(dtype)

    dyc, dxf = prof(grid.dyc), prof(grid.dxf)
    # dtau in the working precision, as the JAX package traces it
    dtau = torch.tensor(2.0 * dt / M, dtype=dtype).item()
    r_azc = (1.0 / prof(grid.azc)).reshape(-1).contiguous()
    Ud0 = (U0 * dyc).contiguous()
    Vd0 = (V0 * dxf).contiguous()
    gHuW = (Hu * (dyc / prof(grid.dxc)) * (dtau * fs.gravitational_acceleration)).contiguous()
    gHvW = (Hv * (dxf / prof(grid.dyf)) * (dtau * fs.gravitational_acceleration)).contiguous()
    GUd = (GU * dyc * dtau).contiguous()
    GVd = (GV * dxf * dtau).contiguous()
    planes = (eta0.contiguous(), Ud0, Vd0, gHuW, gHvW, GUd, GVd, r_azc)
    if uses_kernel(cfg, eta0):
        etab, Ub, Vb = _barotropic_loop_cuda(*planes, weights, dtau)
    else:
        etab, Ub, Vb = barotropic_loop_plain(*planes, weights, dtau)
    return etab, Ub / dyc, Vb / dxf


def barotropic_loop_plain(eta, Ud, Vd, gHuW, gHvW, GUd, GVd, r_azc, weights, dtau):
    """The plain PyTorch version of K2: the flux-form substeps of the JAX
    kernel with ``torch.roll`` / ``torch.cat`` (any dtype, any device)."""
    raz = r_azc.reshape(-1, 1)
    etab = torch.zeros_like(eta)
    Ub = torch.zeros_like(Ud)
    Vb = torch.zeros_like(Vd)
    top = torch.zeros_like(Vd[:1])
    for wm in weights:
        wm = float(torch.tensor(wm, dtype=eta.dtype))
        # continuity: x flux difference (periodic), y flux with Vd[Ny] = 0
        Vd_up = torch.cat([Vd[1:], top], dim=0)
        div = (torch.roll(Ud, -1, dims=1) - Ud + Vd_up - Vd) * raz
        eta = eta - dtau * div
        # momentum: detay[0] = 0 from the mirrored ghost row
        detax = eta - torch.roll(eta, 1, dims=1)
        detay = eta - torch.cat([eta[:1], eta[:-1]], dim=0)
        Ud = Ud - gHuW * detax + GUd
        Vd = Vd - gHvW * detay + GVd
        etab = etab + wm * eta
        Ub = Ub + wm * Ud
        Vb = Vb + wm * Vd
    return etab, Ub, Vb


def _barotropic_loop_cuda(eta, Ud, Vd, gHuW, gHvW, GUd, GVd, r_azc, weights, dtau):
    dev = eta.device
    Ny, Nx = eta.shape
    for name, t in (("eta", eta), ("Ud", Ud), ("Vd", Vd), ("gHuW", gHuW), ("gHvW", gHvW),
                    ("GUd", GUd), ("GVd", GVd)):
        check_tensor(t, name, (Ny, Nx), torch.float32, dev)
    check_tensor(r_azc, "r_azc", (Ny,), torch.float32, dev)

    etab = torch.zeros_like(eta)
    Ub = torch.zeros_like(Ud)
    Vb = torch.zeros_like(Vd)
    # ping-pong: substep m reads `cur` and writes `nxt`; the inputs are
    # never written
    bufs = [[torch.empty_like(eta) for _ in range(3)] for _ in range(2)]
    cur = (eta, Ud, Vd)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        for m, wm in enumerate(weights):
            nxt = bufs[m % 2]
            wm = float(torch.tensor(wm, dtype=torch.float32))
            KERNEL.launch(
                "barotropic_substep_f32",
                *[t.data_ptr() for t in (*cur, *nxt, gHuW, gHvW, GUd, GVd, r_azc,
                                         etab, Ub, Vb)],
                dtau, wm, Nx, Ny, stream,
            )
            cur = nxt
    return etab, Ub, Vb
