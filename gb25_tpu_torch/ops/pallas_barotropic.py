"""The split-explicit barotropic substep loop: kernel K2 (port of
``gb25_tpu.ops.pallas_barotropic.pallas_barotropic_loop``, with the
optional solid-face masks of immersed grids and the tripolar fold row).

The loop advances (eta, Ud = U dyc, Vd = V dxf) through ``substeps``
forward-backward substeps: x periodic, eta mirrored at the south wall
(detay = 0 on row 0), no flux through the north wall face, or on the
tripolar grid the fold's ghost flux -Vd[Ny-1, (2p - x) mod Nx] above the
seam row; on immersed grids the masks ``mu``, ``mv`` multiply Ud and Vd
after every substep. The pressure-gradient and forcing planes carry dtau
folded in (from the 2-D metric planes on the tripolar grid); the filtered
accumulators are un-weighted afterwards. Plane building and un-weighting
are torch ops, as in the JAX package.

``barotropic_loop`` launches ``csrc/barotropic_loop.cu`` once per substep
for CUDA tensors under ``kernels="auto"``, and runs
``barotropic_loop_plain`` for CPU tensors or ``kernels="torch"``.

Kernel K5 (port of ``pallas_barotropic_block``), the decomposed path's
form: one exchange block of substeps on width-W extended planes, with no
boundary of its own (the exchanged ghosts carry walls, neighbours and the
fold; see ``models.free_surface``). ``barotropic_block`` launches
``csrc/barotropic_block.cu`` for CUDA tensors under ``kernels="auto"``,
once for each chunk of at most ``substeps_per_launch()`` substeps
(``launch_chunks``), and runs ``barotropic_block_plain`` otherwise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gb25_tpu_torch.grids.tripolar import fold_x
from gb25_tpu_torch.utils.cuda_build import CudaKernel, check_tensor, launch_info, uses_kernel

_P = ctypes.c_void_p
_I = ctypes.c_int

KERNEL = CudaKernel(
    "barotropic_loop.cu",
    {"barotropic_substep_f32": [_P] * 16 + [ctypes.c_float] * 2 + [ctypes.c_int] * 3 + [_P]},
)
BLOCK_KERNEL = CudaKernel(
    "barotropic_block.cu",
    {"barotropic_block_f32": [_P] * 19 + [_I] * 5 + [_P],
     "barotropic_block_info": [_I] * 2 + [ctypes.POINTER(_I)]},
    extra_flags=("-fmad=false",),
)


def barotropic_loop(cfg, grid, eta0, U0, V0, GU, GV, Hu, Hv, dt, mu=None, mv=None):
    """All substeps of one model step on interior (Ny, Nx) planes; ``mu``,
    ``mv``: optional (Ny, Nx) solid-face masks (1 fluid, 0 solid).

    Returns the filtered (eta_b, U_b, V_b)."""
    from gb25_tpu_torch.models.free_surface import averaging_weights

    fs = cfg.free_surface
    M = fs.substeps
    weights = averaging_weights(M, fs.averaging)
    dtype = eta0.dtype
    hx, hy, Nx, Ny = grid.hx, grid.hy, grid.Nx, grid.Ny

    def plane(m):  # extended metric -> interior (Ny, 1) column or (Ny, Nx) plane
        m = m[0, hy : hy + Ny]
        return (m[:, hx : hx + Nx] if grid.north_fold else m).to(dtype)

    dyc, dxf = plane(grid.dyc), plane(grid.dxf)
    # dtau in the working precision, as the JAX package traces it
    dtau = torch.tensor(2.0 * dt / M, dtype=dtype).item()
    r_azc = 1.0 / plane(grid.azc)
    r_azc = (r_azc if grid.north_fold else r_azc.reshape(-1)).contiguous()
    Ud0 = (U0 * dyc).contiguous()
    Vd0 = (V0 * dxf).contiguous()
    gHuW = (Hu * (dyc / plane(grid.dxc)) * (dtau * fs.gravitational_acceleration)).contiguous()
    gHvW = (Hv * (dxf / plane(grid.dyf)) * (dtau * fs.gravitational_acceleration)).contiguous()
    GUd = (GU * dyc * dtau).contiguous()
    GVd = (GV * dxf * dtau).contiguous()
    masks = None if mu is None else (mu.to(dtype).contiguous(), mv.to(dtype).contiguous())
    planes = (eta0.contiguous(), Ud0, Vd0, gHuW, gHvW, GUd, GVd, r_azc)
    fold_p = grid.pole_index if grid.north_fold else None
    if uses_kernel(cfg, eta0):
        etab, Ub, Vb = _barotropic_loop_cuda(*planes, weights, dtau, masks, fold_p)
    else:
        etab, Ub, Vb = barotropic_loop_plain(*planes, weights, dtau, masks, fold_p)
    return etab, Ub / dyc, Vb / dxf


def barotropic_loop_plain(eta, Ud, Vd, gHuW, gHvW, GUd, GVd, r_azc, weights, dtau, masks=None,
                          fold_p=None):
    """The plain PyTorch version of K2: the flux-form substeps of the JAX
    kernel with ``torch.roll`` / ``torch.cat`` (any dtype, any device).
    ``r_azc``: (Ny,) profile, or (Ny, Nx) plane with ``fold_p``, the pole
    column of the tripolar fold."""
    raz = r_azc if fold_p is not None else r_azc.reshape(-1, 1)
    etab = torch.zeros_like(eta)
    Ub = torch.zeros_like(Ud)
    Vb = torch.zeros_like(Vd)
    top = torch.zeros_like(Vd[:1])
    for wm in weights:
        wm = float(torch.tensor(wm, dtype=eta.dtype))
        # continuity: x flux difference (periodic), y flux with Vd[Ny] = 0,
        # or the fold's ghost flux read from this substep's input
        if fold_p is not None:
            top = -fold_x(Vd[-1:], fold_p, face=False)
        Vd_up = torch.cat([Vd[1:], top], dim=0)
        div = (torch.roll(Ud, -1, dims=1) - Ud + Vd_up - Vd) * raz
        eta = eta - dtau * div
        # momentum: detay[0] = 0 from the mirrored ghost row
        detax = eta - torch.roll(eta, 1, dims=1)
        detay = eta - torch.cat([eta[:1], eta[:-1]], dim=0)
        Ud = Ud - gHuW * detax + GUd
        Vd = Vd - gHvW * detay + GVd
        if masks is not None:  # no transport through solid faces
            Ud = Ud * masks[0]
            Vd = Vd * masks[1]
        etab = etab + wm * eta
        Ub = Ub + wm * Ud
        Vb = Vb + wm * Vd
    return etab, Ub, Vb


def _barotropic_loop_cuda(eta, Ud, Vd, gHuW, gHvW, GUd, GVd, r_azc, weights, dtau, masks=None,
                          fold_p=None):
    dev = eta.device
    Ny, Nx = eta.shape
    mu, mv = masks if masks is not None else (None, None)
    for name, t in (("eta", eta), ("Ud", Ud), ("Vd", Vd), ("gHuW", gHuW), ("gHvW", gHvW),
                    ("GUd", GUd), ("GVd", GVd), ("mu", mu), ("mv", mv)):
        if t is not None:
            check_tensor(t, name, (Ny, Nx), torch.float32, dev)
    mask_ptrs = (None, None) if masks is None else (mu.data_ptr(), mv.data_ptr())
    check_tensor(r_azc, "r_azc", (Ny,) if fold_p is None else (Ny, Nx), torch.float32, dev)
    if fold_p is not None and not 0 <= fold_p < Nx:
        raise ValueError(f"fold pole column {fold_p} outside [0, {Nx})")

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
                *[t.data_ptr() for t in (*cur, *nxt, gHuW, gHvW, GUd, GVd, r_azc)],
                *mask_ptrs, *[t.data_ptr() for t in (etab, Ub, Vb)],
                dtau, wm, Nx, Ny, -1 if fold_p is None else fold_p, stream,
            )
            cur = nxt
    return etab, Ub, Vb


def barotropic_block(cfg, weights, eta, U, V, pu, pv, fu, fv, au, av, rz, mu=None, mv=None):
    """``len(weights)`` substeps on width-W extended (Ye, Xe) planes; returns
    the updated (eta, U, V) and this block's partial accumulators (pe, pU,
    pV) = sum of w (eta, U, V), all at the full extended shape (the outer
    rings garbage: the caller crops them).

    Constant operands, dtau folded in: pu = dtau g Hu / dxc, pv = dtau g Hv
    / dyf, fu = dtau GU, fv = dtau GV; au = dyc, av = dxf and rz = dtau /
    azc as (Ye, 1) columns or (Ye, Xe) planes; ``mu``, ``mv``: optional
    solid-face masks."""
    if uses_kernel(cfg, eta):
        return _barotropic_block_cuda(weights, eta, U, V, pu, pv, fu, fv, au, av, rz, mu, mv)
    return barotropic_block_plain(weights, eta, U, V, pu, pv, fu, fv, au, av, rz, mu, mv)


def barotropic_block_plain(weights, eta, U, V, pu, pv, fu, fv, au, av, rz, mu=None, mv=None):
    """The plain PyTorch version of K5: the JAX kernel's substeps with
    wrapped shifts (``torch.roll``), in the CUDA kernel's operation order
    (any dtype, any device)."""
    pe = torch.zeros_like(eta)
    pU = torch.zeros_like(U)
    pV = torch.zeros_like(V)
    for w in weights:
        w = float(torch.tensor(w, dtype=eta.dtype))
        Ud = U * au
        Vd = V * av
        div = (torch.roll(Ud, -1, dims=1) - Ud + torch.roll(Vd, -1, dims=0) - Vd) * rz
        eta = eta - div
        U = U - pu * (eta - torch.roll(eta, 1, dims=1)) + fu
        V = V - pv * (eta - torch.roll(eta, 1, dims=0)) + fv
        if mu is not None:
            U = U * mu
            V = V * mv
        pe = pe + w * eta
        pU = pU + w * U
        pV = pV + w * V
    return eta, U, V, pe, pU, pV


def launch_chunks(weights, s):
    """K5's launch plan: a block's weights split, in order, into chunks of
    at most ``s`` substeps, one launch each (ceil(len(weights) / s))."""
    return [weights[i : i + s] for i in range(0, len(weights), s)]


def block_info(masked, metric2d):
    """K5's launch shape: registers, shared memory per block, the interior
    tile (columns, rows) of a full launch, blocks per SM and the most
    substeps a launch."""
    return launch_info(BLOCK_KERNEL, "barotropic_block_info", int(masked), int(metric2d),
                       extra=("substeps",))


@functools.cache
def _substeps(kernel):
    return launch_info(kernel, "barotropic_block_info", 0, 0, extra=("substeps",))["substeps"]


def substeps_per_launch():
    """The most substeps one K5 launch advances (its widest apron), read
    from the built kernel."""
    return _substeps(BLOCK_KERNEL)


def step_launches(substeps, width):
    """K5's launches in one step of ``substeps`` substeps in blocks of
    ``width`` (the blocked solve's W): each block's ceil(n / s)."""
    s = substeps_per_launch()
    return sum(len(launch_chunks(range(min(width, substeps - m)), s))
               for m in range(0, substeps, width))


def _barotropic_block_cuda(weights, eta, U, V, pu, pv, fu, fv, au, av, rz, mu=None, mv=None):
    dev = eta.device
    Ye, Xe = eta.shape
    metric2d = au.shape[1] > 1
    for name, t in (("eta", eta), ("U", U), ("V", V), ("pu", pu), ("pv", pv), ("fu", fu),
                    ("fv", fv), ("mu", mu), ("mv", mv)):
        if t is not None:
            check_tensor(t, name, (Ye, Xe), torch.float32, dev)
    for name, t in (("au", au), ("av", av), ("rz", rz)):
        check_tensor(t, name, (Ye, Xe) if metric2d else (Ye, 1), torch.float32, dev)
    if (mu is None) != (mv is None):
        raise ValueError("K5 takes both solid-face masks or neither")
    mask_ptrs = (None, None) if mu is None else (mu.data_ptr(), mv.data_ptr())
    chunks = launch_chunks(weights, substeps_per_launch())
    if not chunks:
        raise ValueError("K5 needs at least one substep")

    # one allocation: the accumulators, which the first launch writes and
    # later ones add to, then one or two sets of (eta, U, V) in ping-pong
    # (launch i reads `cur` and writes `nxt`; the inputs are never written)
    planes = torch.empty((3 * (1 + min(2, len(chunks))), Ye, Xe), dtype=eta.dtype, device=dev)
    acc = planes[:3].unbind()
    bufs = (planes[3:6].unbind(), planes[6:9].unbind())
    cur = (eta, U, V)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        for i, chunk in enumerate(chunks):
            nxt = bufs[i % 2]
            w = (ctypes.c_float * len(chunk))(*chunk)  # rounded to float32 as torch does
            BLOCK_KERNEL.launch(
                "barotropic_block_f32",
                *[t.data_ptr() for t in (*cur, *nxt, pu, pv, fu, fv, au, av, rz)],
                *mask_ptrs, *[t.data_ptr() for t in acc],
                w, len(chunk), int(i == 0), Xe, Ye, int(metric2d), stream,
            )
            cur = nxt
    return (*cur, *acc)
