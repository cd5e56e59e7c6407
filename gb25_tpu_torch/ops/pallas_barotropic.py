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
accumulators are un-weighted afterwards.

``barotropic_loop`` launches ``csrc/barotropic_loop.cu`` once a call for
CUDA tensors under ``kernels="auto"``: all substeps in one cooperative
launch, with the plane building and the un-weighting inside (the on-chip
instance on the tiles of ``loop_plan`` where they hold the grid, else the
L2 instance). For CPU tensors or ``kernels="torch"`` it builds the planes
with torch ops (``loop_planes``) and runs ``barotropic_loop_plain``.

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
import weakref

import torch

from gb25_tpu_torch.grids.tripolar import fold_x
from gb25_tpu_torch.utils.cuda_build import CudaKernel, check_tensor, launch_info, uses_kernel

_P = ctypes.c_void_p
_I = ctypes.c_int

KERNEL = CudaKernel(
    "barotropic_loop.cu",
    {"barotropic_loop_f32": [_P] * 20 + [_I, ctypes.c_float, ctypes.c_float] + [_I] * 6 + [_P],
     "barotropic_loop_info": [_I] * 2 + [ctypes.POINTER(_I)]},
    extra_flags=("-fmad=false",),
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
    run = _barotropic_loop_cuda if uses_kernel(cfg, eta0) else loop_plain
    return run(*loop_operands(cfg, grid, eta0, U0, V0, GU, GV, Hu, Hv, dt, mu, mv))


def loop_operands(cfg, grid, eta0, U0, V0, GU, GV, Hu, Hv, dt, mu=None, mv=None):
    """The operands of ``_barotropic_loop_cuda`` and ``loop_plain``: the
    seven input planes, the metrics dyc, dxf, dxc, dyf, azc ((Ny,) columns,
    or (Ny, Nx) planes on the tripolar grid), the filter weights, dtau, g,
    the masks or None and the fold's pole column or None."""
    from gb25_tpu_torch.models.free_surface import averaging_weights

    fs = cfg.free_surface
    M = fs.substeps
    dtype = eta0.dtype
    hx, hy, Nx, Ny = grid.hx, grid.hy, grid.Nx, grid.Ny

    def metric(m):  # extended metric -> interior (Ny,) column or (Ny, Nx) plane
        m = m[0, hy : hy + Ny]
        return (m[:, hx : hx + Nx] if grid.north_fold else m.reshape(-1)).to(dtype).contiguous()

    inputs = tuple(t.contiguous() for t in (eta0, U0, V0, GU, GV, Hu, Hv))
    # grid constants: taken once (on the tripolar grid, copies of planes)
    metrics = grid.cache.get(("k2_metrics", dtype))
    if metrics is None:
        metrics = grid.cache[("k2_metrics", dtype)] = tuple(
            metric(m) for m in (grid.dyc, grid.dxf, grid.dxc, grid.dyf, grid.azc))
    # dtau in the working precision, as the JAX package traces it
    dtau = torch.tensor(2.0 * dt / M, dtype=dtype).item()
    masks = None if mu is None else (mu.to(dtype).contiguous(), mv.to(dtype).contiguous())
    fold_p = grid.pole_index if grid.north_fold else None
    return (*inputs, *metrics, averaging_weights(M, fs.averaging), dtau,
            fs.gravitational_acceleration, masks, fold_p)


def loop_plain(eta0, U0, V0, GU, GV, Hu, Hv, dyc, dxf, dxc, dyf, azc, weights, dtau, g,
               masks=None, fold_p=None):
    """K2's function on its raw operands in torch ops: ``loop_planes``,
    ``barotropic_loop_plain``, then U_b / dyc, V_b / dxf (the operands of
    ``_barotropic_loop_cuda``)."""
    etab, Ub, Vb = barotropic_loop_plain(
        *loop_planes(eta0, U0, V0, GU, GV, Hu, Hv, dyc, dxf, dxc, dyf, azc, dtau, g, fold_p),
        weights, dtau, masks, fold_p)
    if fold_p is None:
        dyc, dxf = dyc.reshape(-1, 1), dxf.reshape(-1, 1)
    return etab, Ub / dyc, Vb / dxf


def loop_planes(eta0, U0, V0, GU, GV, Hu, Hv, dyc, dxf, dxc, dyf, azc, dtau, g, fold_p=None):
    """K2's operands in the JAX kernel's flux-weighted form, as torch ops:
    (eta, Ud = U dyc, Vd = V dxf, gHuW = Hu (dyc / dxc) (dtau g), gHvW,
    GUd = (GU dyc) dtau, GVd, r_azc = 1 / azc). The metrics are (Ny,)
    columns, or (Ny, Nx) planes with ``fold_p``; r_azc keeps their shape."""
    col = (lambda m: m) if fold_p is not None else (lambda m: m.reshape(-1, 1))
    dyc, dxf, dxc, dyf = (col(m) for m in (dyc, dxf, dxc, dyf))
    return (eta0, U0 * dyc, V0 * dxf, Hu * (dyc / dxc) * (dtau * g),
            Hv * (dxf / dyf) * (dtau * g), GU * dyc * dtau, GV * dxf * dtau, 1.0 / azc)


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


def loop_plan(Nx, Ny, blocks, max_tile):
    """K2's tile plan: (TX, TY, GX, GY), tiles of TX x TY cells (the last
    column and row of tiles ragged), GX x GY of them, one block each, at
    most ``blocks`` (those the card holds at once) and no tile larger than
    ``max_tile`` = (columns, rows); the fewest cells a tile, then the widest
    tile. None where no such plan exists: the L2 instance runs instead."""
    best = None
    for gx in range(1, min(blocks, Nx) + 1):
        tx = -(-Nx // gx)
        gx = -(-Nx // tx)
        if tx > max_tile[0] or blocks // gx == 0:
            continue
        ty = -(-Ny // (blocks // gx))
        if ty > max_tile[1]:
            continue
        key = (tx * ty, -tx)
        if best is None or key < best[0]:
            best = key, (tx, ty, gx, -(-Ny // ty))
    return None if best is None else best[1]


@functools.cache
def _loop_info(kernel, masked, tripolar):
    return launch_info(kernel, "barotropic_loop_info", int(masked), int(tripolar),
                       extra=("sms", "l2_registers", "l2_blocks_per_sm"))


def loop_info(masked, tripolar):
    """K2's launch shape, read from the built kernel: registers, shared
    memory per block and the tile (columns, rows) of the on-chip instance
    at its largest tile (the rows its shared memory allows), its blocks per
    SM there, the SM count, the L2 instance's registers and blocks per SM."""
    return _loop_info(KERNEL, bool(masked), bool(tripolar))


def launch_plan(Nx, Ny, masked, tripolar, on_chip=True):
    """The plan a K2 launch on the current device takes: a dict with the
    instance ("on_chip" or "l2"), and for the on-chip one the tile, the
    grid of tiles, the cells a tile and the shared memory a block."""
    return _launch_plan(KERNEL, Nx, Ny, bool(masked), bool(tripolar), on_chip)


@functools.cache
def _launch_plan(kernel, Nx, Ny, masked, tripolar, on_chip):
    info = _loop_info(kernel, masked, tripolar)
    plan = (loop_plan(Nx, Ny, info["blocks_per_sm"] * info["sms"], info["tile"]) if on_chip
            else None)
    if plan is None:
        return {"instance": "l2"}
    tx, ty, gx, gy = plan
    sx = -(-tx // 4) * 4  # the kernel's row stride: whole float4s
    return {"instance": "on_chip", "tile": [tx, ty], "grid": [gx, gy], "cells": tx * ty,
            "smem_bytes": 4 * (6 * sx * ty + 2 * sx + 3 * ty + 1)}


_ZERO_ONE = {}  # id(mask) -> (weak reference, version, all 0 or 1)


def _zero_one(mask):
    """Whether every value of ``mask`` is 1 or +0: the kernel keeps a mask as
    one bit a cell. Checked once for each mask tensor and version (a grid's
    masks are built once), so a step's launches do not wait for it."""
    key = id(mask)
    ref, version, ok = _ZERO_ONE.get(key, (None, None, None))
    if ref is None or ref() is not mask or version != mask._version:
        ok = bool(((mask == 1) | ((mask == 0) & ~torch.signbit(mask))).all())
        ref = weakref.ref(mask, lambda _, key=key: _ZERO_ONE.pop(key, None))
        _ZERO_ONE[key] = (ref, mask._version, ok)
    return ok


def _barotropic_loop_cuda(eta0, U0, V0, GU, GV, Hu, Hv, dyc, dxf, dxc, dyf, azc, weights, dtau,
                          g, masks=None, fold_p=None, on_chip=True):
    """K2 in one launch; ``on_chip=False`` takes the L2 instance whatever
    the size (the on-chip instance runs wherever its tiles hold the grid)."""
    dev = eta0.device
    Ny, Nx = eta0.shape
    mu, mv = masks if masks is not None else (None, None)
    for name, t in (("eta0", eta0), ("U0", U0), ("V0", V0), ("GU", GU), ("GV", GV), ("Hu", Hu),
                    ("Hv", Hv), ("mu", mu), ("mv", mv)):
        if t is not None:
            check_tensor(t, name, (Ny, Nx), torch.float32, dev)
    for name, t in (("dyc", dyc), ("dxf", dxf), ("dxc", dxc), ("dyf", dyf), ("azc", azc)):
        check_tensor(t, name, (Ny,) if fold_p is None else (Ny, Nx), torch.float32, dev)
    if fold_p is not None and not 0 <= fold_p < Nx:
        raise ValueError(f"fold pole column {fold_p} outside [0, {Nx})")
    if masks is not None and not all(_zero_one(m) for m in masks):
        raise ValueError("K2 takes solid-face masks of 0 and 1 (no -0, no other value)")
    mask_ptrs = (None, None) if masks is None else (mu.data_ptr(), mv.data_ptr())
    plan = launch_plan(Nx, Ny, masks is not None, fold_p is not None, on_chip)
    tx, ty = plan.get("tile", (0, 0))
    gx = plan.get("grid", (0, 0))[0]

    N = Ny * Nx
    # one allocation: the three outputs, (the L2 instance) the constant
    # planes and 1 / area, the two parities of (eta, Ud, Vd)
    n_cst = 0 if tx else 5 * N if fold_p is not None else 4 * N + Ny
    buf = torch.empty(3 * N + n_cst + 6 * N, dtype=torch.float32, device=dev)
    out = buf[: 3 * N].view(3, Ny, Nx)
    w = (ctypes.c_float * len(weights))(*weights)  # rounded to float32 as torch does
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        KERNEL.launch(
            "barotropic_loop_f32",
            *[t.data_ptr() for t in (eta0, U0, V0, GU, GV, Hu, Hv, dyc, dxf, dxc, dyf, azc)],
            *mask_ptrs, *[t.data_ptr() for t in out], buf[3 * N :].data_ptr(),
            buf[3 * N + n_cst :].data_ptr(), w, len(weights), dtau, dtau * g, Nx, Ny,
            -1 if fold_p is None else fold_p, tx, ty, gx, stream,
        )
    return out.unbind()


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
