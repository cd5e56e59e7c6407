"""The split-explicit barotropic substeps as plain PyTorch (a frozen copy
of the port's ``ops/pallas_barotropic.py`` plain versions): the serial
loop of all substeps of a step (what kernel K2 computes on the card) and
one block of substeps on width-W extended planes (kernel K5's).
"""

from __future__ import annotations

import torch

from benchmark.reference.ocean.grids.tripolar import fold_x


def barotropic_loop(cfg, grid, eta0, U0, V0, GU, GV, Hu, Hv, dt, mu=None, mv=None):
    """All substeps of one model step on interior (Ny, Nx) planes; ``mu``,
    ``mv``: optional (Ny, Nx) solid-face masks (1 fluid, 0 solid).

    Returns the filtered (eta_b, U_b, V_b)."""
    return loop_plain(*loop_operands(cfg, grid, eta0, U0, V0, GU, GV, Hu, Hv, dt, mu, mv))


def loop_operands(cfg, grid, eta0, U0, V0, GU, GV, Hu, Hv, dt, mu=None, mv=None):
    """The operands of ``loop_plain``: the
    seven input planes, the metrics dyc, dxf, dxc, dyf, azc ((Ny,) columns,
    or (Ny, Nx) planes on the tripolar grid), the filter weights, dtau, g,
    the masks or None and the fold's pole column or None."""
    from benchmark.reference.ocean.models.free_surface import averaging_weights

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
    ``barotropic_loop_plain``, then U_b / dyc, V_b / dxf (the operands of the
    card's kernel)."""
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


def barotropic_block(cfg, weights, eta, U, V, pu, pv, fu, fv, au, av, rz, mu=None, mv=None):
    """``len(weights)`` substeps on width-W extended (Ye, Xe) planes; returns
    the updated (eta, U, V) and this block's partial accumulators (pe, pU,
    pV) = sum of w (eta, U, V), all at the full extended shape (the outer
    rings garbage: the caller crops them)."""
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
