"""The tendency stage with the quasi-AB2 update fused in, as plain PyTorch
(a frozen copy of the port's ``ops/pallas_zslab.py`` plain version, the
stage kernel K1 computes on the card): from the halo-extended u, v and
tracers, the momentum and tracer tendencies, the updated fields
x* = x + dt c1 G + dt c2 G_prev with the south-wall row zeroed, and the
depth integrals of u, v, u*, v*; with ``ab=None`` the tendencies alone.
"""

from __future__ import annotations

from benchmark.reference.ocean.ops.operators import coriolis_ff

def column_buoyancy(cfg, grid, tr_e):
    """Extended buoyancy ``be`` (``hydrostatic.buoyancy_field``: the b
    tracer itself, or the equation of state) and its column total of b dz
    ``(Ny+2hy, Nx+2hx)``, the two buoyancy operands of K1."""
    from benchmark.reference.ocean.models.hydrostatic import buoyancy_field

    hz, Nz = grid.hz, grid.Nz
    be = buoyancy_field(cfg, grid, tr_e).contiguous()
    b_total = (be[hz : hz + Nz] * grid.dz_c[hz : hz + Nz]).sum(dim=0).contiguous()
    return be, b_total


def zslab_tendencies(cfg, grid, ue, ve, tr_e, prev=None, ab=None, buoyancy=None,
                     face_bottoms=None, wall_v=True):
    """``zslab_tendencies_plain`` with the buoyancy operands of
    ``column_buoyancy`` (its column total is the kernel's alone)."""
    be = buoyancy[0] if buoyancy is not None else None
    return zslab_tendencies_plain(cfg, grid, ue, ve, tr_e, prev, ab, be, face_bottoms, wall_v)


def zslab_tendencies_plain(cfg, grid, ue, ve, tr_e, prev=None, ab=None, be=None,
                           face_bottoms=None, wall_v=True):
    """``tendency_math`` on the extended tensors, then the AB2 update, the
    wall row and the integrals; with ``ab=None`` the tendencies and the
    wall row alone."""
    from benchmark.reference.ocean.models.hydrostatic import mask_v_wall, tendency_math

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
