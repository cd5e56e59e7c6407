"""Vertically implicit diffusion solves as plain PyTorch (a frozen copy of
the port's ``ops/pallas_tridiag.py`` plain version; kernel K3 computes it
on the card).

Solves, column by column,
    (1 + dt damp_k + lam_k + mu_k) x_k - lam_k x_{k-1} - mu_k x_{k+1} = f_k
with lam_k = kappa_k dt / (dz_c[k] dz_f[k]) (0 at the sea floor) and
mu_k = kappa_{k+1} dt / (dz_c[k] dz_f[k+1]) (0 at the surface), for one or
two right-hand sides that share kappa (a field, or one Python float).
"""

from __future__ import annotations

import torch


def vertical_coefficients(dt, dz_c, dz_f):
    """(dt c_lam, dt c_mu), ``(Nz,)`` each: the purely vertical parts of
    lam and mu with the zero-flux ends, c_lam = 1/(dz_c dz_f) with
    c_lam[0] = 0 and c_mu[k] = 1/(dz_c[k] dz_f[k+1]) with c_mu[-1] = 0, in
    the profiles' dtype."""
    dzc = dz_c.reshape(-1)
    dzf = dz_f.reshape(-1)
    c_lam = 1.0 / (dzc * dzf)
    c_lam[0] = 0.0
    c_mu = torch.zeros_like(dzc)
    c_mu[:-1] = 1.0 / (dzc[:-1] * dzf[1:])
    dt_t = torch.tensor(dt, dtype=dzc.dtype, device=dzc.device)
    return (dt_t * c_lam).contiguous(), (dt_t * c_mu).contiguous()


def grid_coefficients(grid, dt):
    """``vertical_coefficients`` of ``grid``'s interior profiles for the
    step ``dt`` (a float), built once per grid and dt and kept in
    ``grid.cache``; a new dt replaces the pair."""
    hit = grid.cache.get("k3_coefficients")
    if hit is None or hit[0] != dt:
        hz, Nz = grid.hz, grid.Nz
        pair = vertical_coefficients(dt, grid.dz_c[hz : hz + Nz], grid.dz_f[hz : hz + Nz])
        hit = grid.cache["k3_coefficients"] = (dt, pair)
    return hit[1]


def implicit_diffusion(cfg, fields, kappa, dt, dz_c, dz_f, damping=None):
    """Solve for each of ``fields`` (a tuple of one or two ``(Nz, Ny, Nx)``
    tensors) with the face diffusivity ``kappa`` (same shape, or a Python
    float) and the optional decay rate ``damping``; dz_c, dz_f are interior
    (Nz, 1, 1) profiles. Returns a tuple of solutions."""
    a_lam, a_mu = vertical_coefficients(dt, dz_c, dz_f)
    return implicit_solve(cfg, fields, kappa, dt, a_lam, a_mu, damping)


def implicit_solve(cfg, fields, kappa, dt, a_lam, a_mu, damping=None):
    """``implicit_diffusion`` on coefficients from ``vertical_coefficients``
    (or ``grid_coefficients``)."""
    fields = tuple(fields)
    if not 1 <= len(fields) <= 2:
        raise ValueError(f"K3 solves one or two right-hand sides, got {len(fields)}")
    return implicit_diffusion_plain(fields, kappa, dt, a_lam, a_mu, damping)


def implicit_diffusion_plain(fields, kappa, dt, a_lam, a_mu, damping=None):
    """The plain PyTorch version of K3: the Pallas kernel's recurrence term
    by term (``pallas_tridiag.py:148-170``) as a z loop of plane operations
    (any dtype, any device); ``kappa`` a field or a Python float."""
    Nz = fields[0].shape[0]
    if isinstance(kappa, float):
        kappa = [kappa] * Nz  # lam = kappa (dt c_lam) as the kernel rounds it
    zero = torch.zeros_like(fields[0][0])
    cp = torch.empty_like(fields[0])
    dps = [torch.empty_like(f) for f in fields]
    cp_prev = zero
    dp_prev = [zero] * len(fields)
    for k in range(Nz):
        lam = kappa[k] * a_lam[k]
        mu = kappa[k + 1] * a_mu[k] if k + 1 < Nz else zero
        b = 1.0 + lam + mu
        if damping is not None:
            b = b + dt * damping[k]
        inv = 1.0 / (b + lam * cp_prev)
        cp[k] = -mu * inv
        cp_prev = cp[k]
        for n, f in enumerate(fields):
            dps[n][k] = (f[k] + lam * dp_prev[n]) * inv
            dp_prev[n] = dps[n][k]
    outs = []
    for dp in dps:
        x = torch.empty_like(dp)
        x_next = zero
        for k in range(Nz - 1, -1, -1):
            x[k] = dp[k] - cp[k] * x_next
            x_next = x[k]
        outs.append(x)
    return tuple(outs)
