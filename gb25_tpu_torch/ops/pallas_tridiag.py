"""Vertically implicit diffusion solves: kernel K3 (port of
``gb25_tpu.ops.pallas_tridiag.pallas_implicit_diffusion``).

Solves, column by column,
    (1 + dt damp_k + lam_k + mu_k) x_k - lam_k x_{k-1} - mu_k x_{k+1} = f_k
with lam_k = kappa_k dt / (dz_c[k] dz_f[k]) (0 at the sea floor) and
mu_k = kappa_{k+1} dt / (dz_c[k] dz_f[k+1]) (0 at the surface), for one or
two right-hand sides that share kappa (and one forward elimination).
kappa is a ``(Nz, Ny, Nx)`` field or, for ``VerticalScalarDiffusivity``,
one Python float (the kernel's constant-kappa instance, an undamped pair,
reads no kappa field).

``implicit_solve`` (and ``implicit_diffusion``, which builds the
coefficients from the profiles first) launches
``csrc/implicit_diffusion.cu`` for CUDA tensors under ``kernels="auto"``
and runs ``implicit_diffusion_plain`` for CPU tensors or
``kernels="torch"``. There is no fallback from a CUDA tensor to the plain
version. The model's step takes its coefficients from
``grid_coefficients``, built once per grid and dt.
"""

from __future__ import annotations

import ctypes

import torch

from gb25_tpu_torch.utils.cuda_build import CudaKernel, check_tensor, launch_info, uses_kernel

_P = ctypes.c_void_p
_I = ctypes.c_int

MAX_NZ = 128  # the kernel keeps a column's coefficients in shared memory

KERNEL = CudaKernel(
    "implicit_diffusion.cu",
    {"implicit_diffusion_f32": [_P] * 8 + [ctypes.c_float] * 2 + [_I] * 4 + [_P],
     "implicit_diffusion_info": [_I] * 4 + [ctypes.POINTER(_I)]},
    extra_flags=("-fmad=false",),
)


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
    if uses_kernel(cfg, fields[0]):
        return implicit_kernel(fields, kappa, dt, a_lam, a_mu, damping)
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


def kernel_info(Nz, nf, damped, const_kappa=False):
    """K3's launch shape for nf right-hand sides at Nz levels (with a
    constant kappa: the undamped pair): registers, shared memory per block,
    columns a block (``tile``), blocks per SM and the levels its ring of
    copies holds in flight."""
    return launch_info(KERNEL, "implicit_diffusion_info", Nz, nf, int(damped), int(const_kappa),
                       extra=("levels_in_flight",))


def implicit_kernel(fields, kappa, dt, a_lam, a_mu, damping=None):
    """K3's launch alone, on coefficients from ``vertical_coefficients``
    (CUDA float32 tensors); ``kappa`` a field or, for an undamped pair, a
    Python float."""
    dev = fields[0].device
    f32 = torch.float32
    Nz, Ny, Nx = fields[0].shape
    if Nz > MAX_NZ:
        raise ValueError(f"K3 solves columns of at most {MAX_NZ} levels, got Nz = {Nz}")
    shape = (Nz, Ny, Nx)
    for n, f in enumerate(fields):
        check_tensor(f, f"field{n}", shape, f32, dev)
    const_kappa = isinstance(kappa, float)
    if const_kappa and (len(fields) != 2 or damping is not None):
        raise ValueError("K3's constant-kappa instance solves an undamped pair")
    if not const_kappa:
        check_tensor(kappa, "kappa", shape, f32, dev)
    if damping is not None:
        check_tensor(damping, "damping", shape, f32, dev)
    check_tensor(a_lam, "dt_c_lam", (Nz,), f32, dev)
    check_tensor(a_mu, "dt_c_mu", (Nz,), f32, dev)

    outs = [torch.empty(shape, dtype=f32, device=dev) for _ in fields]
    f1 = fields[1] if len(fields) > 1 else None
    o1 = outs[1] if len(outs) > 1 else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        KERNEL.launch(
            "implicit_diffusion_f32",
            ptr(fields[0]), ptr(f1), None if const_kappa else ptr(kappa), ptr(damping),
            ptr(a_lam), ptr(a_mu), ptr(outs[0]), ptr(o1),
            float(torch.tensor(dt, dtype=f32)),
            float(torch.tensor(kappa if const_kappa else 0.0, dtype=f32)),
            Nx, Ny, Nz, len(fields), stream,
        )
    return tuple(outs)
