"""Flagship setup: the baroclinic-instability ocean (port of
``gb25_tpu.models.baroclinic``).

Split-explicit free surface with 30 substeps, TEOS-10 buoyancy, spherical
Coriolis, WENO vector-invariant momentum and WENO-5 tracer advection on the
simple lat-lon grid; T = (30 + 1e-3 z) smooth_step(phi), S = -5e-3 z, and
~1e-3 m/s random velocities from a ``torch.Generator`` (the numbers differ
from ``jax.random``'s; tests carry the JAX state across instead).
"""

from __future__ import annotations

import torch

from gb25_tpu_torch.grids import simple_latitude_longitude_grid
from gb25_tpu_torch.models.config import HydrostaticConfig, SplitExplicitFreeSurface
from gb25_tpu_torch.models.keps import TKEDissipationVerticalDiffusivity
from gb25_tpu_torch.models.state import HydrostaticState, initial_state
from gb25_tpu_torch.ops.eos import LinearEquationOfState, TEOS10EquationOfState


def smooth_step(phi):
    """(1 - tanh((|phi| - 40) / 5)) / 2."""
    return (1.0 - torch.tanh((torch.abs(phi) - 40.0) / 5.0)) / 2.0


def baroclinic_instability_config(kernels="auto", closure=None, free_surface=None,
                                  momentum_advection="weno_vector_invariant",
                                  tracer_advection="weno5", eos=None) -> HydrostaticConfig:
    """The flagship configuration; with ``closure`` the tracer set gains
    the closure's ("e" with CATKE, "e" and "eps" with k-epsilon), as in the
    JAX package. ``free_surface``: the split-explicit one with 30 substeps
    unless given (``ExplicitFreeSurface``); ``eos``: TEOS-10 unless given
    (``LinearEquationOfState``); the advection schemes as
    ``HydrostaticConfig`` names them. A ``compute_dtype``, a ``ke_scheme``
    or the b tracer is set on the result with ``dataclasses.replace``, as
    the JAX package's run scripts and tests do."""
    tracers = ("T", "S") + tuple(getattr(closure, "tracer_names", ()))
    return HydrostaticConfig(
        tracers=tracers,
        momentum_advection=momentum_advection,
        tracer_advection=tracer_advection,
        eos=eos or TEOS10EquationOfState(),
        free_surface=free_surface or SplitExplicitFreeSurface(substeps=30),
        closure=closure,
        kernels=kernels,
    )


def baroclinic_instability_state(grid, noise_velocity=1e-3, seed=42,
                                 tracers=("T", "S")) -> HydrostaticState:
    """Initial state on ``grid``'s device and in its dtype: analytic T/S
    (over the true 2-D latitude of a tripolar grid), a closure's e at 1e-6
    and eps at 1e-9 as in the JAX package, plus velocity noise drawn from a
    ``torch.Generator`` seeded with ``seed``."""
    dtype = grid.dtype
    state = initial_state(grid, tracers)
    phi = (grid.phi2_c[None] if grid.north_fold else grid.phi_c_i.reshape(1, -1, 1)).to(dtype)
    z = grid.z_c_i.reshape(-1, 1, 1).to(dtype)
    shape = grid.shape

    T = ((30.0 + 1e-3 * z) * smooth_step(phi)).expand(shape).contiguous()
    S = (-5e-3 * z + 0.0 * phi).expand(shape).contiguous()

    u = torch.zeros(shape, dtype=dtype, device=grid.device)
    v = torch.zeros(shape, dtype=dtype, device=grid.device)
    if noise_velocity:
        gen = torch.Generator(device=grid.device).manual_seed(seed)
        u = noise_velocity * torch.randn(shape, generator=gen, dtype=dtype, device=grid.device)
        v = noise_velocity * torch.randn(shape, generator=gen, dtype=dtype, device=grid.device)
        v[:, 0, :] = 0.0  # southern wall face
    floors = {"e": 1e-6, "eps": 1e-9}
    closure = {k: torch.full(shape, floors[k], dtype=dtype, device=grid.device)
               for k in tracers if k in floors}
    return state.replace(u=u, v=v, tracers={"T": T, "S": S, **closure})


def balanced_jet_state(grid, cfg=None, noise_velocity=1e-3, seed=42,
                       tracers=("T", "S")) -> HydrostaticState:
    """The thermal-wind-balanced baroclinic jet (the eddy probe's
    ``--init balanced``): the analytic T/S front of
    ``baroclinic_instability_state``, with u in thermal-wind balance with
    it and the free surface set so that the bottom flow vanishes,

        g eta(y) = int_{-H}^0 b dz' (its mean removed),
        u(y, z) = -(1/f) d/dy int_{-H}^z b dz',

    so the run starts without the geostrophic-adjustment transient of the
    unbalanced front. 1/f is clamped at |phi| = 10 degrees. The balance
    arithmetic runs in float64 numpy, in the JAX package's order; g is
    9.80665 whatever the config's free surface says, as in the JAX package
    (a known fault of the reference, ROADMAP.md section 3). The velocity
    noise comes from a ``torch.Generator`` seeded with ``seed``: u's draw,
    then v's, v 0 on the southern wall face."""
    import numpy as np

    from gb25_tpu_torch.grids.latlon import EARTH_RADIUS
    from gb25_tpu_torch.models.config import EARTH_ROTATION_RATE

    cfg = cfg or baroclinic_instability_config()
    state = baroclinic_instability_state(grid, noise_velocity=0.0, seed=seed, tracers=tracers)
    dtype, device = grid.dtype, grid.device

    def host(t):
        return t.detach().to("cpu", torch.float64).numpy()

    phi_c = host(grid.phi_c_i)                                  # (Ny,)
    z_c = host(grid.z_c_i)                                      # (Nz,)
    hz = grid.hz
    dz = host(grid.dz_c).reshape(-1)[hz : hz + grid.Nz]
    T = host(state.tracers["T"][:, :, 0]).T                     # (Ny, Nz): x-independent
    S = host(state.tracers["S"][:, :, 0]).T
    b = host(cfg.eos.buoyancy(torch.from_numpy(T), torch.from_numpy(S),
                              torch.from_numpy(z_c.reshape(1, -1))))

    # int_{-H}^{z_k} b dz' at the cell centres (midpoint rule)
    B = np.cumsum(b * dz.reshape(1, -1), axis=1)               # (Ny, Nz)
    y_c = EARTH_RADIUS * np.deg2rad(phi_c)
    dBdy = np.gradient(B, y_c, axis=0)

    f = 2.0 * EARTH_ROTATION_RATE * np.sin(np.deg2rad(phi_c))
    f_min = 2.0 * EARTH_ROTATION_RATE * np.sin(np.deg2rad(10.0))
    f_cl = np.where(np.abs(f) < f_min, np.where(f < 0, -f_min, f_min), f)

    u2 = -dBdy / f_cl.reshape(-1, 1)                           # (Ny, Nz)
    eta1 = (B[:, -1] - B[:, -1].mean()) / 9.80665              # (Ny,)

    shape = grid.shape
    u = torch.as_tensor(u2.T, dtype=dtype, device=device)[:, :, None].expand(shape).contiguous()
    eta = torch.as_tensor(eta1, dtype=dtype, device=device)[:, None].expand(shape[1:]).contiguous()
    v = torch.zeros(shape, dtype=dtype, device=device)
    if noise_velocity:
        gen = torch.Generator(device=device).manual_seed(seed)
        u = u + noise_velocity * torch.randn(shape, generator=gen, dtype=dtype, device=device)
        v = noise_velocity * torch.randn(shape, generator=gen, dtype=dtype, device=device)
        v[:, 0, :] = 0.0
    return state.replace(u=u, v=v, eta=eta)


def buoyancy_tracer_state(state, grid, eos=None):
    """``state`` with its T and S replaced by the b tracer, b = ``eos``'s
    buoyancy of them (the linear equation of state unless given: the
    flagship's analytic T and S are then stably stratified), placed first
    as the buoyancy-tracer config orders it; its previous G of b is 0."""
    eos = eos or LinearEquationOfState()
    hz, Nz = grid.hz, grid.Nz
    tr = dict(state.tracers)
    b = eos.buoyancy(tr.pop("T"), tr.pop("S"), grid.z_c[hz : hz + Nz]).contiguous()
    G = {k: g for k, g in state.Gtracers.items() if k not in ("T", "S")}
    return state.replace(tracers={"b": b, **tr}, Gtracers={"b": torch.zeros_like(b), **G})


def baroclinic_instability_model(Nx, Ny, Nz, *, device="cuda", halo=(4, 4, 4), dtype=torch.float32,
                                 **config_kw):
    """Grid, config and initial state of the flagship benchmark on ``device``;
    ``config_kw`` goes to ``baroclinic_instability_config``. With the
    k-epsilon closure the state starts from e = 1e-5, eps = 1e-8 (the JAX
    package's k-epsilon kernel tests' state)."""
    grid = simple_latitude_longitude_grid(Nx, Ny, Nz, device=device, halo=halo, dtype=dtype)
    cfg = baroclinic_instability_config(**config_kw)
    state = baroclinic_instability_state(grid, tracers=cfg.tracers)
    if isinstance(cfg.closure, TKEDissipationVerticalDiffusivity):
        tr = {**state.tracers, "e": torch.full_like(state.tracers["e"], 1e-5),
              "eps": torch.full_like(state.tracers["eps"], 1e-8)}
        state = state.replace(tracers=tr)
    return cfg, grid, state
