"""Model configuration (a frozen copy of the port's ``models/config.py``
without its precision modes: the reference computes in its state's
dtype)."""

from __future__ import annotations

import dataclasses

from benchmark.reference.ocean.models.catke import CATKEVerticalDiffusivity
from benchmark.reference.ocean.ops.eos import LinearEquationOfState, TEOS10EquationOfState

EARTH_ROTATION_RATE = 7.292115e-5  # rad/s

KERNEL_MODES = ("auto", "torch", "pallas")
MOMENTUM_ADVECTION = ("weno_vector_invariant", "vector_invariant", "none")
TRACER_ADVECTION = ("weno5", "centered2", "upwind1", "none")
KE_SCHEMES = ("hollingsworth", "standard")
# the tracers that carry the buoyancy: T and S through the equation of
# state, or b itself (the reference's BuoyancyTracer)
BUOYANCY_TRACERS = (("T", "S"), ("b",))

@dataclasses.dataclass(frozen=True)
class SplitExplicitFreeSurface:
    """Barotropic substepping with time filtering: ``substeps``
    forward-backward substeps over the window [t, t + 2 dt], replaced by
    their ``averaging``-weighted mean ("parabolic" or "flat").

    ``exchange_width``: the halo width W of the blocked solve (None: the
    grid halo), which the decomposed path runs and, serially, the
    ``kernels="pallas"`` route, as the JAX package's does. Each width-W
    exchange carries W substeps, so W = substeps runs the solve as one
    block. Serial and decomposed runs agree at the same W; the serial
    route of "auto" and "torch" re-imposes its boundary conditions every
    substep (K2) and ignores it."""

    substeps: int = 30
    gravitational_acceleration: float = 9.80665
    averaging: str = "parabolic"
    exchange_width: int | None = None


@dataclasses.dataclass(frozen=True)
class HydrostaticConfig:
    """Static configuration of the hydrostatic free-surface model.

    ``kernels``: "auto" and "torch" run the step in its fused form (the
    tendencies, the AB2 update and the depth integrals in one stage; the
    serial loop of barotropic substeps); "pallas" the unfused form of that
    route: the one-pass tendency stage, the AB2 update and the forcing's
    integrals in the step, and the blocked solve at ``exchange_width``.

    ``closure``: None or ``CATKEVerticalDiffusivity``; ``tracers`` is ("T",
    "S") with the equation of state ``eos`` (TEOS-10 or linear), or ("b",),
    the buoyancy itself, then "e" with CATKE (the reference picks the
    tracers from the buoyancy's type). ``free_surface``: ``SplitExplicitFreeSurface``.
    ``momentum_advection``: WENO
    vector-invariant (the flagship's), the centred vector-invariant form,
    or "none" (q = f, no kinetic energy, no vertical advection: Coriolis
    and the pressure gradient alone); ``tracer_advection``: WENO-5, the
    second-order centred or first-order upwind flux, or "none" (G = 0);
    ``ke_scheme``: the Hollingsworth-corrected kinetic energy or the plain
    C-grid ("standard") one."""

    tracers: tuple = ("T", "S")
    momentum_advection: str = "weno_vector_invariant"
    tracer_advection: str = "weno5"
    eos: object = TEOS10EquationOfState()
    coriolis: float = EARTH_ROTATION_RATE  # Omega; 0 disables rotation
    free_surface: object = SplitExplicitFreeSurface()
    closure: object = None
    chi: float = 0.1  # quasi-AB2 parameter (Euler first step)
    weno_eps: float = 1e-6
    ke_scheme: str = "hollingsworth"
    kernels: str = "auto"

    def __post_init__(self):
        if self.kernels not in KERNEL_MODES:
            raise ValueError(f"kernels must be one of {KERNEL_MODES}, got {self.kernels!r}")
        if not isinstance(self.free_surface, SplitExplicitFreeSurface):
            raise ValueError(f"unsupported free surface {self.free_surface!r}")
        for name, value, allowed in (("momentum_advection", self.momentum_advection,
                                      MOMENTUM_ADVECTION),
                                     ("tracer_advection", self.tracer_advection, TRACER_ADVECTION),
                                     ("ke_scheme", self.ke_scheme, KE_SCHEMES)):
            if value not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, got {value!r}")
        if not isinstance(self.eos, (TEOS10EquationOfState, LinearEquationOfState)):
            raise ValueError(f"unsupported equation of state {self.eos!r}")
        if self.closure is None:
            extra = ()
        elif isinstance(self.closure, CATKEVerticalDiffusivity):
            extra = self.closure.tracer_names
        else:
            raise ValueError(f"unsupported closure {self.closure!r}")
        allowed = [(*b, *extra) for b in BUOYANCY_TRACERS]
        if tuple(self.tracers) not in allowed:
            raise ValueError(f"tracers {tuple(self.tracers)} with closure {self.closure!r}: "
                             f"the port runs one of {allowed}")

    @property
    def g(self):
        return self.free_surface.gravitational_acceleration

    @property
    def fused(self) -> bool:
        """Whether the stage fuses the AB2 update, the wall row and the depth
        integrals: off the "pallas" route."""
        return self.kernels != "pallas"
