"""Model configuration (port of ``gb25_tpu.models.config``, the subset the
flagship and coupled-climate steps use)."""

from __future__ import annotations

import dataclasses

from gb25_tpu_torch.models.catke import CATKEVerticalDiffusivity
from gb25_tpu_torch.models.keps import TKEDissipationVerticalDiffusivity
from gb25_tpu_torch.ops.eos import TEOS10EquationOfState

EARTH_ROTATION_RATE = 7.292115e-5  # rad/s

KERNEL_MODES = ("auto", "torch", "pallas")


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

    ``kernels``: "auto" runs the step in its fused form (K1 computes the
    tendencies, the AB2 update and the depth integrals; the serial free
    surface is K2), launching the Hopper kernels for CUDA tensors and
    their plain PyTorch versions for CPU tensors; "torch" runs the fused
    form's plain versions on any device. "pallas" is the JAX package's
    route of that name: kernel K6 computes the tendencies (TEOS-10
    inside), the step applies the AB2 update and integrates the forcing
    itself, and the serial free surface is the blocked solve (K5) at
    ``exchange_width``; it dispatches as "auto" does, so on CPU tensors it
    runs the unfused form of the JAX package's "jnp" route.

    ``closure``: None, ``CATKEVerticalDiffusivity`` or
    ``TKEDissipationVerticalDiffusivity`` (k-epsilon); ``tracers`` is
    ("T", "S"), plus "e" with CATKE, plus "e", "eps" with k-epsilon. The
    port carries the flagship schemes only (WENO vector-invariant momentum,
    WENO-5 tracers, Hollingsworth kinetic energy); the JAX package's other
    choices come with later slices."""

    tracers: tuple = ("T", "S")
    eos: TEOS10EquationOfState = TEOS10EquationOfState()
    coriolis: float = EARTH_ROTATION_RATE  # Omega; 0 disables rotation
    free_surface: SplitExplicitFreeSurface = SplitExplicitFreeSurface()
    closure: object = None
    chi: float = 0.1  # quasi-AB2 parameter (Euler first step)
    weno_eps: float = 1e-6
    kernels: str = "auto"

    def __post_init__(self):
        if self.kernels not in KERNEL_MODES:
            raise ValueError(f"kernels must be one of {KERNEL_MODES}, got {self.kernels!r}")
        if self.closure is None:
            allowed = ("T", "S")
        elif isinstance(self.closure, (CATKEVerticalDiffusivity,
                                       TKEDissipationVerticalDiffusivity)):
            allowed = ("T", "S", *self.closure.tracer_names)
        else:
            raise ValueError(f"unsupported closure {self.closure!r}")
        if tuple(self.tracers) != allowed:
            raise ValueError(f"tracers {tuple(self.tracers)} with closure {self.closure!r}: "
                             f"the port runs {allowed}")

    @property
    def g(self):
        return self.free_surface.gravitational_acceleration
