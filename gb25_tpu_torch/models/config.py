"""Model configuration (port of ``gb25_tpu.models.config``, the subset the
flagship and coupled-climate steps use)."""

from __future__ import annotations

import dataclasses

import torch

from gb25_tpu_torch.models.catke import CATKEVerticalDiffusivity
from gb25_tpu_torch.models.keps import TKEDissipationVerticalDiffusivity
from gb25_tpu_torch.ops.eos import LinearEquationOfState, TEOS10EquationOfState

EARTH_ROTATION_RATE = 7.292115e-5  # rad/s

KERNEL_MODES = ("auto", "torch", "pallas")
MOMENTUM_ADVECTION = ("weno_vector_invariant", "vector_invariant", "none")
TRACER_ADVECTION = ("weno5", "centered2", "upwind1", "none")
KE_SCHEMES = ("hollingsworth", "standard")
# the tracers that carry the buoyancy: T and S through the equation of
# state, or b itself (the reference's BuoyancyTracer)
BUOYANCY_TRACERS = (("T", "S"), ("b",))

# compute_dtype -> what the array tendency path computes in; "bf16s"
# (bf16 storage, f32 arithmetic) runs K1's bf16-storage instance and
# "float32" K1's unfused float32 instance instead. "bf16x2" is the JAX
# package's paired-bfloat16 limbs (ops/multifloat.py): ``TwoFloat``
# values. "f32x2" is its double-single arithmetic: the port computes it in
# native float64, which the H100 has (a deviation, ROADMAP.md section 3).
# On the "pallas" route "float32", "bfloat16" and "float64" run K6 on
# copies in that dtype (``K6_COMPUTE_DTYPES``); "f32x2" and "bf16x2" run
# the array path, as the JAX package's ``not multifloat`` guards send them.
ARRAY_COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float64": torch.float64,
                        "f32x2": torch.float64, "bf16x2": "bf16x2"}
K6_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                     "float64": torch.float64}
COMPUTE_DTYPES = (None, "float32", "bf16s", *ARRAY_COMPUTE_DTYPES)
# what the JAX package's run scripts make of --target-float-type f16, f8E5M2
# and f8E4M3: it runs them, and they go non-finite within 2 steps
NONFINITE_COMPUTE_DTYPES = ("float16", "float8_e5m2", "float8_e4m3")


@dataclasses.dataclass(frozen=True)
class ExplicitFreeSurface:
    """Forward free surface stepped with the model's AB2 step: the
    barotropic pressure gradient joins the momentum tendencies and
    G_eta = -div(U, V) the free surface's."""

    gravitational_acceleration: float = 9.80665


@dataclasses.dataclass(frozen=True)
class VerticalScalarDiffusivity:
    """Constant vertical viscosity ``nu`` and tracer diffusivity ``kappa``
    (m^2/s), solved vertically implicitly after the barotropic correction
    (the reference model's own closure)."""

    nu: float = 1.0e-4
    kappa: float = 1.0e-5


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

    ``closure``: None, ``VerticalScalarDiffusivity``,
    ``CATKEVerticalDiffusivity`` or ``TKEDissipationVerticalDiffusivity``
    (k-epsilon); ``tracers`` is ("T", "S") with the equation of state
    ``eos`` (TEOS-10 or linear), or ("b",), the buoyancy itself, then "e"
    with CATKE, "e", "eps" with k-epsilon (the reference picks the tracers
    from the buoyancy's type). ``free_surface``: ``SplitExplicitFreeSurface``
    or ``ExplicitFreeSurface``. ``momentum_advection``: WENO
    vector-invariant (the flagship's), the centred vector-invariant form,
    or "none" (q = f, no kinetic energy, no vertical advection: Coriolis
    and the pressure gradient alone); ``tracer_advection``: WENO-5, the
    second-order centred or first-order upwind flux, or "none" (G = 0);
    ``ke_scheme``: the Hollingsworth-corrected kinetic energy or the plain
    C-grid ("standard") one. Each K1 and K6 instance has a variant that
    reads these choices at run time; the flagship's schemes keep their
    instances compiled for them.

    ``compute_dtype``: None (the state's precision, the fused form),
    "float32" (K1's unfused float32 instance; on a state of another dtype
    the stage reads float32 copies of the fields and the grid), "bfloat16",
    "float64" or "f32x2" (the tendency stage runs the array path on copies
    of the fields, f and the grid in that dtype, native float64 for
    "f32x2"), "bf16x2" (the array path on paired-bfloat16 limbs of the
    fields, f and the grid, ``ops.multifloat``), or "bf16s" (K1 reads u, v,
    the tracers and b rounded to bfloat16 and computes in float32). On the
    "pallas" route "float32", "bfloat16" and "float64" run K6 on copies of
    the fields, f and the grid in that dtype (K6's bfloat16 instance
    computes in float32 and rounds its outputs to bfloat16; its float64
    instance computes in float64), "f32x2" and "bf16x2" the array path, and
    "bf16s" is refused, as in the JAX package. The state and its update
    stay in the storage precision, and the AB2 update is unfused; a
    closure's diffusivities (K4) read the state-precision fields and their
    own buoyancy, as the JAX package's closure does. "float16" and the
    float8 modes are not ported (they go non-finite in the JAX package:
    ROADMAP.md section 1, "Not to port")."""

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
    compute_dtype: str | None = None

    def __post_init__(self):
        if self.kernels not in KERNEL_MODES:
            raise ValueError(f"kernels must be one of {KERNEL_MODES}, got {self.kernels!r}")
        if not isinstance(self.free_surface, (SplitExplicitFreeSurface, ExplicitFreeSurface)):
            raise ValueError(f"unsupported free surface {self.free_surface!r}")
        self._check_compute_dtype()
        for name, value, allowed in (("momentum_advection", self.momentum_advection,
                                      MOMENTUM_ADVECTION),
                                     ("tracer_advection", self.tracer_advection, TRACER_ADVECTION),
                                     ("ke_scheme", self.ke_scheme, KE_SCHEMES)):
            if value not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, got {value!r}")
        if not isinstance(self.eos, (TEOS10EquationOfState, LinearEquationOfState)):
            raise ValueError(f"unsupported equation of state {self.eos!r}")
        if self.closure is None or isinstance(self.closure, VerticalScalarDiffusivity):
            extra = ()
        elif isinstance(self.closure, (CATKEVerticalDiffusivity,
                                       TKEDissipationVerticalDiffusivity)):
            extra = self.closure.tracer_names
        else:
            raise ValueError(f"unsupported closure {self.closure!r}")
        allowed = [(*b, *extra) for b in BUOYANCY_TRACERS]
        if tuple(self.tracers) not in allowed:
            raise ValueError(f"tracers {tuple(self.tracers)} with closure {self.closure!r}: "
                             f"the port runs one of {allowed}")

    def _check_compute_dtype(self):
        cd = self.compute_dtype
        if cd in NONFINITE_COMPUTE_DTYPES:
            raise NotImplementedError(
                f"compute_dtype={cd!r} is not ported: in the JAX package this mode goes "
                "non-finite within 2 steps (ROADMAP.md section 1, 'Not to port')")
        if cd not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, got {cd!r}")
        if cd is None:
            return
        if self.kernels == "pallas" and cd == "bf16s":
            raise ValueError("compute_dtype='bf16s' (bf16 storage, f32 compute) is a mode of "
                             "kernel K1: run it with kernels 'auto' or 'torch'; for the array "
                             "path use compute_dtype='bfloat16'")

    @property
    def g(self):
        return self.free_surface.gravitational_acceleration

    @property
    def fused(self) -> bool:
        """Whether K1 fuses the AB2 update, the wall row and the depth
        integrals (the JAX package's rule): with neither a compute_dtype
        nor the explicit free surface, off the "pallas" route."""
        return (self.kernels != "pallas" and self.compute_dtype is None
                and isinstance(self.free_surface, SplitExplicitFreeSurface))

    @property
    def scheme_codes(self) -> tuple:
        """The schemes as the kernels' codes (csrc/tendency_tile.cuh): the
        index of each in MOMENTUM_ADVECTION, KE_SCHEMES and
        TRACER_ADVECTION."""
        return (MOMENTUM_ADVECTION.index(self.momentum_advection),
                KE_SCHEMES.index(self.ke_scheme), TRACER_ADVECTION.index(self.tracer_advection))

    @property
    def array_dtype(self):
        """What the array tendency path computes in: a torch dtype, or
        "bf16x2" (limbs); None for K1, or K6 on the "pallas" route."""
        if self.kernels == "pallas" and self.compute_dtype in K6_COMPUTE_DTYPES:
            return None
        return ARRAY_COMPUTE_DTYPES.get(self.compute_dtype)
