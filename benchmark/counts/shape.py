"""The configuration's shapes as the counts read them, the card's peaks and
the roofline bound."""

from __future__ import annotations

import dataclasses

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOP_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
F64_FLOP_PER_S = 34e12     # H100 SXM float64 outside the tensor cores


@dataclasses.dataclass(frozen=True)
class Shape:
    """What a count needs of a configuration: the interior sizes, the halo,
    the grid's kind, the tracers, the schemes, the equation of state
    ("teos10" or "linear") and the closure (None or "catke")."""

    Nx: int
    Ny: int
    Nz: int
    halo: tuple = (4, 4, 4)
    north_fold: bool = False
    immersed: bool = False
    tracers: tuple = ("T", "S")
    momentum_advection: str = "weno_vector_invariant"
    tracer_advection: str = "weno5"
    ke_scheme: str = "hollingsworth"
    eos: str = "teos10"
    closure: str | None = None
    substeps: int = 30
    atmosphere_planes: int = 0  # planes of the prescribed atmosphere read a step
    ice_planes: int = 0         # prognostic sea-ice planes
    restored: tuple = ()        # tracers relaxed toward a 3-D target

    @classmethod
    def of(cls, config):
        """The ``Shape`` of a configuration file's dict."""
        return cls(Nx=config["Nx"], Ny=config["Ny"], Nz=config["Nz"],
                   halo=tuple(config["halo"]), north_fold=config["grid"] == "tripolar",
                   immersed=bool(config["immersed"]), tracers=tuple(config["tracers"]),
                   momentum_advection=config["momentum_advection"],
                   tracer_advection=config["tracer_advection"], ke_scheme=config["ke_scheme"],
                   eos=config["eos"], closure=config.get("closure"),
                   substeps=config["substeps"],
                   atmosphere_planes=config.get("atmosphere_planes", 0),
                   ice_planes=config.get("ice_planes", 0),
                   restored=tuple(config.get("restored", ())))

    @property
    def cells(self) -> int:
        return self.Nx * self.Ny * self.Nz


def sizes(shape):
    """Bytes of one interior field, one extended field, one interior plane
    and one extended plane in float32."""
    hx, hy, hz = shape.halo
    ext_plane = (shape.Ny + 2 * hy) * (shape.Nx + 2 * hx) * 4
    return (shape.Nx * shape.Ny * shape.Nz * 4, (shape.Nz + 2 * hz) * ext_plane,
            shape.Nx * shape.Ny * 4, ext_plane)


def bound(nbytes, flops, flop_rate=None):
    """(bound_ms, bound_by): the least time for ``nbytes`` of compulsory
    traffic and ``flops`` operations at ``flop_rate`` (float32's by
    default)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / (flop_rate or F32_FLOP_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
