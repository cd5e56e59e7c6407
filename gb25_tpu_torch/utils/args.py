"""The flagship scripts' argument surface (port of ``gb25_tpu.utils.args``).

The reference's ``--grid-x/-y/-z`` (``--Nx`` aliases), ``--resolution``,
``--float-type``, ``--target-float-type`` and ``--limbs`` with the JAX
package's defaults; ``build_config`` yields the config the JAX package's
does, with the same ``compute_dtype`` strings ("bfloat16", "float32",
"float16", "float8_e5m2", "float8_e4m3", "bf16s", "f32x2", "bf16x2"),
which the port's ``HydrostaticConfig`` runs or refuses (float16 and float8:
they go non-finite in the JAX package; "bf16x2": ROADMAP.md item 14).

``--kernels`` keeps the JAX package's four choices and maps them onto the
port's routes: "auto" and "zslab" (the fused tendency kernel K1 and the
barotropic loop K2) to "auto", "pallas" (K6 and the blocked solve K5) to
"pallas", "jnp" (the array code) to "torch" (the kernels' plain
versions). ``--device`` (the port's) is "cuda" unless "cpu" is asked for;
``device_of`` refuses "cuda" on a machine without a card.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

_FLOAT_TYPES = {
    "f64": torch.float64,
    "f32": torch.float32,
    "f16": torch.float16,
    "bf16": torch.bfloat16,
}
_TARGET_TYPES = dict(_FLOAT_TYPES)
_TARGET_TYPES.update({
    "f8E5M2": torch.float8_e5m2,
    "f8E4M3": torch.float8_e4m3fn,
})
# the JAX package's compute_dtype string of each --target-float-type (its
# str(jnp.dtype(...)); jnp.float8_e4m3 is torch's float8_e4m3fn)
_COMPUTE_DTYPE_NAMES = {
    "f64": "float64", "f32": "float32", "f16": "float16", "bf16": "bfloat16",
    "f8E5M2": "float8_e5m2", "f8E4M3": "float8_e4m3",
}
KERNEL_ROUTES = {"auto": "auto", "zslab": "auto", "pallas": "pallas", "jnp": "torch"}


def float_type(name: str):
    """The state dtype of ``--float-type`` (float64 needs no global switch
    in torch)."""
    try:
        return _FLOAT_TYPES[name]
    except KeyError:
        raise SystemExit(f"unknown float type {name!r}; choose from {list(_FLOAT_TYPES)}")


def target_float_type(name: str):
    try:
        return _TARGET_TYPES[name]
    except KeyError:
        raise SystemExit(f"unknown target float type {name!r}")


def benchmark_parser(description="gb25_tpu_torch simulation") -> argparse.ArgumentParser:
    """The reference's parse_baroclinic_instability_args, with the JAX
    package's flags and defaults and the port's ``--device``."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--grid-x", "--Nx", dest="Nx", type=int, default=None,
                   help="global grid points in x")
    p.add_argument("--grid-y", "--Ny", dest="Ny", type=int, default=None)
    p.add_argument("--grid-z", "--Nz", dest="Nz", type=int, default=20)
    p.add_argument("--resolution", type=float, default=None,
                   help="degrees; Nx=384/res, Ny=192/res (reference policy)")
    p.add_argument("--float-type", default="f32", choices=list(_FLOAT_TYPES))
    p.add_argument("--target-float-type", default=None,
                   help="lowered compute dtype (f32, bf16, f64; f16 and f8 are refused); "
                        "'bf16s' = bf16 storage, f32 arithmetic in K1")
    p.add_argument("--limbs", type=int, default=1, choices=[1, 2],
                   help="limbs=2 with --target-float-type f32 runs the tendencies in "
                        "float64 (the JAX package's double-single f32x2); with bf16 in "
                        "paired-bfloat16 limbs (bf16x2, as the JAX package)")
    p.add_argument("--dt", type=float, default=60.0)
    p.add_argument("--steps", type=int, default=256,
                   help="steps per loop (reference benchmarks use 256)")
    p.add_argument("--free-surface", default="split_explicit",
                   choices=["split_explicit", "explicit"])
    p.add_argument("--substeps", type=int, default=30)
    p.add_argument("--closure", default="none",
                   choices=["none", "vertical_scalar", "catke"])
    p.add_argument("--kernels", default="auto", choices=list(KERNEL_ROUTES),
                   help="the JAX package's tendency routes, mapped onto the port's: "
                        "auto, zslab -> auto (K1, K2); pallas -> pallas (K6, K5); "
                        "jnp -> torch (the plain versions)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace to this directory")
    p.add_argument("--output-dir", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def device_of(args) -> torch.device:
    """``args.device``; "cuda" without a card raises (no run falls back to
    the CPU)."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    return device


def check_mesh(mesh, args):
    """``mesh``, where ``--n-devices`` (if given) is its number of ranks."""
    n = getattr(args, "n_devices", None)
    if n is not None and n != mesh.size:
        raise ValueError(f"--n-devices {n} but the group has {mesh.size} ranks")
    return mesh


def resolve_grid_size(args):
    from gb25_tpu_torch.grids import resolution_to_points

    if args.Nx is None or args.Ny is None:
        res = args.resolution or 2.0
        nx, ny = resolution_to_points(res)
        return (args.Nx or nx, args.Ny or ny, args.Nz)
    return (args.Nx, args.Ny, args.Nz)


def build_config(args):
    """The flagship config of ``args``: the free surface (split explicit
    with ``--substeps``, or explicit), the closure (vertical scalar with
    nu = 1e-4, kappa = 1e-5, or CATKE), the compute dtype of
    ``--target-float-type`` and ``--limbs`` (the JAX package's strings)
    and the kernel route. The port's config raises on what it does not
    run."""
    from gb25_tpu_torch.models import (
        ExplicitFreeSurface,
        SplitExplicitFreeSurface,
        VerticalScalarDiffusivity,
        baroclinic_instability_config,
    )
    from gb25_tpu_torch.models.catke import CATKEVerticalDiffusivity

    fs = (SplitExplicitFreeSurface(substeps=args.substeps)
          if args.free_surface == "split_explicit" else ExplicitFreeSurface())
    closure = None
    if args.closure == "vertical_scalar":
        closure = VerticalScalarDiffusivity(nu=1e-4, kappa=1e-5)
    elif args.closure == "catke":
        closure = CATKEVerticalDiffusivity()
    compute_dtype = None
    target = getattr(args, "target_float_type", None)
    if getattr(args, "limbs", 1) == 2:
        base = target or "f32"
        if base not in ("f32", "bf16"):
            raise SystemExit("--limbs 2 supports --target-float-type f32/bf16")
        compute_dtype = {"f32": "f32x2", "bf16": "bf16x2"}[base]
    elif target == "bf16s":
        compute_dtype = "bf16s"
    elif target is not None:
        target_float_type(target)
        compute_dtype = _COMPUTE_DTYPE_NAMES[target]
    cfg = baroclinic_instability_config(
        kernels=KERNEL_ROUTES[getattr(args, "kernels", "auto")], free_surface=fs,
        closure=closure)
    if compute_dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    return cfg
