"""Eddy statistics of the flagship: baroclinic-instability growth against
linear theory (port of the JAX package's ``scripts/probes/eddy_statistics.py``).

Integrates the flagship long enough for the seed noise to organize into
growing baroclinic eddies, records the volume-mean eddy kinetic energy
EKE(t) after each chunk, fits the exponential window and compares the
growth rate with the Eady estimate from the initial buoyancy field:

    sigma_Eady = 0.31 M^2 / N     (Eady 1949; Vallis, thermal-wind shear M^2 / f)

with N^2 the horizontally averaged db/dz and M^2 the largest |db/dy| at
mid-depth. During the linear phase EKE ~ exp(2 sigma t), so the fitted
slope of log EKE is 2 sigma_fit.

    python -m gb25_tpu_torch.scripts.eddy_statistics --nx 360 --ny 160 --nz 8 \\
        --dt 900 --steps 1920 --chunk 96            # the 1-degree validation run
    python -m gb25_tpu_torch.scripts.eddy_statistics --nx 1536 --ny 768 --nz 64 \\
        --dt 90 --init balanced --noise 1e-5 --steps 960 --chunk 96

Each chunk is one ``loop`` call (replayed from a CUDA graph on the card).
A chunk whose EKE is not finite ends the run; the fit sees the finite
samples. It prints one JSON line: the series, the fit, the Eady estimate,
the steps run and the allocator's byte and peak counters of each card.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def eady_growth_rate(grid, state, eos):
    """(sigma_Eady = 0.31 M^2 / N, M^2, N^2) from the initial T and S: the
    buoyancy in float64 where the state lies, the rest in numpy."""
    import torch

    def f64(t):
        return t.detach().to(torch.float64)

    def host(t):
        return f64(t).cpu().numpy()

    z = f64(grid.z_c_i).reshape(-1, 1, 1)
    b = host(eos.buoyancy(f64(state.tracers["T"]), f64(state.tracers["S"]), z))  # (Nz, Ny, Nx)

    hy, hz = grid.hy, grid.hz
    dz = host(grid.dz_c).reshape(-1)[hz : hz + grid.Nz]
    dy = host(grid.dyc).reshape(-1)[hy : hy + grid.Ny]

    # N^2: the horizontal-mean stratification over the interior z faces
    bz = np.diff(b, axis=0) / (0.5 * (dz[1:] + dz[:-1])).reshape(-1, 1, 1)
    N2 = float(np.mean(bz))
    # M^2: the strongest meridional buoyancy gradient at mid-depth (the front)
    kmid = grid.Nz // 2
    by = np.diff(b[kmid], axis=0) / (0.5 * (dy[1:] + dy[:-1])).reshape(-1, 1)
    M2 = float(np.max(np.abs(by)))
    if N2 <= 0:
        return float("nan"), M2, N2
    return 0.31 * M2 / np.sqrt(N2), M2, N2


def fit_growth(times, eke):
    """Exponential-window fit of the linear phase: log EKE fitted between
    the point where EKE has rebounded to 2x its post-adjustment minimum and
    the point where it reaches 60% of its peak (saturation). Returns
    (sigma_fit, r2, (i0, i1))."""
    eke = np.asarray(eke, np.float64)
    times = np.asarray(times, np.float64)
    imin = int(np.argmin(eke))
    tail = eke[imin:]
    peak = float(tail.max())
    lo, hi = 2.0 * float(eke[imin]), 0.6 * peak
    sel = np.nonzero((np.arange(len(eke)) >= imin) & (eke >= lo) & (eke <= hi))[0]
    if sel.size >= 4:
        i0, i1 = int(sel[0]), int(sel[-1])
    else:  # a degenerate series (no adjustment dip, or too few samples)
        i0, i1 = imin, len(eke) - 1
    if i1 - i0 < 3:
        i0, i1 = 0, len(eke) - 1
    t, y = times[i0 : i1 + 1], np.log(eke[i0 : i1 + 1])
    A = np.stack([t, np.ones_like(t)], axis=1)
    coef, *_ = np.linalg.lstsq(A, y, rcond=None)
    yhat = A @ coef
    ss_res = float(np.sum((y - yhat) ** 2))
    ss_tot = float(np.sum((y - y.mean()) ** 2))
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0
    return float(coef[0]) / 2.0, r2, (i0, i1)  # EKE ~ exp(2 sigma t)


def run(nx, ny, nz, dt, steps, chunk, dtype="float32", seed=42, closure="none", init="front",
        noise=1e-3, device="cuda"):
    """The probe's integration and fit; returns its record."""
    import torch

    from gb25_tpu_torch.grids import simple_latitude_longitude_grid
    from gb25_tpu_torch.models import (
        VerticalScalarDiffusivity,
        balanced_jet_state,
        baroclinic_instability_config,
        baroclinic_instability_state,
        loop,
    )
    from gb25_tpu_torch.models.catke import CATKEVerticalDiffusivity
    from gb25_tpu_torch.utils.diagnostics import eddy_mean_kinetic_energy
    from gb25_tpu_torch.utils.profiling import allocator_stats

    grid = simple_latitude_longitude_grid(nx, ny, nz, device=device,
                                          dtype=getattr(torch, dtype))
    # "none" is the reference's default; long eddy-resolving runs need a
    # vertical closure once the eddies sharpen fronts to the grid scale
    closures = {"none": None, "scalar": VerticalScalarDiffusivity(),
                "catke": CATKEVerticalDiffusivity()}
    cfg = baroclinic_instability_config(closure=closures[closure])
    make = balanced_jet_state if init == "balanced" else baroclinic_instability_state
    kw = {"cfg": cfg} if init == "balanced" else {}
    state = make(grid, noise_velocity=noise, seed=seed, tracers=cfg.tracers, **kw)
    sigma_eady, M2, N2 = eady_growth_rate(grid, state, cfg.eos)

    times, ekes, mkes, steps_run = [], [], [], 0
    for _ in range(steps // chunk):
        state = loop(cfg, grid, state, dt, chunk)
        steps_run = state.iteration
        eke, mke = eddy_mean_kinetic_energy(grid, state)
        times.append(float(state.time))
        ekes.append(float(eke))
        mkes.append(float(mke))
        if not np.isfinite(ekes[-1]):
            break

    # a closure-free run that goes non-finite at saturation leaves one
    # non-finite sample at the end: the fit sees the physical series
    while ekes and not np.isfinite(ekes[-1]):
        times.pop(), ekes.pop(), mkes.pop()
    sigma_fit, r2, window = fit_growth(times, ekes)
    alloc = {k: {kk: vv for kk, vv in v.items() if "bytes" in kk or "peak" in kk}
             for k, v in allocator_stats().items()}
    return {
        "allocator": alloc,
        "nx": nx, "ny": ny, "nz": nz, "dt": dt, "steps": steps, "steps_run": steps_run,
        "times_days": [t / 86400.0 for t in times],
        "eke": ekes, "mke": mkes,
        "sigma_eady_per_s": sigma_eady, "M2": M2, "N2": N2,
        "sigma_fit_per_s": sigma_fit, "fit_r2": r2, "fit_window": window,
        "sigma_ratio": sigma_fit / sigma_eady if sigma_eady else None,
        "eke_growth_factor": (max(ekes) / min(ekes)) if ekes else None,
    }


def main(argv=None):
    """Run the probe and print its JSON line; returns the record."""
    from gb25_tpu_torch.utils.args import device_of

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nx", type=int, default=180)
    p.add_argument("--ny", type=int, default=88)
    p.add_argument("--nz", type=int, default=8)
    p.add_argument("--dt", type=float, default=600.0)
    p.add_argument("--steps", type=int, default=1440)
    p.add_argument("--closure", default="none", choices=["none", "scalar", "catke"])
    p.add_argument("--init", default="front", choices=["front", "balanced"],
                   help="front: the unbalanced T/S front (the reference's); balanced: the "
                        "thermal-wind-balanced jet (no adjustment transient)")
    p.add_argument("--chunk", type=int, default=60)
    p.add_argument("--noise", type=float, default=1e-3, help="seed velocity noise (m/s)")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    out = run(args.nx, args.ny, args.nz, args.dt, args.steps, args.chunk, args.dtype,
              closure=args.closure, init=args.init, noise=args.noise,
              device=device_of(args))
    out["init"] = args.init
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
