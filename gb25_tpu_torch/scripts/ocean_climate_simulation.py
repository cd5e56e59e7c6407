"""The full ocean-climate simulation (port of the JAX package's
``scripts/ocean_climate_simulation.py``, the reference's
ocean_climate_simulation.jl): a tripolar (360/res x 170/res x Nz) or
lat-lon grid, regridded bathymetry or the Gaussian islands, T/S restoring
to a climatology under a polar taper at 1/(7 days), initialization from
the climatology, a prescribed atmosphere, ``Simulation`` with progress
every 10 iterations and a surface writer every 3 days (NPZ or NetCDF);
``--sea-ice slab`` adds the prognostic slab ice.

    python -m gb25_tpu_torch.scripts.ocean_climate_simulation --resolution 0.25 --Nz 64 \\
        --grid tripolar --dt 60 --sea-ice slab --output-format netcdf

Without dataset files the synthetic climatology and the data-free
atmosphere stand in. The climate loop is ``coupled_loop`` (or
``coupled_ice_loop``) with the restoring, in chunks of 10 steps each
replayed on the card from a CUDA graph (``models.device_loop``);
``--device cpu`` runs it from the host.
"""

from __future__ import annotations

import argparse
import logging
import os

import torch

INNER_STEPS = 10  # the chunk: progress every 10 iterations


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--resolution", type=float, default=2.0)
    p.add_argument("--Nz", type=int, default=20)
    p.add_argument("--dt", type=float, default=1200.0, help="20 min at 2 degrees")
    p.add_argument("--stop-days", type=float, default=1.0)
    p.add_argument("--grid", default="latlon", choices=["latlon", "tripolar"])
    p.add_argument("--bathymetry", default=None, help="bathymetry.npz or .nc (ETOPO-style)")
    p.add_argument("--climatology", default=None, help="climatology.npz or .nc (ECCO-style)")
    p.add_argument("--atmosphere", default=None, help="atmosphere.npz or .nc (JRA55-style)")
    p.add_argument("--no-pre-regrid", action="store_true",
                   help="keep the --atmosphere record on its own grid and gather onto the "
                        "ocean at each step (records too large to hold at ocean resolution)")
    p.add_argument("--sea-ice", default="freezing_limited", choices=["freezing_limited", "slab"],
                   help="freezing_limited: the reference's implicit default; slab: prognostic "
                        "zero-layer thermodynamic ice with free drift (models/seaice.py)")
    p.add_argument("--output-dir", default="climate_output")
    p.add_argument("--output-format", default="npz", choices=["npz", "netcdf"],
                   help="netcdf: one classic .nc file with an unlimited time axis")
    p.add_argument("--float-type", default="f32")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def build(args):
    """(ccfg, grid, state, ice, atmos, restoring) of the run ``args``
    describe; ``ice`` None without the slab ice."""
    from gb25_tpu_torch.data import (
        climatology_restoring,
        file_prescribed_atmosphere,
        initial_state_from_climatology,
        regrid_bathymetry,
    )
    from gb25_tpu_torch.grids import simple_latitude_longitude_grid
    from gb25_tpu_torch.grids.immersed import gaussian_islands_bottom
    from gb25_tpu_torch.grids.tripolar import tripolar_grid
    from gb25_tpu_torch.models import baroclinic_instability_config
    from gb25_tpu_torch.models.atmosphere import data_free_atmosphere
    from gb25_tpu_torch.models.catke import CATKEVerticalDiffusivity
    from gb25_tpu_torch.models.coupled import CoupledConfig
    from gb25_tpu_torch.models.seaice import SlabSeaIce, initial_ice_state

    dtype = {"f32": torch.float32, "f64": torch.float64}[args.float_type]
    Nx, Ny = int(360 / args.resolution), int(170 / args.resolution)
    make = tripolar_grid if args.grid == "tripolar" else simple_latitude_longitude_grid
    grid = make(Nx, Ny, args.Nz, device=args.device, dtype=dtype)
    if args.bathymetry:
        grid = regrid_bathymetry(grid, args.bathymetry)
    else:
        grid = gaussian_islands_bottom(grid)

    ocean_cfg = baroclinic_instability_config(closure=CATKEVerticalDiffusivity())
    ice = None
    if args.sea_ice == "slab":
        ccfg = CoupledConfig(ocean=ocean_cfg, sea_ice=SlabSeaIce())
        ice = initial_ice_state(grid)
    else:
        ccfg = CoupledConfig(ocean=ocean_cfg)
    state = initial_state_from_climatology(grid, ocean_cfg, path=args.climatology)
    restoring = climatology_restoring(grid, path=args.climatology)
    if args.atmosphere:
        atmos = file_prescribed_atmosphere(grid, args.atmosphere,
                                           pre_regrid=not args.no_pre_regrid)
    else:
        atmos = data_free_atmosphere(grid, dtype=dtype)
    return ccfg, grid, state, ice, atmos, restoring


def simulation(args, ccfg, grid, state, ice, atmos, restoring):
    """The ``Simulation`` of the climate loop with its progress callback and
    surface writer; (sim, writer, holder), ``holder["ice"]`` the ice state
    as the run leaves it (it rides beside the ocean state the driver
    carries)."""
    from gb25_tpu_torch.io import NPZOutputWriter
    from gb25_tpu_torch.io.output import NetCDFOutputWriter
    from gb25_tpu_torch.models.coupled import coupled_ice_loop, coupled_loop
    from gb25_tpu_torch.simulation import IterationInterval, Simulation, progress_callback

    holder = {"ice": ice}
    if ice is not None:
        def step_fn(cfg_unused, grid_, s, dt, n):
            s, holder["ice"] = coupled_ice_loop(ccfg, grid_, atmos, s, holder["ice"], dt, n,
                                                restoring=restoring, chunk=INNER_STEPS)
            return s
    else:
        def step_fn(cfg_unused, grid_, s, dt, n):
            return coupled_loop(ccfg, grid_, atmos, s, dt, n, restoring=restoring,
                                chunk=INNER_STEPS)

    sim = Simulation(ccfg.ocean, grid, state, dt=args.dt, stop_time=args.stop_days * 86400.0,
                     inner_steps=INNER_STEPS, step_fn=step_fn)
    sim.add_callback(progress_callback, IterationInterval(10))
    if args.output_format == "netcdf":
        writer = NetCDFOutputWriter(os.path.join(args.output_dir, "surface.nc"), grid,
                                    interval_seconds=3 * 86400.0)
    else:
        writer = NPZOutputWriter(args.output_dir, interval_seconds=3 * 86400.0)
    sim.add_output_writer(writer)
    return sim, writer, holder


def main(argv=None):
    """Run the simulation; returns (sim, run) for a caller in the same
    process, ``run`` the model's parts: "ccfg", "atmos", "restoring" and
    "ice" (the ice state as the run leaves it, or None)."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    ccfg, grid, state, ice, atmos, restoring = build(args)
    sim, writer, holder = simulation(args, ccfg, grid, state, ice, atmos, restoring)
    sim.run()
    if args.output_format == "netcdf":
        writer.close()
    ice = holder["ice"]
    if ice is not None:
        vmax = float(ice.v.max())
        cover = float((ice.a > 0.15).to(torch.float64).mean())
        print(f"sea ice: max volume {vmax:.3f} m, cover(a>0.15) {100.0 * cover:.1f}% of cells")
    print(f"done: iteration={sim.iteration} t={sim.time / 86400:.2f} days "
          f"wall={sim.run_wall_time:.1f}s")
    return sim, {"ccfg": ccfg, "atmos": atmos, "restoring": restoring, "ice": ice}


if __name__ == "__main__":
    main()
