"""Convert NetCDF datasets (ETOPO1, ECCO4, JRA55) to the ``.npz`` contracts
of ``gb25_tpu_torch.data.datasets`` (port of the JAX package's
``scripts/convert_datasets.py``), through the port's own NetCDF reader
(``data.netcdf``). The run scripts read ``.nc`` paths too; converting once
spares parsing a large file at every run.

    python -m gb25_tpu_torch.scripts.convert_datasets etopo1 ETOPO1.nc -o bathymetry.npz
    python -m gb25_tpu_torch.scripts.convert_datasets ecco THETA.nc -s SALT.nc -o climatology.npz
    python -m gb25_tpu_torch.scripts.convert_datasets jra55 jra55.nc -o atmosphere.npz
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    """Convert one file; returns the output path."""
    from gb25_tpu_torch.data.netcdf import (
        load_atmosphere_nc,
        load_bathymetry_nc,
        load_climatology_nc,
    )

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("kind", choices=["etopo1", "ecco", "jra55"])
    p.add_argument("path")
    p.add_argument("-s", "--salinity", default=None, help="separate salinity file (ecco)")
    p.add_argument("-o", "--out", required=True)
    args = p.parse_args(argv)

    if args.kind == "etopo1":
        lon, lat, z = load_bathymetry_nc(args.path)
        np.savez_compressed(args.out, lon=lon, lat=lat, z=z)
    elif args.kind == "ecco":
        np.savez_compressed(args.out, **load_climatology_nc(args.path,
                                                            salinity_path=args.salinity))
    else:
        np.savez_compressed(args.out, **load_atmosphere_nc(args.path))
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
