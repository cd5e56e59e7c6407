"""Plot one frame of a surface field from the output writers' records
(port of the JAX package's ``scripts/visualize.py``; reference analog:
visualize_ocean_climate_simulation.jl).

    python -m gb25_tpu_torch.scripts.visualize OUTPUT [--field T_surface]
        [--frame -1] [--out T_surface_frame.png]

``OUTPUT`` is an ``NPZOutputWriter`` directory (``io.read_series``) or a
``NetCDFOutputWriter`` ``.nc`` file (``data.netcdf.read_netcdf``); both
hold (x, y) planes, the JAX package's layout, so the same files of either
package plot alike. It writes one PNG with matplotlib's "Agg" backend.
matplotlib is imported inside ``main`` alone: the package imports where it
is not installed.
"""

from __future__ import annotations

import argparse

import numpy as np


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("output_dir", help="NPZ writer directory, or a NetCDF .nc output file")
    p.add_argument("--field", default="T_surface")
    p.add_argument("--frame", type=int, default=-1)
    p.add_argument("--out", default=None, help="the PNG (default <field>_frame.png)")
    return p


def read_frames(path, field):
    """(times in seconds, frames stacked on the first axis) of ``field``."""
    if path.endswith(".nc"):
        from gb25_tpu_torch.data.netcdf import read_netcdf

        v, _, _ = read_netcdf(path)
        return np.asarray(v["time"]), np.asarray(v[field])
    from gb25_tpu_torch.io import read_series

    return read_series(path, field)


def main(argv=None):
    args = parser().parse_args(argv)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    times, data = read_frames(args.output_dir, args.field)
    if data.size == 0:
        raise SystemExit(f"no records for {args.field} in {args.output_dir}")
    frame = data[args.frame]
    fig, ax = plt.subplots(figsize=(10, 5))
    im = ax.imshow(frame.T, origin="lower", aspect="auto", cmap="viridis")
    ax.set_title(f"{args.field} @ t = {times[args.frame] / 86400:.2f} days")
    ax.set_xlabel("i (longitude index)")
    ax.set_ylabel("j (latitude index)")
    fig.colorbar(im, ax=ax)
    out = args.out or f"{args.field}_frame.png"
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
