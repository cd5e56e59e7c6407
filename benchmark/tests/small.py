"""Cells cut to a grid that a CPU test run holds: the flagship at 32x16x6,
the production run at 12 degrees (30x14) with 6 levels."""

from benchmark import spec


def small_cell(name):
    cell = spec.Cell(spec.benchmark(), name)
    c = cell.config
    if "constructor" in c["program"]:
        c.update(Nx=32, Ny=16, Nz=6)
        c["program"]["args"] = [32, 16, 6]
    else:
        c.update(Nx=30, Ny=14, Nz=6)
        argv = c["program"]["argv"]
        argv[argv.index("--resolution") + 1] = "12"
        argv[argv.index("--Nz") + 1] = "6"
    return cell
