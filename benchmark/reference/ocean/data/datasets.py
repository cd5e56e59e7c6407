"""The climatology inputs of the production run as plain PyTorch (a frozen
copy of the port's ``data/datasets.py``, its synthetic climatology alone):
T/S restoring under the linearly tapered polar mask and the ocean at rest
initialized from the climatology.
"""

from __future__ import annotations

import numpy as np
import torch

def _dst_coords(grid):
    """The ocean centers' (longitude, latitude), (Nx, Ny) numpy arrays in the
    grid's dtype: the 2-D centers of a tripolar grid, else the lat-lon
    product."""
    if grid.north_fold:
        return (np.transpose(grid.lam2_c.cpu().numpy()),
                np.transpose(grid.phi2_c.cpu().numpy()))
    lam = grid.lam_c_i.cpu().numpy()[:, None]
    phi = grid.phi_c_i.cpu().numpy()[None, :]
    return (np.broadcast_to(lam, (grid.Nx, grid.Ny)),
            np.broadcast_to(phi, (grid.Nx, grid.Ny)))


def _to_port(a, grid):
    """A JAX-layout numpy array ((Nx, Ny) or (Nx, Ny, Nz)) as a port tensor
    ((Y, X) or (Z, Y, X)) in the grid's dtype on its device."""
    a = np.asarray(a).astype(np.dtype(str(grid.dtype).removeprefix("torch.")))
    return torch.as_tensor(np.ascontiguousarray(np.transpose(a)), device=grid.device)


def linearly_tapered_polar_mask(grid, southern=(-80.0, -70.0), northern=(70.0, 90.0)):
    """The restoring rate's mask, ramping 0 -> 1 into the polar caps (the
    reference's LinearlyTaperedPolarMask): a (1, Ny, Nx) tensor."""
    _, phi = _dst_coords(grid)
    s0, s1 = southern
    n0, n1 = northern
    south = np.clip((s1 - phi) / max(s1 - s0, 1e-9), 0.0, 1.0)
    north = np.clip((phi - n0) / max(n1 - n0, 1e-9), 0.0, 1.0)
    return _to_port(np.maximum(south, north), grid)[None]


def climatology_restoring(grid, rate=1.0 / (7 * 86400.0)):
    """The ``restoring`` dict of the ocean step: T and S relaxed toward the
    synthetic climatology at ``rate`` under the polar mask: {"T": (target,
    rate mask), "S": (...)}, targets (Nz, Ny, Nx), the rate (1, Ny, Nx)."""
    dlon, dlat = _dst_coords(grid)
    zc = grid.z_c_i.cpu().numpy()
    # an analytic stand-in with a realistic structure
    phi3 = dlat[:, :, None]
    z3 = zc[None, None, :]
    Tg = (2.0 + 26.0 * np.cos(np.deg2rad(phi3)) ** 2) * np.exp(z3 / 1000.0) + 2.0
    Sg = 35.0 - 1.5 * np.exp(z3 / 500.0) * np.cos(np.deg2rad(phi3))
    r = rate * linearly_tapered_polar_mask(grid)
    return {"T": (_to_port(Tg, grid), r), "S": (_to_port(Sg, grid), r)}


def initial_state_from_climatology(grid, cfg):
    """An ocean at rest with T and S from the synthetic climatology, a
    closure's e = 1e-6 and eps = 1e-9."""
    from benchmark.reference.ocean.models.state import initial_state

    rest = climatology_restoring(grid, rate=0.0)
    st = initial_state(grid, cfg.tracers)
    tr = dict(st.tracers)
    tr["T"] = rest["T"][0]
    tr["S"] = rest["S"][0]
    if "e" in tr:
        tr["e"] = torch.full(grid.shape, 1e-6, dtype=grid.dtype, device=grid.device)
    if "eps" in tr:
        tr["eps"] = torch.full(grid.shape, 1e-9, dtype=grid.dtype, device=grid.device)
    return st.replace(tracers=tr)
