"""The decomposed step (port of ``gb25_tpu.parallel.sharded``).

Each process of a ``torch.distributed`` group holds one tile of the
(Rx, Ry) mesh: its own slice of the state, the window of the grid metrics
around it (``parallel.localize``) and a ``MeshComm`` for its halo
exchanges. ``sharded_step_fn`` / ``sharded_coupled_step_fn`` return this
rank's ``fn(state_tile, dt)``, which runs ``n_inner`` steps of the same
physics code the serial path runs, the comm threaded through. A mesh of
several ranks runs them from the host; where the mesh is the one card the
loop is replayed from a CUDA graph (``models.device_loop``), which lives in
the tile grid's cache: ``fn`` builds that grid once, so run the untimed and
the timed loops through one ``fn`` (``fn(state, dt, n)`` runs another
count on the same tile; ``fn.step`` is the tile's one step, for a loop
launched from the host, ``fn.grid`` the tile's grid and ``fn.comm`` its
exchange, None on the serial route).

A 1x1 mesh takes the serial route (``comm=None``: kernel K2, no
exchanges) unless ``force_comm`` keeps the decomposed program on one
device, to measure it there: ``"ring"`` runs the exchange structure (each
exchange a copy of the tile's own strips), ``"local"`` fills the ghosts
from the boundary conditions with no exchange at all. Both compute what a
tile of a real decomposition computes: localize, width-W extensions, the
blocked barotropic solve (K5); neither calls ``torch.distributed``, so on
the card their loops are replayed as the serial loops are.
``run_decomposed_sw`` runs the shallow-water model the same way.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.distributed as dist

from gb25_tpu_torch.convert import (
    state_from_numpy,
    state_to_numpy,
    sw_state_from_numpy,
    sw_state_to_numpy,
)
from gb25_tpu_torch.parallel.halo import make_comm
from gb25_tpu_torch.parallel.localize import localize_atmosphere, localize_grid

FORCE_COMM_MODES = (False, "ring", "local")


def _tile(grid, mesh, force_comm):
    """(comm, local grid) of this rank; comm None on the serial route."""
    if force_comm not in FORCE_COMM_MODES:
        raise ValueError(f"force_comm must be one of {FORCE_COMM_MODES}, got {force_comm!r}")
    if grid.Nx % mesh.Rx or grid.Ny % mesh.Ry:
        raise ValueError(f"grid {grid.Nx}x{grid.Ny} not divisible by mesh {mesh.Rx}x{mesh.Ry}")
    if mesh.size == 1 and not force_comm:
        return None, grid
    comm = make_comm(mesh, grid, force_ring=mesh.size == 1 and force_comm == "ring")
    return comm, localize_grid(grid, comm, grid.Nx // mesh.Rx, grid.Ny // mesh.Ry)


def sharded_step_fn(cfg, grid, mesh, n_inner: int | None = None, force_comm=False,
                    restoring=None):
    """This rank's ``fn(state_tile, dt, n=n_inner) -> state_tile``: one
    step, or ``n`` steps (the immersed mask applied once), of the model on
    ``grid`` (the global grid) decomposed over ``mesh``. ``fn.step(state,
    dt=dt)`` is the tile's one step on a premasked state, the step its loop
    runs, and ``fn.grid`` the tile's grid. ``restoring``: the global
    {tracer: (target, rate)} dict, each target and rate cut to the tile's
    interior (``localize_restoring``), as the JAX package shards them."""
    from gb25_tpu_torch.models.hydrostatic import time_step

    comm, lgrid = _tile(grid, mesh, force_comm)
    return _tile_fn(functools.partial(time_step, cfg, lgrid, premasked=True, comm=comm,
                                      restoring=localize_restoring(restoring, mesh, lgrid)),
                    lgrid, comm, n_inner)


def sharded_coupled_step_fn(ccfg, grid, atmos, mesh, n_inner: int | None = None,
                            force_comm=False, restoring=None):
    """This rank's coupled ``fn(state_tile, dt, n=n_inner) ->
    state_tile``, the atmosphere and ``restoring`` cut to the tile;
    ``fn.step`` and ``fn.grid`` as ``sharded_step_fn``'s."""
    from gb25_tpu_torch.models.coupled import coupled_time_step

    comm, lgrid = _tile(grid, mesh, force_comm)
    if comm is not None:
        atmos = localize_atmosphere(atmos, comm, lgrid.Nx, lgrid.Ny)
    return _tile_fn(functools.partial(coupled_time_step, ccfg, lgrid, atmos, premasked=True,
                                      comm=comm,
                                      restoring=localize_restoring(restoring, mesh, lgrid)),
                    lgrid, comm, n_inner)


def localize_restoring(restoring, mesh, lgrid):
    """The restoring dict of this rank's tile of ``lgrid``'s size: every
    target and rate (interior fields, or (1, Ny, Nx) planes) cut to the
    tile; None stays None."""
    if restoring is None:
        return None
    y0, x0 = mesh.iy * lgrid.Ny, mesh.ix * lgrid.Nx

    def cut(a):
        return a[..., y0 : y0 + lgrid.Ny, x0 : x0 + lgrid.Nx].contiguous()

    return {name: (cut(target), cut(rate)) for name, (target, rate) in restoring.items()}


def _tile_fn(step, lgrid, comm, n_inner):
    """``fn`` of a tile's ``step`` (a partial over all but the state and
    dt) on its grid ``lgrid``: the immersed mask applied once, then one
    step or a loop of ``n`` (``models.device_loop.run_loop``)."""
    from gb25_tpu_torch.models.device_loop import run_loop
    from gb25_tpu_torch.models.hydrostatic import premask_state

    def fn(state, dt, n=n_inner):
        state = premask_state(lgrid, state)
        if n is None:
            return step(state, dt=dt)
        return run_loop(functools.partial(step, dt=dt), state, n, comm, lgrid.cache)

    fn.step, fn.grid, fn.comm = step, lgrid, comm
    return fn


def _map_fields(state, f):
    """``state`` (hydrostatic or shallow-water) with ``f`` applied to every
    3-D and 2-D field; the 0-d clock is left as it is."""
    kw = {}
    for field in dataclasses.fields(state):
        v = getattr(state, field.name)
        if torch.is_tensor(v) and v.dim() >= 2:
            kw[field.name] = f(v)
        elif isinstance(v, dict):
            kw[field.name] = {k: f(c) for k, c in v.items()}
    return state.replace(**kw)


def shard_state(state, mesh):
    """This rank's tile of a global state (the clock is replicated)."""
    Ny, Nx = state.u.shape[-2:]
    nyl, nxl = Ny // mesh.Ry, Nx // mesh.Rx
    y0, x0 = mesh.iy * nyl, mesh.ix * nxl
    return _map_fields(state, lambda a: a[..., y0 : y0 + nyl, x0 : x0 + nxl].contiguous())


def gather_state(state, mesh):
    """The global state from every rank's tile, on every rank (one
    all-gather per field)."""
    if mesh.size == 1:
        return state

    def gather(a):
        tiles = [torch.empty_like(a) for _ in range(mesh.size)]
        dist.all_gather(tiles, a.contiguous(), group=mesh.group)
        rows = [torch.cat([tiles[mesh.rank_of(ix, iy)] for ix in range(mesh.Rx)], dim=-1)
                for iy in range(mesh.Ry)]
        return torch.cat(rows, dim=-2)

    return _map_fields(state, gather)


def run_decomposed(mesh, cfg, grid, arrays, dt, steps, atmos=None, force_comm=False,
                   restoring=None):
    """``steps`` steps from a JAX-layout numpy state ``arrays`` (see
    ``convert``), decomposed over ``mesh``; returns the gathered global
    state as JAX-layout numpy arrays. ``cfg`` is a ``HydrostaticConfig``,
    or a ``CoupledConfig`` with its ``atmos``; ``restoring`` the global
    restoring dict. Fit for ``parallel.mesh.spawn`` (every rank passes the
    same global ``grid``)."""
    state = shard_state(state_from_numpy(arrays, grid.device), mesh)
    if atmos is None:
        fn = sharded_step_fn(cfg, grid, mesh, n_inner=steps, force_comm=force_comm,
                             restoring=restoring)
    else:
        fn = sharded_coupled_step_fn(cfg, grid, atmos, mesh, n_inner=steps,
                                     force_comm=force_comm, restoring=restoring)
    return state_to_numpy(gather_state(fn(state, dt), mesh))


def run_decomposed_sw(mesh, cfg, grid, arrays, dt, steps):
    """``steps`` shallow-water steps from a JAX-layout numpy state
    ``arrays`` (``convert.sw_state_to_numpy``'s), decomposed over ``mesh``:
    each rank localizes the one-level ``grid`` (the global grid) and runs
    ``sw_loop`` on its tile with the comm. Returns the gathered global
    state as JAX-layout numpy arrays. Fit for ``parallel.mesh.spawn``."""
    from gb25_tpu_torch.models.shallow_water import sw_loop

    comm, lgrid = _tile(grid, mesh, False)
    state = shard_state(sw_state_from_numpy(arrays, grid.device), mesh)
    return sw_state_to_numpy(gather_state(sw_loop(cfg, lgrid, state, dt, steps, comm), mesh))


def checkpoint_decomposed(mesh, arrays, directory):
    """Write this rank's tile of a JAX-layout numpy state ``arrays`` as a
    sharded checkpoint (``io.checkpoint.save_sharded_state`` with the mesh:
    the tile with its global slices, no gather). Fit for
    ``parallel.mesh.spawn``."""
    from gb25_tpu_torch.io.checkpoint import save_sharded_state

    save_sharded_state(shard_state(state_from_numpy(arrays, "cpu"), mesh), directory, mesh=mesh)


def run_decomposed_seaice_advect(mesh, sea_ice, grid, arrays, ice, atmos, dt):
    """``models.seaice.seaice_advect`` on this rank's tile of ``grid`` (the
    width-1 extensions exchanged with the neighbours, the fold's across the
    top rank row), from a JAX-layout numpy ocean state ``arrays``, the
    (Nx, Ny) numpy planes ``ice`` ({"v", "a"}) and ``atmos`` (name -> plane
    at the model time); returns the gathered (v, a) in JAX's layout. Fit
    for ``parallel.mesh.spawn``."""
    from gb25_tpu_torch.convert import ice_state_from_numpy, ice_state_to_numpy
    from gb25_tpu_torch.models.seaice import seaice_advect

    comm, lgrid = _tile(grid, mesh, False)
    state = shard_state(state_from_numpy(arrays, grid.device), mesh)
    y0, x0 = mesh.iy * lgrid.Ny, mesh.ix * lgrid.Nx

    def cut(t):
        return t[..., y0 : y0 + lgrid.Ny, x0 : x0 + lgrid.Nx].contiguous()

    ice_t = ice_state_from_numpy(ice, grid.device)
    ice_t = ice_t.replace(v=cut(ice_t.v), a=cut(ice_t.a))
    atmos_t = {k: cut(torch.as_tensor(np.ascontiguousarray(np.transpose(a)), device=grid.device))
               for k, a in atmos.items()}
    out = seaice_advect(sea_ice, lgrid, state, ice_t, atmos_t, dt, comm)
    gathered = gather_state(dataclasses.replace(state, u=out.v[None], v=out.a[None]), mesh)
    return ice_state_to_numpy(ice_t.replace(v=gathered.u[0], a=gathered.v[0]))


def tile_snapshot(mesh, grid, fields, force_comm=False):
    """What this rank's tile sees, as numpy arrays in the port's layout: the
    tile's grid (``grid/<name>``: its metrics and, on immersed grids, the
    geometry built from the exchanged bottom) and each of ``fields`` (name
    -> (kind, global array in the port's layout, h)) cut to the tile and
    extended through the
    exchange (``halo/<name>``): ``extend_field`` for a 3-D field,
    ``extend_field_xy`` for a plane with h None, ``extend2`` at width h
    otherwise. A decomposition check: each should equal the window of the
    serially extended global field around the tile."""
    from gb25_tpu_torch.ops.halos import extend2, extend_field, extend_field_xy

    comm, lgrid = _tile(grid, mesh, force_comm)
    Ny, Nx = lgrid.Ny, lgrid.Nx
    y0, x0 = mesh.iy * Ny, mesh.ix * Nx
    out = {f"grid/{n}": getattr(lgrid, n) for n in ("dxc", "dxf", "dyc", "dyf", "azc", "azf")}
    if lgrid.immersed:
        geo = lgrid.geometry
        out.update({f"grid/{n}": getattr(geo, n) for n in ("bottom_e", "u_mask", "v_mask", "bu",
                                                            "bv", "Hu", "Hv")})
    for name, (kind, a, h) in fields.items():
        a = torch.as_tensor(a[..., y0 : y0 + Ny, x0 : x0 + Nx], device=lgrid.device)
        if a.dim() == 3:
            e = extend_field(lgrid, a, kind, comm)
        elif h is None:
            e = extend_field_xy(lgrid, a, kind, comm)
        else:
            e = extend2(lgrid, a, kind, h, comm)
        out[f"halo/{name}"] = e
    return {k: v.cpu().numpy() for k, v in out.items()}
