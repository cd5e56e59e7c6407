"""Per-rank sharded checkpoints with no communication (port of
``gb25_tpu.io.checkpoint``), in the JAX package's on-disk format, so that
either package reads the other's checkpoints.

Each rank writes the fields of its own tile with their global index
ranges: ``fields_rank{R}.npz`` holding ``{name}__shard{i}`` arrays and
``index_rank{R}.json`` holding ``meta`` (iteration, time, nprocs and any
extra metadata) and, for each field, its global shape, dtype and shards'
slices. Names are the JAX state's leaf names ("u", "tracers/T",
"Gtracers/S", "time", "time_lo", "iteration"; dicts in sorted order) and
arrays are in the JAX package's (X, Y, Z) axis order: the port's (Z, Y,
X) tensors have their axes reversed at the file boundary, on their device
(a transposed copy in numpy costs ~1 s a 1536x768x64 field on the host).
There is no gather at save time; ``load_global_field`` reassembles a
field from every rank's files.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re

import numpy as np
import torch


def _flatten_state(state, prefix="") -> dict:
    """name -> tensor (or the int iteration) for every leaf of a state
    dataclass, in the JAX package's leaf order: fields in order, dicts by
    sorted key, nested dataclasses by field."""
    flat = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        name = prefix + f.name
        if isinstance(v, dict):
            flat.update({f"{name}/{k}": v[k] for k in sorted(v)})
        elif dataclasses.is_dataclass(v):
            flat.update(_flatten_state(v, name + "/"))
        else:
            flat[name] = v
    return flat


def _to_jax_layout(v) -> np.ndarray:
    if isinstance(v, int):
        return np.asarray(v, np.int32)
    v = v.detach()
    if v.dim() >= 2:
        v = v.permute(*reversed(range(v.dim()))).contiguous()
    return v.cpu().numpy()


def _from_jax_layout(a, device, dtype):
    """A JAX-layout array as a port tensor on ``device`` in ``dtype``, the
    axes reversed there."""
    t = torch.from_numpy(np.array(a, copy=not a.flags.c_contiguous)).to(device)
    if t.dim() >= 2:
        t = t.permute(*reversed(range(t.dim()))).contiguous()
    return t.to(dtype)


def _rank_and_size(mesh):
    if mesh is not None:
        return mesh.rank, mesh.size
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def save_sharded_state(state, directory, process_index=None, extra_metadata=None, mesh=None):
    """Write this rank's fields of ``state``: with ``mesh`` (the decomposed
    path) ``state`` is this rank's tile and each field is written with its
    slices of the global field, the clock and iteration whole (every rank
    writes them, as every JAX process writes its replicated shards);
    serially the whole state. ``process_index``: the file's rank (this
    rank's by default)."""
    os.makedirs(directory, exist_ok=True)
    rank, nprocs = _rank_and_size(mesh)
    rank = rank if process_index is None else process_index
    flat = _flatten_state(state)

    arrays, index = {}, {}
    for name, v in flat.items():
        a = _to_jax_layout(v)
        key = f"{name}__shard0"
        arrays[key] = a
        if mesh is not None and a.ndim >= 2:
            nx, ny = a.shape[:2]
            x0, y0 = mesh.ix * nx, mesh.iy * ny
            slices = [[x0, x0 + nx], [y0, y0 + ny]] + [[0, n] for n in a.shape[2:]]
            shape = [nx * mesh.Rx, ny * mesh.Ry, *a.shape[2:]]
        else:
            slices = [[0, n] for n in a.shape]
            shape = list(a.shape)
        index[name] = {"global_shape": shape, "dtype": str(a.dtype),
                       "shards": [{"key": key, "slices": slices}]}

    meta = {
        "iteration": int(flat["iteration"]) if "iteration" in flat else None,
        "time": float(flat["time"]) if "time" in flat else None,
        "nprocs": nprocs,
    }
    if extra_metadata:
        meta.update(extra_metadata)

    np.savez(os.path.join(directory, f"fields_rank{rank}.npz"), **arrays)
    with open(os.path.join(directory, f"index_rank{rank}.json"), "w") as f:
        json.dump({"meta": meta, "fields": index}, f)


def _rank_files(directory):
    pat = re.compile(r"index_rank(\d+)\.json$")
    ranks = sorted(int(pat.match(f).group(1)) for f in os.listdir(directory) if pat.match(f))
    if not ranks:
        raise FileNotFoundError(f"no shard files in {directory}")
    return ranks


def load_global_field(directory, name) -> np.ndarray:
    """One field reassembled from every rank's shard files, in the JAX
    package's layout."""
    out = None
    for rank in _rank_files(directory):
        with open(os.path.join(directory, f"index_rank{rank}.json")) as f:
            idx = json.load(f)
        info = idx["fields"][name]
        if out is None:
            out = np.zeros(info["global_shape"], dtype=np.dtype(info["dtype"]))
        with np.load(os.path.join(directory, f"fields_rank{rank}.npz")) as data:
            for entry in info["shards"]:
                sl = tuple(slice(a, b) for a, b in entry["slices"])
                out[sl] = data[entry["key"]]
    return out


def load_all_fields(directory) -> dict:
    """Every saved field, reassembled (``load_global_field``)."""
    ranks = _rank_files(directory)
    with open(os.path.join(directory, f"index_rank{ranks[0]}.json")) as f:
        names = list(json.load(f)["fields"].keys())
    return {n: load_global_field(directory, n) for n in names}


def load_metadata(directory) -> dict:
    ranks = _rank_files(directory)
    with open(os.path.join(directory, f"index_rank{ranks[0]}.json")) as f:
        return json.load(f)["meta"]


def restore_state(state_template, directory, mesh=None):
    """``state_template`` with every field read from a checkpoint (either
    package's), in the template's dtypes and on its device; with ``mesh``
    the template is this rank's tile and each field is cut to it. Names
    come from ``_flatten_state``, as at save time."""
    fields = load_all_fields(directory)
    flat = _flatten_state(state_template)
    values = {}
    for name, leaf in flat.items():
        a = fields[name]
        if isinstance(leaf, int):
            values[name] = int(a)
            continue
        if mesh is not None and a.ndim >= 2:
            nx, ny = leaf.shape[-1], leaf.shape[-2]
            x0, y0 = mesh.ix * nx, mesh.iy * ny
            a = a[x0 : x0 + nx, y0 : y0 + ny]
        values[name] = _from_jax_layout(a, leaf.device, leaf.dtype)
    return _unflatten(state_template, values)


def _unflatten(state, values, prefix=""):
    kw = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        name = prefix + f.name
        if isinstance(v, dict):
            kw[f.name] = {k: values[f"{name}/{k}"] for k in v}
        elif dataclasses.is_dataclass(v):
            kw[f.name] = _unflatten(v, values, name + "/")
        else:
            kw[f.name] = values[name]
    return dataclasses.replace(state, **kw)
