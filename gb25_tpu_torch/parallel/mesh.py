"""The 2-D process grid of the decomposed path (port of
``gb25_tpu.parallel.mesh``).

``factors(N)`` chooses the (Rx, Ry) grid with Rx ~ 2 Ry (the benchmark
domain is 2:1) and the reference's table of special cases. A ``Mesh`` maps
rank r of a ``torch.distributed`` group to the tile (ix, iy) = (r // Ry,
r % Ry), the order of ``np.reshape(devices, (Rx, Ry))`` in the JAX
package. ``spawn`` runs a function on every rank of a local gloo group
(spawned processes, a ``FileStore`` in a temporary directory, no network):
the CPU form of a decomposed run.

The JAX package's TPU placement rules (128-lane-aligned tiles, the
multi-slice band shapes) have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

_SPECIAL = {
    1: (1, 1),
    4: (2, 2),
    16: (4, 4),
    # the reference's table says 512 -> (32, 32) (product 1024); its own
    # Dx = 2 Dy rule gives (32, 16), which the JAX package uses
    512: (32, 16),
    6136: (104, 59),
    9152: (143, 64),
    9180: (135, 68),
    16384: (128, 128),
}


def factors(N: int) -> tuple[int, int]:
    """(Rx, Ry) with Rx Ry = N: the special case where there is one, else
    the divisor pair whose Rx / Ry is closest to 2 (on a log scale)."""
    if N in _SPECIAL:
        return _SPECIAL[N]
    best = None
    for ry in range(1, N + 1):
        if N % ry:
            continue
        score = abs(np.log2((N // ry) / ry) - 1.0)
        if best is None or score < best[0]:
            best = (score, (N // ry, ry))
    return best[1]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An (Rx, Ry) grid of ranks. ``rank`` is this process's rank in
    ``group`` (None: the default group, or no group at all on a 1x1 mesh)."""

    Rx: int
    Ry: int
    rank: int = 0
    group: object = None

    @property
    def size(self) -> int:
        return self.Rx * self.Ry

    @property
    def ix(self) -> int:
        return self.rank // self.Ry

    @property
    def iy(self) -> int:
        return self.rank % self.Ry

    def rank_of(self, ix: int, iy: int) -> int:
        """The group rank of tile (ix, iy)."""
        return ix * self.Ry + iy

    def global_rank(self, r: int) -> int:
        """The default-group rank of group rank ``r`` (what point-to-point
        operations address)."""
        return r if self.group is None else dist.get_global_rank(self.group, r)


def make_mesh(shape=None, group=None) -> Mesh:
    """The mesh of this process: ``shape`` (default ``factors`` of the
    group's size) over ``group``; without an initialized process group, the
    1x1 mesh."""
    if dist.is_available() and dist.is_initialized():
        size, rank = dist.get_world_size(group), dist.get_rank(group)
    else:
        size, rank = 1, 0
    rx, ry = shape or factors(size)
    if rx * ry != size:
        raise ValueError(f"mesh shape {(rx, ry)} != group size {size}")
    return Mesh(rx, ry, rank, group)


@dataclasses.dataclass
class Traffic:
    """What a tile's exchanges posted: batches (each one latency round) and
    the bytes this rank sent (``analysis.comm`` reads it over a step)."""

    exchanges: int = 0
    bytes_sent: int = 0

    def reset(self):
        self.exchanges = self.bytes_sent = 0


def join_group(device):
    """Join the process group ``torchrun`` describes (env://): NCCL with one
    card a rank (``LOCAL_RANK``) for a CUDA ``device``, gloo on the CPU;
    returns this rank's device."""
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", init_method="env://", device_id=device)
    else:
        dist.init_process_group("gloo", init_method="env://")
    return device


def post(ops, traffic=None):
    """Post point-to-point operations as one batch and wait for them,
    counted in ``traffic`` where given (a tile's ``MeshComm.traffic``).
    Under a CUDA graph capture it raises instead: a graph is replayed only
    where the mesh is the one card, whose exchanges call no
    ``torch.distributed`` operation (``models.device_loop``), so a call
    here would be a fault."""
    if ops:
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a torch.distributed exchange under a CUDA graph capture: only a "
                               "mesh of one rank is replayed, and its exchanges stay on the "
                               "device")
        if traffic is not None:
            traffic.exchanges += 1
            traffic.bytes_sent += sum(op.tensor.numel() * op.tensor.element_size()
                                      for op in ops if op.op is dist.isend)
        for work in dist.batch_isend_irecv(ops):
            work.wait()


def _spawned(rank, world, store_path, tasks, results):
    try:
        torch.set_num_threads(1)
        fn, args, shape = tasks.get()
        store = dist.FileStore(store_path, world)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
        try:
            out = fn(make_mesh(shape), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, world_size: int, *args, shape=None, timeout: float = 600.0) -> list:
    """Run ``fn(mesh, *args)`` on ``world_size`` spawned CPU processes, one
    rank each, joined in a gloo group; return the results in rank order.
    ``fn`` and ``args`` cross by pickle, so ``fn`` must be importable (a
    spawned process imports the module that defines it). Raises with the
    first failing rank's traceback."""
    ctx = torch.multiprocessing.get_context("spawn")
    tasks, results = ctx.Queue(), ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="gb25_gloo_")
    procs = [ctx.Process(target=_spawned,
                         args=(r, world_size, os.path.join(tmp, "store"), tasks, results),
                         daemon=True)
             for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        # the work goes by queue, not as process arguments: a large argument
        # would block each start until its process had imported torch
        for _ in procs:
            tasks.put((fn, args, shape))
        out, done = [None] * world_size, set()
        deadline = time.monotonic() + timeout
        while len(done) < world_size:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                # a rank that died without a result (a crash) fails the run
                dead = [r for r, p in enumerate(procs) if r not in done and p.exitcode]
                if dead:
                    raise RuntimeError(f"ranks {dead} exited with no result") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"spawned ranks gave no result within {timeout} s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
            done.add(rank)
        for p in procs:
            p.join(timeout)
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
