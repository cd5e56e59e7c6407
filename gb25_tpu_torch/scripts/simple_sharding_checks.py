"""Distributed sanity checks before a real run (port of the JAX package's
``scripts/simple_sharding_checks.py``, the reference's simple_matmul.jl and
simple_distributed_bcast.jl): the mesh of the group's ranks, a broadcast
from rank 0, a sum over the ranks and a ring exchange along the mesh's x
axis (``parallel.halo``'s batched point-to-point path); gloo on the CPU,
NCCL on cards.

    torchrun --nproc-per-node 4 -m gb25_tpu_torch.scripts.simple_sharding_checks --distributed
    python -m gb25_tpu_torch.scripts.simple_sharding_checks --device cpu   # a group of one
"""

from __future__ import annotations

import argparse


def checks(mesh, device):
    """The checks on this rank of ``mesh``; returns what they saw. Raises
    where a value is wrong."""
    import torch
    import torch.distributed as dist

    from gb25_tpu_torch.parallel.mesh import post

    n, rank = mesh.size, mesh.rank
    print(f"[{rank}] ranks={n} mesh={mesh.Rx}x{mesh.Ry} tile=({mesh.ix}, {mesh.iy}) "
          f"device={device}", flush=True)
    grouped = dist.is_available() and dist.is_initialized()

    # broadcast from rank 0 (the reference's simple_distributed_bcast)
    x = torch.full((8, 8), 7.0 if rank == 0 else -1.0, device=device)
    if grouped:
        dist.broadcast(x, src=mesh.global_rank(0), group=mesh.group)
    if not torch.equal(x, torch.full_like(x, 7.0)):
        raise AssertionError(f"[{rank}] broadcast gave {x.flatten()[:4].tolist()}")

    # a reduction: the sum of the ranks
    s = torch.tensor([float(rank)], device=device)
    if grouped:
        dist.all_reduce(s, group=mesh.group)
    if float(s) != n * (n - 1) / 2:
        raise AssertionError(f"[{rank}] all_reduce gave {float(s)}, expected {n * (n - 1) / 2}")

    # a ring along x: each tile sends its rank to the next tile in x
    ring = None
    if mesh.Rx > 1:
        nxt = mesh.global_rank(mesh.rank_of((mesh.ix + 1) % mesh.Rx, mesh.iy))
        prv = mesh.global_rank(mesh.rank_of((mesh.ix - 1) % mesh.Rx, mesh.iy))
        send = torch.tensor([float(rank)], device=device)
        got = torch.empty_like(send)
        post([dist.P2POp(dist.isend, send, nxt, mesh.group),
              dist.P2POp(dist.irecv, got, prv, mesh.group)])
        ring = int(got)
        want = mesh.rank_of((mesh.ix - 1) % mesh.Rx, mesh.iy)
        if ring != want:
            raise AssertionError(f"[{rank}] ring gave {ring}, expected {want}")
    print(f"[{rank}] broadcast OK, all_reduce OK ({float(s):g}), "
          f"ring {'OK' if ring is not None else 'skipped (one tile in x)'}", flush=True)
    return {"rank": rank, "size": n, "mesh": (mesh.Rx, mesh.Ry), "sum": float(s), "ring": ring}


def main(argv=None):
    """Run the checks on this rank; returns what they saw."""
    import torch.distributed as dist

    from gb25_tpu_torch.parallel import make_mesh
    from gb25_tpu_torch.parallel.mesh import join_group
    from gb25_tpu_torch.utils.args import device_of

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--distributed", action="store_true",
                   help="join the torchrun group (env://): NCCL on cards, gloo on the CPU")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = device_of(args)
    if not args.distributed:
        out = checks(make_mesh(), device)
    else:
        device = join_group(device)
        try:
            out = checks(make_mesh(), device)
        finally:
            dist.destroy_process_group()
    print(f"[{out['rank']}] ALL CHECKS PASSED", flush=True)
    return out


if __name__ == "__main__":
    main()
