"""Job generator for runs on GPU nodes (the port's counterpart of the JAX
package's ``scripts/tpu_pod_launcher.py``, the reference's
sharding/common_submission_generator.jl): one job directory per size of
``--sizes`` (GPUs), each with

  - ``run-info.toml``: git describe and branch, the GPUs (``chips``, the
    reference's key), the nodes, the tile, the scaling, the global grid
    (strong scaling) and the command;
  - ``git.diff`` where the tree has uncommitted changes;
  - ``launcher.sh``: ``torchrun`` over the job's nodes running
    ``python -m gb25_tpu_torch.scripts.sharded_baroclinic_instability_run
    --distributed --tile-x ... --tile-y ...``, with the NCCL environment;
  - ``submit.sh``: the Slurm submit line (``sbatch`` of the launcher).

    python -m gb25_tpu_torch.scripts.launcher --sizes 8,32,128 --tile-x 768 --tile-y 768
    python -m gb25_tpu_torch.scripts.launcher --sizes 8,32 --strong --global-x 6144 \\
        --global-y 3072

Weak scaling (the default) keeps the tile a GPU; ``--strong`` holds the
global grid and sizes the tiles by ``factors(n)``.
"""

from __future__ import annotations

import argparse
import math
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LAUNCHER = """#!/usr/bin/env bash
# one torchrun a node, {gpus_per_node} ranks each (one GPU a rank), started by srun
set -euo pipefail
export NCCL_DEBUG="${{NCCL_DEBUG:-WARN}}"
export TORCH_NCCL_ASYNC_ERROR_HANDLING=1
export OMP_NUM_THREADS=1
MASTER_ADDR="$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n 1)"
cd {workdir}
torchrun --nnodes {nodes} --nproc-per-node {gpus_per_node} \\
    --rdzv-backend c10d --rdzv-endpoint "$MASTER_ADDR:{port}" --rdzv-id "$SLURM_JOB_ID" \\
    -m gb25_tpu_torch.scripts.sharded_baroclinic_instability_run \\
    --distributed --tile-x {tile_x} --tile-y {tile_y} --Nz {nz} \\
    --steps {steps} --dt {dt} --float-type {ft} {extra}
"""

SUBMIT = """#!/usr/bin/env bash
# submit: the launcher on {nodes} node(s), one task a node
sbatch --job-name gb25_{gpus} --nodes {nodes} --ntasks-per-node 1 \\
    --gpus-per-node {gpus_per_node} --exclusive --output {job_dir}/run.log \\
    --wrap "srun bash {job_dir}/launcher.sh"
"""


def sh(cmd):
    """A git command's output in the repository ("" where it fails)."""
    try:
        out = subprocess.run(cmd, shell=True, capture_output=True, text=True, cwd=REPO,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip() if out.returncode == 0 else ""


def main(argv=None):
    """Write the job directories; returns their paths."""
    from gb25_tpu_torch.parallel import factors

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sizes", default="8,32,128,256", help="GPU counts to prepare jobs for")
    p.add_argument("--gpus-per-node", type=int, default=4)
    p.add_argument("--tile-x", type=int, default=768)
    p.add_argument("--tile-y", type=int, default=768)
    p.add_argument("--strong", action="store_true",
                   help="hold the global grid (--global-x/--global-y) as the GPUs grow; the "
                        "tiles are global / factors(n); the default holds the tile a GPU")
    p.add_argument("--global-x", type=int, default=None,
                   help="strong-scaling global x extent (required with --strong)")
    p.add_argument("--global-y", type=int, default=None)
    p.add_argument("--Nz", type=int, default=64)
    p.add_argument("--steps", type=int, default=256)
    p.add_argument("--dt", type=float, default=1.0)
    p.add_argument("--float-type", default="f32")
    p.add_argument("--port", type=int, default=29500, help="the rendezvous port")
    p.add_argument("--out", default="gpu_jobs")
    p.add_argument("--extra", default="")
    args = p.parse_args(argv)
    if args.strong and (args.global_x is None or args.global_y is None):
        p.error("--strong requires --global-x and --global-y")

    dirs = []
    for n in (int(s) for s in args.sizes.split(",")):
        if args.strong:
            rx, ry = factors(n)
            if args.global_x % rx or args.global_y % ry:
                print(f"WARNING: global {args.global_x}x{args.global_y} not divisible by mesh "
                      f"{rx}x{ry} at {n} GPUs: skipping", file=sys.stderr)
                continue
            tile_x, tile_y = args.global_x // rx, args.global_y // ry
        else:
            tile_x, tile_y = args.tile_x, args.tile_y
        gpus_per_node = min(args.gpus_per_node, n)
        nodes = math.ceil(n / gpus_per_node)
        if nodes * gpus_per_node != n:
            print(f"WARNING: {n} GPUs do not fill {nodes} nodes of {gpus_per_node}: skipping",
                  file=sys.stderr)
            continue
        job_dir = os.path.abspath(os.path.join(args.out, f"gpus_{n}"))
        os.makedirs(job_dir, exist_ok=True)

        with open(os.path.join(job_dir, "run-info.toml"), "w") as f:
            f.write(f'git_describe = "{sh("git describe --always --dirty")}"\n')
            f.write(f'git_branch = "{sh("git rev-parse --abbrev-ref HEAD")}"\n')
            f.write(f"chips = {n}\n")  # the reference's key: here the GPUs
            f.write(f"nodes = {nodes}\n")
            f.write(f"tile = [{tile_x}, {tile_y}, {args.Nz}]\n")
            f.write(f'scaling = "{"strong" if args.strong else "weak"}"\n')
            if args.strong:
                f.write(f"global = [{args.global_x}, {args.global_y}, {args.Nz}]\n")
            command = " ".join([os.path.basename(sys.executable), "-m",
                                "gb25_tpu_torch.scripts.launcher",
                                *(argv if argv is not None else sys.argv[1:])])
            f.write(f'command = "{command}"\n')
        diff = sh("git diff")
        if diff:
            with open(os.path.join(job_dir, "git.diff"), "w") as f:
                f.write(diff + "\n")
        with open(os.path.join(job_dir, "launcher.sh"), "w") as f:
            f.write(LAUNCHER.format(workdir=REPO, nodes=nodes, gpus_per_node=gpus_per_node,
                                    port=args.port, tile_x=tile_x, tile_y=tile_y, nz=args.Nz,
                                    steps=args.steps, dt=args.dt, ft=args.float_type,
                                    extra=args.extra))
        with open(os.path.join(job_dir, "submit.sh"), "w") as f:
            f.write(SUBMIT.format(gpus=n, nodes=nodes, gpus_per_node=gpus_per_node,
                                  job_dir=job_dir))
        for name in ("launcher.sh", "submit.sh"):
            os.chmod(os.path.join(job_dir, name), 0o755)
        print(f"prepared {job_dir}")
        dirs.append(job_dir)
    return dirs


if __name__ == "__main__":
    main()
