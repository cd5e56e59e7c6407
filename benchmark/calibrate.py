"""Readings for the limits of ``correct``: in one process, the cell's
comparison on sound runs of the program for each of ``--seeds`` and on its
control (the program with ``compute_dtype`` set to the workload's
``control``, the nearest precision below the configuration's) for each of
``--control-seeds``, each with a window of ``--seconds``; one JSON line a
run, then for every reading the largest sound and the smallest control
value. Each limit in ``workloads/<cell>.json`` lies between the two
(PERF.md gives both).

    python3 benchmark/calibrate.py --workload bi_flagship.loop --seconds 2 \\
        --seeds 11 12 13 --control-seeds 21 22 23
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import run, spec  # noqa: E402


def readings(cell, seeds, control, seconds, device):
    """One dict a seed: the seed, the control, every reading of the
    comparison and the window's rate."""
    out = []
    for seed in seeds:
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        r = run.measure(cell, seed, seconds, False, device, time.perf_counter(), control)
        line = {"workload": cell.name, "seed": seed, "control": control,
                "readings": r["readings"],
                "cell_steps_per_s": r["end_to_end"]["cell_steps_per_s"]}
        print(json.dumps(line), flush=True)
        out.append(line)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    cell = spec.Cell(spec.benchmark(), args.workload)
    run.card_check(cell.entry["chips"])
    sound = readings(cell, args.seeds, None, args.seconds, "cuda")
    control = readings(cell, args.control_seeds, cell.workload["control"], args.seconds, "cuda")
    for name in sound[0]["readings"] if sound else ():
        lo = max(r["readings"][name] for r in sound)
        hi = min((r["readings"][name] for r in control), default=None)
        print(f"{name}: sound runs at most {lo!r}, the control at least {hi!r}, the limit "
              f"{cell.workload['limits'].get(name)!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
