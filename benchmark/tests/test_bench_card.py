"""On the card: one short run of each cell through ``run.main``, whose last
line must be the contract's and correct. Skips where no CUDA card is
visible (decided inside the test)."""

import json

import pytest
import torch

from benchmark import run, spec

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", [w["name"] for w in spec.benchmark()["workloads"]])
def test_a_short_run_is_correct(cell, capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the benchmark measures the port on the card only)")
    assert run.main(["--workload", cell, "--seed", "2147483701", "--seconds", "1"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] and line["failed"] == 0
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
