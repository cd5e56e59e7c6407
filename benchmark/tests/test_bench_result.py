"""The result line is built with the contract's keys alone, the numbers
compared last; without a card the measuring path fails and prints nothing,
and it never falls back to the CPU."""

import json
import math

import pytest
import torch

from benchmark import run

READINGS = {"euler.u": 2e-6, "euler.v": 1e-7, "euler.T": 3e-7, "step.u": 3e-5,
            "step.T": 1e-6}
LIMITS = {"euler.u": 1e-3, "euler.T": 1e-6, "step.u": 1e-3, "step.T": 1e-4}


def test_line_from_a_stubbed_run():
    ok, checks = run.judge(READINGS, LIMITS)
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
              "memory_peak_bytes": 123}
    metrics = {"cell_steps_per_s": {"value": 2.07e9, "unit": "cell-steps/s"}}
    line = json.loads(run.result_line(ok, 280, 0, metrics, device, checks))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True
    assert list(line["checks"]) == list(LIMITS)
    assert line["checks"]["step.u"] == {"value": 3e-5, "limit": 1e-3}
    traced = json.loads(run.result_line(ok, 280, 0, metrics, device, checks,
                                        {"device_ops": [["k", 1.0]], "idle_gaps": []}))
    assert list(traced)[-2:] == ["breakdown", "checks"]
    assert set(traced) <= set(run.RESULT_KEYS)


@pytest.mark.parametrize("value", [2e-3, math.inf, math.nan])
def test_a_number_over_its_limit_is_not_correct(value):
    ok, _ = run.judge({**READINGS, "step.u": value}, LIMITS)
    assert not ok


def test_failed_counts_each_point_once():
    _, checks = run.judge({**READINGS, "step.u": 1.0, "step.T": 1.0, "euler.T": 1.0}, LIMITS)
    assert run.failed_steps(checks, {"euler": 1, "step": 16}) == 17
    _, checks = run.judge(READINGS, LIMITS)
    assert run.failed_steps(checks, {"euler": 1, "step": 16}) == 0


def test_an_exact_limit_takes_only_zero():
    ok, _ = run.judge({"step.ice_a": 0.0}, {"step.ice_a": 0})
    assert ok
    ok, _ = run.judge({"step.ice_a": 1e-12}, {"step.ice_a": 0})
    assert not ok


def test_no_card_fails_and_prints_nothing(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(run.NoCard):
        run.card_check(1)
    assert run.main(["--workload", "bi_flagship.loop", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_too_few_cards_fail(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(run.NoCard):
        run.card_check(1)


def test_forbidden_modules_are_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "gb25_tpu_torch_lookalike", types.ModuleType("x"))
    assert "gb25_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "gb25_tpu.ops", types.ModuleType("gb25_tpu.ops"))
    assert "gb25_tpu" in run.forbidden_modules()
