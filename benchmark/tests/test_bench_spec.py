"""Every configuration, cell, driver, reference and metric reader that
``BENCHMARK.json`` names is found by name and valid, and the file keeps
to the benchmark's contract."""

import re

import pytest

from benchmark import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
LIMIT = re.compile(r"^(euler|step)\.[A-Za-z0-9_]+$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level():
    assert set(BENCH) == TOP
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    spec.validate(BENCH)


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    cfg = spec.config(c["name"])
    assert c["file"] == f"benchmark/configs/{c['name']}.json"
    assert c["reduced"] == cfg["reduced"]
    for key in c["reduced"]:
        assert NAME.match(key) and key in cfg
    assert 1 <= len(c["source"]) <= 200
    assert 1 <= len(c["why"]) <= 200 and not {"\n", "\t"} & set(c["why"])
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1 and NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    cell = spec.Cell(BENCH, w["name"])
    limits = cell.workload["limits"]
    assert all(LIMIT.match(n) for n in limits), limits
    assert {n.split(".")[0] for n in limits} == {"euler", "step"}
    assert all(v >= 0 for v in limits.values())
    spec.driver(cell.workload["driver"]).Run
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    if m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert callable(spec.reader(m["name"]).read)
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in BENCH["workloads"]}


def test_one_layer_name_per_layer():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(1 <= len(x) <= 200 and "\n" not in x for x in layers)


def test_a_missing_cell_is_refused():
    with pytest.raises(spec.SpecError):
        spec.Cell(BENCH, "no_such.cell")
