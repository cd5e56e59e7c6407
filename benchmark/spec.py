"""The benchmark's description, found by name: ``BENCHMARK.json`` at the
root of the checkout, each configuration in ``configs/<name>.json``, each
cell in ``workloads/<cell>.json``, each per-layer metric's reader in
``metrics/<metric>.py``, each driver in ``drivers/<driver>.py`` and each
configuration's plain reference in ``reference/<config>.py``."""

from __future__ import annotations

import importlib
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")

CONFIG_KEYS = ("name", "source", "program", "Nx", "Ny", "Nz", "halo", "dtype", "dt", "grid",
               "immersed", "tracers", "eos", "momentum_advection", "tracer_advection",
               "ke_scheme", "closure", "substeps", "noise_velocity", "assumed", "reduced")
WORKLOAD_KEYS = ("name", "config", "traffic", "driver", "route", "chips", "limits", "why")


class SpecError(ValueError):
    pass


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return load_json(Path(root) / "BENCHMARK.json")


def config(name):
    c = load_json(HERE / "configs" / f"{name}.json")
    missing = [k for k in CONFIG_KEYS if k not in c]
    if missing or c["name"] != name:
        raise SpecError(f"configs/{name}.json: missing {missing} or a name other than {name!r}")
    return c


def workload(name):
    w = load_json(HERE / "workloads" / f"{name}.json")
    missing = [k for k in WORKLOAD_KEYS if k not in w]
    if missing or w["name"] != name:
        raise SpecError(f"workloads/{name}.json: missing {missing} or a name other than {name!r}")
    return w


def driver(name):
    return importlib.import_module(f"benchmark.drivers.{name}")


def reference(config_name):
    return importlib.import_module(f"benchmark.reference.{config_name}")


def reader(metric):
    return importlib.import_module(f"benchmark.metrics.{metric}")


class Cell:
    """One cell of ``BENCHMARK.json`` with its files: ``entry`` (its line
    in ``workloads``), ``workload`` and ``config`` (the files' dicts), and
    the metrics it reports: ``end_to_end`` and ``per_layer`` (their lines
    in ``BENCHMARK.json``)."""

    def __init__(self, bench, name):
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise SpecError(f"no cell {name!r} in BENCHMARK.json: {sorted(entries)}")
        self.name, self.entry = name, entries[name]
        self.workload = workload(name)
        self.config = config(self.entry["config"])
        for key in ("config", "traffic", "chips"):
            if self.workload[key] != self.entry[key]:
                raise SpecError(f"workloads/{name}.json: {key} {self.workload[key]!r} is not "
                                f"BENCHMARK.json's {self.entry[key]!r}")

        def here(metric):
            return name in metric.get("workloads", [name])

        self.end_to_end = [m for m in bench["end_to_end"] if here(m)]
        self.per_layer = [m for m in bench["per_layer"] if here(m)]


def validate(bench):
    """Raise ``SpecError`` unless every name is well formed and every
    configuration, cell, driver, reference and metric reader is found."""
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in bench[group]]
        if len(set(names)) != len(names):
            raise SpecError(f"{group}: a name appears twice")
        for n in names:
            if not NAME.match(n):
                raise SpecError(f"{group}: {n!r} is no valid name")
    for c in bench["configs"]:
        config(c["name"])
        reference(c["name"])
        if c["file"] != f"benchmark/configs/{c['name']}.json":
            raise SpecError(f"config {c['name']}: file {c['file']!r}")
    for w in bench["workloads"]:
        cell = Cell(bench, w["name"])
        driver(cell.workload["driver"])
    for m in bench["per_layer"]:
        if not callable(getattr(reader(m["name"]), "read", None)):
            raise SpecError(f"metrics/{m['name']}.py has no read(ctx)")
    return bench
