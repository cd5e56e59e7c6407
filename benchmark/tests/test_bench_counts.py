"""The frozen work counts give today's numbers at the benchmark's shapes
(the same as ``chip_smoke.py``'s hand counts, PERF.md's table)."""

import pytest

from benchmark import spec
from benchmark.counts.barotropic import k2_bound
from benchmark.counts.closure import k3_bound, k4_bound
from benchmark.counts.k1 import k1_bound
from benchmark.counts.k6 import k6_bound
from benchmark.counts.shape import Shape
from benchmark.counts.step import step_bound, step_terms


def shape(name):
    return Shape.of(spec.config(name))


@pytest.mark.parametrize("name, count, ms, by", [
    ("bi_flagship", k1_bound, 1.604, "bytes"),
    ("bi_flagship", k6_bound, 0.800, "operations"),
    ("ocean_climate_q", k1_bound, 1.653, "bytes"),
    ("bi_flagship", k2_bound, 0.0141, "bytes"),
    ("ocean_climate_q", k4_bound, 0.718, "bytes"),
])
def test_kernel_bounds(name, count, ms, by):
    got, bound_by = count(shape(name))
    assert got == pytest.approx(ms, abs=5e-4)
    assert bound_by == by


def test_k3_climate_solves():
    # (u, v), (T, S) and the damped e: a step's three solves
    s = shape("ocean_climate_q")
    total = k3_bound(s, 2, False)[0] * 2 + k3_bound(s, 1, True)[0]
    assert total == pytest.approx(1.048, abs=5e-4)


@pytest.mark.parametrize("name, ms, nbytes, ops", [
    ("bi_flagship", 1.4452, 4841275392, 54358179840),
    ("ocean_climate_q", 1.6814, 5632835072, 64862208000),
])
def test_whole_step(name, ms, nbytes, ops):
    s = shape(name)
    b, o = step_terms(s)
    assert sum(x for _, x in b) == nbytes
    assert sum(x for _, x in o) == ops
    got, by = step_bound(s)
    assert got == pytest.approx(ms, abs=1e-4)
    assert by == "bytes"
