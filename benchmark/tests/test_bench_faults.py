"""The comparison fails what it must: a run driven on the CPU at a small
size (the harness's look for a card skipped) with the timed path broken
underneath from the window on, and the control (the program in bfloat16,
the nearest precision below the configuration's float32), come out not
correct. The faults a cell on one card can have: a step that returns its
state unchanged, half of the domain left unstepped, an answer altered
where it is produced; and, in set-up, an initial temperature off by 3 K
and, in the production run, restoring targets off by 3 K. (No cell
exchanges between cards.)"""

import importlib

import pytest

from benchmark import run, spec
from small import small_cell

CELLS = ["bi_flagship.loop", "ocean_climate_q.sim", "bi_flagship.k6"]


def unchanged(new, old):
    """The step returns its state, only its iteration advanced."""
    return old.replace(iteration=new.iteration)


def half_domain(new, old):
    """The northern half of every field keeps its old values."""
    half = new.u.shape[1] // 2

    def keep(a, b):
        a = a.clone()
        a[..., half:, :] = b[..., half:, :]
        return a

    return new.replace(u=keep(new.u, old.u), v=keep(new.v, old.v), eta=keep(new.eta, old.eta),
                       tracers={k: keep(c, old.tracers[k]) for k, c in new.tracers.items()})


def altered(new, old):
    """One surface temperature off by 1 K where the step writes it."""
    T = new.tracers["T"].clone()
    T[-1, T.shape[1] // 2, T.shape[2] // 2] += 1.0
    return new.replace(tracers={**new.tracers, "T": T})


def _break(monkeypatch, cell, fault):
    """From the window on, the program's step under the cell's loop hands
    on ``fault(new, old)`` in place of its new ocean state."""
    if cell.workload["driver"] == "loop":
        from gb25_tpu_torch.models import hydrostatic as module
        name = "time_step"

        def wrapped(*a, **kw):
            return fault(original(*a, **kw), a[2])
    else:
        from gb25_tpu_torch.models import coupled as module
        name = "coupled_ice_time_step"

        def wrapped(*a, **kw):
            new, ice = original(*a, **kw)
            return fault(new, a[3]), ice
    original = getattr(module, name)
    driver = spec.driver(cell.workload["driver"])
    window = driver.Run.window

    def broken_window(self, *a, **kw):
        monkeypatch.setattr(module, name, wrapped)
        return window(self, *a, **kw)

    monkeypatch.setattr(driver.Run, "window", broken_window)


def failing(cell, seed=3, control=None):
    """The names of the numbers a short CPU run of ``cell`` fails."""
    r = run.measure(cell, seed, 0.3, False, "cpu", control=control)
    ok, checks = run.judge(r["readings"], cell.workload["limits"])
    bad = {n for n, x in checks.items() if not run.passes(x)}
    assert ok == (not bad)
    return bad


@pytest.mark.parametrize("fault", [unchanged, half_domain, altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_window_is_not_correct(monkeypatch, name, fault):
    cell = small_cell(name)
    _break(monkeypatch, cell, fault)
    bad = failing(cell)
    assert any(n.startswith("step.") for n in bad), bad


def _warm_by_3k(state):
    return state.replace(tracers={**state.tracers, "T": state.tracers["T"] + 3.0})


@pytest.mark.parametrize("name", CELLS)
def test_an_initial_temperature_off_by_3k_is_not_correct(monkeypatch, name):
    """The program's initial state (the flagship's front, the production
    run's climatology) 3 K too warm fails the first step's temperature."""
    cell = small_cell(name)
    if cell.workload["driver"] == "loop":
        from benchmark.drivers import loop as driver

        resolve = driver.resolve

        def warm_ctor(path):
            ctor = resolve(path)

            def built(*a, **kw):
                cfg, grid, state = ctor(*a, **kw)
                return cfg, grid, _warm_by_3k(state)
            return built
        monkeypatch.setattr(driver, "resolve", warm_ctor)
    else:
        ocs = importlib.import_module(cell.config["program"]["script"])
        build = ocs.build

        def warm_build(args):
            ccfg, grid, state, *rest = build(args)
            return (ccfg, grid, _warm_by_3k(state), *rest)
        monkeypatch.setattr(ocs, "build", warm_build)
    assert "euler.T" in failing(cell)


def test_restoring_targets_off_by_3k_are_not_correct(monkeypatch):
    """The production run's restoring targets 3 K too warm (its initial
    state sound) fail the first step's temperature: one step of restoring
    at 1/(7 days) moves T by ~1e-4 of the targets' error."""
    cell = small_cell("ocean_climate_q.sim")
    ocs = importlib.import_module(cell.config["program"]["script"])
    build = ocs.build

    def off_build(args):
        ccfg, grid, state, ice, atmos, restoring = build(args)
        target, rate = restoring["T"]
        return ccfg, grid, state, ice, atmos, {**restoring, "T": (target + 3.0, rate)}
    monkeypatch.setattr(ocs, "build", off_build)
    assert "euler.T" in failing(cell)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    cell = small_cell(name)
    assert failing(cell, 4, cell.workload["control"])


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    assert not failing(small_cell(name), 2147483711)
