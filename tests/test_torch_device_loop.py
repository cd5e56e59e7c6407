"""The device-resident loop (``models.device_loop``) on the CPU.

- ``plan``: the split of n steps into the steps run eagerly first, the
  replays of a captured block and the steps left over, from iteration 0
  (the Euler step stays eager) and from a later iteration, before and
  after the graph is captured;
- ``loop``, ``coupled_loop`` and ``sw_loop`` on the CPU (the host loop)
  equal n step calls bit for bit, on the flagship (both tendency routes),
  k-epsilon, the coupled climate on the islands grid and shallow water;
- the replay machinery with the graph emulated on the CPU (a "replay" runs
  the block's steps on the static state and copies the result back, as the
  captured graph does on the card): over a call that captures, a call that
  reuses the graph and one with a remainder, the loop equals the host loop
  bit for bit, the clock and the iteration included; one graph is captured
  for the key; no returned state shares a tensor with the static state, and
  a later call leaves an earlier call's result as it was;
- the grid's cache keeps one graph: a call with another key frees the kept
  graph (with no garbage collection) before it captures its own; the key
  holds the grid and the atmosphere by weak reference and tells them apart
  by identity; the step must be a ``functools.partial``;
- the decomposed path forced onto a 1x1 mesh ("local" and "ring"): the
  flagship's and the tripolar climate's loops go through ``device_loop``
  (emulated replays) and equal the host loop bit for bit; the graph keeps
  the tile's cached blocked-solve statics and is keyed by the comm; a comm
  whose mesh has several ranks keeps the host loop, and an exchange posted
  under a capture raises.
The graphs themselves run on the card: tests/test_torch_kernels_cuda.py.
"""

import dataclasses
import functools
import gc
import weakref

import pytest
import torch

from gb25_tpu_torch import (
    baroclinic_instability_model,
    coupled_time_step,
    data_free_ocean_climate_model,
    shallow_water_model,
    sw_time_step,
    time_step,
)
from gb25_tpu_torch.models import coupled_loop, loop, sw_loop
from gb25_tpu_torch.models import device_loop as dl
from gb25_tpu_torch.models.hydrostatic import premask_state
from gb25_tpu_torch.models.config import SplitExplicitFreeSurface
from gb25_tpu_torch.models.keps import TKEDissipationVerticalDiffusivity
from gb25_tpu_torch.parallel import Mesh, make_comm, sharded_coupled_step_fn, sharded_step_fn
from gb25_tpu_torch.parallel import mesh as mesh_mod

DT = 60.0
K = dl.BLOCK_STEPS


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: beside other busy
    test processes, torch's default of one OpenMP thread per core made the
    plain versions' many small launches ~100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (n, iteration, captured) -> (head, replays, tail) for blocks of K steps
PLANS = {
    (0, 0, False): (0, 0, 0), (1, 0, False): (1, 0, 0), (2, 0, False): (2, 0, 0),
    (K, 0, False): (K, 0, 0), (K + 1, 0, False): (1, 1, 0), (256, 0, False): (1, 15, 15),
    (0, 0, True): (0, 0, 0), (1, 0, True): (1, 0, 0), (2, 0, True): (2, 0, 0),
    (K, 0, True): (K, 0, 0), (K + 1, 0, True): (1, 1, 0), (256, 0, True): (1, 15, 15),
    (0, 7, False): (0, 0, 0), (1, 7, False): (1, 0, 0), (2, 7, False): (2, 0, 0),
    (K, 7, False): (K, 0, 0), (K + 1, 7, False): (1, 1, 0), (256, 7, False): (1, 15, 15),
    (0, 7, True): (0, 0, 0), (1, 7, True): (1, 0, 0), (2, 7, True): (2, 0, 0),
    (K, 7, True): (0, 1, 0), (K + 1, 7, True): (0, 1, 1), (256, 7, True): (0, 16, 0),
}


@pytest.mark.parametrize("n,iteration,captured", list(PLANS))
def test_plan(n, iteration, captured):
    assert K == 16
    head, replays, tail = dl.plan(n, iteration, K, captured)
    assert (head, replays, tail) == PLANS[n, iteration, captured]
    assert head + replays * K + tail == n
    if iteration == 0 and n:
        assert head >= 1  # the Euler step is never recorded


def _flagship(**kw):
    cfg, grid, state = baroclinic_instability_model(32, 16, 4, device="cpu", **kw)
    return (lambda s, n: loop(cfg, grid, s, DT, n),
            functools.partial(time_step, cfg, grid, dt=DT, premasked=True), grid, state)


def _climate():
    ccfg, grid, atmos, state = data_free_ocean_climate_model(resolution=8.0, Nz=4, device="cpu")
    return (lambda s, n: coupled_loop(ccfg, grid, atmos, s, DT, n),
            functools.partial(coupled_time_step, ccfg, grid, atmos, dt=DT, premasked=True), grid,
            premask_state(grid, state))


def _shallow_water():
    cfg, grid, state = shallow_water_model(48, 24, device="cpu")
    return (lambda s, n: sw_loop(cfg, grid, s, DT, n),
            functools.partial(sw_time_step, cfg, grid, dt=DT), grid, state)


MODELS = {
    "flagship": _flagship,
    "flagship_k6_route": lambda: _flagship(kernels="pallas"),
    "keps": lambda: _flagship(closure=TKEDissipationVerticalDiffusivity()),
    "climate": _climate,
    "shallow_water": _shallow_water,
}


def _assert_same(a, b):
    ta, tb = dl._tensors(a), dl._tensors(b)
    assert list(ta) == list(tb) and a.iteration == b.iteration
    for name in ta:
        assert torch.equal(ta[name], tb[name]), name


@pytest.mark.parametrize("model", list(MODELS))
def test_cpu_loop_equals_step_calls(model):
    run_n, step, _, state = MODELS[model]()
    dl.STATS.reset()
    got = run_n(state, 3)
    _assert_same(got, dl.host_loop(step, state, 3))
    assert got.iteration == 3
    assert (dl.STATS.eager_steps, dl.STATS.replays) == (3, 0)


def _graphs(cache):
    return [e for e in cache.values() if isinstance(e, dl._Captured)]


class _EmulatedGraph:
    """On the CPU, what a captured block does on the card: ``block`` steps
    from the static state, the result copied back into it. It holds the
    step by weak reference, as a CUDA graph holds nothing of it, unless
    ``strong`` (a loop makes its step anew at each call: a later call
    replays the graph after the first call's step is gone)."""

    def __init__(self, step, state, static, block, strong=False):
        self.step = (lambda: step) if strong else weakref.ref(step)
        self.state, self.static, self.block = state, static, block

    def replay(self):
        out = dl._tensors(dl.host_loop(self.step(), dl._with_tensors(self.state, self.static),
                                       self.block))
        dl._check_aliases(out, self.static)
        for field, t in out.items():
            if t is not self.static[field]:
                self.static[field].copy_(t)


def _emulated_capture(step, state, block, key, cache, strong=False):
    assert not _graphs(cache), "a capture began with another graph kept"
    static = {field: t.clone() for field, t in dl._tensors(state).items()}
    dl.STATS.captures += 1
    dl.STATS.captured_steps += block
    return dl._Captured(_EmulatedGraph(step, state, static, block, strong), static, key,
                        dl._kept(step, cache), {})


@pytest.fixture
def emulated(monkeypatch):
    monkeypatch.setattr(dl, "_on_card", lambda tensors: True)
    monkeypatch.setattr(dl, "_capture", _emulated_capture)


@pytest.mark.parametrize("model", ["flagship", "climate", "shallow_water"])
def test_replay_machinery_matches_host_loop(model, emulated):
    _, step, grid, state = MODELS[model]()
    block, cache = 3, grid.cache
    dl.STATS.reset()
    # iteration 0, no graph: the Euler step, a capture, 2 replays and 2 steps
    a = dl.device_loop(step, state, 9, cache, block)
    a_copy = dl._with_tensors(a, {f: t.clone() for f, t in dl._tensors(a).items()})
    # the graph kept: 2 replays; then 1 replay and 1 step
    b = dl.device_loop(step, a, 6, cache, block)
    c = dl.device_loop(step, b, 4, cache, block)
    st = dl.STATS
    assert (st.captures, st.replays, st.replayed_steps, st.eager_steps) == (1, 5, 15, 4)
    assert c.iteration == 19
    _assert_same(a, dl.host_loop(step, state, 9))
    _assert_same(c, dl.host_loop(step, state, 19))
    _assert_same(a, a_copy)  # untouched by the later calls
    static = _graphs(cache)[0].static
    kept = {t.untyped_storage().data_ptr() for t in static.values()}
    for s in (a, b, c):
        assert not kept & {t.untyped_storage().data_ptr() for t in dl._tensors(s).values()}


def test_second_key_frees_first_graph(emulated):
    """One graph a grid: a call with another dt frees the kept graph, by
    reference count alone, before it captures its own; a call with the
    first dt again captures anew, and one with the same key replays."""
    cfg, grid, state = shallow_water_model(48, 24, device="cpu")
    steps = {dt: functools.partial(sw_time_step, cfg, grid, dt=dt) for dt in (DT, 30.0)}
    collecting = gc.isenabled()
    gc.disable()
    try:
        dl.STATS.reset()
        a = dl.device_loop(steps[DT], state, 4, grid.cache, 3)
        first = weakref.ref(_graphs(grid.cache)[0])
        b = dl.device_loop(steps[30.0], a, 4, grid.cache, 3)
        assert first() is None
        (second,) = _graphs(grid.cache)
        dl.device_loop(steps[30.0], b, 3, grid.cache, 3)
        assert _graphs(grid.cache) == [second]
        assert (dl.STATS.captures, dl.STATS.replays) == (2, 3)
    finally:
        if collecting:
            gc.enable()
    _assert_same(b, dl.host_loop(steps[30.0], dl.host_loop(steps[DT], state, 4), 4))


def test_key_holds_objects_weakly(emulated):
    """The key holds a config and dt by value and the grid and an
    atmosphere by weak reference, told apart by identity: an equal config
    made anew replays the kept graph, another atmosphere object does not,
    and the entry keeps neither the grid nor the atmosphere alive."""
    ccfg, grid, atmos, state = data_free_ocean_climate_model(resolution=8.0, Nz=4, device="cpu")
    state = premask_state(grid, state)
    dl.STATS.reset()
    step = functools.partial(coupled_time_step, ccfg, grid, atmos, dt=DT)
    a = dl.device_loop(step, state, 4, grid.cache, 3)
    (entry,) = _graphs(grid.cache)
    func, args, keywords = entry.key[0]
    assert isinstance(func, dl._Ref) and args[0] == ccfg and keywords == (("dt", DT),)
    assert all(isinstance(x, dl._Ref) for x in args[1:])
    assert args[1].ref() is grid and args[2].ref() is atmos
    same = functools.partial(coupled_time_step, dataclasses.replace(ccfg), grid, atmos, dt=DT)
    dl.device_loop(same, a, 3, grid.cache, 3)
    assert (dl.STATS.captures, dl.STATS.replays) == (1, 2)
    other = dataclasses.replace(atmos)
    other_step = functools.partial(coupled_time_step, ccfg, grid, other, dt=DT)
    dl.device_loop(other_step, a, 4, grid.cache, 3)
    assert dl.STATS.captures == 2
    gone = weakref.ref(other)
    del other, other_step
    assert gone() is None
    with pytest.raises(TypeError, match="functools.partial"):
        dl.device_loop(lambda s: s, state, 4, grid.cache, 3)


def _forced_1x1(model, mode):
    """(fn, step, grid, state): the forced 1x1 ``model`` ("flagship" or
    "tripolar" climate at exchange_width 8: four blocks a step, the bench
    rows' 30 exceeds the fold's rows at this size), its
    ``sharded_*_step_fn``, the tile's step (``fn.step``) at DT and the
    premasked state."""
    fs = SplitExplicitFreeSurface(exchange_width=8)
    if model == "flagship":
        cfg, grid, state = baroclinic_instability_model(32, 16, 4, device="cpu")
        cfg = dataclasses.replace(cfg, free_surface=fs)
        fn = sharded_step_fn(cfg, grid, Mesh(1, 1), force_comm=mode)
    else:
        ccfg, grid, atmos, state = data_free_ocean_climate_model(
            resolution=8.0, Nz=4, device="cpu", grid_type="gaussian_islands_tripolar")
        ccfg = dataclasses.replace(ccfg, ocean=dataclasses.replace(ccfg.ocean, free_surface=fs))
        fn = sharded_coupled_step_fn(ccfg, grid, atmos, Mesh(1, 1), force_comm=mode)
    return fn, functools.partial(fn.step, dt=DT), fn.grid, premask_state(fn.grid, state)


@pytest.mark.parametrize("mode", ["local", "ring"])
@pytest.mark.parametrize("model", ["flagship", "tripolar"])
def test_forced_1x1_loops_replay(model, mode, monkeypatch):
    """One fn, two calls: the Euler step, a capture, a replay and a step
    left over; then two replays of the kept graph; equal to the host loop
    bit for bit. The graph is keyed by the comm (a ``_Ref``) and keeps the
    blocked solve's statics from the comm's cache."""
    monkeypatch.setattr(dl, "_on_card", lambda tensors: True)
    monkeypatch.setattr(dl, "_capture", functools.partial(_emulated_capture, strong=True))
    fn, step, grid, state = _forced_1x1(model, mode)
    dl.STATS.reset()
    a = fn(state, DT, 1 + K + 1)
    b = fn(a, DT, 2 * K)
    st = dl.STATS
    assert (st.captures, st.replays, st.eager_steps) == (1, 3, 2)
    want_a = dl.host_loop(step, state, 1 + K + 1)
    _assert_same(a, want_a)
    _assert_same(b, dl.host_loop(step, want_a, 2 * K))
    (entry,) = _graphs(grid.cache)
    keywords = dict(entry.key[0][2])
    comm = fn.step.keywords["comm"]
    assert isinstance(keywords["comm"], dl._Ref) and keywords["comm"].ref() is comm
    statics = list(comm.cache.values())
    assert statics and all(any(v is k for k in entry.keep) for v in statics)
    assert all(any(v is k for k in entry.keep) for n, v in grid.cache.items() if n != dl._ENTRY)


def test_loops_of_several_ranks_stay_on_the_host(monkeypatch):
    """``loop``, ``coupled_loop`` and ``sw_loop`` with a comm whose mesh
    has two ranks run ``host_loop`` (gloo cannot capture), with a 1x1
    comm ``device_loop``; ``post`` refuses to exchange under a capture."""
    calls = []

    def record(name):
        def run(step, state, n, *args):
            calls.append((name, step.keywords["comm"].mesh.size))
            return state
        return run

    monkeypatch.setattr(dl, "host_loop", record("host"))
    monkeypatch.setattr(dl, "device_loop", record("device"))
    cfg, grid, state = baroclinic_instability_model(32, 16, 4, device="cpu")
    ccfg, cgrid, atmos, cstate = data_free_ocean_climate_model(resolution=8.0, Nz=4,
                                                               device="cpu")
    swcfg, swgrid, swstate = shallow_water_model(48, 24, device="cpu")
    for mesh in (Mesh(2, 1), Mesh(1, 1)):
        loop(cfg, grid, state, DT, 2, make_comm(mesh, grid))
        coupled_loop(ccfg, cgrid, atmos, cstate, DT, 2, make_comm(mesh, cgrid))
        sw_loop(swcfg, swgrid, swstate, DT, 2, make_comm(mesh, swgrid))
    assert calls == [("host", 2)] * 3 + [("device", 1)] * 3
    assert not dl.spans_ranks(None) and dl.spans_ranks(make_comm(Mesh(2, 1)))

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="under a CUDA graph capture"):
        mesh_mod.post([object()])
    mesh_mod.post([])  # nothing to post: no exchange, nothing refused
