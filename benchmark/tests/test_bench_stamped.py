"""The stamped phase (``stamped.py``) and the readers of its four metrics.

- the readers on made-up ``ctx.stamps``: each reads its span or counter a
  replayed step or a call, and gives None where the run has no stamps or
  no such span;
- the phase on the CPU at a small size, the graphs emulated as in
  tests/test_torch_device_loop.py (a "replay" runs the block's steps on the
  static state): after a window and the readings taken from it, the phase
  recaptures, reads 4 whole replayed calls and leaves the window's output,
  its snapshot, its stats and every reading from them as they were; its
  stamps hold each stage a replayed step, the boundaries between the 4
  calls and the state copied twice a call.
"""

import types

import pytest
import torch

from benchmark import spec, stamped
from benchmark.counts.shape import Shape
from small import small_cell

NEW = ("teos10_replayed_ms", "fluxes_replayed_ms", "call_boundary_ms", "boundary_copy_gib")


def _span(total_ms, count=1, parent="step"):
    return {"total_ms": total_ms, "self_ms": total_ms, "count": count, "parent": parent,
            "host_ms": 0.0, "host_count": 0}


STAMPS = {
    "spans": {"step": _span(640.0, 16, "loop/replay"), "step/teos10": _span(480.0, 16),
              "step/interface_fluxes": _span(32.0, 16), "step/seaice": _span(16.0, 32)},
    "steps": 16, "calls": 4, "copy_bytes": 8 * 2**30,
    "boundary": {"boundaries": 3, "boundary_ms": 2.5, "copy_ms": 2.0, "idle_ms": 0.5,
                 "named_ms": {"sim/callbacks": 0.5}, "unnamed_ms": 0.0,
                 "clock_uncertainty_ms": 0.01, "dropped": 0},
    "ms_per_step": 40.0,
}


def test_readers_on_made_up_stamps():
    ctx = types.SimpleNamespace(stamps=STAMPS)
    got = {name: spec.reader(name).read(ctx) for name in NEW}
    assert got == {"teos10_replayed_ms": 30.0, "fluxes_replayed_ms": 3.0,
                   "call_boundary_ms": 2.5, "boundary_copy_gib": 2.0}


def test_readers_find_nothing_to_read():
    for ctx in (types.SimpleNamespace(), types.SimpleNamespace(stamps=None)):
        assert all(spec.reader(name).read(ctx) is None for name in NEW)
    bare = {**STAMPS, "spans": {"step": _span(1.0)}, "boundary": None, "copy_bytes": 0}
    ctx = types.SimpleNamespace(stamps=bare)
    assert all(spec.reader(name).read(ctx) is None for name in NEW)


class _Graph:
    """A captured block on the CPU: its steps from the static state, the
    result copied back in (the step held: a loop makes its step anew)."""

    def __init__(self, dl, step, state, static, block):
        self.dl, self.step, self.state, self.static, self.block = dl, step, state, static, block

    def replay(self):
        dl = self.dl
        out = dl._tensors(dl.host_loop(self.step, dl._with_tensors(self.state, self.static),
                                       self.block))
        for field, t in out.items():
            if t is not self.static[field]:
                self.static[field].copy_(t)


@pytest.fixture
def emulated(monkeypatch):
    from gb25_tpu_torch.models import device_loop as dl

    def capture(step, state, block, key, cache, share=None):
        static = share.static if share is not None else {
            f: t.clone() for f, t in dl._tensors(state).items()}
        dl.STATS.captures += 1
        dl.STATS.captured_steps += block
        return dl._Captured(_Graph(dl, step, state, static, block), static, key,
                            dl._kept(step, cache), {})

    monkeypatch.setattr(dl, "_on_card", lambda tensors: True)
    monkeypatch.setattr(dl, "_capture", capture)
    return dl


def _readings(cell, r, steps, wall):
    ctx = types.SimpleNamespace(shape=Shape.of(cell.config), steps=steps, wall_s=wall,
                                stats=r.stats, workload=cell.workload, config=cell.config)
    return {m: spec.reader(m).read(ctx)
            for m in ("replayed_steps_pct", "graph_pool_gib", "step_mfu_pct")}


@pytest.mark.parametrize("name", ["bi_flagship.loop", "ocean_climate_q.sim"])
def test_phase_leaves_the_window_as_it_was(name, emulated):
    cell = small_cell(name)
    w = cell.workload
    r = spec.driver(w["driver"]).Run(cell.config, w, 20260418, "cpu")
    r.setup()
    steps, wall = r.window(0.01, lambda: 0)
    before = _readings(cell, r, steps, wall)
    out = {k: t.clone() for k, t in r.output().items()}
    snap = {k: t.clone() for k, t in r.snapshot.items()}
    stats = dict(r.stats)
    stamps = stamped.phase(r, w["driver"])
    assert _readings(cell, r, steps, wall) == before and r.stats == stats
    for mine, kept in ((r.output(), out), (r.snapshot, snap)):
        assert mine.keys() == kept.keys()
        assert all(torch.equal(mine[k], kept[k]) for k in kept)
    block = w.get("call_steps") or w["inner_steps"]
    assert stamps["steps"] == stamped.CALLS * block and stamps["calls"] == stamped.CALLS
    spans = stamps["spans"]
    assert spans["step"]["count"] == stamps["steps"] and spans["step"]["parent"] == "loop/replay"
    assert spans["step/teos10"]["count"] == stamps["steps"]
    assert spans["loop/call"]["count"] == stamped.CALLS
    assert stamps["boundary"]["boundaries"] == stamped.CALLS - 1
    nbytes = sum(t.numel() * t.element_size()
                 for t in emulated._tensors(r.sim.state if "sim" in name else r.state).values())
    if "sim" in name:
        from benchmark.reference.model import fields_of

        nbytes += sum(t.numel() * t.element_size() for t in fields_of(r.holder["ice"]).values())
    assert stamps["copy_bytes"] == 2 * stamped.CALLS * nbytes
    from gb25_tpu_torch.utils import tracing

    assert tracing.stamping() is None
    ctx = types.SimpleNamespace(stamps=stamps)
    got = {m: spec.reader(m).read(ctx) for m in NEW}
    assert got["teos10_replayed_ms"] > 0 and got["call_boundary_ms"] > 0
    assert (got["fluxes_replayed_ms"] is None) == ("sim" not in name)
    stamped.log(stamps, 1e3 * wall / steps)
