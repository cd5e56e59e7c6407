"""The port's production-run path against the JAX package's: the
``Simulation`` driver, the output writers, sharded checkpoints and the two
run scripts; and the device loop's chunk replay.

- Schedules: the port's ``Simulation`` and JAX's, driven by the same stub
  step function (the clock and iteration advanced by n steps), call it
  with the same chunks and fire callbacks, writers and checkpoints (with
  ``keep``) at the same (iteration, time) list: stop_iteration, stop_time,
  aligned TimeIntervals, writers' intervals and small chunks
  (tests/test_harness.py's cases).
- Records: a short coupled run (float64, 32x16x4, 4 steps, records every 2
  steps) through both packages' ``Simulation`` with an NPZ and a NetCDF
  writer each: the records of each package read by both packages' readers
  agree at 1e-10 of each field's largest value.
- Checkpoints: a round trip bit for bit (float32 state, the clock and the
  iteration); the JAX loaders read a port checkpoint and the port's
  ``restore_state`` reads a JAX checkpoint, bit for bit. (A checkpoint
  that a 2x1 gloo mesh wrote is read back in tests/test_torch_data.py,
  which runs the slice's decomposed cases on one spawn.)
- Scripts: the port's ``ocean_climate_simulation`` main (15x7x4 on the
  CPU, dt 1 hour, slab ice, NetCDF output, 3.5 days: two records) writes
  its records; ``run_10day --phase all`` at 32x16x4 on the CPU (its main
  in this process, each phase a process of its own) reports
  ``bitwise_equal``.
- The device loop (graph emulated on the CPU, as tests/test_torch_device_loop.py
  does): ``lead_plan``'s split; a ``Simulation`` of chunks of 4 replays
  every full chunk (the first from its lead graph of 3 after the Euler
  step) and equals the host loop bit for bit; the (ocean, ice) carry of
  ``coupled_ice_loop`` replays as one state; a restoring dict is keyed by
  its tensors, which the graph keeps.
"""

import dataclasses
import functools
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gb25_tpu.io as jax_io
import gb25_tpu.simulation as jax_sim
from gb25_tpu.data.netcdf import read_netcdf as jax_read_netcdf
from gb25_tpu.grids import simple_latitude_longitude_grid as jax_latlon
from gb25_tpu.io.output import NetCDFOutputWriter as JaxNetCDFWriter
from gb25_tpu.models.coupled import coupled_loop as jax_coupled_loop
from gb25_tpu.models.state import initial_state as jax_initial_state
from gb25_tpu.simulation.simulation import CheckpointWriter as JaxCheckpointWriter
from gb25_tpu.utils.correctness import _leaf_names
import gb25_tpu_torch.io as port_io
import gb25_tpu_torch.simulation as port_sim
from gb25_tpu_torch.convert import state_from_numpy, state_to_numpy
from gb25_tpu_torch.data.netcdf import read_netcdf
from gb25_tpu_torch.grids import simple_latitude_longitude_grid
from gb25_tpu_torch.io.output import NetCDFOutputWriter
from gb25_tpu_torch.models import (
    baroclinic_instability_model,
    coupled_ice_loop,
    coupled_loop,
    data_free_ocean_climate_model,
    initial_ice_state,
    time_step,
)
from gb25_tpu_torch.models import device_loop as dl
from gb25_tpu_torch.models.hydrostatic import premask_state
from gb25_tpu_torch.models.state import initial_state
from test_torch_climate import _models
from test_torch_device_loop import _EmulatedGraph, _assert_same

DT = 60.0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors (the other test
    files' reason)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_arrays(state):
    return {name: np.asarray(x) for name, x in _leaf_names(state)}


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

CASES = {
    "stop_iteration": dict(stop_iteration=10, inner_steps=4, callback=("iteration", 5)),
    "stop_time": dict(stop_time=300.0, inner_steps=16),
    "time_interval": dict(stop_time=1500.0, inner_steps=7, callback=("time", 300.0)),
    "writer_interval": dict(stop_time=720.0, inner_steps=5, writer=240.0),
    "small_chunks": dict(stop_time=720.0, inner_steps=2, writer=240.0),
    "checkpoints": dict(stop_time=1800.0, inner_steps=4, callback=("iteration", 3),
                        checkpoint=(600.0, 2)),
}


def _run_schedule(pkg, case, tmp):
    """Run ``case`` through package ``pkg`` ("jax" or "port") with a stub
    step function; the chunks it asked for, the callbacks' (iteration,
    time), the records' (iteration, time) and the checkpoints kept."""
    sim_mod, io_mod = (jax_sim, jax_io) if pkg == "jax" else (port_sim, port_io)
    if pkg == "jax":
        grid = jax_latlon(16, 8, 4, dtype=jnp.float64)
        state = jax_initial_state(grid)
    else:
        grid = simple_latitude_longitude_grid(16, 8, 4, device="cpu", dtype=torch.float64)
        state = initial_state(grid)
    calls, fired = [], []

    def step_fn(cfg, g, s, dt, n):
        calls.append(n)
        return s.replace(time=s.time + n * dt, iteration=s.iteration + n)

    sim = sim_mod.Simulation(None, grid, state, DT, stop_time=case.get("stop_time"),
                             stop_iteration=case.get("stop_iteration"),
                             inner_steps=case["inner_steps"], step_fn=step_fn)
    if "callback" in case:
        kind, every = case["callback"]
        sched = (sim_mod.IterationInterval(every) if kind == "iteration"
                 else sim_mod.TimeInterval(every))
        sim.add_callback(lambda s: fired.append((s.iteration, s.time)), sched)
    out = os.path.join(tmp, pkg)
    if "writer" in case:
        sim.add_output_writer(io_mod.NPZOutputWriter(os.path.join(out, "npz"),
                                                     interval_seconds=case["writer"]))
    if "checkpoint" in case:
        interval, keep = case["checkpoint"]
        writer = (JaxCheckpointWriter if pkg == "jax" else port_sim.CheckpointWriter)
        sim.add_output_writer(writer(os.path.join(out, "ckpt"), interval, keep=keep))
    sim.run()
    records = []
    for f in sorted(glob.glob(os.path.join(out, "npz", "*.npz"))):
        with np.load(f) as d:
            records.append((int(d["iteration"]), float(d["time"])))
    kept = sorted(os.path.basename(p) for p in glob.glob(os.path.join(out, "ckpt", "*")))
    return {"calls": calls, "fired": fired, "records": records, "checkpoints": kept,
            "end": (sim.iteration, sim.time)}


@pytest.mark.parametrize("case", list(CASES))
def test_simulation_schedules_match_jax(tmp_path, case):
    want = _run_schedule("jax", CASES[case], str(tmp_path))
    got = _run_schedule("port", CASES[case], str(tmp_path))
    assert got == want
    if case == "stop_iteration":
        assert got["fired"] == [(5, 300.0), (10, 600.0)]
    if case == "small_chunks":
        assert [t for _, t in got["records"]] == [0.0, 240.0, 480.0, 720.0]
    if case == "checkpoints":
        assert got["checkpoints"] == ["ckpt_iter000000020", "ckpt_iter000000030"]


# ---------------------------------------------------------------------------
# records of a short coupled run
# ---------------------------------------------------------------------------

def test_npz_and_netcdf_records_match_jax_f64(tmp_path, monkeypatch):
    monkeypatch.setenv("GB25_BAROTROPIC_BLOCK", "1")
    monkeypatch.delenv("GB25_ZSLAB_INTERPRET", raising=False)
    (cj, gj, aj, sj), (ct, gt, at, st) = _models(12.0, 4, torch.float64)
    cj = dataclasses.replace(cj, ocean=dataclasses.replace(cj.ocean, kernels="jnp"))
    jloop = jax.jit(jax_coupled_loop, static_argnames="n")
    runs = {
        "jax": (jax_sim, jax_io, JaxNetCDFWriter, gj, sj,
                lambda c, g, s, dt, n: jloop(cj, g, aj, s, dt, n)),
        "port": (port_sim, port_io, NetCDFOutputWriter, gt, st,
                 lambda c, g, s, dt, n: coupled_loop(ct, g, at, s, dt, n, chunk=2)),
    }
    for pkg, (sim_mod, io_mod, nc_writer, grid, state, step_fn) in runs.items():
        sim = sim_mod.Simulation(None, grid, state, DT, stop_iteration=4, inner_steps=2,
                                 step_fn=step_fn)
        sim.add_output_writer(io_mod.NPZOutputWriter(str(tmp_path / pkg),
                                                     interval_seconds=2 * DT))
        nc = nc_writer(str(tmp_path / f"{pkg}.nc"), grid, interval_seconds=2 * DT)
        sim.add_output_writer(nc)
        sim.run()
        nc.close()
    for name in port_io.STANDARD_OUTPUTS:
        series = {(pkg, reader): read(str(tmp_path / pkg), name)
                  for pkg in runs for reader, read in (("jax", jax_io.read_series),
                                                       ("port", port_io.read_series))}
        times, want = series["jax", "jax"]
        assert list(times) == [0.0, 120.0, 240.0] and want.shape == (3, gj.Nx, gj.Ny)
        for key, (t, got) in series.items():
            assert list(t) == list(times), key
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max(),
                                       err_msg=f"{name} {key}")
    ncs = {(pkg, reader): read(str(tmp_path / f"{pkg}.nc"))[0]
           for pkg in runs for reader, read in (("jax", jax_read_netcdf), ("port", read_netcdf))}
    want = ncs["jax", "jax"]
    for key, got in ncs.items():
        assert set(got) == set(want), key
        for name, w in want.items():
            w = np.asarray(w, np.float64)
            np.testing.assert_allclose(np.asarray(got[name], np.float64), w, rtol=0,
                                       atol=1e-10 * np.abs(w).max(), err_msg=f"{name} {key}")
    assert want["u_surface"].shape == (3, gj.Nx, gj.Ny) and np.abs(want["u_surface"]).max() > 0


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _random_state(dtype=torch.float32, seed=0):
    """A port climate state (T, S, e) at 32x16x4 with every field random,
    the clock and the iteration set."""
    _, grid, _, state = data_free_ocean_climate_model(resolution=12.0, Nz=4, device="cpu",
                                                      dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    arrays = {k: torch.randn(v.shape, generator=gen, dtype=torch.float64).numpy().astype(v.dtype)
              if v.ndim else v for k, v in state_to_numpy(state).items()}
    arrays["time"] = np.asarray(7261.5, arrays["time"].dtype)
    arrays["time_lo"] = np.asarray(-3.5e-5, arrays["time_lo"].dtype)
    arrays["iteration"] = np.asarray(121, np.int32)
    return grid, state_from_numpy(arrays, "cpu"), arrays


def _assert_arrays_equal(got, want):
    assert list(got) == list(want)
    for name in want:
        assert np.asarray(got[name]).dtype == np.asarray(want[name]).dtype, name
        assert np.shape(got[name]) == np.shape(want[name]), name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_checkpoint_round_trip_bitwise(tmp_path):
    grid, state, arrays = _random_state()
    port_io.save_sharded_state(state, str(tmp_path), extra_metadata={"note": "x"})
    assert port_io.load_metadata(str(tmp_path)) == {"iteration": 121, "time": 7261.5,
                                                    "nprocs": 1, "note": "x"}
    back = port_io.restore_state(initial_state(grid, ("T", "S", "e")), str(tmp_path))
    assert back.iteration == 121 and back.u.dtype == torch.float32
    _assert_arrays_equal(state_to_numpy(back), arrays)
    _assert_arrays_equal(port_io.load_all_fields(str(tmp_path)), arrays)


def test_checkpoint_cross_format_bitwise(tmp_path):
    grid, state, arrays = _random_state(seed=1)
    # the JAX loaders read the port's checkpoint
    port_io.save_sharded_state(state, str(tmp_path / "port"))
    _assert_arrays_equal(jax_io.load_all_fields(str(tmp_path / "port")), arrays)
    gj = jax_latlon(grid.Nx, grid.Ny, grid.Nz, dtype=jnp.float32)
    template = jax_initial_state(gj, ("T", "S", "e"), jnp.float32)
    _assert_arrays_equal(_jax_arrays(jax_io.restore_state(template, str(tmp_path / "port"))),
                         arrays)
    assert jax_io.load_metadata(str(tmp_path / "port"))["iteration"] == 121
    # the port reads JAX's checkpoint
    _, _, arrays2 = _random_state(seed=2)
    sj = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(template),
                                      [jnp.asarray(arrays2[name]) for name in arrays2])
    jax_io.save_sharded_state(sj, str(tmp_path / "jax"))
    back = port_io.restore_state(initial_state(grid, ("T", "S", "e")), str(tmp_path / "jax"))
    _assert_arrays_equal(state_to_numpy(back), arrays2)


# ---------------------------------------------------------------------------
# the run scripts
# ---------------------------------------------------------------------------

def test_ocean_climate_simulation_script_cpu(tmp_path):
    from gb25_tpu_torch.scripts import ocean_climate_simulation as script

    sim, run = script.main(["--resolution", "24", "--Nz", "4", "--dt", "3600", "--device", "cpu",
                            "--sea-ice", "slab", "--output-format", "netcdf",
                            "--stop-days", "3.5", "--output-dir", str(tmp_path)])
    assert sim.iteration == 84 and abs(sim.time - 3.5 * 86400.0) < 1e-3
    v, dims, _ = jax_read_netcdf(str(tmp_path / "surface.nc"))
    assert list(v["time"]) == [0.0, 3 * 86400.0] and list(v["iteration"]) == [0, 72]
    assert v["T_surface"].shape == (2, 15, 7) and dims["T_surface"] == ("time", "x", "y")
    assert np.isfinite(v["T_surface"]).all() and np.isfinite(v["u_surface"]).all()
    ice = run["ice"]
    assert float(ice.v.min()) >= 0.0 and 0.0 <= float(ice.a.min()) <= float(ice.a.max()) <= 1.0


def test_run_10day_all_cpu_bitwise(tmp_path):
    from gb25_tpu_torch.scripts import run_10day

    out, js = str(tmp_path / "out"), str(tmp_path / "run.json")
    run_10day.main(["--phase", "all", "--nx", "32", "--nz", "4", "--dt", "432", "--days", "0.1",
                    "--device", "cpu", "--out", out, "--json-out", js])
    with open(js) as f:
        res = json.load(f)
    assert res["comparison"] == {"bitwise_equal": True, "mismatched_fields": {}, "n_fields": 15}
    assert res["interrupt"]["iteration"] == 10 and res["resume"]["iteration"] == 20
    assert res["full"]["finite"] and res["full"]["max_abs_u"] > 0.0


# ---------------------------------------------------------------------------
# the device loop's chunks (graphs emulated on the CPU)
# ---------------------------------------------------------------------------

# (n, iteration, captured) -> (head, lead, replays, tail) for chunks of 4
LEAD_PLANS = {
    (3, 0, False): (3, 0, 0, 0), (4, 0, False): (1, 3, 0, 0), (9, 0, False): (1, 3, 1, 1),
    (4, 0, True): (1, 3, 0, 0), (4, 8, False): (1, 3, 0, 0), (4, 8, True): (0, 0, 1, 0),
    (10, 8, True): (0, 0, 2, 2), (2, 8, True): (2, 0, 0, 0),
}


@pytest.mark.parametrize("n,iteration,captured", list(LEAD_PLANS))
def test_lead_plan(n, iteration, captured):
    head, lead, replays, tail = dl.lead_plan(n, iteration, 4, captured)
    assert (head, lead, replays, tail) == LEAD_PLANS[n, iteration, captured]
    assert head + lead + 4 * replays + tail == n


def _emulated_capture(step, state, block, key, cache, share=None):
    static = (share.static if share is not None
              else {field: t.clone() for field, t in dl._tensors(state).items()})
    dl.STATS.captures += 1
    dl.STATS.captured_steps += block
    return dl._Captured(_EmulatedGraph(step, state, static, block, strong=True), static, key,
                        dl._kept(step, cache), {})


@pytest.fixture
def emulated(monkeypatch):
    monkeypatch.setattr(dl, "_on_card", lambda tensors: True)
    monkeypatch.setattr(dl, "_capture", _emulated_capture)


def test_simulation_chunks_replay_whole(emulated):
    """Chunks of 4 to iteration 13: the first chunk the Euler step and its
    lead graph of 3, the next two the graph of 4, the last (cut to 1 by
    the stop) eager; the result is the host loop's, bit for bit."""
    cfg, grid, state = baroclinic_instability_model(32, 16, 4, device="cpu")
    dl.STATS.reset()
    sim = port_sim.Simulation(cfg, grid, state, DT, stop_iteration=13, inner_steps=4)
    chunks = []
    sim.add_callback(lambda s: chunks.append(s.iteration), port_sim.IterationInterval(4))
    sim.run()
    st = dl.STATS
    assert chunks == [4, 8, 12]
    assert (st.captures, st.replays, st.replayed_steps, st.eager_steps) == (2, 3, 11, 2)
    assert {dl._ENTRY, dl._LEAD} <= set(grid.cache)
    assert grid.cache[dl._ENTRY].static is grid.cache[dl._LEAD].static
    step = functools.partial(time_step, cfg, grid, dt=DT, premasked=True)
    _assert_same(sim.state, dl.host_loop(step, state, 13))


def test_ice_pair_and_restoring_replay(emulated):
    """``coupled_ice_loop`` with restoring: the (ocean, ice) pair replays as
    one state, equal to the host loop bit for bit; the graph keeps the
    restoring tensors; the same dict replays, a dict with another tensor
    captures anew."""
    from gb25_tpu_torch.data import climatology_restoring
    from gb25_tpu_torch.models.coupled import OceanIceState, _ice_pair_step

    ccfg, grid, atmos, state = data_free_ocean_climate_model(resolution=12.0, Nz=4,
                                                             device="cpu", sea_ice="slab")
    phi = grid.phi_c_i.reshape(1, -1, 1).expand(grid.shape)
    state = state.replace(tracers={**state.tracers,
                                   "T": torch.where(phi.abs() > 60, -2.2, state.tracers["T"])})
    ice = initial_ice_state(grid)
    restoring = climatology_restoring(grid, rate=1.0 / 3600.0)
    dl.STATS.reset()
    s1, i1 = coupled_ice_loop(ccfg, grid, atmos, state, ice, DT, 1 + 2 * dl.BLOCK_STEPS,
                              restoring=restoring)
    assert (dl.STATS.captures, dl.STATS.replays) == (1, 2)
    step = functools.partial(_ice_pair_step, ccfg, grid, atmos, dt=DT, comm=None,
                             restoring=restoring, premasked=True)
    want = dl.host_loop(step, OceanIceState(premask_state(grid, state), ice),
                        1 + 2 * dl.BLOCK_STEPS)
    _assert_same(OceanIceState(s1, i1), want)
    assert float(i1.v.max()) > 0.0
    entry = grid.cache[dl._ENTRY]
    assert all(any(t is k for k in entry.keep) for pair in restoring.values() for t in pair)
    coupled_ice_loop(ccfg, grid, atmos, s1, i1, DT, dl.BLOCK_STEPS, restoring=restoring)
    assert dl.STATS.captures == 1
    other = {**restoring, "T": (restoring["T"][0].clone(), restoring["T"][1])}
    coupled_ice_loop(ccfg, grid, atmos, s1, i1, DT, 1 + dl.BLOCK_STEPS, restoring=other)
    assert dl.STATS.captures == 2
