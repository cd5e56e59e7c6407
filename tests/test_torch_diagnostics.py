"""The port's diagnostics, balanced jet, eddy-statistics arithmetic, halo
traffic, weak-scaling projection and trace summaries against the JAX
package's.

- ``utils.diagnostics``: each function on the same float64 state (JAX's
  flagship after 5 steps at 24x12x8, carried into the port) against JAX's
  at 1e-12 of its largest value, the layouts reversed; EKE + MKE times the
  volume equals the total kinetic energy (tests/test_eddy_statistics.py's
  identity) at 1e-12.
- ``balanced_jet_state`` at 32x16x8 float64, noise 0, bit for bit with
  JAX's from the same analytic T/S front (JAX's carried in: torch's and
  XLA's tanh differ by an ulp, which the front's gradient would carry into
  u), then 3 steps against JAX's (kernels "jnp", GB25_BAROTROPIC_BLOCK=1)
  at 1e-10.
- ``scripts.eddy_statistics``: ``eady_growth_rate`` on that state and
  ``fit_growth`` on synthetic series against the JAX probe's functions.
- ``MeshComm.traffic`` over one 3-D extension on a 2x2 gloo mesh: two
  exchanges (x, then y) and the bytes of the strips worked out from the
  tile and the halo; ``analysis.comm.project_weak_scaling`` against JAX's
  on the same counts; a ``weak_scaling`` sweep of 1, 2 and 4 gloo ranks at
  a 16x16x4 tile.
- ``analysis.trace.summarize`` of the Chrome trace ``with_profiler`` writes
  over two CPU steps, with ``annotate``'s labels.
"""

import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gb25_tpu.analysis.comm as jax_comm
import gb25_tpu.utils.diagnostics as jax_diag
from gb25_tpu.grids import simple_latitude_longitude_grid as jax_latlon
from gb25_tpu.models import baroclinic_instability_config as jax_config
from gb25_tpu.models import baroclinic_instability_state as jax_state
from gb25_tpu.models import loop as jax_loop
from gb25_tpu.models.baroclinic import balanced_jet_state as jax_balanced_jet_state
from gb25_tpu.utils.correctness import _leaf_names
import gb25_tpu_torch.models.baroclinic as port_baroclinic
import gb25_tpu_torch.utils.diagnostics as diag
from gb25_tpu_torch.analysis import comm as port_comm
from gb25_tpu_torch.analysis import trace
from gb25_tpu_torch.convert import state_from_numpy, state_to_numpy
from gb25_tpu_torch.grids import simple_latitude_longitude_grid
from gb25_tpu_torch.models import baroclinic_instability_config, loop, time_step
from gb25_tpu_torch.parallel import spawn
from gb25_tpu_torch.scripts import eddy_statistics, weak_scaling
from gb25_tpu_torch.utils.correctness import compare_states
from gb25_tpu_torch.utils.profiling import annotate, with_profiler
from test_torch_mesh_jobs import extension_traffic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors (the other test
    files' reason)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(state):
    return {name: np.asarray(x) for name, x in _leaf_names(state)}


def _probe():
    spec = importlib.util.spec_from_file_location(
        "eddy_statistics", os.path.join(REPO, "scripts", "probes", "eddy_statistics.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def stepped():
    """JAX's flagship after 5 steps of 120 s at 24x12x8 float64 (the JAX
    diagnostics tests' state), and the same state in the port."""
    gj = jax_latlon(24, 12, 8, dtype=jnp.float64)
    sj = jax.jit(jax_loop, static_argnames="n")(jax_config(), gj,
                                                 jax_state(gj, noise_velocity=1e-3), 120.0, n=5)
    gt = simple_latitude_longitude_grid(24, 12, 8, device="cpu", dtype=torch.float64)
    return gj, sj, gt, state_from_numpy(_arrays(sj), "cpu")


def _close(got, want, name, rel=1e-12):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-300),
                               err_msg=name)


def _t(x):
    """A port array in the JAX package's layout (axes reversed)."""
    return np.transpose(x.numpy())


# ---------------------------------------------------------------------------
# utils.diagnostics
# ---------------------------------------------------------------------------

def test_diagnostics_match_jax_f64(stepped):
    gj, sj, gt, st = stepped
    _close(_t(diag.surface_vorticity(gt, st)), jax_diag.surface_vorticity(gj, sj), "zeta")
    _close(_t(diag.surface_speed(st)), jax_diag.surface_speed(sj), "speed")
    _close(float(diag.total_kinetic_energy(gt, st)), jax_diag.total_kinetic_energy(gj, sj), "KE")
    for got, want, name in zip(diag.eddy_mean_kinetic_energy(gt, st),
                               jax_diag.eddy_mean_kinetic_energy(gj, sj), ("EKE", "MKE")):
        _close(float(got), want, name)
    _close(_t(diag.vertical_velocity(gt, st)), jax_diag.vertical_velocity(gj, sj), "w")
    for delta in (0.2, 1.0, 50.0):
        mld = diag.mixed_layer_depth(gt, st, delta_T=delta)
        _close(_t(mld), jax_diag.mixed_layer_depth(gj, sj, delta_T=delta), f"mld {delta}")
    assert diag.surface_vorticity(gt, st).shape == (12, 24)
    assert diag.mixed_layer_depth(gt, st).shape == (12, 24)


def test_eke_mke_identity(stepped):
    _, _, gt, st = stepped
    eke, mke = diag.eddy_mean_kinetic_energy(gt, st)
    assert float(eke) > 0 and float(mke) >= 0
    hy, hz = gt.hy, gt.hz
    vol = float(torch.sum(gt.azc[:, hy : hy + gt.Ny, :] * gt.dz_c[hz : hz + gt.Nz])) * gt.Nx
    np.testing.assert_allclose((float(eke) + float(mke)) * vol,
                               float(diag.total_kinetic_energy(gt, st)), rtol=1e-12)


# ---------------------------------------------------------------------------
# the balanced jet and the eddy probe's arithmetic
# ---------------------------------------------------------------------------

SHAPE = (32, 16, 8)


@pytest.fixture
def balanced(monkeypatch):
    """JAX's balanced jet (noise 0) and the port's from JAX's front."""
    gj = jax_latlon(*SHAPE, dtype=jnp.float64)
    front = _arrays(jax_state(gj, noise_velocity=0.0))
    monkeypatch.setattr(port_baroclinic, "baroclinic_instability_state",
                        lambda grid, **kw: state_from_numpy(front, grid.device))
    gt = simple_latitude_longitude_grid(*SHAPE, device="cpu", dtype=torch.float64)
    return gj, jax_balanced_jet_state(gj, noise_velocity=0.0), gt, \
        port_baroclinic.balanced_jet_state(gt, noise_velocity=0.0)


def test_balanced_jet_bitwise_then_three_steps(balanced, monkeypatch):
    monkeypatch.setenv("GB25_BAROTROPIC_BLOCK", "1")
    monkeypatch.delenv("GB25_ZSLAB_INTERPRET", raising=False)
    gj, sj, gt, st = balanced
    want, got = _arrays(sj), state_to_numpy(st)
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert np.abs(want["u"]).max() > 0.1 and np.abs(want["eta"]).max() > 0.1

    cfg_j = dataclasses.replace(jax_config(), kernels="jnp")
    sj = jax.jit(jax_loop, static_argnames="n")(cfg_j, gj, sj, 60.0, n=3)
    st = loop(baroclinic_instability_config(), gt, st, 60.0, 3)
    compare_states(_arrays(sj), state_to_numpy(st), rtol=1e-10, verbose=False)


def test_balanced_jet_noise_from_a_generator():
    """With noise the state adds a seeded draw to u and draws v (0 on the
    southern wall face); the same seed gives the same state."""
    gt = simple_latitude_longitude_grid(*SHAPE, device="cpu", dtype=torch.float64)
    a = port_baroclinic.balanced_jet_state(gt, noise_velocity=1e-5, seed=3)
    b = port_baroclinic.balanced_jet_state(gt, noise_velocity=1e-5, seed=3)
    calm = port_baroclinic.balanced_jet_state(gt, noise_velocity=0.0)
    assert torch.equal(a.u, b.u) and torch.equal(a.v, b.v)
    assert 0 < float((a.u - calm.u).abs().max()) < 1e-4
    assert float(a.v[:, 0, :].abs().max()) == 0.0 and float(a.v.abs().max()) > 0


def test_eady_growth_rate_matches_jax_probe(balanced):
    probe = _probe()
    gj, sj, gt, st = balanced
    cfg = jax_config()
    for got, want in zip(eddy_statistics.eady_growth_rate(gt, st, baroclinic_instability_config().eos),
                         probe.eady_growth_rate(gj, sj, cfg.eos)):
        np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("series", ["transient_then_growth", "pure_growth", "short"])
def test_fit_growth_matches_jax_probe(series):
    probe = _probe()
    sigma = 2.5e-6
    t = np.linspace(0.0, 12 * 86400.0, 40)
    eke = {"transient_then_growth": 1e-7 * np.exp(-t / 2e5) + 1e-9 * np.exp(2 * sigma * t),
           "pure_growth": 1e-9 * np.exp(2 * sigma * t),
           "short": 1e-9 * np.exp(2 * sigma * t[:5])}[series]
    t = t[: len(eke)]
    got, want = eddy_statistics.fit_growth(t, eke), probe.fit_growth(t, eke)
    assert got[2] == want[2]
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-12)
    if series == "transient_then_growth":
        np.testing.assert_allclose(got[0], sigma, rtol=0.15)


# ---------------------------------------------------------------------------
# halo traffic, the projection, the sweep
# ---------------------------------------------------------------------------

def test_mesh_comm_traffic_on_2x2_gloo_mesh():
    """One 3-D extension of a float64 field on a 2x2 mesh of 16x8x4 tiles:
    x (periodic, two ranks) sends the two (Nz, ny, hx) edge strips, y
    (walls) the one (Nz, hy, nx + 2 hx) strip toward the other rank row,
    its x ghosts included: one exchange each."""
    Nx, Ny, Nz = 32, 16, 4
    h, nx, ny = 4, Nx // 2, Ny // 2
    want = 8 * Nz * (2 * ny * h + h * (nx + 2 * h))
    out = spawn(extension_traffic, 4, (Nx, Ny, Nz), shape=(2, 2))
    assert [tile for _, _, tile in out] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(exchanges == 2 and sent == want for exchanges, sent, _ in out)


@pytest.mark.parametrize("overlap", [True, False])
def test_project_weak_scaling_matches_jax(overlap):
    stats_j = jax_comm.CommStats(permute_count=62, bytes_per_step=38_784, trip_count=None,
                                 per_op=[])
    stats_t = port_comm.CommStats(permute_count=62, bytes_per_step=38_784)
    chips = (8, 32, 256)
    for compute_ms in (0.5, 36.4):
        want = jax_comm.project_weak_scaling(compute_ms, stats_j, chip_counts=chips,
                                             overlap=overlap, ici_bytes_per_sec=4.5e11,
                                             latency_per_round=1e-5)
        got = port_comm.project_weak_scaling(compute_ms, stats_t, bytes_per_sec=4.5e11,
                                             latency_per_exchange=1e-5, chip_counts=chips,
                                             overlap=overlap)
        assert got == want


def test_weak_scaling_sweep_on_gloo_ranks(tmp_path):
    out_path = str(tmp_path / "ws.json")
    out = weak_scaling.main(["--cpu-ranks", "--counts", "1,2,4", "--tile", "16", "--Nz", "4",
                             "--steps", "2", "--dtype", "float64", "--out", out_path,
                             "--compute-ms", "36.4", "--link-bytes-per-sec", "4.5e11",
                             "--latency-s", "1e-5", "--project-chips", "8,64"])
    rows = out["runs"]
    assert [r["devices"] for r in rows] == [1, 2, 4]
    assert [r["mesh"] for r in rows] == [[1, 1], [2, 1], [2, 2]]
    assert [r["global"] for r in rows] == [[16, 16, 4], [32, 16, 4], [32, 32, 4]]
    assert rows[0]["exchanges_per_step"] == 0 and rows[0]["comm_bytes_per_step_per_device"] == 0
    assert all(r["exchanges_per_step"] > 0 and r["comm_bytes_per_step_per_device"] > 0
               for r in rows[1:])
    # a second mesh axis adds the y exchanges
    assert rows[2]["exchanges_per_step"] > rows[1]["exchanges_per_step"]
    assert rows[0]["efficiency"] == 1.0 and all(r["ms_per_step"] > 0 for r in rows)
    with open(out_path) as f:
        saved = json.load(f)
    assert set(saved["projection"]) == {"overlap", "ablated"}
    assert set(saved["projection"]["ablated"]) == {"8", "64"}


# ---------------------------------------------------------------------------
# trace summaries
# ---------------------------------------------------------------------------

def test_trace_summary_of_two_cpu_steps(tmp_path, capsys):
    grid = simple_latitude_longitude_grid(16, 8, 4, device="cpu", dtype=torch.float64)
    cfg = baroclinic_instability_config()
    state = port_baroclinic.baroclinic_instability_state(grid)
    logdir = str(tmp_path / "trace")
    with with_profiler(logdir):
        for i in range(2):
            with annotate("step", n=i):
                state = time_step(cfg, grid, state, 60.0)
    files = trace.find_trace_files(logdir)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    events = trace.read_events(files[0])
    spans = trace.op_durations(events, "user_annotation")
    assert {"step#n=0#", "step#n=1#"} <= set(spans)
    ops = list(trace.op_durations(events, "cpu_op").items())[:5]
    assert len(ops) == 5 and all(ms > 0 for _, ms in ops)
    assert ops == sorted(ops, key=lambda kv: -kv[1])
    assert trace.summarize(logdir) == []  # no device on the CPU
    rows = trace.main([logdir, "--top", "3"])
    assert rows == [] and "1 traces" in capsys.readouterr().out
