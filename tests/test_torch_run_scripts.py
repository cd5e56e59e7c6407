"""The port's flagship scripts against the JAX package's.

- ``utils.args.build_config`` for every combination of --target-float-type,
  --limbs, --closure, --free-surface and --kernels against JAX's: the same
  free surface and substeps, closure and its parameters, compute_dtype, and
  the kernels mapped (auto, zslab -> auto; pallas -> pallas; jnp -> torch);
  where the port's config refuses a mode (float16, float8: it raises
  NotImplementedError; bf16s on the "pallas" route: ValueError),
  build_config raises that error; where JAX's exits, so does the port's.
- ``resolve_grid_size``; ``Timer``'s line; ``sync_states`` onto a tile.
- The serial script's ``main`` at 48x24x10 float64 on the CPU (2-step
  loops: 1 + 2 x 2 steps) against JAX's ``time_step`` and ``loop`` from
  the same state (JAX's initial state carried in: torch's and XLA's tanh
  differ by an ulp), kernels "jnp", GB25_BAROTROPIC_BLOCK=1 (the serial
  barotropic conditions re-imposed every substep, as the port's serial
  route does), at 1e-10 of each field's largest value.
- The sharded script on 2x2 gloo ranks (tiles 16x8x4, float64, 10-step
  loops: 1 + 2 x 10 steps, at dt 60 s where the script's default is 1 s:
  after 21 steps of 1 s the tendencies are ~3e-7 m/s^2 and float64
  rounding of their cancelling terms reaches 1e-10 of that; --save-dir):
  the dumps read back bit for bit into the gathered state, which matches
  JAX's serial steps from the port's initial state (JAX's blocked solve at
  the same width: GB25_BAROTROPIC_BLOCK unset) at 1e-10.
- The correctness protocol on 2x2 gloo ranks at 32x16x4 float64 with a
  10-step loop in place of 100 (the CPU test's time): all five checkpoints
  pass at sqrt(eps); the port's serial state at each checkpoint matches
  JAX's serial steps from the port's initial state at 1e-10 (BLOCK=1).
- The launcher (tests/test_scripts.py's strong-scaling case), the sharding
  checks on 4 gloo ranks, ``convert_datasets`` against the JAX script on
  NetCDF files the port's writer makes, and every device script's main
  refusing --device cuda without a card.
"""

import dataclasses
import importlib.util
import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gb25_tpu.grids import simple_latitude_longitude_grid as jax_latlon
from gb25_tpu.models import baroclinic_instability_state as jax_state
from gb25_tpu.models import loop as jax_loop
from gb25_tpu.models import time_step as jax_time_step
from gb25_tpu.models.state import HydrostaticState as JaxState
from gb25_tpu.utils import args as jax_args
from gb25_tpu.utils.correctness import _leaf_names
from gb25_tpu_torch.convert import state_from_numpy, state_to_numpy
from gb25_tpu_torch.data.netcdf import NetCDF3Writer
from gb25_tpu_torch.grids import simple_latitude_longitude_grid
from gb25_tpu_torch.io import load_global_field
from gb25_tpu_torch.models import baroclinic_instability_state
from gb25_tpu_torch.parallel import shard_state, spawn
from gb25_tpu_torch.parallel.mesh import Mesh
from gb25_tpu_torch.scripts import (
    baroclinic_instability_run,
    convert_datasets,
    correctness_baroclinic_instability_run,
    eddy_statistics,
    launcher,
    sharded_baroclinic_instability_run,
    simple_sharding_checks,
    weak_scaling,
)
from gb25_tpu_torch.utils import args as port_args
from gb25_tpu_torch.utils.correctness import compare_states, sync_states
from gb25_tpu_torch.utils.profiling import Timer, gbprofile
from test_torch_mesh_jobs import correctness_protocol, sharded_script, sharding_checks

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


def _jax_state(arrays):
    """A JAX state from JAX-layout numpy arrays (``convert``'s names)."""
    names = sorted(k.split("/", 1)[1] for k in arrays if k.startswith("tracers/"))

    def a(k):
        return jnp.asarray(arrays[k])

    return JaxState(u=a("u"), v=a("v"), eta=a("eta"),
                    tracers={k: a(f"tracers/{k}") for k in names},
                    Gu=a("Gu"), Gv=a("Gv"), Geta=a("Geta"),
                    Gtracers={k: a(f"Gtracers/{k}") for k in names},
                    time=a("time"), time_lo=a("time_lo"),
                    iteration=jnp.asarray(arrays["iteration"], jnp.int32))


def _port_init(shape, noise=1e-3):
    """The port's initial flagship state at ``shape``, float64, as numpy."""
    grid = simple_latitude_longitude_grid(*shape, device="cpu", dtype=torch.float64)
    return state_to_numpy(baroclinic_instability_state(grid, noise_velocity=noise))


# ---------------------------------------------------------------------------
# utils.args
# ---------------------------------------------------------------------------

TARGETS = [None, "f32", "bf16", "f16", "f64", "f8E5M2", "f8E4M3", "bf16s"]
REFUSED = ("float16", "float8_e5m2", "float8_e4m3")
COMBOS = list(itertools.product(TARGETS, (1, 2), ("none", "vertical_scalar", "catke"),
                                ("split_explicit", "explicit"), ("auto", "zslab", "pallas", "jnp")))


def _build(module, argv):
    args = module.benchmark_parser().parse_args(argv)
    try:
        return module.build_config(args)
    except (SystemExit, NotImplementedError, ValueError) as e:
        return e


@pytest.mark.parametrize("target,limbs,closure,fs,kernels", COMBOS)
def test_build_config_matches_jax(target, limbs, closure, fs, kernels):
    argv = ["--limbs", str(limbs), "--closure", closure, "--free-surface", fs,
            "--kernels", kernels, "--substeps", "24"]
    if target is not None:
        argv += ["--target-float-type", target]
    want, got = _build(jax_args, argv), _build(port_args, argv)
    if isinstance(want, SystemExit):
        assert isinstance(got, SystemExit), got
        return
    assert not isinstance(want, Exception), want
    if want.compute_dtype in REFUSED:
        assert isinstance(got, NotImplementedError), got
        return
    route = port_args.KERNEL_ROUTES[want.kernels]
    if want.compute_dtype == "bf16s" and route == "pallas":
        assert isinstance(got, ValueError), got
        return
    assert not isinstance(got, Exception), got
    assert got.compute_dtype == want.compute_dtype
    assert got.kernels == route
    assert type(got.free_surface).__name__ == type(want.free_surface).__name__
    assert got.g == want.g
    assert getattr(got.free_surface, "substeps", None) == getattr(want.free_surface, "substeps",
                                                                   None)
    assert type(got.closure).__name__ == type(want.closure).__name__
    if want.closure is not None:
        assert dataclasses.asdict(got.closure) == dataclasses.asdict(want.closure)
    assert tuple(got.tracers) == tuple(want.tracers)
    assert (got.momentum_advection, got.tracer_advection) == (want.momentum_advection,
                                                              want.tracer_advection)


@pytest.mark.parametrize("argv", [[], ["--resolution", "4"], ["--grid-x", "64"],
                                  ["--Nx", "40", "--Ny", "20", "--Nz", "7"],
                                  ["--grid-y", "30", "--resolution", "8"]])
def test_resolve_grid_size_matches_jax(argv):
    want = jax_args.resolve_grid_size(jax_args.benchmark_parser().parse_args(argv))
    assert port_args.resolve_grid_size(port_args.benchmark_parser().parse_args(argv)) == want


def test_timer_line(capsys):
    timer = Timer(3)
    with timer("first loop"):
        pass
    line = capsys.readouterr().out.strip()
    head, sec = line.rsplit(": ", 1)
    assert head == "[3] first loop"
    assert sec.endswith(" seconds") and len(sec.split()[0].split(".")[1]) == 6
    assert timer.times["first loop"] == pytest.approx(float(sec.split()[0]), abs=1e-6)


@pytest.mark.parametrize("enabled", [True, False])
def test_gbprofile_file(enabled, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with gbprofile("phase", enabled=enabled):
        sum(range(1000))
    path = tmp_path / "profile_phase.txt"
    assert path.exists() == enabled
    if enabled:
        assert "cumulative" in path.read_text()


def test_sync_states_onto_a_tile():
    """Global float64 values onto a float32 tile of a 2x2 mesh: each field
    is the tile's window of the global one, rounded once; the clock and the
    iteration come across."""
    grid = simple_latitude_longitude_grid(16, 8, 4, device="cpu", dtype=torch.float64)
    src = baroclinic_instability_state(grid).replace(
        iteration=7, time=torch.tensor(420.0, dtype=torch.float64))
    mesh = Mesh(2, 2, rank=3)
    dst = shard_state(baroclinic_instability_state(
        simple_latitude_longitude_grid(16, 8, 4, device="cpu", dtype=torch.float32),
        noise_velocity=0.0), mesh)
    out = sync_states(src, dst, mesh)
    assert out.iteration == 7 and out.u.dtype == torch.float32
    assert torch.equal(out.u, src.u[:, 4:, 8:].to(torch.float32))
    assert torch.equal(out.tracers["T"], src.tracers["T"][:, 4:, 8:].to(torch.float32))
    assert torch.equal(out.eta, src.eta[4:, 8:].to(torch.float32))
    assert float(out.time) == 420.0
    same = sync_states(src, baroclinic_instability_state(grid, noise_velocity=0.0))
    compare_states(src, same, rtol=0.0, verbose=False)
    with pytest.raises(ValueError, match="mesh"):
        sync_states(src, dst)


# ---------------------------------------------------------------------------
# the serial script
# ---------------------------------------------------------------------------

def test_serial_script_matches_jax_f64(monkeypatch, capsys):
    monkeypatch.setenv("GB25_BAROTROPIC_BLOCK", "1")
    monkeypatch.delenv("GB25_ZSLAB_INTERPRET", raising=False)
    shape, dt, steps = (48, 24, 10), 60.0, 2
    gj = jax_latlon(*shape, dtype=jnp.float64)
    sj = jax_state(gj, noise_velocity=1e-3)
    init = _arrays(sj)
    import gb25_tpu_torch.models as models

    monkeypatch.setattr(models, "baroclinic_instability_state",
                        lambda grid, tracers: state_from_numpy(init, grid.device))
    argv = ["--grid-x", "48", "--grid-y", "24", "--grid-z", "10", "--steps", str(steps),
            "--float-type", "f64", "--device", "cpu"]
    out = baroclinic_instability_run.main(argv)
    lines = capsys.readouterr().out.splitlines()
    labels = ["compile first_time_step", "compile loop", "first time step", "first loop",
              "second loop"]
    assert [ln.split(": ")[0] for ln in lines[:5]] == [f"[0] {lb}" for lb in labels]
    assert list(out["times"]) == labels
    assert lines[5].startswith("allocator stats: {}")
    assert lines[6].startswith(f"done: iteration={1 + 2 * steps} max|u|=")

    cfg = jax_args.build_config(jax_args.benchmark_parser().parse_args(argv[:-2]))
    cfg = dataclasses.replace(cfg, kernels="jnp")
    sj = jax.jit(jax_time_step)(cfg, gj, sj, dt)
    lp = jax.jit(jax_loop, static_argnames="n")
    sj = lp(cfg, gj, lp(cfg, gj, sj, dt, n=steps), dt, n=steps)
    compare_states(_arrays(sj), state_to_numpy(out["state"]), rtol=1e-10, verbose=False)


# ---------------------------------------------------------------------------
# the sharded script and the correctness protocol on gloo ranks
# ---------------------------------------------------------------------------

def test_sharded_script_on_2x2_gloo_ranks(monkeypatch, tmp_path):
    monkeypatch.delenv("GB25_BAROTROPIC_BLOCK", raising=False)
    monkeypatch.delenv("GB25_ZSLAB_INTERPRET", raising=False)
    steps, dt, save = 10, 60.0, str(tmp_path / "dump")
    argv = ["--tile-x", "16", "--tile-y", "8", "--Nz", "4", "--steps", str(steps), "--dt",
            str(dt), "--float-type", "f64", "--device", "cpu", "--save-dir", save]
    tiles = spawn(sharded_script, 4, argv, shape=(2, 2))
    # the tiles, gathered in JAX's (X, Y) layout: rank r is tile (r // 2, r % 2)
    got = {}
    for name in tiles[0]:
        if tiles[0][name].ndim >= 2:
            got[name] = np.concatenate([np.concatenate([tiles[2 * ix + iy][name]
                                                        for iy in range(2)], axis=1)
                                        for ix in range(2)], axis=0)
        else:
            got[name] = tiles[0][name]
    for name, a in got.items():
        np.testing.assert_array_equal(load_global_field(save, name), a, err_msg=name)

    gj = jax_latlon(32, 16, 4, dtype=jnp.float64)
    cfg = dataclasses.replace(jax_args.build_config(jax_args.benchmark_parser().parse_args(
        ["--Nz", "4"])), kernels="jnp")
    step = jax.jit(jax_time_step)
    sj = _jax_state(_port_init((32, 16, 4)))
    for _ in range(1 + 2 * steps):
        sj = step(cfg, gj, sj, dt)
    assert int(got["iteration"]) == 1 + 2 * steps
    compare_states(_arrays(sj), got, rtol=1e-10, verbose=False)


def test_correctness_protocol_on_2x2_gloo_ranks(monkeypatch):
    monkeypatch.setenv("GB25_BAROTROPIC_BLOCK", "1")
    monkeypatch.delenv("GB25_ZSLAB_INTERPRET", raising=False)
    loop_steps = 10
    argv = ["--grid-x", "32", "--grid-y", "16", "--grid-z", "4", "--float-type", "f64",
            "--device", "cpu"]
    runs = spawn(correctness_protocol, 4, argv, loop_steps, shape=(2, 2))
    names = correctness_baroclinic_instability_run.CHECKPOINTS
    assert [c for c, _, _ in runs[0]] == list(names)
    # every rank compared the gathered state; all passed at sqrt(eps)
    for rank_run in runs:
        assert [c for c, _, _ in rank_run] == list(names)
    re_sync = runs[0][3][1]
    assert all(err == 0.0 for _, _, err, _ in re_sync)

    dt = 1e-9
    gj = jax_latlon(32, 16, 4, dtype=jnp.float64)
    cfg = dataclasses.replace(jax_args.build_config(jax_args.benchmark_parser().parse_args(
        ["--Nz", "4"])), kernels="jnp")
    step = jax.jit(jax_time_step)
    serial = {c: arrays for c, _, arrays in runs[0]}
    sj = _jax_state(serial["post-init"])
    np.testing.assert_array_equal(serial["post-init"]["u"], _port_init((32, 16, 4))["u"])
    sj = step(cfg, gj, sj, dt)
    compare_states(_arrays(sj), serial["post first step"], rtol=1e-10, verbose=False)
    for _ in range(10):
        sj = step(cfg, gj, sj, dt)
    compare_states(_arrays(sj), serial["after 10 steps"], rtol=1e-10, verbose=False)
    compare_states(_arrays(sj), serial["re-sync"], rtol=1e-10, verbose=False)
    sj = jax.jit(jax_loop, static_argnames="n")(cfg, gj, sj, dt, n=loop_steps)
    compare_states(_arrays(sj), serial["after the loop"], rtol=1e-10, verbose=False)


# ---------------------------------------------------------------------------
# the launcher, the sharding checks, the dataset conversion
# ---------------------------------------------------------------------------

def test_launcher_strong_scaling(tmp_path):
    """--strong holds the global grid: 8 GPUs -> factors (4, 2) -> tiles of
    1536x1536, 32 -> (8, 4) -> 768x768 (tests/test_scripts.py's case)."""
    out = tmp_path / "jobs"
    dirs = launcher.main(["--sizes", "8,32", "--strong", "--global-x", "6144", "--global-y",
                          "3072", "--out", str(out)])
    assert [os.path.basename(d) for d in dirs] == ["gpus_8", "gpus_32"]
    info8 = (out / "gpus_8" / "run-info.toml").read_text()
    assert "tile = [1536, 1536, 64]" in info8
    assert 'scaling = "strong"' in info8
    assert "global = [6144, 3072, 64]" in info8
    assert "chips = 8" in info8 and "git_describe = " in info8 and "command = " in info8
    info32 = (out / "gpus_32" / "run-info.toml").read_text()
    assert "tile = [768, 768, 64]" in info32
    launch32 = (out / "gpus_32" / "launcher.sh").read_text()
    assert "--tile-x 768 --tile-y 768" in launch32
    assert "torchrun --nnodes 8 --nproc-per-node 4" in launch32
    assert "gb25_tpu_torch.scripts.sharded_baroclinic_instability_run" in launch32
    assert "--distributed" in launch32 and "NCCL_DEBUG" in launch32
    submit = (out / "gpus_32" / "submit.sh").read_text()
    assert "sbatch" in submit and "--nodes 8" in submit and "--gpus-per-node 4" in submit


def test_launcher_strong_requires_global(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        launcher.main(["--strong", "--out", str(tmp_path / "j")])
    assert e.value.code != 0
    assert "--global-x" in capsys.readouterr().err


def test_sharding_checks_on_4_gloo_ranks():
    out = spawn(sharding_checks, 4, shape=(2, 2))
    assert [r["rank"] for r in out] == [0, 1, 2, 3]
    assert all(r["sum"] == 6.0 and r["mesh"] == (2, 2) for r in out)
    # the ring along x: tile (ix, iy) received from tile (ix - 1, iy)
    assert [r["ring"] for r in out] == [2, 3, 0, 1]
    alone = simple_sharding_checks.main(["--device", "cpu"])
    assert alone["size"] == 1 and alone["ring"] is None


def _jax_convert_script():
    spec = importlib.util.spec_from_file_location(
        "jax_convert_datasets", os.path.join(REPO, "scripts", "convert_datasets.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_nc(path, dims, variables):
    w = NetCDF3Writer(path, dims)
    for name, (vdims, data, attrs) in variables.items():
        w.define(name, vdims, np.float64, attrs)
    for name, (vdims, data, attrs) in variables.items():
        w.write(name, data)
    w.close()


def _datasets(tmp_path):
    rng = np.random.default_rng(3)
    lon = np.linspace(0.5, 359.5, 24)
    lat = np.linspace(-89.5, 89.5, 12)
    depth = np.array([5.0, 50.0, 500.0])
    files = {}
    files["etopo1"] = [str(tmp_path / "etopo.nc")]
    _write_nc(files["etopo1"][0], {"lon": 24, "lat": 12},
              {"lon": (("lon",), lon, {}), "lat": (("lat",), lat, {}),
               "z": (("lat", "lon"), rng.uniform(-5000, 2000, (12, 24)), {})})
    theta, salt = str(tmp_path / "theta.nc"), str(tmp_path / "salt.nc")
    for path, name, lo in ((theta, "THETA", -2.0), (salt, "SALT", 33.0)):
        _write_nc(path, {"lon": 24, "lat": 12, "depth": 3},
                  {"lon": (("lon",), lon, {"units": "degrees_east"}),
                   "lat": (("lat",), lat, {"units": "degrees_north"}),
                   "depth": (("depth",), depth, {"units": "m"}),
                   name: (("depth", "lat", "lon"), lo + rng.uniform(0, 3, (3, 12, 24)), {})})
    files["ecco"] = [theta, "-s", salt]
    atm = str(tmp_path / "jra.nc")
    _write_nc(atm, {"time": 4, "lat": 12, "lon": 24},
              {"lon": (("lon",), lon, {}), "lat": (("lat",), lat, {}),
               "time": (("time",), np.arange(4) * 10800.0,
                        {"units": "seconds since 2000-01-01"}),
               "tas": (("time", "lat", "lon"), 270 + 20 * rng.uniform(size=(4, 12, 24)), {}),
               "uas": (("time", "lat", "lon"), rng.normal(0, 5, (4, 12, 24)), {})})
    files["jra55"] = [atm]
    return files


def test_convert_datasets_matches_jax_script(tmp_path, monkeypatch):
    jax_script = _jax_convert_script()
    for kind, inputs in _datasets(tmp_path).items():
        port_out, jax_out = str(tmp_path / f"{kind}_port.npz"), str(tmp_path / f"{kind}_jax.npz")
        convert_datasets.main([kind, *inputs, "-o", port_out])
        monkeypatch.setattr("sys.argv", ["convert_datasets.py", kind, *inputs, "-o", jax_out])
        jax_script.main()
        with np.load(port_out) as a, np.load(jax_out) as b:
            assert sorted(a.files) == sorted(b.files), kind
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{kind}/{k}")


DEVICE_SCRIPTS = {
    "baroclinic_instability_run": (baroclinic_instability_run.main, []),
    "sharded_baroclinic_instability_run": (sharded_baroclinic_instability_run.main, []),
    "correctness_baroclinic_instability_run": (correctness_baroclinic_instability_run.main, []),
    "eddy_statistics": (eddy_statistics.main, []),
    "weak_scaling": (weak_scaling.main, []),
    "simple_sharding_checks": (simple_sharding_checks.main, []),
}


@pytest.mark.parametrize("name", list(DEVICE_SCRIPTS))
def test_script_refuses_cuda_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    main, argv = DEVICE_SCRIPTS[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([*argv, "--device", "cuda"])
