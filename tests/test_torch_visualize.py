"""``python -m gb25_tpu_torch.scripts.visualize`` on the port's own output:
an NPZ writer directory and a NetCDF file, each of three records of a
flagship state written by the port's writers. It writes a PNG of the
asked frame, reads the same frames as the JAX package's readers do from
those files, and refuses a field with no records. Skipped where
matplotlib is not installed (the card's machine)."""

import os
import types

import numpy as np
import pytest
import torch

from gb25_tpu.data.netcdf import read_netcdf as jax_read_netcdf
from gb25_tpu.io import read_series as jax_read_series
from gb25_tpu_torch.io import NetCDFOutputWriter, NPZOutputWriter
from gb25_tpu_torch.models import baroclinic_instability_model
from gb25_tpu_torch.scripts import visualize


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """(NPZ directory, NetCDF path): three daily records of a flagship
    state whose surface T moves between them."""
    root = tmp_path_factory.mktemp("visualize")
    _, grid, state = baroclinic_instability_model(24, 12, 4, device="cpu")
    npz_dir, nc_path = str(root / "npz"), str(root / "out.nc")
    writers = [NPZOutputWriter(npz_dir), NetCDFOutputWriter(nc_path, grid)]
    for day in range(3):
        T = state.tracers["T"] + 0.5 * day
        sim = types.SimpleNamespace(time=86400.0 * day, iteration=10 * day,
                                    state=state.replace(tracers={**state.tracers, "T": T}))
        for w in writers:
            w.maybe_write(sim)
    writers[1].close()
    return npz_dir, nc_path


@pytest.mark.parametrize("fmt", ["npz", "netcdf"])
def test_visualize_writes_a_png(outputs, fmt, tmp_path):
    pytest.importorskip("matplotlib")
    path = outputs[0] if fmt == "npz" else outputs[1]
    out = str(tmp_path / "frame.png")
    assert visualize.main([path, "--field", "T_surface", "--frame", "1", "--out", out]) == out
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert os.path.getsize(out) > 1000
    times, frames = visualize.read_frames(path, "T_surface")
    if fmt == "npz":
        jt, jf = jax_read_series(path, "T_surface")
    else:
        v, _, _ = jax_read_netcdf(path)
        jt, jf = np.asarray(v["time"]), np.asarray(v["T_surface"])
    np.testing.assert_array_equal(times, jt)
    np.testing.assert_array_equal(frames, jf)
    assert times.tolist() == [0.0, 86400.0, 172800.0] and frames.shape == (3, 24, 12)
    np.testing.assert_allclose(frames[1] - frames[0], 0.5, rtol=1e-6)


def test_visualize_refuses_a_field_with_no_records(outputs, tmp_path):
    pytest.importorskip("matplotlib")
    with pytest.raises(SystemExit, match="no records"):
        visualize.main([str(tmp_path), "--field", "T_surface"])
    assert not torch.is_tensor(visualize.read_frames(outputs[0], "eta")[1])
