"""Kernel K5 (the blocked barotropic substeps) and the port's blocked free
surface against the JAX package's.

``barotropic_block_plain`` in float32 against the JAX Pallas kernel
``pallas_barotropic_block`` in interpret mode, on the same numpy inputs
(one block of W = 4 substeps on 48x24 planes extended by W): lat-lon thin
metric columns, the same with solid-face masks (an immersed grid), and
tripolar 2-D metric planes with masks; rtol 1e-6, atol 1e-6 of each
output's largest value (the same operations in the same order; XLA may
contract a product and a sum).

The port's blocked solve (``models.free_surface`` on a 1x1 tile in the
"local" mode: the ghosts from the boundary conditions, as serially) in
float64 against JAX ``barotropic_substep`` with kernels="jnp" and no comm,
the blocked array path, at W = the halo and at W = 30 (one block of all
30 substeps), on the lat-lon grid with a rectangular island and on the
tripolar grid: 1e-12 of each field's largest value (the JAX array path
divides by the cell area where the kernel form multiplies by dtau / area).
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gb25_tpu.grids import simple_latitude_longitude_grid as jax_latlon
from gb25_tpu.grids import tripolar_grid as jax_tripolar
from gb25_tpu.grids.immersed import with_bathymetry as jax_with_bathymetry
from gb25_tpu.models import baroclinic_instability_config as jax_config
from gb25_tpu.models.config import SplitExplicitFreeSurface as JaxFS
from gb25_tpu.models.free_surface import barotropic_substep as jax_barotropic_substep
from gb25_tpu.ops.pallas_barotropic import pallas_barotropic_block
from gb25_tpu_torch.convert import immersed_grid_from_numpy
from gb25_tpu_torch.grids import simple_latitude_longitude_grid, tripolar_grid
from gb25_tpu_torch.models import baroclinic_instability_config
from gb25_tpu_torch.models.config import SplitExplicitFreeSurface
from gb25_tpu_torch.models.free_surface import averaging_weights, barotropic_substep
from gb25_tpu_torch.ops.pallas_barotropic import barotropic_block_plain, launch_chunks
from gb25_tpu_torch.parallel import Mesh, MeshComm


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: beside other busy
    test processes, torch's default of one OpenMP thread per core made the
    plain versions' many small launches ~100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    """A JAX-layout array as a port tensor (axes reversed)."""
    return torch.from_numpy(np.array(np.transpose(np.asarray(a))))


def back(x):
    return np.transpose(x.detach().numpy())


def _block_operands(Xe, Ye, metric2d, masked, seed):
    """K5's operands in JAX's (X, Y) layout, float32, at magnitudes of a
    real block (dtau = 4 s, 4000 m deep, ~100 km cells)."""
    rng = np.random.default_rng(seed)

    def f32(a):
        return np.asarray(a, np.float32)

    mshape = (Xe, Ye) if metric2d else (1, Ye)
    ops = {
        "eta": 1e-2 * rng.standard_normal((Xe, Ye)),
        "U": rng.standard_normal((Xe, Ye)),
        "V": rng.standard_normal((Xe, Ye)),
        "pu": 1.6 * (1.0 + 0.1 * rng.random((Xe, Ye))),
        "pv": 1.6 * (1.0 + 0.1 * rng.random((Xe, Ye))),
        "fu": 1e-4 * rng.standard_normal((Xe, Ye)),
        "fv": 1e-4 * rng.standard_normal((Xe, Ye)),
        "au": 1e5 * (1.0 + 0.2 * rng.random(mshape)),
        "av": 1e5 * (1.0 + 0.2 * rng.random(mshape)),
        "rz": 4e-10 * (1.0 + 0.2 * rng.random(mshape)),
    }
    if masked:
        ops["mu"] = (rng.random((Xe, Ye)) > 0.1).astype(float)
        ops["mv"] = (rng.random((Xe, Ye)) > 0.1).astype(float)
    return {k: f32(a) for k, a in ops.items()}


@pytest.mark.parametrize("metric2d,masked", [(False, False), (False, True), (True, True)],
                         ids=["latlon", "immersed", "tripolar"])
def test_plain_k5_matches_jax_kernel_f32(metric2d, masked):
    W, Nx, Ny = 4, 48, 24
    weights = averaging_weights(30)[8 : 8 + W]
    ops = _block_operands(Nx + 2 * W, Ny + 2 * W, metric2d, masked, seed=int(metric2d) + 2 * masked)
    names = ["eta", "U", "V", "pu", "pv", "fu", "fv", "au", "av", "rz"]
    masks = [ops.get("mu"), ops.get("mv")]
    ref = pallas_barotropic_block(weights, *(jnp.asarray(ops[n]) for n in names),
                                  *(None if m is None else jnp.asarray(m) for m in masks),
                                  interpret=True)
    got = barotropic_block_plain(weights, *(t(ops[n]) for n in names),
                                 *(None if m is None else t(m) for m in masks))
    for name, g, w in zip(("eta", "U", "V", "pe", "pU", "pV"), got, ref):
        w = np.asarray(w)
        assert np.isfinite(w).all()
        np.testing.assert_allclose(back(g), w, rtol=1e-6, atol=1e-6 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("n,s", [(1, 6), (2, 6), (4, 6), (6, 6), (7, 6), (30, 6), (30, 4),
                                 (30, 10), (2, 3), (13, 5)])
def test_k5_launch_chunks(n, s):
    """K5's launch plan: a block of n substeps is ceil(n / s) launches of
    at most s substeps each, which cover its weights in order."""
    weights = averaging_weights(30)[:n]
    chunks = launch_chunks(weights, s)
    assert len(chunks) == -(-n // s)
    assert all(1 <= len(c) <= s for c in chunks)
    assert all(len(c) == s for c in chunks[:-1])
    np.testing.assert_array_equal(np.concatenate(chunks), weights)


def _island(Nx, Ny):
    """A rectangular island, land to the surface, and a shelf (JAX layout)."""
    bh = np.full((Nx, Ny), -4000.0)
    bh[Nx // 4 : Nx // 4 + 6, Ny // 3 : Ny // 3 + 5] = 0.0
    bh[Nx // 2 : Nx // 2 + 4, 2:6] = -300.0
    return bh


def _grids(kind, exchange_width):
    shape = (64, 32, 4)
    fs = dict(exchange_width=exchange_width)
    cfg_j = dataclasses.replace(jax_config(), kernels="jnp", free_surface=JaxFS(**fs))
    cfg_t = dataclasses.replace(baroclinic_instability_config(),
                                free_surface=SplitExplicitFreeSurface(**fs))
    if kind == "tripolar":
        return cfg_j, cfg_t, (jax_tripolar(*shape, dtype=jnp.float64),
                              tripolar_grid(*shape, device="cpu", dtype=torch.float64))
    gj = jax_with_bathymetry(jax_latlon(*shape, dtype=jnp.float64), _island(*shape[:2]))
    gt = immersed_grid_from_numpy(
        simple_latitude_longitude_grid(*shape, device="cpu", dtype=torch.float64),
        np.asarray(gj.bottom_height))
    return cfg_j, cfg_t, (gj, gt)


@pytest.mark.parametrize("exchange_width", [None, 30], ids=["W_halo", "W30"])
@pytest.mark.parametrize("kind", ["latlon_island", "tripolar"])
def test_blocked_free_surface_matches_jax_array_path_f64(kind, exchange_width, monkeypatch):
    monkeypatch.delenv("GB25_BAROTROPIC_BLOCK", raising=False)
    monkeypatch.delenv("GB25_ZSLAB_INTERPRET", raising=False)
    cfg_j, cfg_t, (gj, gt) = _grids(kind, exchange_width)
    Nx, Ny, Nz = gj.Nx, gj.Ny, gj.Nz
    rng = np.random.default_rng(7)
    dt = 60.0
    eta = 1e-2 * rng.standard_normal((Nx, Ny))
    U0, V0 = (100.0 * rng.standard_normal((Nx, Ny)) for _ in range(2))
    Us, Vs = U0 + 1e-2 * rng.standard_normal((Nx, Ny)), V0 + 1e-2 * rng.standard_normal((Nx, Ny))
    V0[:, 0] = Vs[:, 0] = 0.0
    u_star, v_star = (0.1 * rng.standard_normal((Nx, Ny, Nz)) for _ in range(2))

    ref = jax_barotropic_substep(
        cfg_j, gj, types.SimpleNamespace(eta=jnp.asarray(eta)), jnp.asarray(u_star),
        jnp.asarray(v_star), None, None, jnp.float64(dt),
        integrals=tuple(jnp.asarray(a) for a in (U0, V0, Us, Vs)))
    comm = MeshComm(Mesh(1, 1), north_fold=gt.north_fold,
                    pole_index=getattr(gt, "pole_index", 0))
    got = barotropic_substep(cfg_t, gt, types.SimpleNamespace(eta=t(eta)), t(u_star), t(v_star),
                             dt, tuple(t(a) for a in (U0, V0, Us, Vs)), comm)
    for name, g, w in zip(("eta", "u", "v"), got, ref):
        w = np.asarray(w)
        assert np.abs(w).max() > 0.0
        np.testing.assert_allclose(back(g), w, rtol=0, atol=1e-12 * np.abs(w).max(),
                                   err_msg=name)
