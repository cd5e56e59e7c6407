"""The config's further choices against the JAX package's:
``VerticalScalarDiffusivity`` (the reference model's own closure) and
``ExplicitFreeSurface``.

float64, 3 steps (an Euler step and two AB2 steps) of the flagship at
32x16x6 with each choice and with both, against JAX ``time_step`` with
kernels="jnp", at 1e-10 of each field's largest value (only reassociation
differs): on the port's K1 route ("auto"; on CPU tensors K1's plain fused
form under the split-explicit free surface, its unfused form under the
explicit one, K2 and K3 their plain versions; JAX with
GB25_BAROTROPIC_BLOCK=1, its array free surface re-imposing the boundary
conditions every substep as K2 does) and on the K6 route
(kernels="pallas"; JAX with GB25_BAROTROPIC_BLOCK unset, its blocked free
surface at W = the halo, as the port's route). Then the explicit free
surface's mass: sum(eta azc) is conserved to float64 rounding over 20
steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gb25_tpu.grids import simple_latitude_longitude_grid as jax_grid
from gb25_tpu.models import ExplicitFreeSurface as JaxExplicit
from gb25_tpu.models import VerticalScalarDiffusivity as JaxScalar
from gb25_tpu.models import baroclinic_instability_config as jax_config
from gb25_tpu.models import baroclinic_instability_state as jax_state
from gb25_tpu.models import time_step as jax_time_step
from gb25_tpu.utils.correctness import _leaf_names
from gb25_tpu_torch.convert import state_from_numpy, state_to_numpy
from gb25_tpu_torch.grids import simple_latitude_longitude_grid
from gb25_tpu_torch.models import (
    ExplicitFreeSurface,
    VerticalScalarDiffusivity,
    baroclinic_instability_config,
    baroclinic_instability_model,
    loop,
)
from gb25_tpu_torch.utils.correctness import compare_states

DT = 60.0
SHAPE = (32, 16, 6)
CHOICES = {
    "vertical_scalar": ({"closure": JaxScalar()}, {"closure": VerticalScalarDiffusivity()}),
    "explicit": ({"free_surface": JaxExplicit()}, {"free_surface": ExplicitFreeSurface()}),
    "both": ({"closure": JaxScalar(), "free_surface": JaxExplicit()},
             {"closure": VerticalScalarDiffusivity(), "free_surface": ExplicitFreeSurface()}),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: beside other busy
    test processes, torch's default of one OpenMP thread per core made the
    plain versions' many small launches ~100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(state):
    return {name: np.asarray(x) for name, x in _leaf_names(state)}


@pytest.mark.parametrize("route", ["auto", "pallas"])
@pytest.mark.parametrize("choice", list(CHOICES))
def test_three_steps_match_jax_f64(monkeypatch, choice, route):
    if route == "auto":
        monkeypatch.setenv("GB25_BAROTROPIC_BLOCK", "1")
    else:
        monkeypatch.delenv("GB25_BAROTROPIC_BLOCK", raising=False)
    monkeypatch.delenv("GB25_ZSLAB_INTERPRET", raising=False)
    jax_kw, port_kw = CHOICES[choice]
    gj = jax_grid(*SHAPE, dtype=jnp.float64)
    sj = jax_state(gj, noise_velocity=1e-3)
    cfg_j = dataclasses.replace(jax_config(**jax_kw), kernels="jnp")
    step = jax.jit(jax_time_step)
    gt = simple_latitude_longitude_grid(*SHAPE, device="cpu", dtype=torch.float64)
    st = state_from_numpy(_arrays(sj), "cpu")
    for _ in range(3):
        sj = step(cfg_j, gj, sj, DT)
    st = loop(baroclinic_instability_config(kernels=route, **port_kw), gt, st, DT, 3)
    ref, port = _arrays(sj), state_to_numpy(st)
    assert list(port) == list(ref)
    compare_states(ref, port, rtol=1e-10, verbose=False)
    if "free_surface" in port_kw:
        assert np.abs(port["Geta"]).max() > 0.0
    assert int(port["iteration"]) == 3


def test_explicit_free_surface_conserves_mass():
    """sum(eta azc) over 20 steps: G_eta is a flux divergence, periodic in
    x with no flux through the walls, so each step moves the sum by float64
    rounding only (bound: 20 steps of 4 ulps of sum |eta azc|; measured
    8.5e-18 of it on the CPU)."""
    cfg, grid, state = baroclinic_instability_model(
        *SHAPE, device="cpu", dtype=torch.float64, free_surface=ExplicitFreeSurface())
    az = grid.azc[0, grid.hy : grid.hy + grid.Ny]  # (Ny, 1)

    def mass(s):
        return float((s.eta * az).sum()), float((s.eta * az).abs().sum())

    s = loop(cfg, grid, state, DT, 1)
    m0, _ = mass(s)
    s = loop(cfg, grid, s, DT, 20)
    m1, scale = mass(s)
    assert scale > 0.0 and torch.isfinite(s.eta).all()
    assert abs(m1 - m0) <= 20 * 4 * np.finfo(np.float64).eps * scale, (m0, m1, scale)
