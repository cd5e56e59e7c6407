"""Kernel K4's plain version (``catke_diffusivities_plain``) against the JAX
package's CATKE.

float32: against the JAX Pallas kernel ``catke_diffusivities_kernel`` in
interpret mode at 64x32x16, at the kernel-vs-array tolerance of
tests/test_pallas_catke.py (rtol 1e-6, atol 1e-10): both evaluate the same
pointwise formulas, so they part by a few ulps where the two programs
contract or order products differently.

float64: against the JAX array function ``catke_diffusivities`` at 1e-12,
on the flat grid and on the Gaussian-islands grid (the bottom distance
read from the bathymetry).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gb25_tpu.grids import simple_latitude_longitude_grid as jax_grid
from gb25_tpu.grids.immersed import gaussian_islands_bottom as jax_islands
from gb25_tpu.models.catke import CATKEVerticalDiffusivity as JaxCATKE
from gb25_tpu.models.catke import catke_diffusivities as jax_catke_diffusivities
from gb25_tpu.models.catke import surface_tke_flux as jax_surface_tke_flux
from gb25_tpu.models.config import HydrostaticConfig as JaxConfig
from gb25_tpu.models.hydrostatic import buoyancy_field as jax_buoyancy_field
from gb25_tpu.ops.halos import extend_field as jax_extend_field
from gb25_tpu.ops.pallas_catke import catke_diffusivities_kernel as jax_catke_kernel
from gb25_tpu_torch.grids import simple_latitude_longitude_grid
from gb25_tpu_torch.grids.immersed import gaussian_islands_bottom
from gb25_tpu_torch.models import baroclinic_instability_config
from gb25_tpu_torch.models.catke import CATKEVerticalDiffusivity, surface_tke_flux
from gb25_tpu_torch.ops.halos import extend_field
from gb25_tpu_torch.ops.pallas_catke import (
    catke_diffusivities_kernel,
    catke_diffusivities_plain,
)

NAMES = ("kappa_u", "kappa_c", "kappa_e", "G_e", "lam_e")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: beside other busy
    test processes, torch's default of one OpenMP thread per core made the
    plain versions' many small launches ~100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t2(a):
    return torch.as_tensor(np.ascontiguousarray(np.transpose(a)))


def back(t):
    return np.transpose(t.numpy())


def _inputs(shape, np_dtype, seed=7):
    """Random u, v and e and a stratified T, S from a numpy seed, in JAX's
    (X, Y, Z) layout."""
    Nx, Ny, Nz = shape
    rng = np.random.default_rng(seed)
    z = np.linspace(-3900.0, -10.0, Nz)
    phi = np.linspace(-70.0, 70.0, Ny)
    u = 0.05 * rng.standard_normal(shape)
    v = 0.05 * rng.standard_normal(shape)
    v[:, 0, :] = 0.0
    T = (20.0 + 5e-3 * z)[None, None, :] * np.cos(np.deg2rad(phi))[None, :, None] \
        + 0.5 * rng.standard_normal(shape)
    S = 35.0 - 1e-4 * z[None, None, :] + 0.1 * rng.standard_normal(shape)
    e = 1e-5 * (1.0 + rng.random(shape))
    return {k: a.astype(np_dtype) for k, a in (("u", u), ("v", v), ("T", T), ("S", S), ("e", e))}


def _both(shape, np_dtype, islands=False):
    tdt = torch.float32 if np_dtype == np.float32 else torch.float64
    gj = jax_grid(*shape, dtype=jnp.dtype(np_dtype))
    gt = simple_latitude_longitude_grid(*shape, device="cpu", dtype=tdt)
    if islands:
        gj, gt = jax_islands(gj), gaussian_islands_bottom(gt)
    a = _inputs(shape, np_dtype)
    kinds = {"u": "u", "v": "v", "T": "c", "S": "c", "e": "c"}
    je = {k: jax_extend_field(gj, jnp.asarray(x), kinds[k], None) for k, x in a.items()}
    te = {k: extend_field(gt, t2(x), kinds[k]) for k, x in a.items()}
    # b is an input of K4: the JAX buoyancy crosses as it is, so a float32
    # ulp of TEOS-10 cannot flip the sign test N^2 > 0 between the two
    jb = jax_buoyancy_field(JaxConfig(), gj, {"T": je["T"], "S": je["S"]})
    cfg = baroclinic_instability_config(closure=CATKEVerticalDiffusivity())
    tb = t2(np.asarray(jb))
    return gj, gt, je, te, jb, tb, cfg


@pytest.mark.parametrize("islands", [False, True], ids=["flat", "islands"])
def test_plain_k4_matches_jax_kernel_f32(islands):
    gj, gt, je, te, jb, tb, cfg = _both((64, 32, 16), np.float32, islands)

    def t3(a):
        return jnp.transpose(a, (2, 1, 0))

    ref = jax_catke_kernel(JaxCATKE(), gj, t3(je["u"]), t3(je["v"]), t3(jb), t3(je["e"]),
                           interpret=True)
    got = catke_diffusivities_plain(cfg.closure, gt, te["u"], te["v"], tb, te["e"])
    for name, g, w in zip(NAMES, got, ref):
        np.testing.assert_allclose(back(g), np.asarray(w), rtol=1e-6, atol=1e-10, err_msg=name)


@pytest.mark.parametrize("islands", [False, True], ids=["flat", "islands"])
def test_plain_k4_matches_jax_array_f64(islands):
    gj, gt, je, te, jb, tb, cfg = _both((32, 16, 12), np.float64, islands)
    ref = jax_catke_diffusivities(JaxCATKE(), gj, je["u"], je["v"], jb, je["e"])
    got = catke_diffusivities_plain(cfg.closure, gt, te["u"], te["v"], tb, te["e"])
    for name, g, w in zip(NAMES, got, ref):
        w = np.asarray(gj.interior(w))
        np.testing.assert_allclose(back(g), w, rtol=1e-12, atol=1e-12 * np.abs(w).max(),
                                   err_msg=name)


def test_closure_constants_are_the_jax_packages():
    assert dataclasses.asdict(CATKEVerticalDiffusivity()) == dataclasses.asdict(JaxCATKE())


def test_surface_tke_flux_matches_jax_f64():
    rng = np.random.default_rng(8)
    tx, ty = 1e-4 * rng.standard_normal((2, 16, 8))
    want = jax_surface_tke_flux(JaxCATKE(), jnp.asarray(tx), jnp.asarray(ty))
    got = surface_tke_flux(CATKEVerticalDiffusivity(), torch.as_tensor(tx), torch.as_tensor(ty))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14)


def test_dispatch_runs_plain_on_cpu():
    """kernels="auto" on CPU tensors and kernels="torch" both run the plain
    version: the same tensors, no launch."""
    from gb25_tpu_torch.ops import pallas_catke

    _, gt, _, te, _, tb, cfg = _both((16, 8, 4), np.float32)
    before = pallas_catke.KERNEL.launches
    outs = [catke_diffusivities_kernel(dataclasses.replace(cfg, kernels=k), gt, te["u"],
                                       te["v"], tb, te["e"]) for k in ("auto", "torch")]
    assert pallas_catke.KERNEL.launches == before
    for a, b in zip(*outs):
        assert a.shape == (4, 8, 16)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
