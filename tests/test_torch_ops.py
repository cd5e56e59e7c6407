"""The port's ops against the JAX package's, on the same numpy inputs.

Float64 throughout: the two sides run the same arithmetic, so they agree
to reassociation roundoff; 1e-12 of the largest magnitude is a bound with
room for the differently ordered reductions (cumsum). Halo fills and
stencil shifts move values only and must be exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gb25_tpu.grids import simple_latitude_longitude_grid as jax_grid
from gb25_tpu.ops import halos as jhalos
from gb25_tpu.ops import operators as jops
from gb25_tpu.ops import stencils as jst
from gb25_tpu.ops.eos import TEOS10EquationOfState as JaxTEOS10
from gb25_tpu.ops.eos import rho_vertical_reference as jax_rho_vertical_reference
from gb25_tpu.ops.weno import weno5_upwind as jax_weno5_upwind
from gb25_tpu_torch.grids import simple_latitude_longitude_grid
from gb25_tpu_torch.ops import halos, operators, stencils
from gb25_tpu_torch.ops.eos import TEOS10EquationOfState, rho_vertical_reference
from gb25_tpu_torch.ops.weno import weno5_upwind

RTOL = 1e-12
SHAPE = (12, 10, 8)  # (Nx, Ny, Nz), JAX layout


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: beside other busy
    test processes, torch's default of one OpenMP thread per core made the
    plain versions' many small launches ~100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t3(a):
    """JAX (X, Y, Z) numpy array -> port (Z, Y, X) tensor (and back)."""
    a = np.asarray(a)
    return torch.from_numpy(np.array(np.transpose(a)))


def back(t):
    return np.transpose(t.numpy())


def close(port, ref, rtol=RTOL):
    ref = np.asarray(ref)
    port = np.asarray(port)
    assert port.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-300)
    np.testing.assert_allclose(port, ref, rtol=0, atol=rtol * scale)


@pytest.fixture
def grids():
    gj = jax_grid(*SHAPE, dtype=jnp.float64)
    gt = simple_latitude_longitude_grid(*SHAPE, device="cpu", dtype=torch.float64)
    return gj, gt


@pytest.mark.parametrize("axis", ["x", "y", "z"])
@pytest.mark.parametrize("op", ["d_f", "d_c", "i_f", "i_c"])
def test_stencils(axis, op):
    a = np.random.default_rng(0).standard_normal((7, 6, 5))
    ref = getattr(jst, op)(jnp.asarray(a), axis)
    out = getattr(stencils, op)(t3(a), axis)
    close(back(out), ref)


@pytest.mark.parametrize("kind", ["c", "u", "v", "w"])
def test_extend_field(grids, kind):
    gj, gt = grids
    a = np.random.default_rng(1).standard_normal(SHAPE)
    ref = jhalos.extend_field(gj, jnp.asarray(a), kind)
    out = halos.extend_field(gt, t3(a), kind)
    np.testing.assert_array_equal(back(out), np.asarray(ref))


@pytest.mark.parametrize("h", [1, 2, 5])
@pytest.mark.parametrize("kind", ["c", "u", "v"])
def test_extend2(grids, kind, h):
    gj, gt = grids
    a = np.random.default_rng(2).standard_normal(SHAPE[:2])
    ref = jhalos.extend2(gj, jnp.asarray(a), kind, h=h)
    out = halos.extend2(gt, t3(a), kind, h=h)
    np.testing.assert_array_equal(back(out), np.asarray(ref))


@pytest.mark.parametrize("align", ["face", "center"])
@pytest.mark.parametrize("axis", ["x", "y", "z"])
def test_weno5_upwind(axis, align):
    """Includes exactly-zero velocities: the upwind test is strict, so a
    v = 0 face takes the from-above stencil on both sides."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((9, 8, 10))
    vel = rng.standard_normal((9, 8, 10))
    vel[rng.random(vel.shape) < 0.25] = 0.0
    ref = jax_weno5_upwind(jnp.asarray(a), jnp.asarray(vel), axis, align=align)
    out = weno5_upwind(t3(a), t3(vel), axis, align=align)
    close(back(out), ref)


def test_teos10_buoyancy(grids):
    gj, gt = grids
    rng = np.random.default_rng(4)
    T = rng.uniform(-2.0, 30.0, SHAPE)
    S = rng.uniform(30.0, 38.0, SHAPE)
    z = np.asarray(gj.z_c)[:, :, 4:-4]
    ref = JaxTEOS10().buoyancy(jnp.asarray(T), jnp.asarray(S), jnp.asarray(z))
    out = TEOS10EquationOfState().buoyancy(t3(T), t3(S), t3(z))
    close(back(out), ref)


def test_rho_vertical_reference(grids):
    gj, gt = grids
    close(rho_vertical_reference(gt.z_c).numpy().reshape(-1),
          np.asarray(jax_rho_vertical_reference(gj.z_c)).reshape(-1))


def _extended_uv(gj, gt, seed=5):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(SHAPE) * 1e-1
    v = rng.standard_normal(SHAPE) * 1e-1
    ue_j = jhalos.extend_field(gj, jnp.asarray(u), "u")
    ve_j = jhalos.extend_field(gj, jnp.asarray(v), "v")
    return ue_j, ve_j, t3(ue_j), t3(ve_j)


def test_diagnose_w(grids):
    gj, gt = grids
    ue_j, ve_j, ue, ve = _extended_uv(gj, gt)
    close(back(operators.diagnose_w(gt, ue, ve)), jops.diagnose_w(gj, ue_j, ve_j))


def test_hydrostatic_pressure(grids):
    gj, gt = grids
    b = np.random.default_rng(6).standard_normal(tuple(n + 8 for n in SHAPE)) * 1e-2
    close(back(operators.hydrostatic_pressure(gt, t3(b))),
          jops.hydrostatic_pressure(gj, jnp.asarray(b)))


@pytest.mark.parametrize("op", ["horizontal_divergence", "vertical_vorticity"])
def test_horizontal_operators(grids, op):
    gj, gt = grids
    ue_j, ve_j, ue, ve = _extended_uv(gj, gt, seed=7)
    close(back(getattr(operators, op)(gt, ue, ve)), getattr(jops, op)(gj, ue_j, ve_j))


def test_kinetic_energy(grids):
    gj, gt = grids
    ue_j, ve_j, ue, ve = _extended_uv(gj, gt, seed=8)
    close(back(operators.kinetic_energy(ue, ve)), jops.kinetic_energy(ue_j, ve_j))


def test_coriolis_ff(grids):
    gj, gt = grids
    omega = 7.292115e-5
    close(operators.coriolis_ff(gt, omega).numpy(), jops.coriolis_ff(gj, omega))
