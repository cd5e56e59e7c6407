"""K1's plain version against the JAX package's tendency stage.

float32: the port's ``zslab_tendencies_plain`` against the JAX z-slab
kernel run in interpret mode with the flagship options (ab2, wall_v,
integrals), at rtol 2e-4 with the atol of tests/test_zslab.py: the kernel
sums its z carries in another order than a cumsum, which the JAX package's
own kernel-vs-array test bounds at that tolerance.

float64: against JAX ``tendency_math`` plus the AB2 arithmetic written out
in numpy; only reassociation differs, so 1e-12 of each field's largest
magnitude holds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gb25_tpu.grids import simple_latitude_longitude_grid as jax_grid
from gb25_tpu.models import baroclinic_instability_config as jax_config
from gb25_tpu.models import baroclinic_instability_state as jax_state
from gb25_tpu.models.hydrostatic import tendency_math as jax_tendency_math
from gb25_tpu.ops.halos import extend_field as jax_extend_field
from gb25_tpu.ops.operators import coriolis_ff as jax_coriolis_ff
from gb25_tpu.ops.pallas_zslab import zslab_tendencies as jax_zslab_tendencies
from gb25_tpu_torch.grids import simple_latitude_longitude_grid
from gb25_tpu_torch.models import baroclinic_instability_config
from gb25_tpu_torch.ops.halos import extend_field
from gb25_tpu_torch.ops.pallas_zslab import zslab_tendencies, zslab_tendencies_plain

DT = 60.0


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
    return torch.from_numpy(np.array(np.transpose(np.asarray(a))))


def back(t):
    return np.transpose(t.numpy())


def _inputs(shape, np_dtype, seed=11):
    """JAX initial state, previous tendencies and AB2 coefficients (the
    second step's: c1 = 1.6, c2 = -0.6) in the working precision."""
    gj = jax_grid(*shape, dtype=np_dtype)
    sj = jax_state(gj, noise_velocity=1e-3)
    rng = np.random.default_rng(seed)
    prev = {k: (rng.standard_normal(shape) * 1e-7).astype(np_dtype)
            for k in ("Gu", "Gv", "T", "S")}
    prev["Gv"][:, 0, :] = 0.0
    ft = np.dtype(np_dtype).type
    ab = (ft(DT) * ft(1.6), ft(DT) * ft(-0.6))
    return gj, sj, prev, ab


def _port(shape, torch_dtype, sj, prev, ab):
    gt = simple_latitude_longitude_grid(*shape, device="cpu", dtype=torch_dtype)
    cfg = baroclinic_instability_config()
    ue = extend_field(gt, t3(sj.u), "u")
    ve = extend_field(gt, t3(sj.v), "v")
    tr_e = {k: extend_field(gt, t3(sj.tracers[k]), "c") for k in ("T", "S")}
    prev_t = (t3(prev["Gu"]), t3(prev["Gv"]), {"T": t3(prev["T"]), "S": t3(prev["S"])})
    return zslab_tendencies_plain(cfg, gt, ue, ve, tr_e, prev_t, (float(ab[0]), float(ab[1])))


@pytest.mark.parametrize("shape", [(128, 32, 8), (64, 16, 16)])
def test_plain_k1_matches_jax_kernel_f32(shape):
    gj, sj, prev, ab = _inputs(shape, np.float32)
    cfg = jax_config()
    ue = jax_extend_field(gj, sj.u, "u")
    ve = jax_extend_field(gj, sj.v, "v")
    tr_e = {k: jax_extend_field(gj, c, "c") for k, c in sj.tracers.items()}
    f_ff = jax_coriolis_ff(gj, cfg.coriolis).astype(jnp.float32)
    ab_j = jnp.asarray([[ab[0], ab[1]]], jnp.float32)
    prev_j = {k: jnp.asarray(v) for k, v in prev.items()}
    ref = jax_zslab_tendencies(
        cfg, gj, f_ff, ue, ve, tr_e, interpret=True,
        ab2=(ab_j, prev_j["Gu"], prev_j["Gv"], {"T": prev_j["T"], "S": prev_j["S"]}),
        wall_v=True, integrals=True)
    Gu, Gv, Gtr, u_new, v_new, tr_new, ints = _port(shape, torch.float32, sj, prev, ab)

    def check(port, want, atol):
        np.testing.assert_allclose(back(port), np.asarray(want), rtol=2e-4, atol=atol)

    def check_updated(port, want, G):
        # x* = x + dt c1 G + ...: the tendencies' tolerance, carried
        # through the update, bounds the difference of x*
        atol = float(ab[0]) * 2e-4 * float(np.abs(np.asarray(G)).max())
        check(port, want, atol)

    check(Gu, ref[0], 1e-9)
    check(Gv, ref[1], 1e-9)
    for k in ("T", "S"):
        check(Gtr[k], ref[2][k], 1e-7)
        check_updated(tr_new[k], ref[5][k], ref[2][k])
    check_updated(u_new, ref[3], ref[0])
    check_updated(v_new, ref[4], ref[1])
    # depth integrals: sums of Nz terms taken in another order, so bounded
    # relative to the largest integral, plus the propagated tendency
    # tolerance for the integrals of u*, v* over the depth H
    H = float(np.asarray(gj.dz_c)[:, :, 4:-4].sum())
    for port, want, G in zip(ints, ref[6], (0.0, 0.0, ref[0], ref[1])):
        G_max = float(np.abs(np.asarray(G)).max())
        check(port, want, 2e-4 * float(np.abs(np.asarray(want)).max())
              + float(ab[0]) * 2e-4 * G_max * H)
    assert float(np.abs(back(v_new)[:, 0, :]).max()) == 0.0


def test_plain_k1_matches_jax_array_math_f64():
    shape = (32, 16, 8)
    gj, sj, prev, ab = _inputs(shape, np.float64)
    cfg = jax_config()
    ue = jax_extend_field(gj, sj.u, "u")
    ve = jax_extend_field(gj, sj.v, "v")
    tr_e = {k: jax_extend_field(gj, c, "c") for k, c in sj.tracers.items()}
    f_ff = jax_coriolis_ff(gj, cfg.coriolis)
    Gu_e, Gv_e, Gtr_e = jax_tendency_math(cfg, gj, f_ff, ue, ve, tr_e)
    a, b = ab
    G = {"Gu": np.asarray(gj.interior(Gu_e)), "Gv": np.asarray(gj.interior(Gv_e)).copy(),
         "T": np.asarray(gj.interior(Gtr_e["T"])), "S": np.asarray(gj.interior(Gtr_e["S"]))}
    G["Gv"][:, 0, :] = 0.0
    cur = {"Gu": np.asarray(sj.u), "Gv": np.asarray(sj.v),
           "T": np.asarray(sj.tracers["T"]), "S": np.asarray(sj.tracers["S"])}
    new = {k: cur[k] + a * G[k] + b * prev[k] for k in G}
    new["Gv"][:, 0, :] = 0.0
    dz = np.asarray(gj.dz_c)[:, :, 4:-4]
    ints = [np.sum(f * dz, axis=2) for f in (cur["Gu"], cur["Gv"], new["Gu"], new["Gv"])]

    Gu, Gv, Gtr, u_new, v_new, tr_new, ints_t = _port(shape, torch.float64, sj, prev, ab)
    port = {"Gu": Gu, "Gv": Gv, "T": Gtr["T"], "S": Gtr["S"]}
    port_new = {"Gu": u_new, "Gv": v_new, "T": tr_new["T"], "S": tr_new["S"]}
    for k in G:
        for got, want in ((port[k], G[k]), (port_new[k], new[k])):
            np.testing.assert_allclose(back(got), want, rtol=0,
                                       atol=1e-12 * np.abs(want).max(), err_msg=k)
    for got, want in zip(ints_t, ints):
        np.testing.assert_allclose(back(got), want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_dispatch_runs_plain_on_cpu():
    """Under kernels="auto" a CPU tensor takes the plain version; "torch"
    takes it on any device. (A CUDA tensor takes the kernel or raises:
    tests/test_torch_kernels_cuda.py.)"""
    shape = (16, 8, 4)
    gt = simple_latitude_longitude_grid(*shape, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(0)
    ext = (12, 16, 24)
    ue, ve, T, S = (torch.from_numpy(rng.standard_normal(ext).astype(np.float32))
                    for _ in range(4))
    prev = (torch.zeros(4, 8, 16), torch.zeros(4, 8, 16),
            {"T": torch.zeros(4, 8, 16), "S": torch.zeros(4, 8, 16)})
    outs = [zslab_tendencies(baroclinic_instability_config(kernels=k), gt, ue, ve,
                             {"T": T, "S": S}, prev, (60.0, 0.0)) for k in ("auto", "torch")]
    for a, b in zip(outs[0][:2], outs[1][:2]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
