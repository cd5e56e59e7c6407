"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Skipped where there is no CUDA device (the decision is made inside
the fixture, never at import). On the GPU machine, without the JAX test
configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: K1 rtol 2e-4 (the JAX package's kernel-vs-array bound, with
tests/test_zslab.py's atol), K2 rtol 1e-5 (tests/test_barotropic_kernel.py),
one step rtol 1e-3 / atol 5e-6 (tests/test_zslab.py).
"""

import dataclasses

import pytest
import torch

from gb25_tpu_torch import baroclinic_instability_model, time_step
from gb25_tpu_torch.models.free_surface import face_depths
from gb25_tpu_torch.ops import pallas_barotropic, pallas_zslab
from gb25_tpu_torch.ops.halos import extend_field

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the GPU)")
    return torch.device("cuda")


def _close(got, want, rtol, atol):
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("shape", [(128, 32, 8), (64, 16, 16), (100, 20, 10)])
def test_k1_matches_plain(cuda, shape):
    cfg, grid, state = baroclinic_instability_model(*shape, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    ue = extend_field(grid, state.u, "u")
    ve = extend_field(grid, state.v, "v")
    tr_e = {k: extend_field(grid, c, "c") for k, c in state.tracers.items()}
    noise = [1e-7 * torch.randn(grid.shape, generator=gen, device=cuda) for _ in range(4)]
    noise[1][:, 0, :] = 0.0
    prev = (noise[0], noise[1], {"T": noise[2], "S": noise[3]})
    ab = (96.0, -36.0)
    before = pallas_zslab.KERNEL.launches
    got = pallas_zslab.zslab_tendencies(cfg, grid, ue, ve, tr_e, prev, ab)
    torch.cuda.synchronize()
    assert pallas_zslab.KERNEL.launches == before + 1
    want = pallas_zslab.zslab_tendencies_plain(cfg, grid, ue, ve, tr_e, prev, ab)
    for g, w in zip(got[:2], want[:2]):
        _close(g, w, 2e-4, 1e-9)
    for k in ("T", "S"):
        _close(got[2][k], want[2][k], 2e-4, 1e-7)
    for g, w, G in zip((got[3], got[4], got[5]["T"], got[5]["S"]),
                       (want[3], want[4], want[5]["T"], want[5]["S"]),
                       (want[0], want[1], want[2]["T"], want[2]["S"])):
        _close(g, w, 2e-4, ab[0] * 2e-4 * float(G.abs().max()))
    for g, w in zip(got[6], want[6]):
        _close(g, w, 2e-4, 2e-4 * float(w.abs().max()) + 1e-6)
    assert float(got[4][:, 0, :].abs().max()) == 0.0


@pytest.mark.parametrize("shape", [(128, 32), (100, 20)])
def test_k2_matches_plain(cuda, shape):
    Nx, Ny = shape
    cfg, grid, state = baroclinic_instability_model(Nx, Ny, 8, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(4)
    eta0, U0, V0, GU, GV = (s * torch.randn((Ny, Nx), generator=gen, device=cuda)
                            for s in (1e-2, 1.0, 1.0, 1e-4, 1e-4))
    V0[0] = 0.0
    GV[0] = 0.0
    Hu, Hv = face_depths(grid)
    before = pallas_barotropic.KERNEL.launches
    got = pallas_barotropic.barotropic_loop(cfg, grid, eta0, U0, V0, GU, GV, Hu, Hv, 60.0)
    torch.cuda.synchronize()
    assert pallas_barotropic.KERNEL.launches == before + cfg.free_surface.substeps
    plain = dataclasses.replace(cfg, kernels="torch")
    want = pallas_barotropic.barotropic_loop(plain, grid, eta0, U0, V0, GU, GV, Hu, Hv, 60.0)
    for g, w in zip(got, want):
        _close(g, w, 1e-5, 1e-6 * float(w.abs().max()))


def test_step_matches_plain_step(cuda):
    cfg, grid, state = baroclinic_instability_model(128, 32, 8, device=cuda)
    a = time_step(cfg, grid, state, 60.0)
    b = time_step(dataclasses.replace(cfg, kernels="torch"), grid, state, 60.0)
    for x, y in ((a.u, b.u), (a.v, b.v), (a.eta, b.eta), (a.tracers["T"], b.tracers["T"]),
                 (a.tracers["S"], b.tracers["S"])):
        _close(x, y, 1e-3, 5e-6)


def test_auto_on_cuda_raises_for_unsupported_dtype(cuda):
    """A CUDA tensor under kernels="auto" takes the kernel or raises: a
    float64 field is refused, never handed to the plain version."""
    cfg, grid, state = baroclinic_instability_model(32, 16, 4, device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="dtype"):
        time_step(cfg, grid, state, 60.0)
