"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Skipped where there is no CUDA device (the decision is made inside
the fixture, never at import). On the GPU machine, without the JAX test
configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: K1 rtol 2e-4 (the JAX package's kernel-vs-array bound, with
tests/test_zslab.py's atol), K2 bit for bit (its plain version's operations
in order, -fmad=false; all substeps in one launch, in the on-chip and the
L2 instance, flat, masked, fold and fold without masks, on strongly
coupled operands at sizes that its tiles do not divide; masks other than
0 and 1 refused; whether a CUDA graph captures its cooperative launch is
reported, not asserted), K4 rtol 1e-6 (tests/test_pallas_catke.py: the same pointwise formulas,
rounded alike with -fmad=false; K4's k-epsilon function bit for bit), K3
bit for bit (the Pallas kernel's recurrence term by term, -fmad=false; one
and two right-hand sides, with and without damping, 1 to 128 levels, rows
that its blocks of columns do not divide), one step rtol 1e-3 / atol 5e-6
(tests/test_zslab.py). The tripolar instances of K1 and K2 and the
four-tracer instance of K1 run on the same checks. K5 (the blocked
barotropic substeps of the decomposed path) bit for bit on the whole
extended planes (its plain version's operations in order, -fmad=false),
with exactly ceil(n / s) launches for a block of n substeps, s substeps a
launch: blocks of 1, 2, 4, s, s + 1 and 30 substeps, with metric columns,
masks and metric planes, on planes that its tiles do not divide and on a
plane smaller than one tile with its apron; K1 with wall_v=0 (a tile that
is not south-most) at K1's tolerances; the decomposed 1x1 step at the
one-step tolerances, its "ring" mode bit for bit with its "local" mode.
K6 (the one-pass tendency kernel of the kernels="pallas" route) at K1's
tolerances in its flagship, tripolar and four-tracer instances, its split
pair bit for bit with its single launch and its TEOS-10 buoyancy within a
few float32 ulps of the plain one; K1 at its tolerances and K6 bit for bit
with their plain versions on grids that their 32 x 8 level tiles do not
divide, narrower than a tile, with unaligned rows and 400 levels deep; a
K6-route step at the one-step tolerances against a "torch" step, with
exactly 1 K6, 0 K1 and 0 K2 launches, K5's ceil(n / s) for each of the
step's blocks (and 3 K3, 1 K4 in the coupled climate). The device loop
(``models.device_loop``): ``loop``, ``coupled_loop`` and ``sw_loop``
replayed from their captured CUDA graph against the same steps launched
from the host, bit for bit on every field, the clock and the iteration, at
128x64x8 on the flagship (both tendency routes), k-epsilon, the climate on
the islands and the tripolar grid and shallow water, over a call that
captures and a second call that replays the kept graph; a step that cannot
be captured makes the loop raise. K1's unfused instances (float32 and
bfloat16 storage, the routes under a compute_dtype or the explicit free
surface) at K1's tolerances on grids its tiles divide and do not (rows not
16-byte aligned take the value-by-value staging), the bfloat16 instance on
operands rounded beforehand bit for bit with itself on the raw ones and
apart from the float32 instance; K3's constant-kappa pair bit for bit with
the plain version and with the field instance on a constant field; one
step of each new route (bf16s, the explicit free surface,
VerticalScalarDiffusivity) at the one-step tolerances against a "torch"
step with its launches (1 K1 and 1 K2; 1 K1 and no K2; 1 K1, 1 K2 and 2
K3), the device loop on those routes and on the cast array path
("bfloat16", "f32x2") bit for bit with the host loop, and the "bfloat16"
mode within tests/test_precision.py's bounds of float32 over 10 steps.
The decomposed path forced onto a 1x1 mesh at W = 30: the flagship's and
the tripolar climate's loops replayed bit for bit with the host loop in
"local" and "ring"; one step of the K6 route, "bf16s", "float32",
VerticalScalarDiffusivity and the explicit free surface on the tile against
a "torch" step with their launches (K5's ceil(30 / s), no K2). "float32"
serially: 1 K1 (unfused), 1 K2 a step, replayed bit for bit. A float64
state under "auto" launches nothing and equals the CPU step within 1e-10;
under "pallas" it launches K6's float64 instance once a step (K2-K5 plain)
and equals the CPU's "pallas" step within 1e-10. K6's float64 instances
(one to four tracers, columns and planes, TEOS-10, the linear equation of
state and the b tracer) bit for bit with the plain twin; "float64" on the
K6 route and "bf16x2" (paired-bfloat16 limbs, array path) replayed bit for
bit with the host loop. K1's instances that make b themselves (no closure:
TEOS-10 in the compiled flagship instance, TEOS-10, the linear equation of
state and the b tracer in the general ones; flat, islands and tripolar,
fused and unfused) bit for bit with the instances that read the eager
float32 b and a column total summed in the kernel's order, and at K1's
tolerances against the plain version; the share of K1's launches whose b
the kernel made over three steps, 1 without a closure and 0 with CATKE.
"""

import dataclasses
import functools

import pytest
import torch

from gb25_tpu_torch import (
    baroclinic_instability_model,
    coupled_time_step,
    data_free_ocean_climate_model,
    shallow_water_model,
    sw_time_step,
    time_step,
)
from gb25_tpu_torch.grids.immersed import face_bottom_planes, face_masks
from gb25_tpu_torch.models import (
    ExplicitFreeSurface,
    VerticalScalarDiffusivity,
    coupled_loop,
    device_loop,
    loop,
    sw_loop,
)
from gb25_tpu_torch.models.hydrostatic import premask_state
from gb25_tpu_torch.models.free_surface import face_depths
from gb25_tpu_torch.models.keps import TKEDissipationVerticalDiffusivity
from gb25_tpu_torch.models.baroclinic import buoyancy_tracer_state
from gb25_tpu_torch.models.catke import CATKEVerticalDiffusivity
from gb25_tpu_torch.ops.eos import LinearEquationOfState
from gb25_tpu_torch.ops import (
    pallas_barotropic,
    pallas_catke,
    pallas_tendency,
    pallas_tridiag,
    pallas_zslab,
)
from gb25_tpu_torch.ops.halos import extend_field
from gb25_tpu_torch.ops.operators import coriolis_ff

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: beside other busy
    test processes, torch's default of one OpenMP thread per core made the
    plain versions' many small launches ~100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    assert pallas_barotropic.KERNEL.launches == before + 1
    plain = dataclasses.replace(cfg, kernels="torch")
    want = pallas_barotropic.barotropic_loop(plain, grid, eta0, U0, V0, GU, GV, Hu, Hv, 60.0)
    for g, w in zip(got, want):
        assert torch.equal(g, w), float((g - w).abs().max())


def test_step_matches_plain_step(cuda):
    cfg, grid, state = baroclinic_instability_model(128, 32, 8, device=cuda)
    a = time_step(cfg, grid, state, 60.0)
    b = time_step(dataclasses.replace(cfg, kernels="torch"), grid, state, 60.0)
    for x, y in ((a.u, b.u), (a.v, b.v), (a.eta, b.eta), (a.tracers["T"], b.tracers["T"]),
                 (a.tracers["S"], b.tracers["S"])):
        _close(x, y, 1e-3, 5e-6)


def test_auto_on_cuda_raises_for_unsupported_dtype(cuda):
    """A float64 state on the card: "auto" takes every kernel's plain
    version (the JAX package's route for a non-float32 state), launching
    nothing, and its step equals the same step on the CPU within 1e-10;
    "pallas" launches K6's float64 instance once and the plain versions of
    K2-K5, and equals the CPU's "pallas" step within 1e-10; K1 raises on a
    float64 operand."""
    cfg, grid, _ = baroclinic_instability_model(32, 16, 4, device=cuda, dtype=torch.float64)
    _, grid_cpu, state_cpu = baroclinic_instability_model(32, 16, 4, device="cpu",
                                                          dtype=torch.float64)
    # the CPU's state on the card (the initial noise comes from each device's generator)
    state = state_cpu.replace(**{f.name: _to(getattr(state_cpu, f.name), cuda)
                                 for f in dataclasses.fields(state_cpu) if f.name != "iteration"})
    kernels = list(_all_kernels())
    before = [k.launches for k in kernels]
    a = time_step(cfg, grid, state, 60.0)
    torch.cuda.synchronize()
    assert [k.launches for k in kernels] == before
    b = time_step(cfg, grid_cpu, state_cpu, 60.0)
    for x, y in ((a.u, b.u), (a.v, b.v), (a.eta, b.eta), (a.tracers["T"], b.tracers["T"])):
        _close(x.cpu(), y, 1e-10, 1e-10 * float(y.abs().max()))
    pallas = dataclasses.replace(cfg, kernels="pallas")
    before = [k.launches for k in kernels]
    a = time_step(pallas, grid, state, 60.0)
    torch.cuda.synchronize()
    assert [k.launches - b0 for k, b0 in zip(kernels, before)] == [0, 0, 0, 0, 0, 0, 1]
    b = time_step(pallas, grid_cpu, state_cpu, 60.0)
    for x, y in ((a.u, b.u), (a.v, b.v), (a.eta, b.eta), (a.tracers["T"], b.tracers["T"])):
        _close(x.cpu(), y, 1e-10, 1e-10 * float(y.abs().max()))
    ue, ve = extend_field(grid, state.u, "u"), extend_field(grid, state.v, "v")
    tr_e = {k: extend_field(grid, c, "c") for k, c in state.tracers.items()}
    be, b_total = pallas_zslab.column_buoyancy(cfg, grid, tr_e)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        pallas_zslab.zslab_kernel_unfused(cfg, grid, ue, ve, tr_e, be, b_total)


def _to(x, device):
    return {k: v.to(device) for k, v in x.items()} if isinstance(x, dict) else x.to(device)


def _all_kernels():
    return (pallas_zslab.KERNEL, pallas_barotropic.KERNEL, pallas_barotropic.BLOCK_KERNEL,
            pallas_tridiag.KERNEL, pallas_catke.KERNEL, pallas_catke.KEPS_KERNEL,
            pallas_tendency.KERNEL)


def _climate_operands(cuda, shape, seed, grid_type="gaussian_islands"):
    """Extended, masked u, v, tracers and the buoyancy of a perturbed
    climate state on the Gaussian-islands grid (lat-lon or tripolar)."""
    Nx, Ny, Nz = shape
    ccfg, grid, _, state = data_free_ocean_climate_model(resolution=384 / Nx, Nz=Nz, device=cuda,
                                                         grid_type=grid_type)
    assert grid.shape == (Nz, Ny, Nx)
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def noise(s):
        return s * torch.randn(grid.shape, generator=gen, device=cuda)

    um, vm = face_masks(grid)
    ue = extend_field(grid, noise(0.05), "u") * um
    ve = extend_field(grid, noise(0.05), "v") * vm
    tr = {"T": state.tracers["T"] + noise(0.1), "S": state.tracers["S"],
          "e": 1e-5 * (1.0 + torch.rand(grid.shape, generator=gen, device=cuda))}
    tr_e = {k: extend_field(grid, c, "c") for k, c in tr.items()}
    be, b_total = pallas_zslab.column_buoyancy(ccfg.ocean, grid, tr_e)
    return ccfg.ocean, grid, ue, ve, tr_e, be, b_total, noise


@pytest.mark.parametrize("shape", [(128, 64, 8), (96, 48, 12)])
def test_k4_matches_plain(cuda, shape):
    cfg, grid, ue, ve, tr_e, be, _, _ = _climate_operands(cuda, shape, 5)
    before = pallas_catke.KERNEL.launches
    got = pallas_catke.catke_diffusivities_kernel(cfg, grid, ue, ve, be, tr_e["e"])
    torch.cuda.synchronize()
    assert pallas_catke.KERNEL.launches == before + 1
    want = pallas_catke.catke_diffusivities_plain(cfg.closure, grid, ue, ve, be, tr_e["e"])
    for g, w in zip(got, want):
        _close(g, w, 1e-6, 1e-10 * float(w.abs().max()))


@pytest.mark.parametrize("case", ["pair", "damped", "single"])
def test_k3_matches_plain(cuda, case):
    Nx, Ny, Nz = 100, 20, 16
    cfg, grid, _ = baroclinic_instability_model(Nx, Ny, Nz, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(6)
    shape = (Nz, Ny, Nx)
    f0 = torch.randn(shape, generator=gen, device=cuda)
    f1 = 20.0 + torch.randn(shape, generator=gen, device=cuda)
    kappa = 10.0 ** (6.0 * torch.rand(shape, generator=gen, device=cuda) - 5.0)
    damp = 1e-3 * torch.rand(shape, generator=gen, device=cuda)
    fields = {"pair": (f0, f1), "damped": (f0,), "single": (f1,)}[case]
    damping = damp if case == "damped" else None
    dzc, dzf = grid.dz_c[4:-4], grid.dz_f[4:-4]
    before = pallas_tridiag.KERNEL.launches
    got = pallas_tridiag.implicit_diffusion(cfg, fields, kappa, 60.0, dzc, dzf, damping)
    torch.cuda.synchronize()
    assert pallas_tridiag.KERNEL.launches == before + 1
    a_lam, a_mu = pallas_tridiag.vertical_coefficients(60.0, dzc, dzf)
    want = pallas_tridiag.implicit_diffusion_plain(fields, kappa, 60.0, a_lam, a_mu, damping)
    for g, w in zip(got, want):
        assert torch.equal(g, w), float((g - w).abs().max())


@pytest.mark.parametrize("Nx", [31, 96, 100])
@pytest.mark.parametrize("Nz", [1, 7, 64, 128])
@pytest.mark.parametrize("nf,damped", [(1, False), (1, True), (2, False), (2, True)])
def test_k3_columns_match_plain_bitwise(cuda, nf, damped, Nz, Nx):
    """K3 on columns of 1 to 128 levels, in rows of 31, 96 and 100 columns
    (blocks of columns that do not divide them), against its plain version
    bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(Nz * 1000 + Nx)
    shape = (Nz, 3, Nx)
    fields = tuple(20.0 * n + torch.randn(shape, generator=gen, device=cuda) for n in range(nf))
    kappa = 10.0 ** (6.0 * torch.rand(shape, generator=gen, device=cuda) - 5.0)
    damping = 1e-3 * torch.rand(shape, generator=gen, device=cuda) if damped else None
    dz = 1.0 + 99.0 * torch.rand((Nz, 1, 1), generator=gen, device=cuda)
    a_lam, a_mu = pallas_tridiag.vertical_coefficients(60.0, dz, 0.5 + 0.5 * dz)
    got = pallas_tridiag.implicit_kernel(fields, kappa, 60.0, a_lam, a_mu, damping)
    want = pallas_tridiag.implicit_diffusion_plain(fields, kappa, 60.0, a_lam, a_mu, damping)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.isfinite(w).all()
        assert torch.equal(g, w), float((g - w).abs().max())


def test_k3_rejects_deep_columns(cuda):
    cfg, grid, _ = baroclinic_instability_model(32, 8, 130, device=cuda)
    f = torch.zeros(grid.shape, device=cuda)
    with pytest.raises(ValueError, match="at most 128"):
        pallas_tridiag.implicit_diffusion(cfg, (f,), f, 60.0, grid.dz_c[4:-4], grid.dz_f[4:-4])


@pytest.mark.parametrize("grid_type", ["gaussian_islands", "gaussian_islands_tripolar"])
def test_k1_climate_matches_plain(cuda, grid_type):
    cfg, grid, ue, ve, tr_e, be, b_total, noise = _climate_operands(cuda, (128, 64, 8), 7,
                                                                    grid_type)
    prev = (noise(1e-7), noise(1e-7), {k: noise(1e-7) for k in tr_e})
    prev[1][:, 0, :] = 0.0
    ab = (96.0, -36.0)
    fb = face_bottom_planes(grid)
    before = pallas_zslab.KERNEL.launches
    got = pallas_zslab.zslab_tendencies(cfg, grid, ue, ve, tr_e, prev, ab,
                                        buoyancy=(be, b_total), face_bottoms=fb)
    torch.cuda.synchronize()
    assert pallas_zslab.KERNEL.launches == before + 1
    want = pallas_zslab.zslab_tendencies_plain(cfg, grid, ue, ve, tr_e, prev, ab, be, fb)
    _close(got[0], want[0], 2e-4, 1e-9)
    _close(got[1], want[1], 2e-4, 1e-9)
    for k in tr_e:
        _close(got[2][k], want[2][k], 2e-4, 1e-7)
        _close(got[5][k], want[5][k], 2e-4, ab[0] * 2e-4 * float(want[2][k].abs().max()))
    for g, w, G in ((got[3], want[3], want[0]), (got[4], want[4], want[1])):
        _close(g, w, 2e-4, ab[0] * 2e-4 * float(G.abs().max()))
    for g, w in zip(got[6], want[6]):
        _close(g, w, 2e-4, 2e-4 * float(w.abs().max()) + 1e-6)


@pytest.mark.parametrize("grid_type", ["gaussian_islands", "gaussian_islands_tripolar"])
def test_k2_masked_matches_plain(cuda, grid_type):
    Nx, Ny = 128, 64
    ccfg, grid, _, _ = data_free_ocean_climate_model(resolution=3.0, Nz=8, device=cuda,
                                                     grid_type=grid_type)
    gen = torch.Generator(device=cuda).manual_seed(8)
    eta0, U0, V0, GU, GV = (s * torch.randn((Ny, Nx), generator=gen, device=cuda)
                            for s in (1e-2, 1.0, 1.0, 1e-4, 1e-4))
    Hu, Hv = face_depths(grid)
    mu, mv = (Hu > 0).float(), (Hv > 0).float()
    V0[0] = 0.0
    GV[0] = 0.0
    cfg = ccfg.ocean
    # the tripolar grid's metric-floored cells next to the pole caps are
    # gravity-wave unstable at dt = 60 s (the JAX fold test runs 10 s)
    dt = 10.0 if grid.north_fold else 60.0
    before = pallas_barotropic.KERNEL.launches
    got = pallas_barotropic.barotropic_loop(cfg, grid, eta0, U0, V0, GU * mu, GV * mv, Hu, Hv,
                                            dt, mu=mu, mv=mv)
    torch.cuda.synchronize()
    assert pallas_barotropic.KERNEL.launches == before + 1
    plain = dataclasses.replace(cfg, kernels="torch")
    want = pallas_barotropic.barotropic_loop(plain, grid, eta0, U0, V0, GU * mu, GV * mv, Hu,
                                             Hv, dt, mu=mu, mv=mv)
    for g, w in zip(got, want):
        assert torch.equal(g, w), float((g - w).abs().max())


@pytest.mark.parametrize("grid_type", ["gaussian_islands", "gaussian_islands_tripolar"])
def test_coupled_step_matches_plain_step(cuda, grid_type):
    ccfg, grid, atmos, state = data_free_ocean_climate_model(resolution=3.0, Nz=8, device=cuda,
                                                             grid_type=grid_type)
    plain = dataclasses.replace(ccfg, ocean=dataclasses.replace(ccfg.ocean, kernels="torch"))
    counts = [k.launches for k in (pallas_zslab.KERNEL, pallas_barotropic.KERNEL,
                                   pallas_tridiag.KERNEL, pallas_catke.KERNEL)]
    a = coupled_time_step(ccfg, grid, atmos, state, 60.0)
    torch.cuda.synchronize()
    after = [k.launches for k in (pallas_zslab.KERNEL, pallas_barotropic.KERNEL,
                                  pallas_tridiag.KERNEL, pallas_catke.KERNEL)]
    assert [x - y for x, y in zip(after, counts)] == [1, 1, 3, 1]
    b = coupled_time_step(plain, grid, atmos, state, 60.0)
    for x, y in ((a.u, b.u), (a.v, b.v), (a.eta, b.eta), *zip(a.tracers.values(),
                                                           b.tracers.values())):
        _close(x, y, 1e-3, 5e-6)


def test_k2_fold_without_masks_matches_plain(cuda):
    """K2's tripolar instance without mask planes: the fold row alone."""
    ccfg, grid, _, _ = data_free_ocean_climate_model(resolution=3.0, Nz=8, device=cuda,
                                                     grid_type="gaussian_islands_tripolar")
    Nx, Ny = grid.Nx, grid.Ny
    gen = torch.Generator(device=cuda).manual_seed(9)
    eta0, U0, V0, GU, GV = (s * torch.randn((Ny, Nx), generator=gen, device=cuda)
                            for s in (1e-3, 1.0, 1.0, 1e-4, 1e-4))
    V0[0] = 0.0
    GV[0] = 0.0
    H = torch.full((Ny, Nx), 4000.0, device=cuda)
    cfg = ccfg.ocean
    before = pallas_barotropic.KERNEL.launches
    got = pallas_barotropic.barotropic_loop(cfg, grid, eta0, U0, V0, GU, GV, H, H, 10.0)
    torch.cuda.synchronize()
    assert pallas_barotropic.KERNEL.launches == before + 1
    want = pallas_barotropic.barotropic_loop(dataclasses.replace(cfg, kernels="torch"), grid,
                                             eta0, U0, V0, GU, GV, H, H, 10.0)
    for g, w in zip(got, want):
        assert torch.equal(g, w), float((g - w).abs().max())


def _k2_operands(cuda, Ny, Nx, tripolar, masked, seed):
    """K2's raw operands with neighbours coupled strongly (dtau^2 g H / dx^2
    ~ 0.15 at dtau = g = 1), so that a wrong edge, halo or fold cell changes
    the result's bits: (eta0, U0, V0, GU, GV, Hu, Hv), (dyc, dxf, dxc, dyf,
    azc) as (Ny,) columns or (Ny, Nx) planes, and the masks or None."""
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def r(shape, scale, offset=0.0):
        return offset + scale * torch.rand(shape, generator=gen, device=cuda)

    m = (Ny, Nx) if tripolar else (Ny,)
    ins = [r((Ny, Nx), 2e-2, -1e-2), r((Ny, Nx), 2.0, -1.0), r((Ny, Nx), 2.0, -1.0),
           r((Ny, Nx), 2e-2, -1e-2), r((Ny, Nx), 2e-2, -1e-2), r((Ny, Nx), 0.1, 0.1),
           r((Ny, Nx), 0.1, 0.1)]
    metrics = [r(m, 0.4, 0.8) for _ in range(5)]
    masks = [(r((Ny, Nx), 1.0) > 0.1).float() for _ in range(2)] if masked else None
    return ins, metrics, masks


K2_CASES = {"flat": (False, False), "masked": (False, True), "fold": (True, True),
            "fold_no_masks": (True, False)}


@pytest.mark.parametrize("shape", [(20, 100), (13, 37), (5, 7), (77, 301), (768, 1536)],
                         ids=["100x20", "37x13", "7x5", "301x77", "1536x768"])
@pytest.mark.parametrize("case", list(K2_CASES))
@pytest.mark.parametrize("on_chip", [True, False], ids=["on_chip", "l2"])
def test_k2_instances_match_plain_bitwise(cuda, on_chip, case, shape):
    """K2 in one launch against loop_plain (its plane building, the plain
    substeps and the un-weighting): bit for bit, in the on-chip instance
    (shared-memory tiles) and the L2 instance, on grids that the tiles do
    not divide, with the pole column inside a tile."""
    from gb25_tpu_torch.models.free_surface import averaging_weights

    tripolar, masked = K2_CASES[case]
    Ny, Nx = shape
    ins, metrics, masks = _k2_operands(cuda, Ny, Nx, tripolar, masked, seed=Nx + Ny)
    plan = pallas_barotropic.launch_plan(Nx, Ny, masked, tripolar, on_chip)
    assert plan["instance"] == ("on_chip" if on_chip else "l2")
    # the pole column half-way across the second tile (of the whole row in L2)
    tx = plan["tile"][0] if on_chip else Nx
    pole = ((tx + tx // 2) % Nx if tx >= 3 else Nx // 3) if tripolar else None
    weights = averaging_weights(30)
    before = pallas_barotropic.KERNEL.launches
    got = pallas_barotropic._barotropic_loop_cuda(*ins, *metrics, weights, 1.0, 1.0, masks, pole,
                                                  on_chip=on_chip)
    torch.cuda.synchronize()
    assert pallas_barotropic.KERNEL.launches == before + 1
    want = pallas_barotropic.loop_plain(*ins, *metrics, weights, 1.0, 1.0, masks, pole)
    for g, w in zip(got, want):
        assert torch.isfinite(w).all()
        assert torch.equal(g, w), float((g - w).abs().max())


def test_k2_refuses_masks_other_than_0_and_1(cuda):
    """K2 keeps a solid-face mask as one bit a cell: a mask value of 0.5 or
    -0 is refused, never rounded to a bit."""
    from gb25_tpu_torch.models.free_surface import averaging_weights

    ins, metrics, masks = _k2_operands(cuda, 20, 100, False, True, seed=6)
    for bad in (0.5, -0.0):
        mu = masks[0].clone()
        mu[3, 7] = bad
        with pytest.raises(ValueError, match="masks of 0 and 1"):
            pallas_barotropic._barotropic_loop_cuda(*ins, *metrics, averaging_weights(30), 1.0,
                                                    1.0, (mu, masks[1]))


def test_k2_graph_capture_reported(cuda, capsys):
    """Whether torch.cuda.graph captures K2's cooperative launch, and
    whether a replay equals the eager call: printed, never a failure."""
    from gb25_tpu_torch.models.free_surface import averaging_weights

    ins, metrics, masks = _k2_operands(cuda, 64, 128, False, True, seed=5)
    weights = averaging_weights(30)

    def run():
        return pallas_barotropic._barotropic_loop_cuda(*ins, *metrics, weights, 1.0, 1.0, masks)

    want = run()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        run()  # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            out = run()
        graph.replay()
        torch.cuda.synchronize()
        report = f"captured; replay equals eager: {all(map(torch.equal, out, want))}"
    except Exception as exc:  # the finding, whatever it is
        report = f"not captured: {type(exc).__name__}: {exc}"
    with capsys.disabled():
        print(f"\nK2 cooperative launch under torch.cuda.graph: {report}")


def _keps_operands(cuda, shape, seed):
    cfg, grid, state = baroclinic_instability_model(*shape, device=cuda,
                                                    closure=TKEDissipationVerticalDiffusivity())
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def noise(s):
        return s * torch.randn(grid.shape, generator=gen, device=cuda)

    tr = {"T": state.tracers["T"] + noise(0.1), "S": state.tracers["S"],
          "e": 1e-5 * (1.0 + torch.rand(grid.shape, generator=gen, device=cuda)),
          "eps": 1e-8 * (1.0 + torch.rand(grid.shape, generator=gen, device=cuda))}
    ue = extend_field(grid, noise(0.05), "u")
    ve = extend_field(grid, noise(0.05), "v")
    tr_e = {k: extend_field(grid, c, "c") for k, c in tr.items()}
    be, b_total = pallas_zslab.column_buoyancy(cfg, grid, tr_e)
    return cfg, grid, ue, ve, tr_e, be, b_total, noise


@pytest.mark.parametrize("shape", [(128, 64, 8), (100, 20, 10)])
def test_k4_keps_matches_plain_bitwise(cuda, shape):
    cfg, grid, ue, ve, tr_e, be, _, _ = _keps_operands(cuda, shape, 10)
    before = pallas_catke.KEPS_KERNEL.launches
    got = pallas_catke.keps_diffusivities_kernel(cfg, grid, ue, ve, be, tr_e["e"], tr_e["eps"])
    torch.cuda.synchronize()
    assert pallas_catke.KEPS_KERNEL.launches == before + 1
    want = pallas_catke.keps_diffusivities_plain(cfg.closure, grid, ue, ve, be, tr_e["e"],
                                                 tr_e["eps"])
    for g, w in zip(got, want):
        _close(g, w, 0.0, 0.0)


def test_k1_four_tracers_matches_plain(cuda):
    cfg, grid, ue, ve, tr_e, be, b_total, noise = _keps_operands(cuda, (128, 32, 8), 11)
    prev = (noise(1e-7), noise(1e-7), {k: noise(1e-7) for k in tr_e})
    prev[1][:, 0, :] = 0.0
    ab = (96.0, -36.0)
    before = pallas_zslab.KERNEL.launches
    got = pallas_zslab.zslab_tendencies(cfg, grid, ue, ve, tr_e, prev, ab, buoyancy=(be, b_total))
    torch.cuda.synchronize()
    assert pallas_zslab.KERNEL.launches == before + 1
    want = pallas_zslab.zslab_tendencies_plain(cfg, grid, ue, ve, tr_e, prev, ab, be)
    _close(got[0], want[0], 2e-4, 1e-9)
    _close(got[1], want[1], 2e-4, 1e-9)
    for k in ("T", "S", "e", "eps"):
        _close(got[2][k], want[2][k], 2e-4, 1e-7)
        _close(got[5][k], want[5][k], 2e-4, ab[0] * 2e-4 * float(want[2][k].abs().max()))
    for g, w in zip(got[6], want[6]):
        _close(g, w, 2e-4, 2e-4 * float(w.abs().max()) + 1e-6)


def test_keps_steps_match_plain_steps(cuda):
    """Two k-epsilon flagship steps (an Euler and an AB2 step) through the
    kernels against the plain path: one K1, one K2, four K3 (u and v, T and
    S, e, eps) and one k-epsilon K4 launch per step."""
    cfg, grid, state = baroclinic_instability_model(128, 32, 8, device=cuda,
                                                    closure=TKEDissipationVerticalDiffusivity())
    kernels = (pallas_zslab.KERNEL, pallas_barotropic.KERNEL, pallas_tridiag.KERNEL,
               pallas_catke.KEPS_KERNEL, pallas_catke.KERNEL)
    counts = [k.launches for k in kernels]
    a = loop(cfg, grid, state, 60.0, 2)
    torch.cuda.synchronize()
    assert [k.launches - c for k, c in zip(kernels, counts)] == [2, 2, 8, 2, 0]
    b = loop(dataclasses.replace(cfg, kernels="torch"), grid, state, 60.0, 2)
    for x, y in ((a.u, b.u), (a.v, b.v), (a.eta, b.eta), *zip(a.tracers.values(),
                                                           b.tracers.values())):
        _close(x, y, 1e-3, 5e-6)
    assert float(a.tracers["e"].min()) >= 0.0 and float(a.tracers["eps"].min()) >= 0.0


def _k5_operands(cuda, Ye, Xe, metric2d, masked, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def r(shape, scale, offset=0.0):
        return offset + scale * torch.rand(shape, generator=gen, device=cuda)

    m = (Ye, Xe) if metric2d else (Ye, 1)
    ops = [r((Ye, Xe), 2e-2, -1e-2), r((Ye, Xe), 2.0, -1.0), r((Ye, Xe), 2.0, -1.0),
           r((Ye, Xe), 0.2, 1.6), r((Ye, Xe), 0.2, 1.6), r((Ye, Xe), 2e-4, -1e-4),
           r((Ye, Xe), 2e-4, -1e-4), r(m, 2e4, 1e5), r(m, 2e4, 1e5), r(m, 1e-10, 4e-10)]
    masks = [(r((Ye, Xe), 1.0) > 0.1).float() for _ in range(2)] if masked else [None, None]
    return ops, masks


@pytest.mark.parametrize("metric2d,masked", [(False, False), (False, True), (True, True)],
                         ids=["latlon", "immersed", "tripolar"])
def test_k5_matches_plain_bitwise(cuda, metric2d, masked):
    """K5 (one block of 30 substeps, W = 30) against its plain version: the
    same operations in the same order under -fmad=false, bit for bit."""
    from gb25_tpu_torch.models.free_surface import averaging_weights

    ops, masks = _k5_operands(cuda, 32 + 60, 96 + 60, metric2d, masked, seed=11)
    weights = averaging_weights(30)
    before = pallas_barotropic.BLOCK_KERNEL.launches
    got = pallas_barotropic._barotropic_block_cuda(weights, *ops, *masks)
    torch.cuda.synchronize()
    s = pallas_barotropic.substeps_per_launch()
    assert pallas_barotropic.BLOCK_KERNEL.launches == before + -(-30 // s)
    want = pallas_barotropic.barotropic_block_plain(weights, *ops, *masks)
    for g, w in zip(got, want):
        assert torch.isfinite(w).all()
        assert torch.equal(g, w), float((g - w).abs().max())


def _k5_coupled_operands(cuda, Ye, Xe, metric2d, masked, seed):
    """K5 operands whose substeps couple neighbours strongly (pu au rz ~
    0.15, where a real block's ~1e-3 lets a wrong apron cell fade below a
    float32 ulp within a few cells), so that any cell read from outside a
    tile's exact neighbourhood changes the interior's bits."""
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def r(shape, scale, offset=0.0):
        return offset + scale * torch.rand(shape, generator=gen, device=cuda)

    m = (Ye, Xe) if metric2d else (Ye, 1)
    ops = [r((Ye, Xe), 2e-2, -1e-2), r((Ye, Xe), 2.0, -1.0), r((Ye, Xe), 2.0, -1.0),
           r((Ye, Xe), 0.2, 1.6), r((Ye, Xe), 0.2, 1.6), r((Ye, Xe), 2e-4, -1e-4),
           r((Ye, Xe), 2e-4, -1e-4), r(m, 0.4, 0.8), r(m, 0.4, 0.8), r(m, 0.1, 0.05)]
    masks = [(r((Ye, Xe), 1.0) > 0.1).float() for _ in range(2)] if masked else [None, None]
    return ops, masks


@pytest.mark.parametrize("plane", [(92, 156), (53, 131), (5, 7)],
                         ids=["block", "ragged", "tiny"])
@pytest.mark.parametrize("metric2d,masked", [(False, False), (False, True), (True, True)],
                         ids=["latlon", "immersed", "tripolar"])
@pytest.mark.parametrize("n", ["1", "2", "4", "s", "s+1", "30"])
def test_k5_blocks_match_plain_bitwise(cuda, n, metric2d, masked, plane):
    """K5 on blocks of n substeps, s substeps a launch: ceil(n / s) launches
    and every output bit for bit with the plain version on the whole
    extended plane, on planes that the tile does not divide and on a plane
    smaller than one tile with its apron."""
    from gb25_tpu_torch.models.free_surface import averaging_weights

    s = pallas_barotropic.substeps_per_launch()
    n = {"s": s, "s+1": s + 1}.get(n) or int(n)
    ops, masks = _k5_coupled_operands(cuda, *plane, metric2d, masked, seed=n + plane[1])
    weights = averaging_weights(30)[:n]
    before = pallas_barotropic.BLOCK_KERNEL.launches
    got = pallas_barotropic._barotropic_block_cuda(weights, *ops, *masks)
    torch.cuda.synchronize()
    assert pallas_barotropic.BLOCK_KERNEL.launches == before + -(-n // s)
    want = pallas_barotropic.barotropic_block_plain(weights, *ops, *masks)
    for g, w in zip(got, want):
        assert torch.isfinite(w).all()
        assert torch.equal(g, w), float((g - w).abs().max())


def test_k1_without_wall_row_matches_plain(cuda):
    """K1 on a tile that is not south-most (wall_v=0): row 0 of v*, Gv and
    the v* integral is an interior row, and matches the plain version."""
    cfg, grid, state = baroclinic_instability_model(128, 32, 8, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    ue = extend_field(grid, state.u, "u")
    ve = extend_field(grid, 1e-3 + state.v, "v")
    tr_e = {k: extend_field(grid, c, "c") for k, c in state.tracers.items()}
    prev = (torch.zeros(grid.shape, device=cuda),
            1e-7 * torch.randn(grid.shape, generator=gen, device=cuda),
            {k: torch.zeros(grid.shape, device=cuda) for k in tr_e})
    ab = (96.0, -36.0)
    got = pallas_zslab.zslab_tendencies(cfg, grid, ue, ve, tr_e, prev, ab, wall_v=False)
    want = pallas_zslab.zslab_tendencies_plain(cfg, grid, ue, ve, tr_e, prev, ab, wall_v=False)
    torch.cuda.synchronize()
    _close(got[1], want[1], 2e-4, 1e-9)
    _close(got[4], want[4], 2e-4, ab[0] * 2e-4 * float(want[1].abs().max()))
    _close(got[6][3], want[6][3], 2e-4, 2e-4 * float(want[6][3].abs().max()) + 1e-6)
    assert float(got[4][:, 0, :].abs().min()) > 0.0 and float(got[6][3][0].abs().min()) > 0.0


@pytest.mark.parametrize("mode", ["local", "ring"])
def test_decomposed_1x1_step_matches_plain(cuda, mode):
    """One step of the decomposed 1x1 flagship (W = 30: one K5 block)
    against the plain path on the same route; "ring" equals "local" bit for
    bit (every exchange of a 1x1 ring is a copy of the tile's own strips)."""
    from gb25_tpu_torch.models.config import SplitExplicitFreeSurface
    from gb25_tpu_torch.parallel import make_mesh, sharded_step_fn

    cfg, grid, state = baroclinic_instability_model(128, 32, 8, device=cuda)
    cfg = dataclasses.replace(cfg, free_surface=SplitExplicitFreeSurface(exchange_width=30))
    mesh = make_mesh()
    before = pallas_barotropic.BLOCK_KERNEL.launches, pallas_barotropic.KERNEL.launches
    a = sharded_step_fn(cfg, grid, mesh, force_comm=mode)(state, 60.0)
    torch.cuda.synchronize()
    assert (pallas_barotropic.BLOCK_KERNEL.launches - before[0],
            pallas_barotropic.KERNEL.launches - before[1]) == (
                pallas_barotropic.step_launches(30, 30), 0)
    plain = dataclasses.replace(cfg, kernels="torch")
    b = sharded_step_fn(plain, grid, mesh, force_comm=mode)(state, 60.0)
    for x, y in ((a.u, b.u), (a.v, b.v), (a.eta, b.eta), (a.tracers["T"], b.tracers["T"])):
        _close(x, y, 1e-3, 5e-6)
    c = sharded_step_fn(cfg, grid, mesh, force_comm="local" if mode == "ring" else "ring")(
        state, 60.0)
    for x, y in ((a.u, c.u), (a.v, c.v), (a.eta, c.eta), (a.tracers["T"], c.tracers["T"])):
        assert torch.equal(x, y)


def _k6_operands(cuda, case):
    if case == "flagship":
        cfg, grid, state = baroclinic_instability_model(100, 20, 10, device=cuda)
        ue, ve = extend_field(grid, state.u, "u"), extend_field(grid, state.v, "v")
        tr_e = {k: extend_field(grid, c, "c") for k, c in state.tracers.items()}
        return cfg, grid, ue, ve, tr_e
    if case == "tripolar":
        return _climate_operands(cuda, (128, 64, 8), 12, "gaussian_islands_tripolar")[:5]
    return _keps_operands(cuda, (128, 64, 8), 13)[:5]


@pytest.mark.parametrize("case", ["flagship", "tripolar", "four_tracers"])
def test_k6_matches_plain(cuda, case):
    cfg, grid, ue, ve, tr_e = _k6_operands(cuda, case)
    f_ff = coriolis_ff(grid, cfg.coriolis).to(torch.float32)
    pallas = dataclasses.replace(cfg, kernels="pallas")
    before = pallas_tendency.KERNEL.launches
    got = pallas_tendency.pallas_tendencies(pallas, grid, f_ff, ue, ve, tr_e)
    split = pallas_tendency.pallas_tendencies(pallas, grid, f_ff, ue, ve, tr_e, split=True)
    torch.cuda.synchronize()
    assert pallas_tendency.KERNEL.launches == before + 3
    want = pallas_tendency.pallas_tendencies_plain(cfg, grid, f_ff, ue, ve, tr_e)
    for g, w in zip(got[:2], want[:2]):
        _close(g, w, 2e-4, 1e-9)
    assert list(got[2]) == list(tr_e)
    for k in tr_e:
        _close(got[2][k], want[2][k], 2e-4, 1e-7)
        assert torch.equal(split[2][k], got[2][k])
    assert torch.equal(split[0], got[0]) and torch.equal(split[1], got[1])
    b = pallas_tendency.teos10_kernel(cfg.eos, tr_e["T"], tr_e["S"], grid.z_c)
    _close(b, cfg.eos.buoyancy(tr_e["T"], tr_e["S"], grid.z_c), 1e-6, 0.0)


# The level tiles of K1 and K6 (csrc/tendency_tile.cuh) hold 32 x 8
# columns: these grids leave ragged east and north tiles, a grid narrower
# than one tile row (Ny = 5), rows whose stride is not a multiple of 16
# bytes (Nx = 37: 4-byte copies into shared memory) and a column deeper
# than any the models run (Nz = 400: the march keeps nothing per level).
TILE_CASES = {
    "flagship_100x20x10": ("flagship", (100, 20, 10)),
    "flagship_37x5x6": ("flagship", (37, 5, 6)),
    "flagship_40x8x400": ("flagship", (40, 8, 400)),
    "islands_100x50x6": ("gaussian_islands", (100, 50, 6)),
    "tripolar_100x50x6": ("gaussian_islands_tripolar", (100, 50, 6)),
    "tripolar_37x18x6": ("gaussian_islands_tripolar", (37, 18, 6)),
}


def _tile_operands(cuda, case, shape):
    if case != "flagship":
        return _climate_operands(cuda, shape, 14, case)
    cfg, grid, state = baroclinic_instability_model(*shape, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(15)

    def noise(s):
        return s * torch.randn(grid.shape, generator=gen, device=cuda)

    ue = extend_field(grid, state.u + noise(0.05), "u")
    ve = extend_field(grid, state.v + noise(0.05), "v")
    tr = {"T": state.tracers["T"] + noise(0.1), "S": state.tracers["S"]}
    tr_e = {k: extend_field(grid, c, "c") for k, c in tr.items()}
    be, b_total = pallas_zslab.column_buoyancy(cfg, grid, tr_e)
    return cfg, grid, ue, ve, tr_e, be, b_total, noise


@pytest.mark.parametrize("name", list(TILE_CASES))
def test_k1_tiles_match_plain(cuda, name):
    cfg, grid, ue, ve, tr_e, be, b_total, noise = _tile_operands(cuda, *TILE_CASES[name])
    prev = (noise(1e-7), noise(1e-7), {k: noise(1e-7) for k in tr_e})
    prev[1][:, 0, :] = 0.0
    ab = (96.0, -36.0)
    fb = face_bottom_planes(grid) if grid.immersed else None
    before = pallas_zslab.KERNEL.launches
    got = pallas_zslab.zslab_tendencies(cfg, grid, ue, ve, tr_e, prev, ab,
                                        buoyancy=(be, b_total), face_bottoms=fb)
    torch.cuda.synchronize()
    assert pallas_zslab.KERNEL.launches == before + 1
    want = pallas_zslab.zslab_tendencies_plain(cfg, grid, ue, ve, tr_e, prev, ab, be, fb)
    _close(got[0], want[0], 2e-4, 1e-9)
    _close(got[1], want[1], 2e-4, 1e-9)
    for k in tr_e:
        _close(got[2][k], want[2][k], 2e-4, 1e-7)
        _close(got[5][k], want[5][k], 2e-4, ab[0] * 2e-4 * float(want[2][k].abs().max()))
    for g, w, G in ((got[3], want[3], want[0]), (got[4], want[4], want[1])):
        _close(g, w, 2e-4, ab[0] * 2e-4 * float(G.abs().max()))
    for g, w in zip(got[6], want[6]):
        _close(g, w, 2e-4, 2e-4 * float(w.abs().max()) + 1e-6)
    assert float(got[4][:, 0, :].abs().max()) == 0.0


@pytest.mark.parametrize("name", list(TILE_CASES))
def test_k6_tiles_match_plain_bitwise(cuda, name):
    """K6 and its split pair bit for bit with the plain version: the same
    operations in the same order under -fmad=false."""
    cfg, grid, ue, ve, tr_e = _tile_operands(cuda, *TILE_CASES[name])[:5]
    f_ff = coriolis_ff(grid, cfg.coriolis).to(torch.float32)
    pallas = dataclasses.replace(cfg, kernels="pallas")
    before = pallas_tendency.KERNEL.launches
    got = pallas_tendency.pallas_tendencies(pallas, grid, f_ff, ue, ve, tr_e)
    split = pallas_tendency.pallas_tendencies(pallas, grid, f_ff, ue, ve, tr_e, split=True)
    torch.cuda.synchronize()
    assert pallas_tendency.KERNEL.launches == before + 3
    want = pallas_tendency.pallas_tendencies_plain(cfg, grid, f_ff, ue, ve, tr_e)
    for out in (got, split):
        for g, w in ((out[0], want[0]), (out[1], want[1]),
                     *((out[2][k], want[2][k]) for k in tr_e)):
            assert torch.isfinite(w).all()
            assert torch.equal(g, w), float((g - w).abs().max())


def _k6_route_k5_launches(cfg, grid):
    """K5's launches in one K6-route step: ceil(n / s) for each block."""
    from gb25_tpu_torch.models.free_surface import exchange_width

    fs = cfg.free_surface
    return pallas_barotropic.step_launches(fs.substeps, exchange_width(fs, grid))


def _k6_route_counts():
    return [k.launches for k in (pallas_tendency.KERNEL, pallas_barotropic.BLOCK_KERNEL,
                                 pallas_zslab.KERNEL, pallas_barotropic.KERNEL,
                                 pallas_tridiag.KERNEL, pallas_catke.KERNEL)]


def test_k6_route_step_matches_plain_step(cuda):
    cfg, grid, state = baroclinic_instability_model(128, 32, 8, device=cuda, kernels="pallas")
    before = _k6_route_counts()
    a = time_step(cfg, grid, state, 60.0)
    torch.cuda.synchronize()
    k5 = _k6_route_k5_launches(cfg, grid)
    assert [x - y for x, y in zip(_k6_route_counts(), before)] == [1, k5, 0, 0, 0, 0]
    b = time_step(dataclasses.replace(cfg, kernels="torch"), grid, state, 60.0)
    for x, y in ((a.u, b.u), (a.v, b.v), (a.eta, b.eta), (a.tracers["T"], b.tracers["T"]),
                 (a.tracers["S"], b.tracers["S"])):
        _close(x, y, 1e-3, 5e-6)


def test_k6_route_coupled_step_matches_plain_step(cuda):
    ccfg, grid, atmos, state = data_free_ocean_climate_model(
        resolution=3.0, Nz=8, device=cuda, grid_type="gaussian_islands_tripolar",
        kernels="pallas")
    before = _k6_route_counts()
    a = coupled_time_step(ccfg, grid, atmos, state, 60.0)
    torch.cuda.synchronize()
    k5 = _k6_route_k5_launches(ccfg.ocean, grid)
    assert [x - y for x, y in zip(_k6_route_counts(), before)] == [1, k5, 0, 0, 3, 1]
    plain = dataclasses.replace(ccfg, ocean=dataclasses.replace(ccfg.ocean, kernels="torch"))
    b = coupled_time_step(plain, grid, atmos, state, 60.0)
    for x, y in ((a.u, b.u), (a.v, b.v), (a.eta, b.eta), *zip(a.tracers.values(),
                                                           b.tracers.values())):
        _close(x, y, 1e-3, 5e-6)


def _looped_model(cuda, name):
    """(run_n, step, grid, state) of one serial path at 128x64x8: the loop
    a user calls and the step it repeats."""
    if name == "shallow_water":
        cfg, grid, state = shallow_water_model(128, 64, device=cuda)
        return (lambda s, n: sw_loop(cfg, grid, s, 60.0, n),
                lambda s: sw_time_step(cfg, grid, s, 60.0), grid, state)
    if name in ("climate", "tripolar"):
        grid_type = "gaussian_islands" if name == "climate" else "gaussian_islands_tripolar"
        ccfg, grid, atmos, state = data_free_ocean_climate_model(resolution=3.0, Nz=8, device=cuda,
                                                                 grid_type=grid_type)
        return (lambda s, n: coupled_loop(ccfg, grid, atmos, s, 60.0, n),
                lambda s: coupled_time_step(ccfg, grid, atmos, s, 60.0, premasked=True), grid,
                state)
    if name.startswith("forced_"):
        return _forced_1x1_model(cuda, *name.split("_")[1:])
    if name in SCHEME_ROWS:
        cfg, grid, state = _scheme_row_model(cuda, name, (128, 64, 8))
        return (lambda s, n: loop(cfg, grid, s, 60.0, n),
                lambda s: time_step(cfg, grid, s, 60.0, premasked=True), grid, state)
    kw = {"flagship": {}, "flagship_k6_route": {"kernels": "pallas"},
          "keps": {"closure": TKEDissipationVerticalDiffusivity()},
          "vertical_scalar": {"closure": VerticalScalarDiffusivity()},
          "explicit": {"free_surface": ExplicitFreeSurface()}}.get(name, {})
    cfg, grid, state = baroclinic_instability_model(128, 64, 8, device=cuda, **kw)
    if name in ("bf16s", "bfloat16", "f32x2", "float32", "bf16x2"):
        cfg = dataclasses.replace(cfg, compute_dtype=name)
    if name == "float64_k6_route":
        cfg = dataclasses.replace(cfg, kernels="pallas", compute_dtype="float64")
    return (lambda s, n: loop(cfg, grid, s, 60.0, n),
            lambda s: time_step(cfg, grid, s, 60.0, premasked=True), grid, state)


def _forced_1x1_model(cuda, model, mode):
    """(run_n, step, tile grid, state) of the flagship or the tripolar
    climate forced onto a 1x1 mesh at W = 30, "local" or "ring": one
    ``sharded_*_step_fn``, whose tile grid keeps the graph."""
    from gb25_tpu_torch.models.config import SplitExplicitFreeSurface
    from gb25_tpu_torch.parallel import make_mesh, sharded_coupled_step_fn, sharded_step_fn

    fs = SplitExplicitFreeSurface(exchange_width=30)
    if model == "flagship":
        cfg, grid, state = baroclinic_instability_model(128, 64, 8, device=cuda)
        cfg = dataclasses.replace(cfg, free_surface=fs)
        fn = sharded_step_fn(cfg, grid, make_mesh(), force_comm=mode)
    else:
        ccfg, grid, atmos, state = data_free_ocean_climate_model(
            resolution=3.0, Nz=8, device=cuda, grid_type="gaussian_islands_tripolar")
        ccfg = dataclasses.replace(ccfg, ocean=dataclasses.replace(ccfg.ocean, free_surface=fs))
        fn = sharded_coupled_step_fn(ccfg, grid, atmos, make_mesh(), force_comm=mode)
    return lambda s, n: fn(s, 60.0, n), functools.partial(fn.step, dt=60.0), fn.grid, state


@pytest.mark.parametrize("name", ["flagship", "flagship_k6_route", "keps", "climate", "tripolar",
                                  "shallow_water", "bf16s", "bfloat16", "f32x2", "float32",
                                  "vertical_scalar", "explicit", "forced_flagship_local",
                                  "forced_flagship_ring", "forced_tripolar_local",
                                  "forced_tripolar_ring", "oracle_schemes", "b_tracer",
                                  "oracle_schemes_k6", "bf16x2", "float64_k6_route"])
def test_device_loop_matches_host_loop_bitwise(cuda, name):
    """A call from iteration 0 (the Euler step eager, a capture, 2 replays,
    3 steps left over), then a call that replays the kept graph twice,
    against the same steps launched from the host (the immersed mask
    applied at the start of each call, as the loops do)."""
    run_n, step, grid, state = _looped_model(cuda, name)
    k = device_loop.BLOCK_STEPS
    device_loop.STATS.reset()
    a = run_n(state, 1 + 2 * k + 3)
    b = run_n(a, 2 * k)
    torch.cuda.synchronize()
    stats = device_loop.STATS
    assert (stats.captures, stats.replays, stats.eager_steps) == (1, 4, 4)
    want_a = device_loop.host_loop(step, premask_state(grid, state), 1 + 2 * k + 3)
    want_b = device_loop.host_loop(step, premask_state(grid, want_a), 2 * k)
    for got, want in ((a, want_a), (b, want_b)):
        assert got.iteration == want.iteration
        tg, tw = device_loop._tensors(got), device_loop._tensors(want)
        assert list(tg) == list(tw)
        for field in tg:
            assert torch.equal(tg[field], tw[field]), field


def _host_read_step(cfg, grid, s):
    float(s.h.sum())  # a host read: refused while a stream captures
    return sw_time_step(cfg, grid, s, 60.0)


def test_failed_capture_raises(cuda):
    """No quiet fallback: a step that reads the device from the host cannot
    be captured, and the loop raises."""
    cfg, grid, state = shallow_water_model(64, 32, device=cuda)
    with pytest.raises(RuntimeError):
        device_loop.device_loop(functools.partial(_host_read_step, cfg, grid), state,
                                device_loop.BLOCK_STEPS + 1, grid.cache)
    torch.cuda.synchronize()


def test_device_loop_counts_replayed_launches(cuda):
    """The loop's tally of launches on the device: the wrappers count the
    eager steps and the steps a capture recorded, and each replay adds what
    its graph recorded, so K1 and K2 show one launch for each of the n
    steps, of which the wrappers saw the eager and the recorded ones."""
    cfg, grid, state = baroclinic_instability_model(128, 64, 8, device=cuda)
    kernels = (pallas_zslab.KERNEL, pallas_barotropic.KERNEL)
    k = device_loop.BLOCK_STEPS
    for kernel in kernels:
        kernel.launches = 0
    device_loop.STATS.reset()
    loop(cfg, grid, state, 60.0, 1 + 2 * k + 3)
    stats = device_loop.STATS
    assert (stats.eager_steps, stats.captured_steps, stats.replays) == (4, k, 2)
    for kernel in kernels:
        assert kernel.launches == 4 + k
        assert stats.recorded_launches[kernel] == k
        assert stats.replayed_launches[kernel] == 2 * k
        assert stats.launches(kernel) == 1 + 2 * k + 3


@pytest.mark.parametrize("shape", [(128, 32, 8), (100, 20, 10), (37, 5, 6)])
@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_k1_unfused_matches_plain(cuda, storage, shape):
    """K1's unfused instances against their plain versions at K1's
    tolerances; 100 + 8 and 37 + 8 columns are not multiples of 8, so the
    bfloat16 instance stages those value by value."""
    cfg, grid, ue, ve, tr_e, be, b_total, _ = _tile_operands(cuda, "flagship", shape)
    st = torch.bfloat16 if storage == "bf16" else None
    before = pallas_zslab.KERNEL.launches
    got = pallas_zslab.zslab_tendencies(cfg, grid, ue, ve, tr_e, buoyancy=(be, b_total),
                                        storage=st)
    torch.cuda.synchronize()
    assert pallas_zslab.KERNEL.launches == before + 1
    want = pallas_zslab.zslab_tendencies_plain(cfg, grid, ue, ve, tr_e, be=be, storage=st)
    _close(got[0], want[0], 2e-4, 1e-9)
    _close(got[1], want[1], 2e-4, 1e-9)
    for k in tr_e:
        _close(got[2][k], want[2][k], 2e-4, 1e-7)
    assert float(got[1][:, 0, :].abs().max()) == 0.0
    if st is None:
        return

    def rt(x):
        return x.to(torch.bfloat16).float()

    pre = pallas_zslab.zslab_tendencies(cfg, grid, rt(ue), rt(ve),
                                        {k: rt(c) for k, c in tr_e.items()}, storage=st)
    f32 = pallas_zslab.zslab_tendencies(cfg, grid, ue, ve, tr_e, buoyancy=(be, b_total))
    flat = [(got[0], pre[0], f32[0]), (got[1], pre[1], f32[1]),
            *((got[2][k], pre[2][k], f32[2][k]) for k in tr_e)]
    assert all(torch.equal(a, b) for a, b, _ in flat)
    assert max(float((a - c).abs().max()) for a, _, c in flat) > 0.0


def test_k1_unfused_climate_instance_matches_plain(cuda):
    """The climate's three tracers (T, S, e) on the islands grid, which the
    unfused instances once refused: one launch of the lat-lon instance (the
    unfused form has no immersed variant), at K1's tolerances."""
    ccfg, grid, atmos, state = data_free_ocean_climate_model(resolution=3.0, Nz=8, device=cuda)
    ue = extend_field(grid, state.u, "u")
    ve = extend_field(grid, state.v, "v")
    tr_e = {k: extend_field(grid, c, "c") for k, c in state.tracers.items()}
    _check_k1_unfused(ccfg.ocean, grid, ue, ve, tr_e, None)


@pytest.mark.parametrize("Nx", [31, 96, 100])
@pytest.mark.parametrize("Nz", [1, 7, 64, 128])
def test_k3_constant_kappa_matches_plain_bitwise(cuda, Nz, Nx):
    """The constant-kappa pair bit for bit with the plain version on the
    same float, and with the field instance on a field of that value."""
    gen = torch.Generator(device=cuda).manual_seed(Nz * 1000 + Nx)
    shape = (Nz, 6, Nx)
    fields = tuple(torch.randn(shape, generator=gen, device=cuda) for _ in range(2))
    dz = torch.linspace(10.0, 200.0, Nz, device=cuda).reshape(-1, 1, 1)
    a_lam, a_mu = pallas_tridiag.vertical_coefficients(600.0, dz, dz)
    before = pallas_tridiag.KERNEL.launches
    got = pallas_tridiag.implicit_kernel(fields, 1e-4, 600.0, a_lam, a_mu)
    torch.cuda.synchronize()
    assert pallas_tridiag.KERNEL.launches == before + 1
    want = pallas_tridiag.implicit_diffusion_plain(fields, 1e-4, 600.0, a_lam, a_mu)
    field = pallas_tridiag.implicit_kernel(fields, torch.full(shape, 1e-4, device=cuda), 600.0,
                                           a_lam, a_mu)
    for g, w, f in zip(got, want, field):
        assert torch.equal(g, w), float((g - w).abs().max())
        assert torch.equal(g, f)
    with pytest.raises(ValueError, match="undamped pair"):
        pallas_tridiag.implicit_kernel(fields[:1], 1e-4, 600.0, a_lam, a_mu)


NEW_ROUTES = {  # the model's keywords, its compute_dtype, launches of K1, K2, K3 a step
    "bf16s": ({}, "bf16s", [1, 1, 0]),
    "float32": ({}, "float32", [1, 1, 0]),
    "explicit": ({"free_surface": ExplicitFreeSurface()}, None, [1, 0, 0]),
    "vertical_scalar": ({"closure": VerticalScalarDiffusivity()}, None, [1, 1, 2]),
}


@pytest.mark.parametrize("name", list(NEW_ROUTES))
def test_new_route_step_matches_plain_step(cuda, name):
    kw, mode, launches = NEW_ROUTES[name]
    cfg, grid, state = baroclinic_instability_model(128, 32, 8, device=cuda, **kw)
    cfg = dataclasses.replace(cfg, compute_dtype=mode)
    kernels = (pallas_zslab.KERNEL, pallas_barotropic.KERNEL, pallas_tridiag.KERNEL)
    before = [k.launches for k in kernels]
    a = time_step(cfg, grid, state, 60.0)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == launches
    b = time_step(dataclasses.replace(cfg, kernels="torch"), grid, state, 60.0)
    for x, y in ((a.u, b.u), (a.v, b.v), (a.eta, b.eta), (a.Geta, b.Geta),
                 (a.tracers["T"], b.tracers["T"]), (a.tracers["S"], b.tracers["S"])):
        _close(x, y, 1e-3, 5e-6)


def test_bfloat16_compute_tracks_f32_on_card(cuda):
    """tests/test_precision.py::test_bf16_compute_tracks_f32 on the card:
    10 steps at 32x16x6 with compute_dtype="bfloat16" against float32,
    u within 0.15 of max|u|, T within 0.3 (the array path's z scans sum in
    float32 on the card as on the CPU, ``operators.cumsum_z``)."""
    cfg32, grid, state = baroclinic_instability_model(32, 16, 6, device=cuda)
    s32 = loop(cfg32, grid, state, 60.0, 10)
    s16 = loop(dataclasses.replace(cfg32, compute_dtype="bfloat16"), grid, state, 60.0, 10)
    du = float((s16.u - s32.u).abs().max())
    assert du < 0.15 * max(float(s32.u.abs().max()), 1e-6)
    assert float((s16.tracers["T"] - s32.tracers["T"]).abs().max()) < 0.3


TILE_ROUTES = {  # the model's keywords and compute_dtype; launches of K1, K2, K3, K5, K6 a step
    "k6_route": ({"kernels": "pallas"}, None, [0, 0, 0, "K5", 1]),
    "bf16s": ({}, "bf16s", [1, 0, 0, "K5", 0]),
    "float32": ({}, "float32", [1, 0, 0, "K5", 0]),
    "vertical_scalar": ({"closure": VerticalScalarDiffusivity()}, None, [1, 0, 2, "K5", 0]),
    "explicit": ({"free_surface": ExplicitFreeSurface()}, None, [1, 0, 0, 0, 0]),
}


@pytest.mark.parametrize("mode", ["local", "ring"])
@pytest.mark.parametrize("name", list(TILE_ROUTES))
def test_tile_route_step_matches_plain_step(cuda, name, mode):
    """One step of each route on a forced 1x1 tile (W = 30 where the
    split-explicit free surface runs: one block of K5 launches), after 8
    steps, against the "torch" step on the same tile, with its launches."""
    from gb25_tpu_torch.models.config import SplitExplicitFreeSurface
    from gb25_tpu_torch.parallel import make_mesh, sharded_step_fn

    kw, compute_dtype, launches = TILE_ROUTES[name]
    cfg, grid, state = baroclinic_instability_model(128, 32, 8, device=cuda, **kw)
    cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    if name != "explicit":
        cfg = dataclasses.replace(cfg, free_surface=SplitExplicitFreeSurface(exchange_width=30))
    launches = [pallas_barotropic.step_launches(30, 30) if n == "K5" else n for n in launches]
    kernels = (pallas_zslab.KERNEL, pallas_barotropic.KERNEL, pallas_tridiag.KERNEL,
               pallas_barotropic.BLOCK_KERNEL, pallas_tendency.KERNEL)
    fn = sharded_step_fn(cfg, grid, make_mesh(), force_comm=mode)
    state = fn(state, 60.0, 8)  # from rest Gu is too small for the atol
    before = [k.launches for k in kernels]
    a = fn(state, 60.0)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == launches
    plain = dataclasses.replace(cfg, kernels="torch")
    b = sharded_step_fn(plain, grid, make_mesh(), force_comm=mode)(state, 60.0)
    _step_close(cfg, grid, state, a, b, route=name == "k6_route")


def _step_close(cfg, grid, state, a, b, route=False):
    """The steps ``a`` (kernels) and ``b`` ("torch") from ``state``: u, v,
    eta, the tracers and every G at chip_smoke's step tolerances, rtol 1e-3
    and an atol of 1e-3 of each field's largest value, at most 5e-6, so that
    each G is held to its own scale. Gu and Gv at least 8 float32 ulps of
    the largest column total of b dz over the smallest face spacing: K1, K6
    and their plain versions sum the pressure in other orders
    (chip_smoke.pressure_ulp_atol's bound, as one number). ``route`` (K6
    against the "torch" route's K1 and K2): u, v and eta at 1e-3 of their
    largest value, as chip_smoke.route_step_compare holds them."""
    hz, Nz = grid.hz, grid.Nz
    buoy = (state.tracers["b"] if "b" in state.tracers else
            cfg.eos.buoyancy(state.tracers["T"], state.tracers["S"], grid.z_c[hz : hz + Nz]))
    p = float((buoy * grid.dz_c[hz : hz + Nz]).sum(dim=0).abs().max())
    spacing = float(torch.minimum(grid.dxc.min(), grid.dyf.min()))
    floor = {"Gu": 8 * torch.finfo(torch.float32).eps * p / spacing}
    floor["Gv"] = floor["Gu"]

    def fields(s):
        return {"u": s.u, "v": s.v, "eta": s.eta, **s.tracers, "Gu": s.Gu, "Gv": s.Gv,
                "Geta": s.Geta, **{"G" + k: g for k, g in s.Gtracers.items()}}

    fa, fb = fields(a), fields(b)
    for name, y in fb.items():
        largest = float(y.abs().max())
        atol = min(5e-6, 1e-3 * largest)
        if route and name in ("u", "v", "eta"):
            atol = 1e-3 * largest
        torch.testing.assert_close(fa[name], y, rtol=1e-3, atol=max(atol, floor.get(name, 0.0)),
                                   msg=lambda m, name=name: f"{name}: {m}")


@pytest.mark.parametrize("mode", ["float32", "bf16s"])
def test_float32_operand_modes_on_a_float64_state_launch_k1(cuda, mode):
    """"float32" and "bf16s" on a float64 state: K1's unfused instance runs
    on the float32 copies of the fields and the grid (one launch, as the
    JAX package's kernel gate sees its cast operands), the free surface
    takes K2's plain version (a float64 state); after 8 steps, one step
    against the "torch" step of the same mode."""
    cfg, grid, _ = baroclinic_instability_model(128, 64, 8, device=cuda, dtype=torch.float64)
    _, _, state = baroclinic_instability_model(128, 64, 8, device="cpu", dtype=torch.float64)
    state = state.replace(**{f.name: _to(getattr(state, f.name), cuda)
                             for f in dataclasses.fields(state) if f.name != "iteration"})
    cfg = dataclasses.replace(cfg, compute_dtype=mode)
    state = loop(cfg, grid, state, 60.0, 8)  # from rest Gu is too small for the atol
    kernels = list(_all_kernels())
    before = [k.launches for k in kernels]
    a = time_step(cfg, grid, state, 60.0)
    torch.cuda.synchronize()
    made = {k.source: k.launches - n for k, n in zip(kernels, before) if k.launches != n}
    assert made == {pallas_zslab.KERNEL.source: 1}
    assert a.u.dtype == torch.float64
    _step_close(cfg, grid, state, a,
                time_step(dataclasses.replace(cfg, kernels="torch"), grid, state, 60.0))


# --------------------------------------------------------------------------
# the JAX package's other schemes, the linear equation of state and the b
# tracer: K1's and K6's general instances
# --------------------------------------------------------------------------

SCHEME_COMBOS = {f"{mom}-{ke}-{tr}": (mom, ke, tr)
                 for mom, ke in (("weno_vector_invariant", "hollingsworth"),
                                 ("weno_vector_invariant", "standard"),
                                 ("vector_invariant", "hollingsworth"),
                                 ("vector_invariant", "standard"), ("none", "hollingsworth"))
                 for tr in ("weno5", "centered2", "upwind1", "none")}
GENERAL_COMBOS = [c for c in SCHEME_COMBOS
                  if c != "weno_vector_invariant-hollingsworth-weno5"]
GEOMETRIES = {"flat": "flagship", "immersed": "gaussian_islands",
              "tripolar": "gaussian_islands_tripolar"}
# the rows of chip_smoke [36]: the oracle's schemes with the linear equation
# of state on the K1 route and the K6 route, and the b-tracer flagship
SCHEME_ROWS = ("oracle_schemes", "b_tracer", "oracle_schemes_k6")


def _schemes(cfg, combo, eos=None):
    mom, ke, tr = SCHEME_COMBOS[combo]
    return dataclasses.replace(cfg, momentum_advection=mom, ke_scheme=ke, tracer_advection=tr,
                               eos=eos or cfg.eos)


def _b_operands(cfg, grid, tr_e, keep=()):
    """The b-tracer operands: b, the linear buoyancy of the extended T and
    S, first, then the tracers ``keep``; its column total."""
    b = LinearEquationOfState().buoyancy(tr_e["T"], tr_e["S"], None).contiguous()
    tr_b = {"b": b, **{k: tr_e[k] for k in keep}}
    # b alone: without the closure, whose tracers it would need
    cfg = dataclasses.replace(cfg, tracers=("b", *keep), closure=cfg.closure if keep else None)
    be, b_total = pallas_zslab.column_buoyancy(cfg, grid, tr_b)
    assert be is b
    return cfg, tr_b, be, b_total


def _general_operands(cuda, geometry, btracer=False):
    cfg, grid, ue, ve, tr_e, be, b_total, noise = _tile_operands(
        cuda, GEOMETRIES[geometry], (128, 64, 8))
    if btracer:
        cfg, tr_e, be, b_total = _b_operands(cfg, grid, tr_e)
    return cfg, grid, ue, ve, tr_e, be, b_total, noise


def _check_k1_fused(cfg, grid, ue, ve, tr_e, be, b_total, noise, general=True, own=False):
    """One launch of a fused K1 instance against its plain version at K1's
    tolerances; ``own``: the instance that makes b (handed none), against
    the plain version that sums the column totals in its order."""
    prev = (noise(1e-7), noise(1e-7), {k: noise(1e-7) for k in tr_e})
    prev[1][:, 0, :] = 0.0
    ab = (96.0, -36.0)
    fb = face_bottom_planes(grid) if grid.immersed else None
    before = pallas_zslab.KERNEL.launches
    got = pallas_zslab.zslab_tendencies(cfg, grid, ue, ve, tr_e, prev, ab,
                                        buoyancy=None if own else (be, b_total), face_bottoms=fb)
    torch.cuda.synchronize()
    assert pallas_zslab.KERNEL.launches == before + 1
    want = pallas_zslab.zslab_tendencies_plain(cfg, grid, ue, ve, tr_e, prev, ab, be, fb,
                                               sequential=own)
    _close(got[0], want[0], 2e-4, 1e-9)
    _close(got[1], want[1], 2e-4, 1e-9)
    for k in tr_e:
        _close(got[2][k], want[2][k], 2e-4, 1e-7)
        # 4 float32 ulps of the largest |dt c2 G_prev|: the update's own
        # rounding, where x* cancels to near 0 and G is 0 ("none")
        sum_ulps = 4 * torch.finfo(torch.float32).eps * abs(ab[1]) * float(prev[2][k].abs().max())
        _close(got[5][k], want[5][k], 2e-4,
               ab[0] * 2e-4 * float(want[2][k].abs().max()) + sum_ulps)
        if cfg.tracer_advection == "none":
            assert not got[2][k].any()
    for g, w, G in ((got[3], want[3], want[0]), (got[4], want[4], want[1])):
        _close(g, w, 2e-4, ab[0] * 2e-4 * float(G.abs().max()))
    for g, w in zip(got[6], want[6]):
        _close(g, w, 2e-4, 2e-4 * float(w.abs().max()) + 1e-6)
    assert float(got[4][:, 0, :].abs().max()) == 0.0
    info = pallas_zslab.kernel_info(len(tr_e), grid.immersed, grid.north_fold, general=general,
                                    own=own)
    assert info["registers"] > 0 and info["blocks_per_sm"] >= 1


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("combo", GENERAL_COMBOS)
def test_k1_general_matches_plain(cuda, combo, geometry):
    """K1's general fused instances (2, 3 tracers: flat, immersed,
    tripolar) at K1's tolerances, every scheme combination."""
    cfg, grid, ue, ve, tr_e, be, b_total, noise = _general_operands(cuda, geometry)
    _check_k1_fused(_schemes(cfg, combo), grid, ue, ve, tr_e, be, b_total, noise)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_k1_one_tracer_matches_plain(cuda, geometry):
    cfg, grid, ue, ve, tr_e, be, b_total, noise = _general_operands(cuda, geometry, True)
    assert list(tr_e) == ["b"]
    _check_k1_fused(cfg, grid, ue, ve, tr_e, be, b_total, noise)


def test_k1_four_tracers_general_matches_plain(cuda):
    cfg, grid, ue, ve, tr_e, be, b_total, noise = _keps_operands(cuda, (128, 64, 8), 13)
    _check_k1_fused(_schemes(cfg, "vector_invariant-standard-centered2"), grid, ue, ve, tr_e,
                    be, b_total, noise)


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("combo", [*GENERAL_COMBOS, "b_tracer"])
def test_k1_general_unfused_matches_plain(cuda, combo, storage):
    """K1's general unfused instances (float32 and bfloat16 storage) at
    K1's tolerances: every scheme combination with two tracers, and the
    one-tracer b instance."""
    cfg, grid, ue, ve, tr_e, _, _, _ = _general_operands(cuda, "flat", combo == "b_tracer")
    if combo != "b_tracer":
        cfg = _schemes(cfg, combo)
    _check_k1_unfused(cfg, grid, ue, ve, tr_e, torch.bfloat16 if storage == "bf16" else None,
                      general=True)


def test_k1_unfused_general_three_tracers_matches_plain(cuda):
    """A general unfused instance with three tracers on the islands grid,
    which the unfused instances once refused, at K1's tolerances."""
    cfg, grid, ue, ve, tr_e, be, b_total, _ = _general_operands(cuda, "immersed")
    _check_k1_unfused(_schemes(cfg, "none-hollingsworth-upwind1"), grid, ue, ve, tr_e, None)


def _check_k6_bitwise(cfg, grid, ue, ve, tr_e):
    f_ff = coriolis_ff(grid, cfg.coriolis).to(torch.float32)
    pallas = dataclasses.replace(cfg, kernels="pallas")
    before = pallas_tendency.KERNEL.launches
    got = pallas_tendency.pallas_tendencies(pallas, grid, f_ff, ue, ve, tr_e)
    split = pallas_tendency.pallas_tendencies(pallas, grid, f_ff, ue, ve, tr_e, split=True)
    torch.cuda.synchronize()
    assert pallas_tendency.KERNEL.launches == before + 3
    want = pallas_tendency.pallas_tendencies_plain(cfg, grid, f_ff, ue, ve, tr_e)
    for out in (got, split):
        assert list(out[2]) == list(tr_e)
        for g, w in ((out[0], want[0]), (out[1], want[1]),
                     *((out[2][k], want[2][k]) for k in tr_e)):
            assert torch.isfinite(w).all()
            assert torch.equal(g, w), float((g - w).abs().max())


@pytest.mark.parametrize("combo", GENERAL_COMBOS)
def test_k6_general_matches_plain_bitwise(cuda, combo):
    """K6's general instances under TEOS-10, single and split, bit for bit
    with the plain version, every scheme combination."""
    cfg, grid, ue, ve, tr_e = _general_operands(cuda, "flat")[:5]
    _check_k6_bitwise(_schemes(cfg, combo), grid, ue, ve, tr_e)


@pytest.mark.parametrize("case", ["linear", "b_tracer", "linear_tripolar", "b_e_tripolar",
                                  "b_e_eps"])
def test_k6_eos_modes_match_plain_bitwise(cuda, case):
    """K6's buoyancy modes: the linear equation of state (the oracle's
    schemes; on the tripolar grid's three tracers) and the b tracer (one
    tracer; with e on the tripolar grid; with e and eps), single and split
    (the split momentum launch stages b alone), bit for bit."""
    linear = LinearEquationOfState()
    if case == "b_e_eps":
        cfg, grid, ue, ve, tr_e = _keps_operands(cuda, (128, 64, 8), 13)[:5]
        cfg, tr_e, _, _ = _b_operands(cfg, grid, tr_e, keep=("e", "eps"))
    else:
        geometry = "tripolar" if case.endswith("tripolar") else "flat"
        cfg, grid, ue, ve, tr_e = _general_operands(cuda, geometry)[:5]
        if case.startswith("b"):
            cfg, tr_e, _, _ = _b_operands(cfg, grid, tr_e,
                                          keep=("e",) if case == "b_e_tripolar" else ())
    if case.startswith("linear"):
        cfg = _schemes(cfg, "vector_invariant-standard-centered2", linear)
    _check_k6_bitwise(cfg, grid, ue, ve, tr_e)


def _scheme_row_model(cuda, name, shape):
    """The config, grid and state of one of chip_smoke [36]'s rows."""
    if name == "b_tracer":
        cfg, grid, state = baroclinic_instability_model(*shape, device=cuda)
        cfg = dataclasses.replace(cfg, tracers=("b",))
        return cfg, grid, buoyancy_tracer_state(state, grid)
    kernels = "pallas" if name == "oracle_schemes_k6" else "auto"
    cfg, grid, state = baroclinic_instability_model(
        *shape, device=cuda, kernels=kernels, momentum_advection="vector_invariant",
        tracer_advection="centered2", eos=LinearEquationOfState())
    return dataclasses.replace(cfg, ke_scheme="standard"), grid, state


SCHEME_ROUTES = {  # launches of K1, K2, K6 and K5 a step ("K5": the blocked solve's)
    "oracle_schemes": [1, 1, 0, 0],
    "b_tracer": [1, 1, 0, 0],
    "oracle_schemes_k6": [0, 0, 1, "K5"],
    "b_tracer_explicit": [1, 0, 0, 0],
    "b_catke": [1, 1, 0, 0],
}


@pytest.mark.parametrize("name", list(SCHEME_ROUTES))
def test_scheme_route_step_matches_plain_step(cuda, name):
    """One step of each new route after 8 steps, against the "torch" step,
    with one K1 (or K6) launch: the rows of chip_smoke [36], the b tracer
    under the explicit free surface (K1's unfused one-tracer instance) and
    ("b", "e") with CATKE."""
    if name in SCHEME_ROWS:
        cfg, grid, state = _scheme_row_model(cuda, name, (128, 32, 8))
    else:
        kw = ({"free_surface": ExplicitFreeSurface()} if name == "b_tracer_explicit"
              else {"closure": CATKEVerticalDiffusivity()})
        cfg, grid, state = baroclinic_instability_model(128, 32, 8, device=cuda, **kw)
        cfg = dataclasses.replace(cfg, tracers=("b", *cfg.tracers[2:]))
        state = buoyancy_tracer_state(state, grid)
    dt = 5.0 if name == "b_tracer_explicit" else 60.0
    launches = [_k6_route_k5_launches(cfg, grid) if n == "K5" else n
                for n in SCHEME_ROUTES[name]]
    state = loop(cfg, grid, state, dt, 8)  # from rest Gu is too small for the atol
    kernels = (pallas_zslab.KERNEL, pallas_barotropic.KERNEL, pallas_tendency.KERNEL,
               pallas_barotropic.BLOCK_KERNEL)
    before = [k.launches for k in kernels]
    a = time_step(cfg, grid, state, dt)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == launches
    b = time_step(dataclasses.replace(cfg, kernels="torch"), grid, state, dt)
    _step_close(cfg, grid, state, a, b, route=name == "oracle_schemes_k6")


# --------------------------------------------------------------------------
# every compute_dtype on every route and closure: K1's unfused instances for
# three and four tracers and on the tripolar planes, K6's bfloat16 instances
# --------------------------------------------------------------------------

def _check_k1_unfused(cfg, grid, ue, ve, tr_e, storage, general=None, own=False):
    """One launch of K1's unfused form against its plain version at K1's
    tolerances, the wall row of Gv 0; ``general``: the instance's launch
    shape is read too; ``own``: the float32 instance that makes b (against
    the plain version that sums the column totals in its order)."""
    be, b_total = pallas_zslab.column_buoyancy(cfg, grid, tr_e)
    before = pallas_zslab.KERNEL.launches
    got = pallas_zslab.zslab_tendencies(cfg, grid, ue, ve, tr_e,
                                        buoyancy=None if own else (be, b_total), storage=storage)
    torch.cuda.synchronize()
    assert pallas_zslab.KERNEL.launches == before + 1
    want = pallas_zslab.zslab_tendencies_plain(cfg, grid, ue, ve, tr_e, be=be, storage=storage,
                                               sequential=own)
    _close(got[0], want[0], 2e-4, 1e-9)
    _close(got[1], want[1], 2e-4, 1e-9)
    assert list(got[2]) == list(tr_e)
    for k in tr_e:
        _close(got[2][k], want[2][k], 2e-4, 1e-7)
    assert float(got[1][:, 0, :].abs().max()) == 0.0
    if general is not None:
        form = "unfused" if storage is None else "unfused_bf16"
        info = pallas_zslab.kernel_info(len(tr_e), False, grid.north_fold, form, general, own)
        assert info["registers"] > 0 and info["blocks_per_sm"] >= 1


# K1's instances that make b (the default route with no closure): the
# grids (the lat-lon flagship at 64x16x16, the islands and tripolar grids
# at 32x16x16) and where b comes from (TEOS-10 in the compiled flagship
# instance, TEOS-10 with other schemes, the linear equation of state and
# the b tracer in the general ones). The linear equation of state runs the
# general schemes too: the compiled instance is TEOS-10's alone, and a
# compiled and a general instance part by the multiply-adds the compiler
# fuses in their stencils (K1 is built without -fmad=false), so a general
# instance making b is held bit for bit to a general instance reading it.
OWN_B_SOURCES = ("teos10", "general_teos10", "linear", "b_tracer")
OWN_B_CASES = {f"{source}-{geometry}": (geometry, source)
               for geometry in GEOMETRIES for source in OWN_B_SOURCES}


def _sequential_total(grid, be):
    """The column total of b dz summed up from the floor, each product and
    sum rounded on its own: the order of the kernel's own totals."""
    hz, Nz = grid.hz, grid.Nz
    bdz = be[hz : hz + Nz] * grid.dz_c[hz : hz + Nz]
    total = torch.zeros_like(bdz[0])
    for k in range(Nz):
        total = total + bdz[k]
    return total.contiguous()


def _own_b_operands(cuda, geometry, source):
    """The case's config, grid, extended u, v and tracers (T and S, or b),
    the eager float32 b (``column_buoyancy``), its total summed in the
    kernel's order, and the noise maker."""
    case = GEOMETRIES[geometry]
    shape = (64, 16, 16) if case == "flagship" else (32, 16, 16)
    cfg, grid, ue, ve, tr_e, _, _, noise = _tile_operands(cuda, case, shape)
    assert grid.shape == (shape[2], shape[1], shape[0])
    cfg = dataclasses.replace(cfg, closure=None, tracers=("T", "S"))
    tr_e = {k: tr_e[k] for k in ("T", "S")}
    if source == "general_teos10":
        cfg = _schemes(cfg, "vector_invariant-standard-centered2")
    elif source == "linear":
        cfg = dataclasses.replace(_schemes(cfg, "vector_invariant-standard-centered2"),
                                  eos=LinearEquationOfState())
    elif source == "b_tracer":
        cfg, tr_e, _, _ = _b_operands(cfg, grid, tr_e)
    be = pallas_zslab.column_buoyancy(cfg, grid, tr_e)[0]
    return cfg, grid, ue, ve, tr_e, be, _sequential_total(grid, be), noise


def _flat(out):
    """A K1 result's tensors in order (a dict's in its key order)."""
    flat = []
    for x in out:
        items = x.values() if isinstance(x, dict) else x if isinstance(x, tuple) else (x,)
        flat.extend(items)
    return flat


@pytest.mark.parametrize("case", list(OWN_B_CASES))
def test_k1_own_b_matches_operand_path_bitwise(cuda, case):
    """K1 making b itself (no b handed in) against the same instance's
    shape reading the eager float32 b and a column total summed in the
    kernel's order, bit for bit, fused and unfused: its b is torch's eager
    b to the bit, and nothing else moves."""
    geometry, source = OWN_B_CASES[case]
    cfg, grid, ue, ve, tr_e, be, total, noise = _own_b_operands(cuda, geometry, source)
    prev = (noise(1e-7), noise(1e-7), {k: noise(1e-7) for k in tr_e})
    prev[1][:, 0, :] = 0.0
    ab = (96.0, -36.0)
    fb = face_bottom_planes(grid) if grid.immersed else None
    before = pallas_zslab.KERNEL.launches
    runs = [pallas_zslab.zslab_tendencies(cfg, grid, ue, ve, tr_e, prev, ab, buoyancy=b,
                                          face_bottoms=fb) for b in (None, (be, total))]
    runs += [pallas_zslab.zslab_tendencies(cfg, grid, ue, ve, tr_e, buoyancy=b)
             for b in (None, (be, total))]
    torch.cuda.synchronize()
    assert pallas_zslab.KERNEL.launches == before + 4
    for own, read in ((runs[0], runs[1]), (runs[2], runs[3])):
        for g, w in zip(_flat(own), _flat(read), strict=True):
            assert torch.isfinite(w).all()
            assert torch.equal(g, w), float((g - w).abs().max())
    general = source != "teos10"
    for form in ("fused", "unfused"):
        info = pallas_zslab.kernel_info(len(tr_e), grid.immersed and form == "fused",
                                        grid.north_fold, form, general, own=True)
        assert info["registers"] > 0 and info["blocks_per_sm"] >= 1
        print(f"\nK1 {form} own-b {case}: {info}")


@pytest.mark.parametrize("case", list(OWN_B_CASES))
def test_k1_own_b_matches_plain(cuda, case):
    """K1's instances that make b against the plain version at K1's
    tolerances, one step's operands, fused and unfused."""
    geometry, source = OWN_B_CASES[case]
    cfg, grid, ue, ve, tr_e, be, total, noise = _own_b_operands(cuda, geometry, source)
    general = source != "teos10"
    _check_k1_fused(cfg, grid, ue, ve, tr_e, be, total, noise, general, own=True)
    _check_k1_unfused(cfg, grid, ue, ve, tr_e, None, general, own=True)



@pytest.mark.parametrize("closure", [None, CATKEVerticalDiffusivity], ids=["none", "catke"])
def test_k1_b_own_share_of_steps(cuda, closure):
    """Over three host-launched steps at 64x16x16, the share of K1's
    launches whose b the kernel made (``pallas_zslab.b_own_share``): all of
    the flagship's, none of the CATKE step's, whose closure reads b."""
    cfg, grid, state = baroclinic_instability_model(
        64, 16, 16, device=cuda, closure=None if closure is None else closure())
    before = pallas_zslab.b_launches()
    for _ in range(3):
        state = time_step(cfg, grid, state, 10.0)
    torch.cuda.synchronize()
    assert pallas_zslab.KERNEL.launches == before[1] + 3
    assert pallas_zslab.b_own_share(before) == (1.0 if closure is None else 0.0)
    assert torch.isfinite(state.u).all()

def _precision_operands(cuda, geometry, ntr):
    """Extended operands with ``ntr`` tracers: b alone (1), T and S (2),
    T, S, e (3), T, S, e, eps (4) on the lat-lon k-epsilon grid (flat) or
    the tripolar islands grid, with the config that advects them."""
    if geometry == "flat":
        cfg, grid, ue, ve, tr_all = _keps_operands(cuda, (128, 64, 8), 21)[:5]
    else:
        cfg, grid, ue, ve, tr_all, _, _, noise = _climate_operands(
            cuda, (128, 64, 8), 22, "gaussian_islands_tripolar")
        tr_all = {**tr_all, "eps": extend_field(grid, 1e-8 * (1.0 + noise(0.1)), "c")}
    if ntr == 1:
        cfg, tr_e, _, _ = _b_operands(cfg, grid, tr_all)
        return cfg, grid, ue, ve, tr_e
    names = ("T", "S", "e", "eps")[:ntr]
    closure = {2: None, 3: CATKEVerticalDiffusivity(),
               4: TKEDissipationVerticalDiffusivity()}[ntr]
    cfg = dataclasses.replace(cfg, closure=closure, tracers=names)
    return cfg, grid, ue, ve, {k: tr_all[k] for k in names}


# (tracers, general): the flagship's schemes are compiled for two tracers or more
UNFUSED_INSTANCES = [(1, True), *((n, g) for n in (2, 3, 4) for g in (False, True))]


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("ntr,general", UNFUSED_INSTANCES)
@pytest.mark.parametrize("geometry", ["flat", "tripolar"])
def test_k1_unfused_instances_match_plain(cuda, geometry, ntr, general, storage):
    """Every unfused instance, float32 and bf16-storage: one to four
    tracers, metric columns and tripolar planes, the flagship's schemes
    compiled in (two tracers or more) and the general instance (the
    oracle's schemes)."""
    cfg, grid, ue, ve, tr_e = _precision_operands(cuda, geometry, ntr)
    if general:
        cfg = _schemes(cfg, "vector_invariant-standard-centered2")
    _check_k1_unfused(cfg, grid, ue, ve, tr_e, torch.bfloat16 if storage == "bf16" else None,
                      general)


@pytest.mark.parametrize("ntr", [1, 2, 3, 4])
@pytest.mark.parametrize("geometry", ["flat", "tripolar"])
def test_k6_bf16_instances_match_plain_bitwise(cuda, geometry, ntr):
    """K6's bfloat16 instances (one to four tracers, columns and planes) on
    the operands, f and the grid cast to bfloat16: one launch, bfloat16
    outputs bit for bit with the plain twin (float32 arithmetic on the
    widened operands, each output rounded to bfloat16)."""
    cfg, grid, ue, ve, tr_e = _precision_operands(cuda, geometry, ntr)
    bf = torch.bfloat16
    pallas = dataclasses.replace(cfg, kernels="pallas")
    args = (pallas, grid.cast(bf), coriolis_ff(grid, cfg.coriolis).to(bf), ue.to(bf), ve.to(bf),
            {k: c.to(bf) for k, c in tr_e.items()})
    before = pallas_tendency.KERNEL.launches
    got = pallas_tendency.pallas_tendencies(*args)
    torch.cuda.synchronize()
    assert pallas_tendency.KERNEL.launches == before + 1
    want = pallas_tendency.pallas_tendencies_plain(*args)
    assert list(got[2]) == list(tr_e)
    for g, w in ((got[0], want[0]), (got[1], want[1]), *((got[2][k], want[2][k]) for k in tr_e)):
        assert g.dtype == bf and torch.isfinite(w).all()
        assert torch.equal(g, w), float((g.float() - w.float()).abs().max())
    info = pallas_tendency.kernel_info(ntr, "all", grid.north_fold, general=True, dtype=bf)
    assert info["registers"] > 0 and info["blocks_per_sm"] >= 1
    with pytest.raises(ValueError, match="one launch"):
        pallas_tendency.pallas_tendencies(*args, split=True)


@pytest.mark.parametrize("ntr", [1, 2, 3, 4])
@pytest.mark.parametrize("geometry", ["flat", "tripolar"])
def test_k6_f64_instances_match_plain_bitwise(cuda, geometry, ntr):
    """K6's float64 instances (one to four tracers: b alone, T and S, T, S,
    e and T, S, e, eps; columns and planes) on the operands, f and the grid
    in float64: one launch, float64 outputs bit for bit with the plain twin
    (the same operations in float64, -fmad=false); with two tracers the
    linear equation of state too."""
    cfg, grid, ue, ve, tr_e = _precision_operands(cuda, geometry, ntr)
    f64 = torch.float64
    eoss = [cfg.eos] + ([LinearEquationOfState()] if ntr == 2 else [])
    for eos in eoss:
        pallas = dataclasses.replace(cfg, kernels="pallas", eos=eos)
        args = (pallas, grid.cast(f64), coriolis_ff(grid, cfg.coriolis).to(f64), ue.to(f64),
                ve.to(f64), {k: c.to(f64) for k, c in tr_e.items()})
        before = pallas_tendency.KERNEL.launches
        got = pallas_tendency.pallas_tendencies(*args)
        torch.cuda.synchronize()
        assert pallas_tendency.KERNEL.launches == before + 1
        want = pallas_tendency.pallas_tendencies_plain(*args)
        assert list(got[2]) == list(tr_e)
        for g, w in ((got[0], want[0]), (got[1], want[1]),
                     *((got[2][k], want[2][k]) for k in tr_e)):
            assert g.dtype == f64 and torch.isfinite(w).all()
            assert torch.equal(g, w), float((g - w).abs().max())
    info = pallas_tendency.kernel_info(ntr, "all", grid.north_fold, general=True, dtype=f64)
    assert info["registers"] > 0 and info["blocks_per_sm"] >= 1
    with pytest.raises(ValueError, match="one launch"):
        pallas_tendency.pallas_tendencies(*args, split=True)


@pytest.mark.parametrize("name", list(TILE_CASES))
def test_k6_f64_tiles_match_plain_bitwise(cuda, name):
    """K6's float64 instance bit for bit with its plain twin on the grids
    its 32 x 8 tiles do not divide, narrower than a tile, with unaligned
    rows (value-by-value staging) and 400 levels deep."""
    cfg, grid, ue, ve, tr_e = _tile_operands(cuda, *TILE_CASES[name])[:5]
    f64 = torch.float64
    args = (dataclasses.replace(cfg, kernels="pallas"), grid.cast(f64),
            coriolis_ff(grid, cfg.coriolis).to(f64), ue.to(f64), ve.to(f64),
            {k: c.to(f64) for k, c in tr_e.items()})
    got = pallas_tendency.pallas_tendencies(*args)
    want = pallas_tendency.pallas_tendencies_plain(*args)
    for g, w in ((got[0], want[0]), (got[1], want[1]), *((got[2][k], want[2][k]) for k in tr_e)):
        assert torch.equal(g, w), float((g - w).abs().max())


def _precision_route_model(cuda, name):
    """The config (a CoupledConfig for the climate), grid, atmosphere (or
    None) and state of one of chip_smoke [39]'s rows at 128x64x8, with its
    step's launches of K1, K2, K6, K5, K3, K4 (catke or k-epsilon)."""
    k1, mode, kernels, model = {
        "climate_bf16s": (1, "bf16s", "auto", "tripolar"),
        "climate_float32": (1, "float32", "auto", "tripolar"),
        "keps_float32": (1, "float32", "auto", "keps"),
        "flagship_k6_bfloat16": (0, "bfloat16", "pallas", "flagship"),
        "climate_k6_bfloat16": (0, "bfloat16", "pallas", "tripolar"),
        "climate_explicit": (1, None, "auto", "tripolar"),
    }[name]
    if model == "tripolar":
        ccfg, grid, atmos, state = data_free_ocean_climate_model(
            resolution=3.0, Nz=8, device=cuda, grid_type="gaussian_islands_tripolar",
            kernels=kernels)
        ocean = dataclasses.replace(ccfg.ocean, compute_dtype=mode)
        if name == "climate_explicit":
            ocean = dataclasses.replace(ocean, free_surface=ExplicitFreeSurface())
        cfg, n3, n4 = dataclasses.replace(ccfg, ocean=ocean), 3, 1
    else:
        closure = TKEDissipationVerticalDiffusivity() if model == "keps" else None
        cfg, grid, state = baroclinic_instability_model(128, 64, 8, device=cuda, kernels=kernels,
                                                        closure=closure)
        cfg, atmos, ocean = dataclasses.replace(cfg, compute_dtype=mode), None, None
        n3, n4 = (4, 1) if closure else (0, 0)
    ocean = ocean or cfg
    explicit = isinstance(ocean.free_surface, ExplicitFreeSurface)
    k5 = _k6_route_k5_launches(ocean, grid) if kernels == "pallas" else 0
    launches = [k1, int(k1 and not explicit), 1 - k1, k5, n3, n4]
    return cfg, grid, atmos, state, launches


PRECISION_ROUTES = ("climate_bf16s", "climate_float32", "keps_float32", "flagship_k6_bfloat16",
                    "climate_k6_bfloat16", "climate_explicit")


@pytest.mark.parametrize("name", PRECISION_ROUTES)
def test_precision_route_step_matches_plain_step(cuda, name, monkeypatch):
    """One step of each of chip_smoke [39]'s routes after 8 steps, with its
    launches a step, against the same route's plain path (every wrapper's
    plain version: on the K6 route under "bfloat16" the "torch" route would
    run the K1 route's cast array path), and the device loop against the
    host loop over 16 steps, bit for bit."""
    cfg, grid, atmos, state, launches = _precision_route_model(cuda, name)
    dt = 5.0 if name == "climate_explicit" else 60.0
    if atmos is None:
        def step(s):
            return time_step(cfg, grid, s, dt)

        def run(s, n):
            return loop(cfg, grid, s, dt, n)
    else:
        def step(s):
            return coupled_time_step(cfg, grid, atmos, s, dt)

        def run(s, n):
            return coupled_loop(cfg, grid, atmos, s, dt, n)
    state = run(state, 8)  # from rest Gu is too small for the atol
    kernels = (pallas_zslab.KERNEL, pallas_barotropic.KERNEL, pallas_tendency.KERNEL,
               pallas_barotropic.BLOCK_KERNEL, pallas_tridiag.KERNEL,
               pallas_catke.KEPS_KERNEL if name == "keps_float32" else pallas_catke.KERNEL)
    before = [k.launches for k in kernels]
    a = step(state)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == launches
    replayed = run(state, device_loop.BLOCK_STEPS)
    host = device_loop.host_loop(functools.partial(
        coupled_time_step, cfg, grid, atmos, dt=dt, premasked=True) if atmos is not None
        else functools.partial(time_step, cfg, grid, dt=dt, premasked=True),
        premask_state(grid, state), device_loop.BLOCK_STEPS)
    ta, tb = device_loop._tensors(replayed), device_loop._tensors(host)
    assert [f for f in ta if not torch.equal(ta[f], tb[f])] == []
    for module in (pallas_zslab, pallas_barotropic, pallas_tendency, pallas_tridiag,
                   pallas_catke):
        monkeypatch.setattr(module, "uses_kernel", lambda *args: False)
    b = step(state)
    ocean = cfg.ocean if atmos is not None else cfg
    _step_close(ocean, grid, state, a, b)
