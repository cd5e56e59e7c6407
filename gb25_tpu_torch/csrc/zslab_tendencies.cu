// Tendency stage of the hydrostatic step, with the quasi-AB2 update, the
// south-wall row and the four barotropic depth integrals fused in.
//
// Replaces: gb25_tpu/ops/pallas_zslab.py::zslab_tendencies (the z-slab
// Pallas kernel, pallas_call at :769) with ab2, wall_v and
// integrals=True: the flagship instance (tracers T, S), the climate
// instance (tracers T, S, e, with the immersed-masked u*/v* integrals), the
// tripolar climate instance (the same, with the metrics and f as 2-D
// planes: the JAX kernel's metric_spec 2-D branch, :555-564) and the
// k-epsilon instance (tracers T, S, e, eps).
//
// What bounds it on an H100: device memory. Per step the flagship instance
// reads five extended fields (u, v, T, S, b) and four previous tendencies
// and writes eight interior fields (~5 GB at 1536x768x64 f32, ~1.6 ms at
// 3.35 TB/s) against ~600 flop per cell (~6e10 flop, ~1 ms at the float32
// rate); the climate instance adds one tracer (~6.6 GB, ~2.0 ms). The
// stencil re-reads its neighbours many times over; those re-reads have to
// hit L1/L2 or the kernel turns into a cache-bandwidth bound far above
// that floor.
//
// Design: one thread per interior (x, y) column, threads along x, so every
// load of a (Z, Y, X) field is coalesced across a warp and neighbouring
// columns share cache lines. Each thread marches z from the bottom up and
// carries, in registers, the continuity sum (w) and the running sum of b dz
// (hydrostatic pressure) for its own column and for the columns to its west
// and south, which the momentum stencil reads (w and p at i-1 and j-1).
// The vertical fluxes at the bottom face of each level are carried from
// the level below, so each face is reconstructed once. The AB2 update, the
// wall row and the depth integrals of u, v, u*, v* accumulate in registers
// of the owning column. The tracer count (2 to 4), the immersed integrals
// and the 2-D metrics are template parameters, so the flagship instance
// computes exactly what it did before any of them existed. A 2-D metric
// is read at the (y, x) of the face or center it weights, as the plain
// version's broadcast product reads it. On immersed grids only the
// accumulation of Us and Vs is masked, with the fluid test z_c > face
// bottom of grids/immersed.py; the stored u*, v* stay unmasked and the
// caller re-masks them. Outputs are fresh buffers: nothing is updated in
// place (the caller may still hold the previous state). Simple first: no
// shared-memory tiling, no TMA; those come when the kernel is tuned.
//
// Semantics follow the array path of the JAX package (ops/operators.py,
// models/hydrostatic.py): w = 0 below the bottom and the surface value
// above it; the fields' z ghosts (zero gradient) come with the extended
// inputs; the WENO-5 upwind test is strict (vel > 0). The stencils are
// shared with kernel K6 (tendency_stencils.cuh).

#include <cuda_runtime.h>
#include <cstddef>

#include "tendency_stencils.cuh"

namespace {

constexpr int kMaxTracers = 4;

struct Args {
  Field u, v, b;
  Field tr[kMaxTracers];
  const float* btot;  // (Ny+2hy, Nx+2hx): column total of b dz
  // (Ny+2hy) y profiles, or (Ny+2hy, Nx+2hx) planes on the tripolar grid
  const float *dxc, *dxf, *dyc, *dyf, *azc, *azf, *fff;
  const float *dzc, *dzf, *zc;                           // (Nz+2hz) z profiles
  const float *bu, *bv;                                  // (Ny, Nx) face bottoms (immersed)
  const float *Gu_p, *Gv_p;                              // (Nz, Ny, Nx) previous G
  const float* Gtr_p[kMaxTracers];
  float *Gu, *Gv;                                        // (Nz, Ny, Nx) new G
  float* Gtr[kMaxTracers];
  float *un, *vn;                                        // (Nz, Ny, Nx) updated fields
  float* trn[kMaxTracers];
  float *U0, *V0, *Us, *Vs;                              // (Ny, Nx) depth integrals
  int Nx, Ny, Nz, hx, hy, hz;
  int wall_row;          // 0: row 0 is the south wall; -1: no wall row on this tile
  float a, b_prev, eps;  // dt*c1, dt*c2, WENO epsilon
};

template <int NTR, bool IMM, bool M2>
__global__ void __launch_bounds__(128) zslab_tendencies_kernel(const Args A) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  if (i >= A.Nx || j >= A.Ny) return;
  const int X = i + A.hx, Y = j + A.hy;
  const size_t ij = (size_t)j * A.Nx + i;
  const size_t plane_i = (size_t)A.Ny * A.Nx;

  // carries: continuity sums (w = -sum) and inclusive b dz sums, for the
  // own (c), west (w) and south (s) columns
  float sw_c = 0.f, sw_w = 0.f, sw_s = 0.f;
  float cs_c = 0.f, cs_w = 0.f, cs_s = 0.f;
  const size_t Xe = A.Nx + 2 * A.hx;
  const float tot_c = A.btot[(size_t)Y * Xe + X];
  const float tot_w = A.btot[(size_t)Y * Xe + X - 1];
  const float tot_s = A.btot[(size_t)(Y - 1) * Xe + X];
  float w_c = 0.f, w_w = 0.f, w_s = 0.f;  // w at the bottom face of the level

  // bottom-face carries of the vertical terms (w = 0 on the sea floor)
  int Z = A.hz;
  float xu = 0.5f * (w_c + w_w) * ((A.u(Z, Y, X) - A.u(Z - 1, Y, X)) * (1.0f / A.dzf[Z]));
  float xv = 0.5f * (w_c + w_s) * ((A.v(Z, Y, X) - A.v(Z - 1, Y, X)) * (1.0f / A.dzf[Z]));
  float fz[NTR];
#pragma unroll
  for (int t = 0; t < NTR; ++t) fz[t] = tracer_zflux(A, A.tr[t], Z, Y, X, w_c);

  const float wall = (j != A.wall_row) ? 1.0f : 0.0f;  // v and Gv vanish on the south wall
  float U0 = 0.f, V0 = 0.f, Us = 0.f, Vs = 0.f;
  float bu = 0.f, bv = 0.f;  // face bottoms of this column (immersed)
  if (IMM) {
    bu = A.bu[ij];
    bv = A.bv[ij];
  }

  for (int k = 0; k < A.Nz; ++k) {
    Z = k + A.hz;
    const float dzc = A.dzc[Z];

    // continuity -> w at the top face of this level. The column sums are
    // rounded term by term (no fused multiply-add), as a cumsum of the
    // products rounds them: p ~ 500 m^2/s^2 against horizontal differences
    // far smaller, so one ulp of p shows in the pressure gradient.
    sw_c = __fadd_rn(sw_c, __fmul_rn(divergence<M2>(A, Z, Y, X), dzc));
    sw_w = __fadd_rn(sw_w, __fmul_rn(divergence<M2>(A, Z, Y, X - 1), dzc));
    sw_s = __fadd_rn(sw_s, __fmul_rn(divergence<M2>(A, Z, Y - 1, X), dzc));
    const float w_c1 = -sw_c, w_w1 = -sw_w, w_s1 = -sw_s;

    // hydrostatic pressure p = csum - total - b dz / 2
    const float bdz_c = __fmul_rn(A.b(Z, Y, X), dzc);
    const float bdz_w = __fmul_rn(A.b(Z, Y, X - 1), dzc);
    const float bdz_s = __fmul_rn(A.b(Z, Y - 1, X), dzc);
    cs_c = __fadd_rn(cs_c, bdz_c);
    cs_w = __fadd_rn(cs_w, bdz_w);
    cs_s = __fadd_rn(cs_s, bdz_s);
    const float p_c = __fsub_rn(__fsub_rn(cs_c, tot_c), __fmul_rn(0.5f, bdz_c));
    const float p_w = __fsub_rn(__fsub_rn(cs_w, tot_w), __fmul_rn(0.5f, bdz_w));
    const float p_s = __fsub_rn(__fsub_rn(cs_s, tot_s), __fmul_rn(0.5f, bdz_s));

    // vector-invariant momentum: upwinded vorticity flux
    float s[6];
    for (int r = 0; r < 6; ++r) s[r] = pv<M2>(A, Z, Y - 2 + r, X);
    const float vbar = 0.5f * (0.5f * (A.v(Z, Y + 1, X) + A.v(Z, Y + 1, X - 1)) +
                               0.5f * (A.v(Z, Y, X) + A.v(Z, Y, X - 1)));
    float Gu = weno_upwind(s, vbar, A.eps) * vbar;
    for (int r = 0; r < 6; ++r) s[r] = pv<M2>(A, Z, Y, X - 2 + r);
    const float ubar = 0.5f * (0.5f * (A.u(Z, Y, X + 1) + A.u(Z, Y - 1, X + 1)) +
                               0.5f * (A.u(Z, Y, X) + A.u(Z, Y - 1, X)));
    float Gv = -weno_upwind(s, ubar, A.eps) * ubar;

    // Bernoulli gradient
    const float K = kinetic(A, Z, Y, X);
    const float r_dxc = 1.0f / met<M2>(A, A.dxc, Y, X), r_dyf = 1.0f / met<M2>(A, A.dyf, Y, X);
    Gu = Gu - (K - kinetic(A, Z, Y, X - 1)) * r_dxc;
    Gv = Gv - (K - kinetic(A, Z, Y - 1, X)) * r_dyf;

    // vertical advection -w du/dz, centered between the two faces
    const float r_dzf1 = 1.0f / A.dzf[Z + 1];
    const float xu1 = 0.5f * (w_c1 + w_w1) * ((A.u(Z + 1, Y, X) - A.u(Z, Y, X)) * r_dzf1);
    const float xv1 = 0.5f * (w_c1 + w_s1) * ((A.v(Z + 1, Y, X) - A.v(Z, Y, X)) * r_dzf1);
    Gu = Gu - 0.5f * (xu1 + xu);
    Gv = Gv - 0.5f * (xv1 + xv);
    xu = xu1;
    xv = xv1;

    // hydrostatic pressure gradient
    Gu = Gu - (p_c - p_w) * r_dxc;
    Gv = Gv - (p_c - p_s) * r_dyf;
    Gv = Gv * wall;

    // tracers: flux-form WENO-5
    const float r_dzc = 1.0f / dzc;
    float fz1[NTR], Gc[NTR];
#pragma unroll
    for (int t = 0; t < NTR; ++t) fz1[t] = tracer_zflux(A, A.tr[t], Z + 1, Y, X, w_c1);
#pragma unroll
    for (int t = 0; t < NTR; ++t) {
      Gc[t] = tracer_horizontal<M2>(A, A.tr[t], Z, Y, X) - (fz1[t] - fz[t]) * r_dzc;
      fz[t] = fz1[t];
    }

    // quasi-AB2 update: x* = x + dt c1 G + dt c2 G_prev. Every load comes
    // before the first store of the level: the outputs are not declared
    // disjoint from the inputs, so a load after a store could not reuse a
    // value already in a register.
    const size_t o = (size_t)k * plane_i + ij;
    const float u0 = A.u(Z, Y, X), v0 = A.v(Z, Y, X);
    const float un = (u0 + A.a * Gu) + A.b_prev * A.Gu_p[o];
    const float vn = ((v0 + A.a * Gv) + A.b_prev * A.Gv_p[o]) * wall;
    float trn[NTR];
#pragma unroll
    for (int t = 0; t < NTR; ++t)
      trn[t] = (A.tr[t](Z, Y, X) + A.a * Gc[t]) + A.b_prev * A.Gtr_p[t][o];
    A.Gu[o] = Gu;
    A.Gv[o] = Gv;
#pragma unroll
    for (int t = 0; t < NTR; ++t) A.Gtr[t][o] = Gc[t];
    A.un[o] = un;
    A.vn[o] = vn;
#pragma unroll
    for (int t = 0; t < NTR; ++t) A.trn[t][o] = trn[t];

    U0 = U0 + u0 * dzc;
    V0 = V0 + v0 * dzc;
    if (IMM) {
      const float zc = A.zc[Z];
      Us = Us + (un * (zc > bu ? 1.0f : 0.0f)) * dzc;
      Vs = Vs + (vn * (zc > bv ? 1.0f : 0.0f)) * dzc;
    } else {
      Us = Us + un * dzc;
      Vs = Vs + vn * dzc;
    }

    w_c = w_c1;
    w_w = w_w1;
    w_s = w_s1;
  }
  A.U0[ij] = U0;
  A.V0[ij] = V0;
  A.Us[ij] = Us;
  A.Vs[ij] = Vs;
}

template <int NTR, bool IMM, bool M2>
void launch(const Args& A, dim3 grid, dim3 block, cudaStream_t s) {
  zslab_tendencies_kernel<NTR, IMM, M2><<<grid, block, 0, s>>>(A);
}

}  // namespace

extern "C" const char* gb25_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// ntr tracers (2 to 4) in tr[0..ntr); the pointer arrays hold kMaxTracers
// entries, the unused ones null. bu and bv are null unless the grid is
// immersed; then zc (the extended z_c profile) is read too. metric2d: the
// six metrics and fff are (Ny+2hy, Nx+2hx) planes (the tripolar grid,
// which is always immersed). wall_v: local row 0 is the south wall (serially,
// and on the south-most tiles of the decomposed path), so v* and Gv are 0
// there; 0 on the other tiles, whose row 0 is an interior row.
extern "C" int zslab_tendencies_f32(
    const float* u, const float* v, const float* b, const float* const* tr, const float* btot,
    const float* dxc, const float* dxf, const float* dyc, const float* dyf, const float* azc,
    const float* azf, const float* fff, const float* dzc, const float* dzf, const float* zc,
    const float* bu, const float* bv, const float* Gu_p, const float* Gv_p,
    const float* const* Gtr_p, float* Gu, float* Gv, float* const* Gtr, float* un, float* vn,
    float* const* trn, float* U0, float* V0, float* Us, float* Vs, int ntr, int Nx, int Ny,
    int Nz, int hx, int hy, int hz, int metric2d, int wall_v, float a, float b_prev, float eps,
    void* stream) {
  if (ntr < 2 || ntr > kMaxTracers) return static_cast<int>(cudaErrorInvalidValue);
  const bool imm = bu != nullptr;
  if (imm && (bv == nullptr || zc == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (metric2d && !imm) return static_cast<int>(cudaErrorInvalidValue);
  const int Xe = Nx + 2 * hx;
  const size_t plane = (size_t)(Ny + 2 * hy) * Xe;
  Args A;
  A.u = Field{u, Xe, plane};
  A.v = Field{v, Xe, plane};
  A.b = Field{b, Xe, plane};
  for (int t = 0; t < kMaxTracers; ++t) {
    const bool used = t < ntr;
    A.tr[t] = Field{used ? tr[t] : nullptr, Xe, plane};
    A.Gtr_p[t] = used ? Gtr_p[t] : nullptr;
    A.Gtr[t] = used ? Gtr[t] : nullptr;
    A.trn[t] = used ? trn[t] : nullptr;
  }
  A.btot = btot;
  A.dxc = dxc; A.dxf = dxf; A.dyc = dyc; A.dyf = dyf; A.azc = azc; A.azf = azf; A.fff = fff;
  A.dzc = dzc; A.dzf = dzf; A.zc = zc;
  A.bu = bu; A.bv = bv;
  A.Gu_p = Gu_p; A.Gv_p = Gv_p;
  A.Gu = Gu; A.Gv = Gv;
  A.un = un; A.vn = vn;
  A.U0 = U0; A.V0 = V0; A.Us = Us; A.Vs = Vs;
  A.Nx = Nx; A.Ny = Ny; A.Nz = Nz; A.hx = hx; A.hy = hy; A.hz = hz;
  A.wall_row = wall_v ? 0 : -1;
  A.a = a; A.b_prev = b_prev; A.eps = eps;
  dim3 block(128, 1, 1);
  dim3 grid((Nx + 127) / 128, Ny, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // [ntr - 2][flat, immersed, tripolar]
  using Launch = void (*)(const Args&, dim3, dim3, cudaStream_t);
  static const Launch launchers[3][3] = {
      {launch<2, false, false>, launch<2, true, false>, launch<2, true, true>},
      {launch<3, false, false>, launch<3, true, false>, launch<3, true, true>},
      {launch<4, false, false>, launch<4, true, false>, launch<4, true, true>},
  };
  launchers[ntr - 2][imm ? (metric2d ? 2 : 1) : 0](A, grid, block, s);
  return static_cast<int>(cudaGetLastError());
}
