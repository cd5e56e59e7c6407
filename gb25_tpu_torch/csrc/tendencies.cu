// The whole tendency stage of the hydrostatic step in one kernel: continuity
// w, TEOS-10 buoyancy, hydrostatic pressure, WENO vector-invariant momentum
// and WENO-5 tracer advection, from the halo-extended u, v and tracers to
// the interior Gu, Gv and one G per tracer. Nothing else: the AB2 update,
// the depth integrals, the closure's sources, the surface fluxes and the
// masks are the caller's (the "pallas" route of models/hydrostatic.py).
//
// Replaces: gb25_tpu/ops/pallas_tendency.py::pallas_tendencies (the
// one-pass Pallas tendency kernel, _run_kernel :135, pallas_call :234):
// tracers T, S (the flagship), T, S, e (the climate) and T, S, e, eps
// (k-epsilon); the metrics and f as y profiles or, on the tripolar grid, as
// (y, x) planes (the Pallas kernel's metric_spec, :173-184); split = false
// (one launch) or true (a momentum launch, then a tracer launch).
//
// What bounds it on an H100: device memory, nearly level with the float32
// rate. At 1536x768x64 the flagship instance reads four extended fields (u,
// v, T, S: 1.38 GB) and writes four interior ones (1.21 GB), ~0.77 ms at
// 3.35 TB/s, against ~720 operations per cell (~600 of stencils, ~120 of
// TEOS-10 and the column sums), ~0.81 ms at 67 TFLOP/s. As in the Pallas
// kernel, b, p and w never reach device memory; the stencils' re-reads of
// their neighbours have to hit L1/L2.
//
// Design: one block per tile of 32 x 4 interior columns, threads along x
// (coalesced loads of the (Z, Y, X) fields).
//   A. The block evaluates TEOS-10 once per cell of its columns and of a
//      one-column west and south apron (the pressure gradient reads p at
//      i-1 and j-1) and keeps b dz in dynamic shared memory:
//      33 x 5 x (Nz + 1) floats, 42.9 KB at Nz = 64.
//   B. One thread per column sums b dz up from the floor: the column total
//      that p = csum - total - b dz / 2 needs before its first level.
//   C. Each thread marches its own column up from the floor, as K1 does:
//      it carries the continuity sums (w) of its column and of the columns
//      west and south of it, and the running sums of b dz (p) read from
//      shared memory, and reads u, v and the tracers through L1/L2.
// The tracer launch of split = true needs no b: it skips A and B.
//
// TEOS-10 is written as torch evaluates ops/eos.py on a CUDA float32
// tensor, so the kernel's b can equal the plain version's bit for bit: the
// same Horner order (by powers of zz, then tt, then ss), every product and
// sum rounded on its own (-fmad=false), each Python constant rounded once to
// float, and each division by a constant a product with the float
// reciprocal (the wrapper passes the reciprocals, rounded as torch rounds
// them). The column sums are sequential; the plain version's total comes
// from torch's reduction, so p, and with it Gu and Gv, may differ by an
// ulp of p.
//
// The inputs arrive halo-filled (the fold rows included) and, on immersed
// grids, with u and v masked on solid faces: like the Pallas kernel, K6 has
// no fold, no mask and no wall logic. The outputs are fresh buffers.

#include <cuda_runtime.h>
#include <cstddef>

#include "tendency_stencils.cuh"

namespace {

constexpr int kMaxTracers = 4;
constexpr int kTX = 32, kTY = 4;               // interior columns of a block
constexpr int kSX = kTX + 1, kSY = kTY + 1;    // with the west and south apron
constexpr int kSC = kSX * kSY;                 // columns of the shared b dz tile

enum Mode { kAll = 0, kMomentum = 1, kTracers = 2 };

struct Args {
  Field u, v, T, S;
  Field tr[kMaxTracers];
  // (Ny+2hy) y profiles, or (Ny+2hy, Nx+2hx) planes on the tripolar grid
  const float *dxc, *dxf, *dyc, *dyf, *azc, *azf, *fff;
  const float *dzc, *dzf, *zc;  // (Nz+2hz) z profiles
  float *Gu, *Gv;               // (Nz, Ny, Nx)
  float* Gtr[kMaxTracers];
  int Nx, Ny, Nz, hx, hy, hz;
  float eps;                                              // WENO epsilon
  float inv_sau, inv_ctu, inv_zu, neg_g, rho0, inv_rho0;  // TEOS-10 scalars
};

// The polyTEOS10_bsq anomaly coefficient of ss^i tt^j zz^k as kEos[k][j][i]
// (ops/eos.py::_EOS): at zz^k, tt runs to kDeg[k] and ss to kDeg[k] - j,
// with kDeg = {6, 4, 2, 1}. Each double is rounded once to float, as torch
// rounds a Python number for a float32 tensor.
__constant__ float kEos[4][7][7] = {
    {
        {8.0189615746e02, 8.6672408165e02, -1.7864682637e03, 2.0375295546e03,
         -1.2849161071e03, 4.3227585684e02, -6.0579916612e01},
        {2.6010145068e01, -6.5281885265e01, 8.1770425108e01, -5.6888046321e01,
         1.7681814114e01, -1.9193502195e00},
        {-3.7074170417e01, 6.1548258127e01, -6.0362551501e01, 2.9130021253e01,
         -5.4723692739e00},
        {2.1661789529e01, -3.3449108469e01, 1.9717078466e01, -3.1742946532e00},
        {-8.3627885467e00, 1.1311538584e01, -5.3563304045e00},
        {5.4048723791e-01, 4.8169980163e-01},
        {-1.9083568888e-01},
    },
    {
        {1.9681925209e01, -4.2549998214e01, 5.0774768218e01, -3.0938076334e01,
         6.6051753097e00},
        {-1.3336301113e01, -4.4870114575e00, 5.0042598061e00, -6.5399043664e-01},
        {6.7080479603e00, 3.5063081279e00, -1.8795372996e00},
        {-2.4649669534e00, -5.5077101279e-01},
        {5.5927935970e-01},
    },
    {
        {2.0660924175e00, -4.9527603989e00, 2.5019633244e00},
        {2.0564311499e00, -2.1311365518e-01},
        {-1.2419983026e00},
    },
    {
        {-2.3342758797e-02, -1.8507636718e-02},
        {3.7969820455e-01},
    },
};

// sum_ij kEos[K][j][i] ss^i tt^j: Horner in tt of Horner in ss, from the
// highest powers down (ops/eos.py::_horner_2d).
template <int K, int N>
__device__ __forceinline__ float eos_horner2d(float ss, float tt) {
  float out = 0.0f;
#pragma unroll
  for (int j = N; j >= 0; --j) {
    float acc = kEos[K][j][N - j];
#pragma unroll
    for (int i = N - j - 1; i >= 0; --i) acc = acc * ss + kEos[K][j][i];
    out = (j == N) ? acc : out * tt + acc;
  }
  return out;
}

// b = -g (rho' - rho0) / rho0 from the TEOS-10 anomaly rho'(S, T, z)
// (ops/eos.py::TEOS10EquationOfState.buoyancy).
__device__ __forceinline__ float teos10_buoyancy(const Args& A, float T, float S, float z) {
  const float ss = sqrtf((S + 32.0f) * A.inv_sau);
  const float tt = T * A.inv_ctu;
  const float zz = (-z) * A.inv_zu;
  float r = eos_horner2d<3, 1>(ss, tt);
  r = r * zz + eos_horner2d<2, 2>(ss, tt);
  r = r * zz + eos_horner2d<1, 4>(ss, tt);
  r = r * zz + eos_horner2d<0, 6>(ss, tt);
  return (A.neg_g * (r - A.rho0)) * A.inv_rho0;
}

template <int NTR, int MODE, bool M2>
__global__ void __launch_bounds__(kTX * kTY) tendency_stage_kernel(const Args A) {
  // [Nz][kSY][kSX] b dz, then [kSC] column totals; row 0 and column 0 are
  // the south and west apron
  extern __shared__ float bdz[];
  constexpr bool kMom = MODE != kTracers, kTrc = MODE != kMomentum;
  const int i0 = blockIdx.x * kTX, j0 = blockIdx.y * kTY;
  const int tid = threadIdx.y * kTX + threadIdx.x;
  const int Nz = A.Nz;

  if constexpr (kMom) {
    // A: b dz of every cell of the tile's columns (a ragged tile at the
    // east or north edge has fewer), TEOS-10 once per cell
    const int nx = min(kTX, A.Nx - i0) + 1, ny = min(kTY, A.Ny - j0) + 1;
    for (int n = tid; n < Nz * kSC; n += kTX * kTY) {
      const int k = n / kSC, c = n - k * kSC, yy = c / kSX, xx = c - yy * kSX;
      if (xx < nx && yy < ny) {
        const int Z = k + A.hz, Y = j0 + yy - 1 + A.hy, X = i0 + xx - 1 + A.hx;
        bdz[n] = teos10_buoyancy(A, A.T(Z, Y, X), A.S(Z, Y, X), A.zc[Z]) * A.dzc[Z];
      }
    }
    __syncthreads();
    // B: the column totals, summed up from the floor
    for (int c = tid; c < kSC; c += kTX * kTY) {
      const int yy = c / kSX, xx = c - yy * kSX;
      if (xx < nx && yy < ny) {
        float tot = 0.0f;
        for (int k = 0; k < Nz; ++k) tot = tot + bdz[k * kSC + c];
        bdz[Nz * kSC + c] = tot;
      }
    }
    __syncthreads();
  }

  // C: this thread's column, marched up from the floor
  const int i = i0 + threadIdx.x, j = j0 + threadIdx.y;
  if (i >= A.Nx || j >= A.Ny) return;
  const int X = i + A.hx, Y = j + A.hy;
  const size_t ij = (size_t)j * A.Nx + i;
  const size_t plane_i = (size_t)A.Ny * A.Nx;
  const int sc = (threadIdx.y + 1) * kSX + threadIdx.x + 1;  // this column in bdz

  // carries: continuity sums (w = -sum) of the own (c), west (w) and south
  // (s) columns; inclusive sums of b dz and the column totals
  float sw_c = 0.f, sw_w = 0.f, sw_s = 0.f;
  float cs_c = 0.f, cs_w = 0.f, cs_s = 0.f;
  float tot_c = 0.f, tot_w = 0.f, tot_s = 0.f;
  if constexpr (kMom) {
    tot_c = bdz[Nz * kSC + sc];
    tot_w = bdz[Nz * kSC + sc - 1];
    tot_s = bdz[Nz * kSC + sc - kSX];
  }
  // the vertical terms at the bottom face of the level, carried from the
  // level below: w = 0 on the sea floor
  float xu = 0.f, xv = 0.f;
  float fz[NTR];
#pragma unroll
  for (int t = 0; t < NTR; ++t) fz[t] = 0.f;

  for (int k = 0; k < Nz; ++k) {
    const int Z = k + A.hz;
    const float dzc = A.dzc[Z];
    const size_t o = (size_t)k * plane_i + ij;

    // continuity -> w at the top face of this level
    sw_c = sw_c + divergence<M2>(A, Z, Y, X) * dzc;
    const float w_c1 = -sw_c;
    float Gu_o = 0.f, Gv_o = 0.f, Gc[NTR];

    if constexpr (kMom) {
      sw_w = sw_w + divergence<M2>(A, Z, Y, X - 1) * dzc;
      sw_s = sw_s + divergence<M2>(A, Z, Y - 1, X) * dzc;
      const float w_w1 = -sw_w, w_s1 = -sw_s;

      // hydrostatic pressure p = csum - total - b dz / 2
      const float bdz_c = bdz[k * kSC + sc];
      const float bdz_w = bdz[k * kSC + sc - 1];
      const float bdz_s = bdz[k * kSC + sc - kSX];
      cs_c = cs_c + bdz_c;
      cs_w = cs_w + bdz_w;
      cs_s = cs_s + bdz_s;
      const float p_c = (cs_c - tot_c) - 0.5f * bdz_c;
      const float p_w = (cs_w - tot_w) - 0.5f * bdz_w;
      const float p_s = (cs_s - tot_s) - 0.5f * bdz_s;

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
      const float r_dxc = 1.0f / met<M2>(A, A.dxc, Y, X);
      const float r_dyf = 1.0f / met<M2>(A, A.dyf, Y, X);
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
      Gu_o = Gu - (p_c - p_w) * r_dxc;
      Gv_o = Gv - (p_c - p_s) * r_dyf;
    }

    if constexpr (kTrc) {
      // tracers: flux-form WENO-5
      const float r_dzc = 1.0f / dzc;
#pragma unroll
      for (int t = 0; t < NTR; ++t) {
        const float fz1 = tracer_zflux(A, A.tr[t], Z + 1, Y, X, w_c1);
        Gc[t] = tracer_horizontal<M2>(A, A.tr[t], Z, Y, X) - (fz1 - fz[t]) * r_dzc;
        fz[t] = fz1;
      }
    }

    // stores after every load of the level: the outputs are not declared
    // disjoint from the inputs, so a load after a store could not reuse a
    // value already in a register (K1 measured 8%)
    if constexpr (kMom) {
      A.Gu[o] = Gu_o;
      A.Gv[o] = Gv_o;
    }
    if constexpr (kTrc) {
#pragma unroll
      for (int t = 0; t < NTR; ++t) A.Gtr[t][o] = Gc[t];
    }
  }
}

template <int NTR, int MODE, bool M2>
cudaError_t launch(const Args& A, dim3 grid, dim3 block, size_t smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tendency_stage_kernel<NTR, MODE, M2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  tendency_stage_kernel<NTR, MODE, M2><<<grid, block, smem, s>>>(A);
  return cudaGetLastError();
}

// TEOS-10 alone over n cells: the kernel's own buoyancy, so that a check can
// hold it against the plain version's bit for bit. z is read at index
// (cell / zstride), the layout of an extended (Z, Y, X) field.
__global__ void teos10_buoyancy_kernel(const Args A, const float* T, const float* S,
                                       const float* zc, float* b, size_t n, size_t zstride) {
  const size_t c = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c < n) b[c] = teos10_buoyancy(A, T[c], S[c], zc[c / zstride]);
}

Args eos_args(float inv_sau, float inv_ctu, float inv_zu, float neg_g, float rho0,
              float inv_rho0) {
  Args A = {};
  A.inv_sau = inv_sau; A.inv_ctu = inv_ctu; A.inv_zu = inv_zu;
  A.neg_g = neg_g; A.rho0 = rho0; A.inv_rho0 = inv_rho0;
  return A;
}

}  // namespace

extern "C" const char* gb25_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// u, v, T, S and the ntr tracers tr[0..ntr) (2 to 4; the pointer arrays
// hold kMaxTracers entries, the unused ones null) are extended (Nz+2hz,
// Ny+2hy, Nx+2hx); T and S are also among tr. metric2d: the six metrics and
// fff are (Ny+2hy, Nx+2hx) planes (the tripolar grid), else (Ny+2hy)
// profiles. mode: 0 every output, 1 Gu and Gv only (Gtr may be null), 2 the
// tracers' G only (Gu, Gv may be null). The TEOS-10 scalars: 1 / SAU,
// 1 / CTU, 1 / ZU, -g, rho0 and 1 / rho0 as float32.
extern "C" int tendencies_f32(
    const float* u, const float* v, const float* T, const float* S, const float* const* tr,
    const float* dxc, const float* dxf, const float* dyc, const float* dyf, const float* azc,
    const float* azf, const float* fff, const float* dzc, const float* dzf, const float* zc,
    float* Gu, float* Gv, float* const* Gtr, int ntr, int Nx, int Ny, int Nz, int hx, int hy,
    int hz, int metric2d, int mode, float eps, float inv_sau, float inv_ctu, float inv_zu,
    float neg_g, float rho0, float inv_rho0, void* stream) {
  if (ntr < 2 || ntr > kMaxTracers || mode < kAll || mode > kTracers)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode != kTracers && (Gu == nullptr || Gv == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int Xe = Nx + 2 * hx;
  const size_t plane = (size_t)(Ny + 2 * hy) * Xe;
  Args A = eos_args(inv_sau, inv_ctu, inv_zu, neg_g, rho0, inv_rho0);
  A.u = Field{u, Xe, plane};
  A.v = Field{v, Xe, plane};
  A.T = Field{T, Xe, plane};
  A.S = Field{S, Xe, plane};
  for (int t = 0; t < kMaxTracers; ++t) {
    const bool used = t < ntr;
    A.tr[t] = Field{used ? tr[t] : nullptr, Xe, plane};
    A.Gtr[t] = used && mode != kMomentum ? Gtr[t] : nullptr;
    if (used && mode != kMomentum && A.Gtr[t] == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  A.dxc = dxc; A.dxf = dxf; A.dyc = dyc; A.dyf = dyf; A.azc = azc; A.azf = azf; A.fff = fff;
  A.dzc = dzc; A.dzf = dzf; A.zc = zc;
  A.Gu = Gu; A.Gv = Gv;
  A.Nx = Nx; A.Ny = Ny; A.Nz = Nz; A.hx = hx; A.hy = hy; A.hz = hz;
  A.eps = eps;
  const size_t smem = mode == kTracers ? 0 : (size_t)(Nz + 1) * kSC * sizeof(float);
  dim3 block(kTX, kTY, 1);
  dim3 grid((Nx + kTX - 1) / kTX, (Ny + kTY - 1) / kTY, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // [mode][ntr - 2][metric2d]; the momentum launch reads no tracer but T, S
  using Launch = cudaError_t (*)(const Args&, dim3, dim3, size_t, cudaStream_t);
  static const Launch launchers[3][3][2] = {
      {{launch<2, kAll, false>, launch<2, kAll, true>},
       {launch<3, kAll, false>, launch<3, kAll, true>},
       {launch<4, kAll, false>, launch<4, kAll, true>}},
      {{launch<2, kMomentum, false>, launch<2, kMomentum, true>},
       {launch<2, kMomentum, false>, launch<2, kMomentum, true>},
       {launch<2, kMomentum, false>, launch<2, kMomentum, true>}},
      {{launch<2, kTracers, false>, launch<2, kTracers, true>},
       {launch<3, kTracers, false>, launch<3, kTracers, true>},
       {launch<4, kTracers, false>, launch<4, kTracers, true>}},
  };
  return static_cast<int>(launchers[mode][ntr - 2][metric2d ? 1 : 0](A, grid, block, smem, s));
}

// b = teos10_buoyancy(T, S, z) over n cells (the check's entry, not the
// step's): T, S, b of n floats, zc read at (cell / zstride).
extern "C" int teos10_buoyancy_f32(const float* T, const float* S, const float* zc, float* b,
                                   long long n, long long zstride, float inv_sau, float inv_ctu,
                                   float inv_zu, float neg_g, float rho0, float inv_rho0,
                                   void* stream) {
  if (n < 0 || zstride <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args A = eos_args(inv_sau, inv_ctu, inv_zu, neg_g, rho0, inv_rho0);
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  if (blocks > 0)
    teos10_buoyancy_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        A, T, S, zc, b, static_cast<size_t>(n), static_cast<size_t>(zstride));
  return static_cast<int>(cudaGetLastError());
}
