// The serial barotropic loop K2 by temporal blocking, K5's design carried
// over (csrc/barotropic_block.cu): up to kS substeps a launch on a staged
// tile of kSX x kSY cells with an n-wide apron, ceil(M / kS) launches a
// loop, on the lat-lon grid (metric columns; optional solid-face masks).
// The alternative to csrc/barotropic_loop.cu's one persistent launch that
// solver_variants.py times against it; no path of the package runs it.
//
// Operands: the planes of pallas_barotropic.loop_planes (eta, Ud, Vd, gHuW,
// gHvW, GUd, GVd) and 1 / azc as an (Ny) column, in the plain version's
// flux form; x periodic (the apron's columns wrap), eta mirrored at the
// south wall (detay = 0 on row 0), no flux through the north wall. Unlike
// K5 the kernel knows the walls: rows outside [0, Ny) are never read by a
// cell inside, so only a tile's x sides and its inner y sides shrink by a
// ring a substep. The fold of the tripolar grid, whose top-row tiles would
// have to stage the apron of their columns' fold image as well, is not
// built. Each thread owns one staged column and kCY rows and keeps their
// state, accumulators and constants in registers; shared memory holds Ud,
// Vd (continuity reads them east and north) and the new eta (momentum reads
// it west and south). Operations in barotropic_loop_plain's order, built
// with -fmad=false: bit for bit with it.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int kS = 6;    // substeps a launch at most, the widest apron
constexpr int kSX = 32;  // staged columns: threads in x
constexpr int kBY = 8;   // threads in y
constexpr int kCY = 4;   // staged rows per thread
constexpr int kSY = kBY * kCY;
constexpr int kThreads = kSX * kBY;
constexpr int kP = kSX + 2;             // row stride of a padded plane
constexpr int kPlane = kP * (kSY + 2);  // floats of a padded plane
constexpr size_t kSmem = 3 * kPlane * sizeof(float);
static_assert(kSX > 2 * kS && kSY > 2 * kS, "tile too small for its apron");

struct Args {
  const float *eta, *Ud, *Vd;          // (Ny, Nx) state before the launch
  float *eta_o, *Ud_o, *Vd_o;          // after it
  const float *gu, *gv, *fu, *fv;      // gHuW, gHvW, GUd, GVd
  const float* raz;                    // (Ny) 1 / azc
  const float *mu, *mv;                // masks, or null
  float *pe, *pU, *pV;                 // accumulators
  float dtau;
  float w[kS];
  int n, first, Nx, Ny;
};

template <bool MASK>
__global__ void __launch_bounds__(kThreads) loop_blocked(const Args A) {
  extern __shared__ float smem[];
  float* s_eta = smem;  // staged cell (ly, lx) at (ly + 1) kP + lx + 1
  float* s_Ud = smem + kPlane;
  float* s_Vd = smem + 2 * kPlane;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int n = A.n, tx_n = kSX - 2 * n, ty_n = kSY - 2 * n;
  const int x0 = blockIdx.x * tx_n, y0 = blockIdx.y * ty_n;

  for (int t = ty * kSX + tx; t < 2 * kP + 2 * kSY; t += kThreads) {
    const int p = t < kP ? t : t < 2 * kP ? (kSY + 1) * kP + t - kP
                                          : (t - 2 * kP) / 2 * kP + kP + ((t & 1) ? kSX + 1 : 0);
    s_eta[p] = 0.0f;
    s_Ud[p] = 0.0f;
    s_Vd[p] = 0.0f;
  }

  int gx = (x0 - n + tx) % A.Nx;
  if (gx < 0) gx += A.Nx;
  const bool own_x = tx >= n && tx < n + tx_n && x0 + tx - n < A.Nx;
  float e[kCY], U[kCY], V[kCY], pe[kCY], pU[kCY], pV[kCY];
  float gu[kCY], gv[kCY], fu[kCY], fv[kCY], rz[kCY], mu[kCY], mv[kCY];
  int gy[kCY];
  size_t o[kCY];
  bool own[kCY], in[kCY];
#pragma unroll
  for (int c = 0; c < kCY; ++c) {
    const int ly = ty + c * kBY;
    gy[c] = y0 - n + ly;
    in[c] = gy[c] >= 0 && gy[c] < A.Ny;
    own[c] = own_x && ly >= n && ly < n + ty_n && in[c];
    o[c] = in[c] ? (size_t)gy[c] * A.Nx + gx : 0;
    e[c] = U[c] = V[c] = gu[c] = gv[c] = fu[c] = fv[c] = rz[c] = mu[c] = mv[c] = 0.0f;
    if (in[c]) {
      e[c] = __ldg(A.eta + o[c]);
      U[c] = __ldg(A.Ud + o[c]);
      V[c] = __ldg(A.Vd + o[c]);
      gu[c] = __ldg(A.gu + o[c]);
      gv[c] = __ldg(A.gv + o[c]);
      fu[c] = __ldg(A.fu + o[c]);
      fv[c] = __ldg(A.fv + o[c]);
      rz[c] = __ldg(A.raz + gy[c]);
      if (MASK) {
        mu[c] = __ldg(A.mu + o[c]);
        mv[c] = __ldg(A.mv + o[c]);
      }
    }
    const bool carry = own[c] && !A.first;
    pe[c] = carry ? A.pe[o[c]] : 0.0f;
    pU[c] = carry ? A.pU[o[c]] : 0.0f;
    pV[c] = carry ? A.pV[o[c]] : 0.0f;
    const int i = (ly + 1) * kP + tx + 1;
    s_Ud[i] = U[c];
    s_Vd[i] = V[c];
  }
  __syncthreads();

#pragma unroll
  for (int m = 0; m < kS; ++m) {
    if (m == n) break;
#pragma unroll
    for (int c = 0; c < kCY; ++c) {
      const int i = (ty + c * kBY + 1) * kP + tx + 1;
      const float Vn = gy[c] + 1 < A.Ny ? s_Vd[i + kP] : 0.0f;
      const float div = (((s_Ud[i + 1] - U[c]) + Vn) - V[c]) * rz[c];
      e[c] = e[c] - A.dtau * div;
      s_eta[i] = e[c];
    }
    __syncthreads();
    const float w = A.w[m];
#pragma unroll
    for (int c = 0; c < kCY; ++c) {
      const int i = (ty + c * kBY + 1) * kP + tx + 1;
      const float es = gy[c] > 0 ? s_eta[i - kP] : e[c];  // mirror at y = 0
      U[c] = (U[c] - gu[c] * (e[c] - s_eta[i - 1])) + fu[c];
      V[c] = (V[c] - gv[c] * (e[c] - es)) + fv[c];
      if (MASK) {
        U[c] = U[c] * mu[c];
        V[c] = V[c] * mv[c];
      }
      pe[c] = pe[c] + w * e[c];
      pU[c] = pU[c] + w * U[c];
      pV[c] = pV[c] + w * V[c];
      s_Ud[i] = U[c];
      s_Vd[i] = V[c];
    }
    __syncthreads();
  }

#pragma unroll
  for (int c = 0; c < kCY; ++c) {
    if (!own[c]) continue;
    A.eta_o[o[c]] = e[c];
    A.Ud_o[o[c]] = U[c];
    A.Vd_o[o[c]] = V[c];
    A.pe[o[c]] = pe[c];
    A.pU[o[c]] = pU[c];
    A.pV[o[c]] = pV[c];
  }
}

}  // namespace

extern "C" const char* gb25_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// n substeps (1 <= n <= kS) from (eta, Ud, Vd) into (eta_o, Ud_o, Vd_o);
// first: the accumulators start from 0, else they are read and added to.
extern "C" int k2_blocked_f32(const float* eta, const float* Ud, const float* Vd, float* eta_o,
                              float* Ud_o, float* Vd_o, const float* gu, const float* gv,
                              const float* fu, const float* fv, const float* raz,
                              const float* mu, const float* mv, float* pe, float* pU, float* pV,
                              const float* w, float dtau, int n, int first, int Nx, int Ny,
                              void* stream) {
  if ((mu == nullptr) != (mv == nullptr) || n < 1 || n > kS || Nx < 1 || Ny < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args A{eta, Ud, Vd, eta_o, Ud_o, Vd_o, gu, gv, fu, fv, raz, mu, mv, pe, pU, pV, dtau};
  for (int m = 0; m < kS; ++m) A.w[m] = m < n ? w[m] : 0.0f;
  A.n = n;
  A.first = first;
  A.Nx = Nx;
  A.Ny = Ny;
  const int tx_n = kSX - 2 * n, ty_n = kSY - 2 * n;
  const dim3 grid((Nx + tx_n - 1) / tx_n, (Ny + ty_n - 1) / ty_n, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mu != nullptr) {
    cudaFuncSetAttribute(loop_blocked<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    loop_blocked<true><<<grid, dim3(kSX, kBY, 1), kSmem, s>>>(A);
  } else {
    cudaFuncSetAttribute(loop_blocked<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    loop_blocked<false><<<grid, dim3(kSX, kBY, 1), kSmem, s>>>(A);
  }
  return static_cast<int>(cudaGetLastError());
}

// substeps a launch at most
extern "C" int k2_blocked_info(int* out) {
  out[0] = kS;
  return 0;
}
