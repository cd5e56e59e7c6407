// Up to kS forward-backward substeps of the blocked barotropic solve per
// launch on width-W extended planes, with this block's weighted partial
// accumulators.
//
// Replaces: gb25_tpu/ops/pallas_barotropic.py::pallas_barotropic_block
// (pallas_call at :442), the decomposed path's kernel: len(weights)
// substeps on (Ye, Xe) = (Ny + 2W, Nx + 2W) planes, one exchange block. Per
// substep, with every shift wrapping within the extended plane:
//   Ud = U au, Vd = V av
//   eta -= ((Ud[x+1] - Ud) + Vd[y+1] - Vd) rz
//   U = U - pu (eta - eta[x-1]) + fu,  V = V - pv (eta - eta[y-1]) + fv
//   U, V *= mu, mv (immersed grids)
//   pe, pU, pV += w (eta, U, V)
// The kernel knows no boundary: walls, neighbours and the fold enter
// through the exchanged ghosts, and the wrapped outer rings carry garbage
// that moves one ring inward per substep (the caller crops W rings after
// W substeps). au = dyc, av = dxf and rz = dtau / azc are (Ye) columns on
// lat-lon grids and (Ye, Xe) planes on the tripolar grid; pu, pv, fu, fv
// carry dtau.
//
// What bounds it on an H100: device memory. At the decomposed 1x1 climate
// shape (828 x 1596, W = 30) a plane is 5.3 MB; a substep reads ~12 planes
// and writes 6 (~95 MB, more than the 50 MB L2), so one launch a substep
// streams every plane 30 times a block.
//
// Design: temporal blocking, the Hopper form of the Pallas kernel's planes
// kept in VMEM for a whole block. One launch advances n <= kS substeps on
// a staged tile of kSX x kSY cells: an interior of (kSX - 2n) x (kSY - 2n)
// cells with an n-wide apron on every side, loaded with the plane's
// wrapped indexing (mod Ye, Xe, as torch.roll in the plain version). One
// substep's dependence radius is 1 (U(y, x) reads eta(y, x-1), which reads
// V(y+1, x-1)), so after n substeps every cell of the tile's interior
// depends only on its wrapped radius-n neighbourhood, which the tile holds
// exactly: the interior is bit for bit the plain version's on the whole
// extended plane, the garbage rings included, for planes of any size (a
// plane smaller than the tile wraps into it more than once). Each thread owns one staged column and kCY rows of the tile
// and keeps their eta, U, V, accumulators and constants (pu, pv, fu, fv,
// au, av, rz, masks) in registers across the substeps; shared memory holds
// only what neighbours read: Ud and Vd (continuity reads them east and
// north) and the new eta (momentum reads it west and south), with a zero
// pad ring so that every staged cell runs the same code (the cells next to
// the pad turn to garbage, which stays inside the apron). A substep is two
// phases between barriers: continuity, each cell's eta once; momentum and
// the masks, then the accumulators and the new Ud, Vd. The first launch
// of a block starts the accumulators from 0, as the plain version's zeros
// + w x does; a later one reads them and goes on adding in substep order.
// Only the interior is written. The operations are those of
// barotropic_block_plain in its order, built with -fmad=false, so the two
// agree bit for bit.
//
// kS = 6 on a 32 x 32 staged tile (256 threads, ~127 registers, 2 blocks
// an SM) won a side-by-side timing of kS = 3 to 10 on 32 x 32, 64 x 32 and
// 64 x 64 staged tiles (solver_variants.py; PERF.md, section 6), summed
// over the main paths' blocks: apron work grows as kSX kSY / ((kSX - 2
// kS)(kSY - 2 kS)) while the launches of a W = 30 block fall as 1 / kS
// (there 64 x 32 was 0.5-2.5% faster); a launch of fewer substeps (the K6
// route's blocks of 4 and 2) takes the narrower apron its substeps need,
// so its interior is wider, and there 32 x 32's two blocks an SM ran ~7%
// faster.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int kS = 6;          // substeps a launch at most, the widest apron
constexpr int kSX = 32;        // staged columns: threads in x
constexpr int kBY = 8;         // threads in y
constexpr int kCY = 4;         // staged rows per thread
constexpr int kSY = kBY * kCY;               // staged rows
constexpr int kThreads = kSX * kBY;
constexpr int kP = kSX + 2;                  // row stride of a padded plane
constexpr int kPlane = kP * (kSY + 2);       // floats of a padded plane
constexpr size_t kSmem = 3 * kPlane * sizeof(float);
static_assert(kSX > 2 * kS && kSY > 2 * kS && kSX % 32 == 0, "tile too small for its apron");

struct Args {
  const float *eta, *U, *V;        // (Ye, Xe) state before the launch
  float *eta_o, *U_o, *V_o;        // (Ye, Xe) state after it
  const float *pu, *pv, *fu, *fv;  // (Ye, Xe) constant planes, dtau folded in
  const float *au, *av, *rz;       // (Ye) columns, or (Ye, Xe) planes
  const float *mu, *mv;            // (Ye, Xe) solid-face masks, or null
  float *pe, *pU, *pV;             // (Ye, Xe) partial accumulators
  float w[kS];                     // this launch's filter weights
  int n;                           // substeps of this launch, 1..kS: the apron
  int first;                       // 1: the accumulators start from 0
  int Xe, Ye;
};

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

template <bool MASK, bool M2>
__global__ void __launch_bounds__(kThreads) barotropic_block_kernel(const Args A) {
  extern __shared__ float smem[];
  float* s_eta = smem;  // staged cell (ly, lx) at (ly + 1) kP + lx + 1
  float* s_Ud = smem + kPlane;
  float* s_Vd = smem + 2 * kPlane;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int n = A.n, tx_n = kSX - 2 * n, ty_n = kSY - 2 * n;  // apron, interior
  const int x0 = blockIdx.x * tx_n, y0 = blockIdx.y * ty_n;

  // the pad ring: rows -1 and kSY, columns -1 and kSX
  for (int t = ty * kSX + tx; t < 2 * kP + 2 * kSY; t += kThreads) {
    const int p = t < kP ? t : t < 2 * kP ? (kSY + 1) * kP + t - kP
                                          : (t - 2 * kP) / 2 * kP + kP + ((t & 1) ? kSX + 1 : 0);
    s_eta[p] = 0.0f;
    s_Ud[p] = 0.0f;
    s_Vd[p] = 0.0f;
  }

  const int gx = wrap(x0 - n + tx, A.Xe);
  const bool own_x = tx >= n && tx < n + tx_n && x0 + tx - n < A.Xe;
  float e[kCY], U[kCY], V[kCY], pe[kCY], pU[kCY], pV[kCY];
  float pu[kCY], pv[kCY], fu[kCY], fv[kCY], au[kCY], av[kCY], rz[kCY], mu[kCY], mv[kCY];
  size_t o[kCY];
  bool own[kCY];
#pragma unroll
  for (int c = 0; c < kCY; ++c) {
    const int ly = ty + c * kBY;
    const int gy = wrap(y0 - n + ly, A.Ye);
    o[c] = (size_t)gy * A.Xe + gx;
    own[c] = own_x && ly >= n && ly < n + ty_n && y0 + ly - n < A.Ye;
    e[c] = __ldg(A.eta + o[c]);
    U[c] = __ldg(A.U + o[c]);
    V[c] = __ldg(A.V + o[c]);
    pu[c] = __ldg(A.pu + o[c]);
    pv[c] = __ldg(A.pv + o[c]);
    fu[c] = __ldg(A.fu + o[c]);
    fv[c] = __ldg(A.fv + o[c]);
    const size_t om = M2 ? o[c] : (size_t)gy;
    au[c] = __ldg(A.au + om);
    av[c] = __ldg(A.av + om);
    rz[c] = __ldg(A.rz + om);
    if (MASK) {
      mu[c] = __ldg(A.mu + o[c]);
      mv[c] = __ldg(A.mv + o[c]);
    }
    const bool carry = own[c] && !A.first;
    pe[c] = carry ? A.pe[o[c]] : 0.0f;
    pU[c] = carry ? A.pU[o[c]] : 0.0f;
    pV[c] = carry ? A.pV[o[c]] : 0.0f;
    const int i = (ly + 1) * kP + tx + 1;
    s_Ud[i] = U[c] * au[c];
    s_Vd[i] = V[c] * av[c];
  }
  __syncthreads();

#pragma unroll
  for (int m = 0; m < kS; ++m) {
    if (m == n) break;
    // continuity: eta once a cell, from the Ud, Vd of the cell and of its
    // east and north neighbours
#pragma unroll
    for (int c = 0; c < kCY; ++c) {
      const int i = (ty + c * kBY + 1) * kP + tx + 1;
      const float div = (((s_Ud[i + 1] - s_Ud[i]) + s_Vd[i + kP]) - s_Vd[i]) * rz[c];
      e[c] = e[c] - div;
      s_eta[i] = e[c];
    }
    __syncthreads();
    // momentum from the new eta of the cell and of its west and south
    // neighbours, the masks, the accumulators, the new Ud, Vd
    const float w = A.w[m];
#pragma unroll
    for (int c = 0; c < kCY; ++c) {
      const int i = (ty + c * kBY + 1) * kP + tx + 1;
      U[c] = (U[c] - pu[c] * (e[c] - s_eta[i - 1])) + fu[c];
      V[c] = (V[c] - pv[c] * (e[c] - s_eta[i - kP])) + fv[c];
      if (MASK) {
        U[c] = U[c] * mu[c];
        V[c] = V[c] * mv[c];
      }
      pe[c] = pe[c] + w * e[c];
      pU[c] = pU[c] + w * U[c];
      pV[c] = pV[c] + w * V[c];
      s_Ud[i] = U[c] * au[c];
      s_Vd[i] = V[c] * av[c];
    }
    __syncthreads();
  }

#pragma unroll
  for (int c = 0; c < kCY; ++c) {
    if (!own[c]) continue;
    A.eta_o[o[c]] = e[c];
    A.U_o[o[c]] = U[c];
    A.V_o[o[c]] = V[c];
    A.pe[o[c]] = pe[c];
    A.pU[o[c]] = pU[c];
    A.pV[o[c]] = pV[c];
  }
}

// Let the kernel take kSmem bytes of dynamic shared memory (above 48 KB
// only after this attribute is set).
template <class Kernel>
cudaError_t allow_shared(Kernel kernel) {
  if (kSmem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kSmem));
}

template <bool MASK, bool M2>
cudaError_t launch(const Args& A, cudaStream_t s) {
  const cudaError_t err = allow_shared(barotropic_block_kernel<MASK, M2>);
  if (err != cudaSuccess) return err;
  const int tx_n = kSX - 2 * A.n, ty_n = kSY - 2 * A.n;
  const dim3 grid((A.Xe + tx_n - 1) / tx_n, (A.Ye + ty_n - 1) / ty_n, 1);
  barotropic_block_kernel<MASK, M2><<<grid, dim3(kSX, kBY, 1), kSmem, s>>>(A);
  return cudaGetLastError();
}

// registers per thread, shared memory per block (bytes), the interior
// tile's columns and rows at kS substeps, blocks one SM holds at once, kS
template <bool MASK, bool M2>
cudaError_t info(int* out) {
  const auto kernel = barotropic_block_kernel<MASK, M2>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) err = allow_shared(kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], kernel, kThreads, kSmem);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(kSmem + attr.sharedSizeBytes);
  out[2] = kSX - 2 * kS;
  out[3] = kSY - 2 * kS;
  out[5] = kS;
  return err;
}

}  // namespace

extern "C" const char* gb25_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// n substeps (1 <= n <= kS, weights w[0..n)) from (eta, U, V) into (eta_o,
// U_o, V_o), which must not alias them; first: the accumulators start from
// 0, else they are read and added to in place. metric2d: au, av, rz are
// (Ye, Xe) planes (the tripolar grid), else (Ye) columns. mu and mv are
// both null or both set.
extern "C" int barotropic_block_f32(const float* eta, const float* U, const float* V,
                                    float* eta_o, float* U_o, float* V_o, const float* pu,
                                    const float* pv, const float* fu, const float* fv,
                                    const float* au, const float* av, const float* rz,
                                    const float* mu, const float* mv, float* pe, float* pU,
                                    float* pV, const float* w, int n, int first, int Xe, int Ye,
                                    int metric2d, void* stream) {
  if ((mu == nullptr) != (mv == nullptr) || Xe < 1 || Ye < 1 || n < 1 || n > kS)
    return static_cast<int>(cudaErrorInvalidValue);
  Args A{eta, U, V, eta_o, U_o, V_o, pu, pv, fu, fv, au, av, rz, mu, mv, pe, pU, pV};
  for (int m = 0; m < kS; ++m) A.w[m] = m < n ? w[m] : 0.0f;
  A.n = n;
  A.first = first;
  A.Xe = Xe;
  A.Ye = Ye;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (mu != nullptr && metric2d)
    err = launch<true, true>(A, s);
  else if (mu != nullptr)
    err = launch<true, false>(A, s);
  else if (metric2d)
    err = launch<false, true>(A, s);
  else
    err = launch<false, false>(A, s);
  return static_cast<int>(err);
}

// The launch shape of the instance with or without masks and metric
// planes, into out[0..6) (see info).
extern "C" int barotropic_block_info(int masked, int metric2d, int* out) {
  cudaError_t err;
  if (masked && metric2d)
    err = info<true, true>(out);
  else if (masked)
    err = info<true, false>(out);
  else if (metric2d)
    err = info<false, true>(out);
  else
    err = info<false, false>(out);
  return static_cast<int>(err);
}
