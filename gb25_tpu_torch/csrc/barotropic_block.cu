// One forward-backward substep of the blocked barotropic solve on width-W
// extended planes, with this block's weighted partial accumulators updated
// in place.
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
// What bounds it on an H100: device memory and launch latency. At the
// decomposed 1x1 climate shape (828 x 1596, W = 30) a plane is 5.3 MB and a
// substep reads ~12 planes and writes 6 (~95 MB, ~28 us at 3.35 TB/s): more
// than the 50 MB L2, so each substep streams its planes, and 30 launches a
// step add their own cost.
//
// Design (the simple one; temporal blocking of W substeps per launch on a
// shared-memory tile with a W-wide apron is the next step): one launch per
// substep, one thread per cell, threads along x, ping-pong buffers for
// (eta, U, V). A thread computes the new eta at its own cell and at its
// west and south neighbours (wrapped), which the momentum update reads, so
// a substep reads only the previous substep's buffers. The accumulators
// are updated in place, each element by one thread. The operations are
// those of barotropic_block_plain in its order, built with -fmad=false, so
// the two agree bit for bit.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

struct Args {
  const float *eta, *U, *V;        // (Ye, Xe) state before the substep
  float *eta_o, *U_o, *V_o;        // (Ye, Xe) state after it
  const float *pu, *pv, *fu, *fv;  // (Ye, Xe) constant planes, dtau folded in
  const float *au, *av, *rz;       // (Ye) columns, or (Ye, Xe) planes
  const float *mu, *mv;            // (Ye, Xe) solid-face masks, or null
  float *pe, *pU, *pV;             // (Ye, Xe) partial accumulators
  float w;                         // this substep's filter weight
  int Xe, Ye;
};

// a metric at row y, offset o: a column entry or a plane entry
template <bool M2>
__device__ __forceinline__ float met(const float* m, int y, size_t o) {
  return M2 ? __ldg(m + o) : __ldg(m + y);
}

// continuity at (y, x): eta - ((Ud[x+1] - Ud) + Vd[y+1] - Vd) rz, wrapped
template <bool M2>
__device__ __forceinline__ float eta_new(const Args& A, int y, int x) {
  const size_t o = (size_t)y * A.Xe + x;
  const int xp = (x + 1 == A.Xe) ? 0 : x + 1;
  const int yp = (y + 1 == A.Ye) ? 0 : y + 1;
  const size_t oe = (size_t)y * A.Xe + xp;
  const size_t on = (size_t)yp * A.Xe + x;
  const float Ud = __ldg(A.U + o) * met<M2>(A.au, y, o);
  const float Ud_e = __ldg(A.U + oe) * met<M2>(A.au, y, oe);
  const float Vd = __ldg(A.V + o) * met<M2>(A.av, y, o);
  const float Vd_n = __ldg(A.V + on) * met<M2>(A.av, yp, on);
  const float div = (((Ud_e - Ud) + Vd_n) - Vd) * met<M2>(A.rz, y, o);
  return __ldg(A.eta + o) - div;
}

template <bool MASK, bool M2>
__global__ void __launch_bounds__(256) barotropic_block_kernel(const Args A) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= A.Xe || y >= A.Ye) return;
  const size_t o = (size_t)y * A.Xe + x;
  const int xm = (x == 0) ? A.Xe - 1 : x - 1;
  const int ym = (y == 0) ? A.Ye - 1 : y - 1;

  const float e = eta_new<M2>(A, y, x);
  const float e_w = eta_new<M2>(A, y, xm);
  const float e_s = eta_new<M2>(A, ym, x);

  float U = (__ldg(A.U + o) - __ldg(A.pu + o) * (e - e_w)) + __ldg(A.fu + o);
  float V = (__ldg(A.V + o) - __ldg(A.pv + o) * (e - e_s)) + __ldg(A.fv + o);
  if (MASK) {
    U = U * __ldg(A.mu + o);
    V = V * __ldg(A.mv + o);
  }

  A.eta_o[o] = e;
  A.U_o[o] = U;
  A.V_o[o] = V;
  A.pe[o] = A.pe[o] + A.w * e;
  A.pU[o] = A.pU[o] + A.w * U;
  A.pV[o] = A.pV[o] + A.w * V;
}

}  // namespace

extern "C" const char* gb25_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// metric2d: au, av, rz are (Ye, Xe) planes (the tripolar grid), else (Ye)
// columns. mu and mv are both null or both set.
extern "C" int barotropic_block_substep_f32(const float* eta, const float* U, const float* V,
                                            float* eta_o, float* U_o, float* V_o,
                                            const float* pu, const float* pv, const float* fu,
                                            const float* fv, const float* au, const float* av,
                                            const float* rz, const float* mu, const float* mv,
                                            float* pe, float* pU, float* pV, float w, int Xe,
                                            int Ye, int metric2d, void* stream) {
  if ((mu == nullptr) != (mv == nullptr) || Xe < 1 || Ye < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args A{eta, U, V, eta_o, U_o, V_o, pu, pv, fu, fv, au, av, rz, mu, mv, pe, pU, pV, w, Xe, Ye};
  dim3 block(256, 1, 1);
  dim3 grid((Xe + 255) / 256, Ye, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mu != nullptr && metric2d)
    barotropic_block_kernel<true, true><<<grid, block, 0, s>>>(A);
  else if (mu != nullptr)
    barotropic_block_kernel<true, false><<<grid, block, 0, s>>>(A);
  else if (metric2d)
    barotropic_block_kernel<false, true><<<grid, block, 0, s>>>(A);
  else
    barotropic_block_kernel<false, false><<<grid, block, 0, s>>>(A);
  return static_cast<int>(cudaGetLastError());
}
