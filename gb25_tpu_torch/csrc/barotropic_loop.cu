// One forward-backward substep of the split-explicit barotropic solve, with
// the filtered (parabolic-weighted) accumulators updated in place.
//
// Replaces: gb25_tpu/ops/pallas_barotropic.py::pallas_barotropic_loop (the
// whole-loop VMEM kernel, pallas_call at :262) on the flat lat-lon grid:
// x periodic, eta mirrored at the y walls (detay = 0 on row 0), no flux
// through the north wall face (Vd[Ny] = 0). No fold row, no masks.
//
// What bounds it on an H100: device memory and launch latency. The TPU
// kernel keeps all 30 substeps resident in VMEM; here the working set is
// ~14 planes x 4.7 MB = ~66 MB at 1536x768 f32, more than the 50 MB L2, so
// each substep streams its planes from device memory (~10 planes read, 6
// written: ~75 MB, ~22 us at 3.35 TB/s), and 30 launches per model step
// add their own overhead.
//
// Design: one launch per substep, one thread per cell, threads along x,
// ping-pong buffers for (eta, Ud = U dyc, Vd = V dxf). A thread computes
// the new eta at its own cell and at the cells to its west and south (the
// pressure-gradient update reads those), so a substep needs no grid-wide
// synchronisation: it reads only the previous substep's buffers. Each
// accumulator element belongs to one thread. The substep weight and dtau
// are kernel arguments. A CUDA graph of the 30 launches and temporal
// blocking (several substeps per launch on a tile with an apron) are the
// next steps.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

struct Args {
  const float *eta, *Ud, *Vd;          // (Ny, Nx) state before the substep
  float *eta_o, *Ud_o, *Vd_o;          // (Ny, Nx) state after it
  const float *gHuW, *gHvW, *GUd, *GVd;  // (Ny, Nx) planes, dtau folded in
  const float* r_azc;                  // (Ny) 1 / cell area
  float *eta_b, *U_b, *V_b;            // (Ny, Nx) filtered accumulators
  float dtau, wm;
  int Nx, Ny;
};

// continuity: eta - dtau * div(Ud, Vd) at (y, x); Vd above the top row is 0
__device__ __forceinline__ float eta_new(const Args& A, int y, int x) {
  const size_t o = (size_t)y * A.Nx + x;
  const int xp = (x + 1 == A.Nx) ? 0 : x + 1;
  const float vup = (y + 1 < A.Ny) ? __ldg(A.Vd + o + A.Nx) : 0.0f;
  const float div =
      (((__ldg(A.Ud + (size_t)y * A.Nx + xp) - __ldg(A.Ud + o)) + vup) - __ldg(A.Vd + o)) *
      __ldg(A.r_azc + y);
  return __ldg(A.eta + o) - A.dtau * div;
}

__global__ void __launch_bounds__(256) barotropic_substep_kernel(const Args A) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= A.Nx || y >= A.Ny) return;
  const size_t o = (size_t)y * A.Nx + x;
  const int xm = (x == 0) ? A.Nx - 1 : x - 1;

  const float e = eta_new(A, y, x);
  const float e_w = eta_new(A, y, xm);
  const float e_s = (y > 0) ? eta_new(A, y - 1, x) : e;  // mirror: detay = 0 on row 0

  const float Ud = (__ldg(A.Ud + o) - __ldg(A.gHuW + o) * (e - e_w)) + __ldg(A.GUd + o);
  const float Vd = (__ldg(A.Vd + o) - __ldg(A.gHvW + o) * (e - e_s)) + __ldg(A.GVd + o);

  A.eta_o[o] = e;
  A.Ud_o[o] = Ud;
  A.Vd_o[o] = Vd;
  A.eta_b[o] += A.wm * e;
  A.U_b[o] += A.wm * Ud;
  A.V_b[o] += A.wm * Vd;
}

}  // namespace

extern "C" const char* gb25_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int barotropic_substep_f32(const float* eta, const float* Ud, const float* Vd,
                                      float* eta_o, float* Ud_o, float* Vd_o,
                                      const float* gHuW, const float* gHvW, const float* GUd,
                                      const float* GVd, const float* r_azc, float* eta_b,
                                      float* U_b, float* V_b, float dtau, float wm, int Nx,
                                      int Ny, void* stream) {
  Args A{eta, Ud, Vd, eta_o, Ud_o, Vd_o, gHuW, gHvW, GUd, GVd, r_azc,
         eta_b, U_b, V_b, dtau, wm, Nx, Ny};
  dim3 block(256, 1, 1);
  dim3 grid((Nx + 255) / 256, Ny, 1);
  barotropic_substep_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(A);
  return static_cast<int>(cudaGetLastError());
}
