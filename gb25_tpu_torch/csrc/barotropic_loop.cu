// One forward-backward substep of the split-explicit barotropic solve, with
// the filtered (parabolic-weighted) accumulators updated in place.
//
// Replaces: gb25_tpu/ops/pallas_barotropic.py::pallas_barotropic_loop (the
// whole-loop VMEM kernel, pallas_call at :262): x periodic, eta mirrored at
// the south wall (detay = 0 on row 0), no flux through the north wall face
// (Vd[Ny] = 0). On immersed grids two optional solid-face mask planes
// multiply Ud and Vd after every substep's update (no transport through
// coastlines). On the tripolar grid the flux above the seam row is the
// fold's ghost, -Vd[Ny-1, (2p - x) mod Nx] (the JAX kernel's permutation
// matmul, :213-221), and 1 / cell area is a (Ny, Nx) plane.
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
// synchronisation: it reads only the previous substep's buffers, the fold
// row included. Each accumulator element belongs to one thread. The
// substep weight and dtau are kernel arguments; the masked and the tripolar
// variants are template instances, so the flat-grid instance computes
// exactly what it did before either existed.
// A CUDA graph of the 30 launches and temporal
// blocking (several substeps per launch on a tile with an apron) are the
// next steps.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

struct Args {
  const float *eta, *Ud, *Vd;          // (Ny, Nx) state before the substep
  float *eta_o, *Ud_o, *Vd_o;          // (Ny, Nx) state after it
  const float *gHuW, *gHvW, *GUd, *GVd;  // (Ny, Nx) planes, dtau folded in
  const float* r_azc;                  // (Ny) 1 / cell area; (Ny, Nx) on the tripolar grid
  const float *mu, *mv;                // (Ny, Nx) solid-face masks (immersed) or null
  float *eta_b, *U_b, *V_b;            // (Ny, Nx) filtered accumulators
  float dtau, wm;
  int Nx, Ny;
  int pole;                            // fold column p of the tripolar grid
};

// The flux through the top face of the seam row: the fold's ghost,
// -Vd[Ny-1, (2p - x) mod Nx], from the substep's input.
__device__ __forceinline__ float fold_flux(const Args& A, int x) {
  int xf = 2 * A.pole - x;
  if (xf < 0) xf += A.Nx;
  if (xf >= A.Nx) xf -= A.Nx;
  return -__ldg(A.Vd + (size_t)(A.Ny - 1) * A.Nx + xf);
}

// continuity: eta - dtau * div(Ud, Vd) at (y, x); Vd above the top row is 0,
// or the fold's ghost on the tripolar grid
template <bool TRIPOLAR>
__device__ __forceinline__ float eta_new(const Args& A, int y, int x) {
  const size_t o = (size_t)y * A.Nx + x;
  const int xp = (x + 1 == A.Nx) ? 0 : x + 1;
  float vup;
  if (y + 1 < A.Ny)
    vup = __ldg(A.Vd + o + A.Nx);
  else
    vup = TRIPOLAR ? fold_flux(A, x) : 0.0f;
  const float div =
      (((__ldg(A.Ud + (size_t)y * A.Nx + xp) - __ldg(A.Ud + o)) + vup) - __ldg(A.Vd + o)) *
      __ldg(A.r_azc + (TRIPOLAR ? o : (size_t)y));
  return __ldg(A.eta + o) - A.dtau * div;
}

template <bool MASK, bool TRIPOLAR>
__global__ void __launch_bounds__(256) barotropic_substep_kernel(const Args A) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= A.Nx || y >= A.Ny) return;
  const size_t o = (size_t)y * A.Nx + x;
  const int xm = (x == 0) ? A.Nx - 1 : x - 1;

  const float e = eta_new<TRIPOLAR>(A, y, x);
  const float e_w = eta_new<TRIPOLAR>(A, y, xm);
  const float e_s = (y > 0) ? eta_new<TRIPOLAR>(A, y - 1, x) : e;  // mirror: detay = 0 on row 0

  float Ud = (__ldg(A.Ud + o) - __ldg(A.gHuW + o) * (e - e_w)) + __ldg(A.GUd + o);
  float Vd = (__ldg(A.Vd + o) - __ldg(A.gHvW + o) * (e - e_s)) + __ldg(A.GVd + o);
  if (MASK) {
    Ud = Ud * __ldg(A.mu + o);
    Vd = Vd * __ldg(A.mv + o);
  }

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

// pole < 0: the lat-lon instance (r_azc an (Ny) profile); pole >= 0: the
// tripolar instance, folding about column pole (r_azc an (Ny, Nx) plane).
extern "C" int barotropic_substep_f32(const float* eta, const float* Ud, const float* Vd,
                                      float* eta_o, float* Ud_o, float* Vd_o,
                                      const float* gHuW, const float* gHvW, const float* GUd,
                                      const float* GVd, const float* r_azc, const float* mu,
                                      const float* mv, float* eta_b, float* U_b, float* V_b,
                                      float dtau, float wm, int Nx, int Ny, int pole,
                                      void* stream) {
  if ((mu == nullptr) != (mv == nullptr) || pole >= Nx)
    return static_cast<int>(cudaErrorInvalidValue);
  Args A{eta, Ud, Vd, eta_o, Ud_o, Vd_o, gHuW, gHvW, GUd, GVd, r_azc, mu, mv,
         eta_b, U_b, V_b, dtau, wm, Nx, Ny, pole};
  dim3 block(256, 1, 1);
  dim3 grid((Nx + 255) / 256, Ny, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tripolar = pole >= 0;
  if (mu != nullptr && tripolar)
    barotropic_substep_kernel<true, true><<<grid, block, 0, s>>>(A);
  else if (mu != nullptr)
    barotropic_substep_kernel<true, false><<<grid, block, 0, s>>>(A);
  else if (tripolar)
    barotropic_substep_kernel<false, true><<<grid, block, 0, s>>>(A);
  else
    barotropic_substep_kernel<false, false><<<grid, block, 0, s>>>(A);
  return static_cast<int>(cudaGetLastError());
}
