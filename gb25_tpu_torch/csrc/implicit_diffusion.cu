// Backward-Euler vertical diffusion, one tridiagonal (Thomas) solve per
// water column, for one or two right-hand sides that share the diffusivity
// and an optional linear decay rate:
//   (1 + dt damp_k + lam_k + mu_k) x_k - lam_k x_{k-1} - mu_k x_{k+1} = f_k,
//   lam_k = kappa_k (dt c_lam_k), mu_k = kappa_{k+1} (dt c_mu_k),
// with c_lam_0 = 0 (no flux through the sea floor) and c_mu_{Nz-1} = 0 (no
// flux through the surface). kappa is a (Nz, Ny, Nx) field (the CATKE and
// k-epsilon closures') or one constant (VerticalScalarDiffusivity's nu or
// kappa: the constant-kappa instances read no kappa field).
//
// Replaces: gb25_tpu/ops/pallas_tridiag.py::pallas_implicit_diffusion
// (pallas_call at :192).
//
// What bounds it on an H100: device memory. One pass reads the fields,
// kappa and the damping and writes the solutions: 5 (u, v), 5 (T, S) and 4
// (e with damping) interior fields of 302 MB at 1536x768x64 f32, ~0.45 ms
// each at 3.35 TB/s; 4 for a pair with a constant kappa (~0.36 ms); ~10
// flop per level and field.
//
// Design: one thread per (x, y) column, a warp per 32 neighbouring columns
// along x (kWarps warps a block, each on its own), so each level of every
// (Z, Y, X) operand is one coalesced row. Each byte crosses device memory
// once. The forward sweep keeps the elimination coefficients cp and the
// intermediates dp of every level in shared memory, laid out
// [level][column] so that a warp's accesses never share a bank; the back
// substitution reads them from there and writes each solution once. That
// shared memory (Nz (1 + nf) floats a column) leaves room for ~300
// columns an SM, too few threads to cover the memory's latency one level
// at a time, and loads into registers stall on the little L1 it leaves: so
// the warp stages each level's operands (f, the damping, kappa one level
// up) by cp.async into a ring of kStages levels in shared memory, kStages
// levels ahead of the level it eliminates (16-byte copies where the rows
// allow, 4-byte ones otherwise). Only __syncwarp orders a warp's copies
// and reads. The right-hand sides share cp, as in the Pallas kernel. The
// coefficient arithmetic follows the Pallas kernel's order (lam = kappa (dt
// c_lam), inv = 1 / (b + lam cp_prev), a true division), and the file is
// built with -fmad=false so the plain version (ops/pallas_tridiag.py)
// rounds the same way: the two agree bit for bit.
//
// kWarps and kStages won a side-by-side timing of 32, 64 and 128 columns a
// block and 2 to 16 levels in flight on the three kinds of solve
// (solver_variants.py; PERF.md, section 6).

#include <cuda_runtime.h>
#include <cstddef>

#include "cp_async.cuh"

namespace {

constexpr int kMaxNz = 128;
constexpr int kWarps = 1;        // warps a block, 32 columns each
constexpr int kStages = 8;       // levels in flight: the ring's slots
constexpr int kCols = 32 * kWarps;

struct Args {
  const float *f0, *f1, *kap, *damp;  // (Nz, Ny, Nx); f1, damp may be null; kap null: kc
  const float *a_lam, *a_mu;          // (Nz) dt c_lam, dt c_mu
  float *x0, *x1;                     // (Nz, Ny, Nx) solutions
  float dt;
  int Nx, Ny, Nz;
  int vec;                            // 1: rows staged in 16-byte copies
  float kc;                           // the constant kappa (kap null)
};

// The operands of one level: f0, f1 (NF == 2), the damping (DAMP) at the
// level and, unless kappa is constant (KC), kappa one level up.
template <int NF, bool DAMP, bool KC>
constexpr int kOpsOf = NF + (DAMP ? 1 : 0) + (KC ? 0 : 1);

// Floats of one warp's shared memory: cp and dp of every level, then the
// ring of kStages levels of operands, each [level][column].
template <int NF, bool DAMP, bool KC>
__host__ __device__ __forceinline__ int warp_floats(int Nz) {
  return 32 * (Nz * (1 + NF) + kStages * kOpsOf<NF, DAMP, KC>);
}

template <int NF, bool DAMP, bool KC>
size_t smem_bytes(int Nz) {
  return sizeof(float) * kWarps * warp_floats<NF, DAMP, KC>(Nz);
}

// Operand op of a level (see kOpsOf), at level 0.
template <int NF, bool DAMP>
__device__ __forceinline__ const float* operand(const Args& A, int op, size_t plane) {
  if (op == 0) return A.f0;
  if (NF == 2 && op == 1) return A.f1;
  if (DAMP && op == NF) return A.damp;
  return A.kap + plane;  // kappa one level up
}

// One warp starts the copies of level k's operands for its 32 columns
// (from column i0) into a slot of the ring (ops x 32 floats): with 16-byte
// copies lane l takes operand l / 8, columns i0 + 4 (l % 8) ..+3; else
// every lane its own column of each operand.
template <int NF, bool DAMP, bool KC>
__device__ __forceinline__ void stage_level(const Args& A, float* slot, int k, size_t row,
                                            int i0, int lane) {
  constexpr int kOps = kOpsOf<NF, DAMP, KC>;
  const size_t plane = (size_t)A.Ny * A.Nx;
  const size_t o = (size_t)k * plane + row + i0;
  const bool up = KC || k + 1 < A.Nz;  // no kappa operand, or kappa one level up exists
  if (A.vec) {
    const int op = lane / 8, c = 4 * (lane % 8);
    if (op < kOps && i0 + c < A.Nx && (up || op < kOps - 1))
      cp_async16(slot + 32 * op + c, operand<NF, DAMP>(A, op, plane) + o + c);
  } else if (i0 + lane < A.Nx) {
#pragma unroll
    for (int op = 0; op < kOps; ++op)
      if (up || op < kOps - 1)
        cp_async4(slot + 32 * op + lane, operand<NF, DAMP>(A, op, plane) + o + lane);
  }
}

template <int NF, bool DAMP, bool KC>
__global__ void __launch_bounds__(kCols) implicit_diffusion_kernel(const Args A) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kOps = kOpsOf<NF, DAMP, KC>;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int i0 = blockIdx.x * kCols + 32 * warp;  // this warp's first column
  const int i = i0 + lane;
  const int Nz = A.Nz;
  const size_t plane = (size_t)A.Ny * A.Nx;
  const size_t row = (size_t)blockIdx.y * A.Nx;
  float* base = smem + warp * warp_floats<NF, DAMP, KC>(Nz);
  float* cp = base + lane;  // level k of this column at [32 k]
  float* dp0 = cp + 32 * Nz;
  float* dp1 = dp0 + 32 * Nz;
  float* ring = base + 32 * Nz * (1 + NF);  // slot s at [32 kOps s]

#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    if (s < Nz) stage_level<NF, DAMP, KC>(A, ring + 32 * kOps * s, s, row, i0, lane);
    cp_async_commit();
  }

  float cp_prev = 0.0f, d0 = 0.0f, d1 = 0.0f;
  float kap_k = KC ? A.kc : (i < A.Nx ? __ldg(A.kap + row + i) : 0.0f);
  for (int k = 0; k < Nz; ++k) {
    float* slot = ring + 32 * kOps * (k % kStages);
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const float f0 = slot[lane];
    const float f1 = NF == 2 ? slot[32 + lane] : 0.0f;
    const float dm = DAMP ? slot[32 * NF + lane] : 0.0f;
    const float kap_up = KC ? A.kc : slot[32 * (kOps - 1) + lane];
    __syncwarp();
    if (k + kStages < Nz) stage_level<NF, DAMP, KC>(A, slot, k + kStages, row, i0, lane);
    cp_async_commit();

    const float lam = kap_k * __ldg(A.a_lam + k);
    float mu = 0.0f;
    if (k + 1 < Nz) {
      mu = kap_up * __ldg(A.a_mu + k);
      kap_k = kap_up;
    }
    float b = 1.0f + lam + mu;
    if (DAMP) b = b + A.dt * dm;
    const float inv = 1.0f / (b + lam * cp_prev);
    cp_prev = -mu * inv;
    cp[32 * k] = cp_prev;
    d0 = (f0 + lam * d0) * inv;
    dp0[32 * k] = d0;
    if (NF == 2) {
      d1 = (f1 + lam * d1) * inv;
      dp1[32 * k] = d1;
    }
  }
  if (i >= A.Nx) return;

  float xn0 = 0.0f, xn1 = 0.0f;
  for (int k = Nz - 1; k >= 0; --k) {
    const size_t o = (size_t)k * plane + row + i;
    const float c = cp[32 * k];
    xn0 = dp0[32 * k] - c * xn0;
    A.x0[o] = xn0;
    if (NF == 2) {
      xn1 = dp1[32 * k] - c * xn1;
      A.x1[o] = xn1;
    }
  }
}

// Let the kernel take smem bytes of dynamic shared memory (above 48 KB only
// after this attribute is set).
template <class Kernel>
cudaError_t allow_shared(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int NF, bool DAMP, bool KC>
cudaError_t launch(const Args& A, cudaStream_t s) {
  const size_t smem = smem_bytes<NF, DAMP, KC>(A.Nz);
  const cudaError_t err = allow_shared(implicit_diffusion_kernel<NF, DAMP, KC>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((A.Nx + kCols - 1) / kCols, A.Ny, 1);
  implicit_diffusion_kernel<NF, DAMP, KC><<<grid, dim3(kCols, 1, 1), smem, s>>>(A);
  return cudaGetLastError();
}

// registers per thread, shared memory per block (bytes), columns a block,
// 1, blocks one SM holds at once, levels in flight
template <int NF, bool DAMP, bool KC>
cudaError_t info(int Nz, int* out) {
  const auto kernel = implicit_diffusion_kernel<NF, DAMP, KC>;
  const size_t smem = smem_bytes<NF, DAMP, KC>(Nz);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) err = allow_shared(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], kernel, kCols, smem);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(smem + attr.sharedSizeBytes);
  out[2] = kCols;
  out[3] = 1;
  out[5] = kStages;
  return err;
}

bool aligned16(const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; }

bool valid(int Nz, int nf) { return Nz >= 1 && Nz <= kMaxNz && nf >= 1 && nf <= 2; }

}  // namespace

extern "C" const char* gb25_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// nf = 1 or 2 right-hand sides; damp may be null (no decay term); kap
// null: kappa is the constant kc (the undamped pair's constant-kappa
// instance, VerticalScalarDiffusivity's solves). Nz must not exceed 128
// (checked here and by the Python wrapper).
extern "C" int implicit_diffusion_f32(const float* f0, const float* f1, const float* kap,
                                      const float* damp, const float* a_lam, const float* a_mu,
                                      float* x0, float* x1, float dt, float kc, int Nx, int Ny,
                                      int Nz, int nf, void* stream) {
  if (!valid(Nz, nf)) return static_cast<int>(cudaErrorInvalidValue);
  if (kap == nullptr && (nf != 2 || damp != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte copies need every row and operand 16-byte aligned
  const bool vec = Nx % 4 == 0 && aligned16(f0) && aligned16(f1) && aligned16(kap) &&
                   aligned16(damp);
  const Args A{f0, f1, kap, damp, a_lam, a_mu, x0, x1, dt, Nx, Ny, Nz, vec ? 1 : 0, kc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (kap == nullptr)
    err = launch<2, false, true>(A, s);
  else if (nf == 1 && damp == nullptr)
    err = launch<1, false, false>(A, s);
  else if (nf == 1)
    err = launch<1, true, false>(A, s);
  else if (damp == nullptr)
    err = launch<2, false, false>(A, s);
  else
    err = launch<2, true, false>(A, s);
  return static_cast<int>(err);
}

// The launch shape of the instance for nf right-hand sides, with or without
// damping, with a kappa field or (const_kappa, the undamped pair) a
// constant, at Nz levels, into out[0..6) (see info).
extern "C" int implicit_diffusion_info(int Nz, int nf, int damped, int const_kappa, int* out) {
  if (!valid(Nz, nf)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (const_kappa && (nf != 2 || damped))
    err = cudaErrorInvalidValue;
  else if (const_kappa)
    err = info<2, false, true>(Nz, out);
  else if (nf == 1 && !damped)
    err = info<1, false, false>(Nz, out);
  else if (nf == 1)
    err = info<1, true, false>(Nz, out);
  else if (!damped)
    err = info<2, false, false>(Nz, out);
  else
    err = info<2, true, false>(Nz, out);
  return static_cast<int>(err);
}
