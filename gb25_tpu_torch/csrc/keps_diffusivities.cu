// k-epsilon diffusivities and sources of one step: kappa_u, kappa_c,
// kappa_e, kappa_eps at the bottom face of each cell, the TKE source G_e
// and the dissipation source G_eps at centers.
//
// Replaces: gb25_tpu/ops/pallas_catke.py::column_closure_kernel (pallas_call
// at :164) as used by keps_diffusivities_kernel (:228).
//
// What bounds it on an H100: device memory. It reads five extended fields
// (u, v, b, e, eps) and writes six interior ones (~3.6 GB at 1536x768x64
// f32, ~1.1 ms at 3.35 TB/s) against ~60 flop per cell and no
// transcendental.
//
// Design: K4's CATKE function's (csrc/catke_diffusivities.cu). One thread
// per interior (x, y) column, threads along x, so every level of a
// (Z, Y, X) field is a coalesced load and the x+1 / y+1 neighbours the
// shear reads come from lines the neighbouring threads fetch. The thread
// marches z upwards. kappa_u at a center is computed once and carried to
// the face above; every face quantity (kappa_u, the shear production and
// buoyancy flux terms) is computed once, at the face above the cell, and
// carried to the next level as its bottom face (the z stencil has radius
// 1). The arithmetic follows models/keps.py::keps_math term by term, with
// the Prandtl and Schmidt divisions as products with their reciprocals, and
// the file is built with -fmad=false, so no product is fused into a sum the
// plain version rounds separately.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

struct Consts {
  float C_mu, e_min, eps_min, kappa_max;
  float r_sigma_c, r_sigma_k, r_sigma_eps;  // 1 / sigma, rounded once on the host
  float C_eps1, C_eps2, C_eps3_unstable, C_eps3_stable;
};

struct Args {
  const float *u, *v, *b, *e, *eps;  // (Nz+2hz, Ny+2hy, Nx+2hx) extended
  const float* dzf;                  // (Nz+2hz) z profile
  float *kap_u, *kap_c, *kap_e, *kap_eps, *G_e, *G_eps;  // (Nz, Ny, Nx)
  int Nx, Ny, Nz, hx, hy, hz;
  Consts C;
};

// The terms of a face that the two adjacent centers average.
struct Face {
  float kap_u, kap_c, kuS2, kcN2;
};

// kappa_u at the center at offset o: C_mu e^2 / eps, floored e and eps,
// capped at kappa_max
__device__ __forceinline__ float center_kappa(const Args& A, size_t o) {
  const float e = fmaxf(__ldg(A.e + o), A.C.e_min);
  const float eps = fmaxf(__ldg(A.eps + o), A.C.eps_min);
  return fminf(A.C.C_mu * e * e / eps, A.C.kappa_max);
}

// The face at the bottom of extended level Z of column (Y, X), between the
// centers whose kappa_u are kc_hi (level Z) and kc_lo (level Z - 1).
__device__ __forceinline__ Face face(const Args& A, int Z, int Y, int X, float kc_hi,
                                     float kc_lo) {
  const size_t Xe = A.Nx + 2 * A.hx;
  const size_t plane = (size_t)(A.Ny + 2 * A.hy) * Xe;
  const size_t o = (size_t)Z * plane + (size_t)Y * Xe + X;
  const size_t om = o - plane;
  const float dzf = A.dzf[Z];

  const float N2 = (__ldg(A.b + o) - __ldg(A.b + om)) / dzf;
  const float du0 = (__ldg(A.u + o) - __ldg(A.u + om)) / dzf;
  const float du1 = (__ldg(A.u + o + 1) - __ldg(A.u + om + 1)) / dzf;
  const float dv0 = (__ldg(A.v + o) - __ldg(A.v + om)) / dzf;
  const float dv1 = (__ldg(A.v + o + Xe) - __ldg(A.v + om + Xe)) / dzf;
  const float S2 = 0.5f * (du1 * du1 + du0 * du0) + 0.5f * (dv1 * dv1 + dv0 * dv0);

  Face f;
  f.kap_u = 0.5f * (kc_hi + kc_lo);
  f.kap_c = f.kap_u * A.C.r_sigma_c;
  f.kuS2 = f.kap_u * S2;
  f.kcN2 = f.kap_c * N2;
  return f;
}

__global__ void __launch_bounds__(128) keps_diffusivities_kernel(const Args A) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  if (i >= A.Nx || j >= A.Ny) return;
  const int X = i + A.hx, Y = j + A.hy;
  const size_t Xe = A.Nx + 2 * A.hx;
  const size_t plane = (size_t)(A.Ny + 2 * A.hy) * Xe;
  const size_t plane_i = (size_t)A.Ny * A.Nx;
  const size_t ij = (size_t)j * A.Nx + i;
  const Consts& C = A.C;

  size_t oc = (size_t)A.hz * plane + (size_t)Y * Xe + X;  // center of level hz
  float kc = center_kappa(A, oc);
  Face lo = face(A, A.hz, Y, X, kc, center_kappa(A, oc - plane));
  for (int k = 0; k < A.Nz; ++k, oc += plane) {
    const int Z = k + A.hz;
    const float kc_up = center_kappa(A, oc + plane);
    const Face hi = face(A, Z + 1, Y, X, kc_up, kc);
    const size_t o = (size_t)k * plane_i + ij;

    A.kap_u[o] = lo.kap_u;
    A.kap_c[o] = lo.kap_c;
    A.kap_e[o] = lo.kap_u * C.r_sigma_k;
    A.kap_eps[o] = lo.kap_u * C.r_sigma_eps;

    const float P = 0.5f * (hi.kuS2 + lo.kuS2);
    const float B = -(0.5f * (hi.kcN2 + lo.kcN2));
    const float e_pos = fmaxf(__ldg(A.e + oc), C.e_min);
    const float eps_pos = fmaxf(__ldg(A.eps + oc), C.eps_min);
    A.G_e[o] = P + B - eps_pos;
    const float C3B = B > 0.0f ? C.C_eps3_unstable * B : C.C_eps3_stable * B;
    A.G_eps[o] = (eps_pos / e_pos) * (C.C_eps1 * P + C3B - C.C_eps2 * eps_pos);
    lo = hi;
    kc = kc_up;
  }
}

}  // namespace

extern "C" const char* gb25_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int keps_diffusivities_f32(
    const float* u, const float* v, const float* b, const float* e, const float* eps,
    const float* dzf, float* kap_u, float* kap_c, float* kap_e, float* kap_eps, float* G_e,
    float* G_eps, int Nx, int Ny, int Nz, int hx, int hy, int hz, float C_mu, float e_min,
    float eps_min, float kappa_max, float r_sigma_c, float r_sigma_k, float r_sigma_eps,
    float C_eps1, float C_eps2, float C_eps3_unstable, float C_eps3_stable, void* stream) {
  if (hx < 1 || hy < 1 || hz < 1) return static_cast<int>(cudaErrorInvalidValue);
  Args A;
  A.u = u; A.v = v; A.b = b; A.e = e; A.eps = eps; A.dzf = dzf;
  A.kap_u = kap_u; A.kap_c = kap_c; A.kap_e = kap_e; A.kap_eps = kap_eps;
  A.G_e = G_e; A.G_eps = G_eps;
  A.Nx = Nx; A.Ny = Ny; A.Nz = Nz; A.hx = hx; A.hy = hy; A.hz = hz;
  A.C = Consts{C_mu, e_min, eps_min, kappa_max, r_sigma_c, r_sigma_k, r_sigma_eps,
               C_eps1, C_eps2, C_eps3_unstable, C_eps3_stable};
  dim3 block(128, 1, 1);
  dim3 grid((Nx + 127) / 128, Ny, 1);
  keps_diffusivities_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(A);
  return static_cast<int>(cudaGetLastError());
}
