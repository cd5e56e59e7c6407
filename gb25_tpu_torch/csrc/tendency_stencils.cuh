// Stencils of the tendency stage, shared by kernel K1 (zslab_tendencies.cu)
// and kernel K6 (tendencies.cu): a view of a halo-extended (Z, Y, X) field,
// a metric read from a y profile or a (y, x) plane, WENO-5 and its upwind
// choice, the potential vorticity at a corner, the Hollingsworth kinetic
// energy, the horizontal divergence and the flux-form tracer terms.
//
// ``Args`` is each kernel's own argument struct; these functions read its
// fields u and v, its metric pointers dxc, dxf, dyc, dyf, azc, azf, fff and
// its WENO epsilon eps. Semantics follow the array path of the JAX package
// (ops/operators.py, models/hydrostatic.py); the WENO-5 upwind test is
// strict (vel > 0).

#pragma once

#include <cstddef>

namespace {

struct Field {
  const float* p;
  int Xe;
  size_t plane;  // (Ny + 2hy) * (Nx + 2hx)
  __device__ __forceinline__ float operator()(int z, int y, int x) const {
    return __ldg(p + (size_t)z * plane + (size_t)y * Xe + x);
  }
};

// A metric at row y of a profile, or at (y, x) of a plane.
template <bool M2, class Args>
__device__ __forceinline__ float met(const Args& A, const float* m, int y, int x) {
  return M2 ? m[(size_t)y * A.u.Xe + x] : m[y];
}

// WENO-5 from five upwind-ordered samples, factored division-free form
// (ops/weno.py::_weno5_from_shifts).
__device__ __forceinline__ float weno5(float m2, float m1, float s0, float p1, float p2,
                                       float eps) {
  const float sixth = 1.0f / 6.0f;
  const float c13 = 13.0f / 12.0f;
  float d1 = m1 - m2, d2 = s0 - m1, d3 = p1 - s0, d4 = p2 - p1;
  float q0 = s0 + (5.0f * d2 - 2.0f * d1) * sixth;
  float q1 = s0 + (d2 + 2.0f * d3) * sixth;
  float q2 = s0 + (4.0f * d3 - d4) * sixth;
  float x0 = d2 - d1, x1 = d3 - d2, x2 = d4 - d3, y1 = d2 + d3;
  float e0 = x0 + 2.0f * d2, e2 = x2 - 2.0f * d3;
  float b0 = c13 * x0 * x0 + 0.25f * (e0 * e0);
  float b1 = c13 * x1 * x1 + 0.25f * y1 * y1;
  float b2 = c13 * x2 * x2 + 0.25f * (e2 * e2);
  float t0 = (b0 + eps) * (b0 + eps);
  float t1 = (b1 + eps) * (b1 + eps);
  float t2 = (b2 + eps) * (b2 + eps);
  float w0 = 0.1f * (t1 * t2), w1 = 0.6f * (t0 * t2), w2 = 0.3f * (t0 * t1);
  return (w0 * q0 + w1 * q1 + w2 * q2) / (w0 + w1 + w2);
}

// Upwind selection over six samples s[0..5] ordered along the axis, with
// the reconstruction point between s[2] and s[3]: from below when vel > 0.
__device__ __forceinline__ float weno_upwind(const float s[6], float vel, float eps) {
  return vel > 0.0f ? weno5(s[0], s[1], s[2], s[3], s[4], eps)
                    : weno5(s[5], s[4], s[3], s[2], s[1], eps);
}

// q = f + zeta at the corner (y, x) of level z.
template <bool M2, class Args>
__device__ __forceinline__ float pv(const Args& A, int z, int y, int x) {
  float zeta = ((A.v(z, y, x) * met<M2>(A, A.dyf, y, x) -
                 A.v(z, y, x - 1) * met<M2>(A, A.dyf, y, x - 1)) -
                (A.u(z, y, x) * met<M2>(A, A.dxc, y, x) -
                 A.u(z, y - 1, x) * met<M2>(A, A.dxc, y - 1, x))) *
               (1.0f / met<M2>(A, A.azf, y, x));
  return met<M2>(A, A.fff, y, x) + zeta;
}

// Hollingsworth-corrected kinetic energy at the center (y, x).
template <class Args>
__device__ __forceinline__ float kinetic(const Args& A, int z, int y, int x) {
  float u0 = A.u(z, y, x), u1 = A.u(z, y, x + 1);
  float v0 = A.v(z, y, x), v1 = A.v(z, y + 1, x);
  float Ks = 0.5f * (0.5f * (u1 * u1 + u0 * u0) + 0.5f * (v1 * v1 + v0 * v0));
  float ub0 = 0.5f * (A.u(z, y + 1, x) + A.u(z, y - 1, x));
  float ub1 = 0.5f * (A.u(z, y + 1, x + 1) + A.u(z, y - 1, x + 1));
  float vb0 = 0.5f * (A.v(z, y, x + 1) + A.v(z, y, x - 1));
  float vb1 = 0.5f * (A.v(z, y + 1, x + 1) + A.v(z, y + 1, x - 1));
  float Kb = 0.5f * (0.5f * (ub1 * ub1 + ub0 * ub0) + 0.5f * (vb1 * vb1 + vb0 * vb0));
  const float third = 1.0f / 3.0f;
  return (2.0f * third) * Ks + third * Kb;
}

// Horizontal divergence of (u, v) at the center (y, x).
template <bool M2, class Args>
__device__ __forceinline__ float divergence(const Args& A, int z, int y, int x) {
  return ((A.u(z, y, x + 1) * met<M2>(A, A.dyc, y, x + 1) -
           A.u(z, y, x) * met<M2>(A, A.dyc, y, x)) +
          (A.v(z, y + 1, x) * met<M2>(A, A.dxf, y + 1, x) -
           A.v(z, y, x) * met<M2>(A, A.dxf, y, x))) *
         (1.0f / met<M2>(A, A.azc, y, x));
}

// Flux-form tracer tendency at (z, y, x) except the vertical part, which
// needs the carried bottom-face flux. Returns -(dx_c Fx + dy_c Fy) / Az.
template <bool M2, class Args>
__device__ __forceinline__ float tracer_horizontal(const Args& A, const Field& c, int z, int y,
                                                   int x) {
  float s[6];
  float F[2], G[2];
  for (int f = 0; f < 2; ++f) {  // x faces x and x+1
    int xf = x + f;
    for (int r = 0; r < 6; ++r) s[r] = c(z, y, xf - 3 + r);
    float vel = A.u(z, y, xf);
    F[f] = (vel * met<M2>(A, A.dyc, y, xf)) * weno_upwind(s, vel, A.eps);
  }
  for (int f = 0; f < 2; ++f) {  // y faces y and y+1
    int yf = y + f;
    for (int r = 0; r < 6; ++r) s[r] = c(z, yf - 3 + r, x);
    float vel = A.v(z, yf, x);
    G[f] = (vel * met<M2>(A, A.dxf, yf, x)) * weno_upwind(s, vel, A.eps);
  }
  return -((F[1] - F[0]) + (G[1] - G[0])) * (1.0f / met<M2>(A, A.azc, y, x));
}

// Vertical tracer flux w * c at the bottom face of extended level z.
template <class Args>
__device__ __forceinline__ float tracer_zflux(const Args& A, const Field& c, int z, int y, int x,
                                              float w) {
  float s[6];
  for (int r = 0; r < 6; ++r) s[r] = c(z - 3 + r, y, x);
  return w * weno_upwind(s, w, A.eps);
}

}  // namespace
