// The buoyancy of seawater inside the tile kernels: TEOS-10, the linear
// equation of state, or the b tracer itself, as kernel K6 (tendencies.cu)
// evaluates it on every level and kernel K1 (zslab_tendencies.cu) where
// its caller hands it no b; and a column's total of b dz.
//
// Written as torch evaluates ops/eos.py on a CUDA tensor, so that b equals
// the plain version's bit for bit: the same Horner order (by powers of zz,
// then tt, then ss), every product and sum rounded on its own, each Python
// constant rounded once to float, and each division by a constant a
// product with the reciprocal (the wrapper passes the reciprocals, rounded
// as torch rounds them: ops/pallas_tendency.py::eos_scalars). The column
// sums are sequential from the floor, as the kernels' running sums of b dz.
//
// Rounding each operation on its own: K6 is built with -fmad=false, so
// there the operators do it (GB25_ADD, GB25_SUB and GB25_MUL expand to
// them, and K6's code is what it was before this header held it); K1 is
// built without, so it defines GB25_EOS_RN before including this header
// and the same expressions round through tendency_tile.cuh's intrinsics,
// which no build flag contracts into a multiply-add.
//
// A_, the kernel's arguments, holds R (the arithmetic type), the TEOS-10
// scalars inv_sau, inv_ctu, inv_zu, neg_g, rho0, inv_rho0, the linear
// equation's lin_g, lin_alpha, lin_T0, lin_beta, lin_S0, eos (where b
// comes from, in the general instances), T and S_ (the fields b is made
// of; both the b tracer in b mode), zc and dzc (the extended z profiles),
// Nz and hz.

#pragma once

#include <type_traits>

#include "tendency_tile.cuh"

#ifdef GB25_EOS_RN
#define GB25_ADD(a, b) add_rn(a, b)
#define GB25_SUB(a, b) sub_rn(a, b)
#define GB25_MUL(a, b) mul_rn(a, b)
#else
#define GB25_ADD(a, b) ((a) + (b))
#define GB25_SUB(a, b) ((a) - (b))
#define GB25_MUL(a, b) ((a) * (b))
#endif

namespace {

// Where b comes from: TEOS-10 of T and S, the linear equation of state of
// T and S, or the b tracer (read as T, and as S).
enum { kEosTeos10 = 0, kEosLinear = 1, kEosTracer = 2 };

// The polyTEOS10_bsq anomaly coefficient of ss^i tt^j zz^k as kEos[k][j][i]
// (ops/eos.py::_EOS): at zz^k, tt runs to kDeg[k] and ss to kDeg[k] - j,
// with kDeg = {6, 4, 2, 1}. Each double is rounded once to float, as torch
// rounds a Python number for a float32 tensor; kEosD holds the doubles
// themselves (K6's float64 instance), from the same literals.
#define GB25_TEOS10_COEFFS \
  {                                                                                     \
    {                                                                                   \
        {8.0189615746e02, 8.6672408165e02, -1.7864682637e03, 2.0375295546e03,           \
         -1.2849161071e03, 4.3227585684e02, -6.0579916612e01},                          \
        {2.6010145068e01, -6.5281885265e01, 8.1770425108e01, -5.6888046321e01,          \
         1.7681814114e01, -1.9193502195e00},                                            \
        {-3.7074170417e01, 6.1548258127e01, -6.0362551501e01, 2.9130021253e01,          \
         -5.4723692739e00},                                                             \
        {2.1661789529e01, -3.3449108469e01, 1.9717078466e01, -3.1742946532e00},         \
        {-8.3627885467e00, 1.1311538584e01, -5.3563304045e00},                          \
        {5.4048723791e-01, 4.8169980163e-01},                                           \
        {-1.9083568888e-01},                                                            \
    },                                                                                  \
    {                                                                                   \
        {1.9681925209e01, -4.2549998214e01, 5.0774768218e01, -3.0938076334e01,          \
         6.6051753097e00},                                                              \
        {-1.3336301113e01, -4.4870114575e00, 5.0042598061e00, -6.5399043664e-01},       \
        {6.7080479603e00, 3.5063081279e00, -1.8795372996e00},                           \
        {-2.4649669534e00, -5.5077101279e-01},                                          \
        {5.5927935970e-01},                                                             \
    },                                                                                  \
    {                                                                                   \
        {2.0660924175e00, -4.9527603989e00, 2.5019633244e00},                           \
        {2.0564311499e00, -2.1311365518e-01},                                           \
        {-1.2419983026e00},                                                             \
    },                                                                                  \
    {                                                                                   \
        {-2.3342758797e-02, -1.8507636718e-02},                                         \
        {3.7969820455e-01},                                                             \
    },                                                                                  \
  }

__constant__ float kEos[4][7][7] = GB25_TEOS10_COEFFS;
__constant__ double kEosD[4][7][7] = GB25_TEOS10_COEFFS;

// The coefficient kEos[K][j][i] in the arithmetic type R.
template <class R>
__device__ __forceinline__ R eos_coeff(int K, int j, int i) {
  if constexpr (std::is_same<R, double>::value)
    return kEosD[K][j][i];
  else
    return kEos[K][j][i];
}

__device__ __forceinline__ float sqrt_rn(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_rn(double x) { return sqrt(x); }

// sum_ij kEos[K][j][i] ss^i tt^j: Horner in tt of Horner in ss, from the
// highest powers down (ops/eos.py::_horner_2d).
template <int K, int N, class R>
__device__ __forceinline__ R eos_horner2d(R ss, R tt) {
  R out = R(0.0);
#pragma unroll
  for (int j = N; j >= 0; --j) {
    R acc = eos_coeff<R>(K, j, N - j);
#pragma unroll
    for (int i = N - j - 1; i >= 0; --i) acc = GB25_ADD(GB25_MUL(acc, ss), eos_coeff<R>(K, j, i));
    out = (j == N) ? acc : GB25_ADD(GB25_MUL(out, tt), acc);
  }
  return out;
}

// b = -g (rho' - rho0) / rho0 from the TEOS-10 anomaly rho'(S, T, z)
// (ops/eos.py::TEOS10EquationOfState.buoyancy).
template <class A_, class R = typename A_::R>
__device__ __forceinline__ R teos10_buoyancy(const A_& A, NoDeduce<R> T, NoDeduce<R> S,
                                             NoDeduce<R> z) {
  const R ss = sqrt_rn(GB25_MUL(GB25_ADD(S, R(32.0)), A.inv_sau));
  const R tt = GB25_MUL(T, A.inv_ctu);
  const R zz = GB25_MUL(-z, A.inv_zu);
  R r = eos_horner2d<3, 1>(ss, tt);
  r = GB25_ADD(GB25_MUL(r, zz), (eos_horner2d<2, 2>(ss, tt)));
  r = GB25_ADD(GB25_MUL(r, zz), (eos_horner2d<1, 4>(ss, tt)));
  r = GB25_ADD(GB25_MUL(r, zz), (eos_horner2d<0, 6>(ss, tt)));
  return GB25_MUL(GB25_MUL(A.neg_g, GB25_SUB(r, A.rho0)), A.inv_rho0);
}

// b = g (alpha (T - T0) - beta (S - S0)) (ops/eos.py::LinearEquationOfState),
// each operation rounded on its own.
template <class A_, class R = typename A_::R>
__device__ __forceinline__ R linear_buoyancy(const A_& A, NoDeduce<R> T, NoDeduce<R> S) {
  return GB25_MUL(A.lin_g, GB25_SUB(GB25_MUL(A.lin_alpha, GB25_SUB(T, A.lin_T0)),
                                    GB25_MUL(A.lin_beta, GB25_SUB(S, A.lin_S0))));
}

// The buoyancy of a cell: TEOS-10 in the flagship's instances; in the
// general ones A.eos's (in b mode T holds b).
template <bool GEN, class A_, class R = typename A_::R>
__device__ __forceinline__ R buoyancy(const A_& A, NoDeduce<R> T, NoDeduce<R> S,
                                      NoDeduce<R> z) {
  if (GEN && A.eos == kEosTracer) return T;
  if (GEN && A.eos == kEosLinear) return linear_buoyancy(A, T, S);
  return teos10_buoyancy(A, T, S, z);
}

// The column total of b dz, b down the column from device memory, summed up
// from the floor.
template <bool GEN, class A_, class R = typename A_::R>
__device__ __forceinline__ R column_total(const A_& A, int Y, int X) {
  R tot = R(0.0);
  for (int k = 0; k < A.Nz; ++k) {
    const int Z = k + A.hz;
    tot = GB25_ADD(tot, GB25_MUL(buoyancy<GEN>(A, A.T(Z, Y, X), A.S_(Z, Y, X), A.zc[Z]),
                                 A.dzc[Z]));
  }
  return tot;
}

}  // namespace

#undef GB25_ADD
#undef GB25_SUB
#undef GB25_MUL
