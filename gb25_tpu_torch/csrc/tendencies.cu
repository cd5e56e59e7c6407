// The whole tendency stage of the hydrostatic step in one kernel: continuity
// w, TEOS-10 buoyancy, hydrostatic pressure, WENO vector-invariant momentum
// and WENO-5 tracer advection, from the halo-extended u, v and tracers to
// the interior Gu, Gv and one G per tracer; or, in its general instances,
// any of the config's schemes (tendency_tile.cuh) with the buoyancy from
// TEOS-10, from the linear equation of state or from the b tracer itself
// (one to four tracers). Nothing else: the AB2 update,
// the depth integrals, the closure's sources, the surface fluxes and the
// masks are the caller's (the "pallas" route of models/hydrostatic.py).
//
// Replaces: gb25_tpu/ops/pallas_tendency.py::pallas_tendencies (the
// one-pass Pallas tendency kernel, _run_kernel :135, pallas_call :234):
// tracers T, S (the flagship), T, S, e (the climate) and T, S, e, eps
// (k-epsilon); the metrics and f as y profiles or, on the tripolar grid, as
// (y, x) planes (the Pallas kernel's metric_spec, :173-184); split = false
// (one launch) or true (a momentum launch, then a tracer launch). Each
// instance has a general variant that reads the schemes and the buoyancy's
// source from its arguments (the Pallas kernel runs tendency_math with the
// config's schemes and cfg.eos inside, :105-108, 217-225); the general
// variants add one tracer (b) and, for the b tracer, a momentum launch
// that stages b alone.
//
// What bounds it on an H100: device memory, nearly level with the float32
// rate. At 1536x768x64 the flagship instance reads four extended fields (u,
// v, T, S: 1.38 GB) and writes four interior ones (1.21 GB), ~0.77 ms at
// 3.35 TB/s, against ~720 operations per cell (~600 of stencils, ~120 of
// TEOS-10 and the column sums), ~0.81 ms at 67 TFLOP/s. As in the Pallas
// kernel, b, p and w never reach device memory.
//
// Design: the level tile of tendency_tile.cuh, shared with kernel K1. A
// block of 32 x kTY threads owns 32 x kTY interior columns and their
// south and west apron (the pressure gradient reads p at i - 1 and j - 1).
//   1. The column totals of b dz that p = csum - total - b dz / 2 needs
//      before its first level, from a pre-pass: each carried column's owner
//      evaluates TEOS-10 down its column from device memory and sums b dz
//      up from the floor. Keeping the whole columns' b dz in shared memory
//      instead (TEOS-10 once per cell, 76 KB a block at Nz = 64) leaves an
//      SM fewer blocks and measured slower (PERF.md section 6); the
//      pre-pass keeps nothing per level, so the depth is not limited.
//   2. The march up z as K1's: u, v and the tracers staged per level by
//      cp.async, the corner PV, kinetic energy and tracer face fluxes once
//      per level in shared memory, b from TEOS-10 on the staged T and S,
//      the continuity and b dz sums in registers of each carried column's
//      owner.
// The tracer launch of split = true needs no b: it skips the totals, the
// momentum and the apron columns.
//
// The buoyancy and the column totals are eos.cuh's, shared with K1: TEOS-10
// and the linear equation of state as torch evaluates ops/eos.py on a CUDA
// tensor, so the kernel's b equals the plain version's bit for bit; the b
// tracer is read as it is. The column sums are sequential, as the plain
// version's cumsum. The rest of the kernel is built with -fmad=false.
//
// The inputs arrive halo-filled (the fold rows included) and, on immersed
// grids, with u and v masked on solid faces: like the Pallas kernel, K6 has
// no fold, no mask and no wall logic. The outputs are fresh buffers.
//
// The float64 instance (tendencies_f64: a float64 state, or
// compute_dtype="float64", on the "pallas" route, where the JAX package
// hands its kernel float64 operands) runs the same expressions in double:
// fields, metrics, profiles, scalars, shared memory and every operation,
// TEOS-10's coefficients from a double table, the wrapper's scalars as
// torch applies them to a float64 tensor. It is general (schemes and eos
// read at run time), one launch, 1-4 tracers, columns or tripolar planes.
// Its shared memory is twice the float instance's (59,904 bytes a block on
// the flagship, up to 117,344 on tripolar planes with four tracers), so it
// takes the opt-in above 48 KB, and it has launch bounds of its own
// (kMinBlocksF64): doubles under the float instances' 80-register cap
// would spill. Bound on an H100: 8-byte values double the bytes of the
// float instance, and its ~720 operations a cell run at the FP64 rate of
// 34 TFLOP/s, half the float32 rate: ~1.7 ms of operations against ~1.5
// ms of bytes on the flagship.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstddef>
#include <type_traits>

#include "eos.cuh"
#include "tendency_tile.cuh"

namespace {

constexpr int kMaxTracers = 4;
using bf16 = __nv_bfloat16;

enum Mode { kAll = 0, kMomentum = 1, kTracers = 2 };

// Blocks per SM the float64 instance's registers must allow: 1 leaves it
// up to 255 registers a thread.
constexpr int kMinBlocksF64 = 1;

// S: the type of the fields and of the outputs (float, bfloat16 in the
// bfloat16 instances, double in the float64 instance); R = Real<S>: the
// type of the metrics, the profiles, the scalars and the arithmetic (float,
// or double in the float64 instance).
template <class S>
struct ArgsT {
  using R = Real<S>;
  const S* stage[2 + kMaxTracers];  // the staged fields: u, v, then the tracers or T, S
  FieldT<S> u, v, T, S_;
  FieldT<S> tr[kMaxTracers];
  // (Ny+2hy) y profiles, or (Ny+2hy, Nx+2hx) planes on the tripolar grid
  const R *dxc, *dxf, *dyc, *dyf, *azc, *azf, *fff;
  const R *dzc, *dzf, *zc;  // (Nz+2hz) z profiles
  S *Gu, *Gv;               // (Nz, Ny, Nx)
  S* Gtr[kMaxTracers];
  int Nx, Ny, Nz, hx, hy, hz;
  int align;   // staged column -3 - align is 16-byte aligned; -1: value by value
  int iT, iS;  // T and S among the staged fields after u and v (b twice in b mode)
  R eps;                                              // WENO epsilon
  R inv_sau, inv_ctu, inv_zu, neg_g, rho0, inv_rho0;  // TEOS-10 scalars
  R lin_g, lin_alpha, lin_T0, lin_beta, lin_S0;       // the linear equation's
  Schemes sch;  // the advection and kinetic-energy schemes (general instances)
  int eos;      // kEosTeos10, kEosLinear or kEosTracer (general instances)
};
using Args = ArgsT<float>;

// An output value in its storage type: float, rounded to bfloat16, or
// double.
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void store(double* p, double x) { *p = x; }

// Shared memory of a launch in bytes. A launch stages 2 + NTR fields: u, v
// and the tracers; for the momentum launch u, v and its NTR buoyancy fields
// (T and S, or b). With bfloat16 fields the ring holds bfloat16 slots and
// the float slot each level is widened into (tendency_tile.cuh); with
// double fields every value is a double.
template <int NTR, int MODE, bool M2, class S = float>
constexpr size_t smem_bytes() {
  constexpr int NF = 2 + NTR;
  return sizeof(Real<S>) * (tile_floats<NF, MODE == kMomentum ? 0 : NTR, M2>() -
                            kStages * NF * kSF + ring_floats<S, NF>());
}

template <bool M2, class A_, class R = typename A_::R>
__device__ __forceinline__ void start_column(ColumnT<R>& c, const A_& A, const Tile& t, int Xe) {
  c.razc = R(1.0) / metric_at<M2>(A.azc, t.Y0 + c.y, t.X0 + c.x, Xe);
}

// Blocks per SM an instance's registers must allow: kMinBlocks (80
// registers a thread) for float and bfloat16 fields, kMinBlocksF64 for
// double ones.
template <class S>
struct MinBlocks {
  static constexpr int value = std::is_same<S, double>::value ? kMinBlocksF64 : kMinBlocks;
};

// GEN: the general instance (A.sch, A.eos); else the flagship's schemes
// and TEOS-10. S: the fields' and outputs' type; bfloat16 fields are
// staged as bfloat16 and each level widened once into a float slot, as in
// K1's bf16-storage instance, and every operation is float; double fields
// are staged as they are and every operation is double (R = Real<S>).
template <int NTR, int MODE, bool M2, bool GEN, class S = float>
__global__ void __launch_bounds__(kThreads, MinBlocks<S>::value)
    tendency_stage_kernel(const ArgsT<S> A) {
  using R = Real<S>;
  constexpr bool kMom = MODE != kTracers, kTrc = MODE != kMomentum;
  const Schemes sch = GEN ? A.sch : kFlagship;
  constexpr int NF = 2 + NTR;  // staged fields
  constexpr int NT = kTrc ? NTR : 0;  // tracers this launch advects
  constexpr bool kWide = std::is_same<S, bf16>::value;  // staged narrow, widened per level
  constexpr int kSXS = kWide ? kSXH : kSX;  // a staged row of S
  constexpr int kSlotS = kSXS * kSY;
  extern __shared__ __align__(16) float smem[];
  const bool vec = A.align >= 0;
  const int a = vec ? A.align : 0;  // the staged rows' alignment
  // the layout the stencils read: the ring's, or the widened slot's
  // (columns from -3)
  const Tile t(A.Nx, A.Ny, A.hx, A.hy, kWide ? 0 : a);
  const int Xe = A.Nx + 2 * A.hx, Ye = A.Ny + 2 * A.hy;
  const size_t plane = (size_t)Ye * Xe;
  S* ring = reinterpret_cast<S*>(smem);  // [kStages][NF][kSlotS], then (bf16) [NF][kSF]
  R* mets = reinterpret_cast<R*>(smem) + ring_floats<S, NF>();
  R* pvq = mets + metric_floats<M2>();  // [kPY][kPX]
  R* keq = pvq + kPY * kPX;              // [kCY][kCX]
  R* wq = keq + kCY * kCX;
  R* pq = wq + kCY * kCX;
  R* fxq = pq + kCY * kCX;               // [NT][kTY][kCX]
  R* fyq = fxq + NT * kTY * kCX;         // [NT][kCY][kTX]

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < A.Nz)
      stage_window<NF, kSXS>(ring + s * NF * kSlotS, A.stage, (size_t)(s + A.hz) * plane, t, Xe,
                             vec, a);
    cp_async_commit();
  }
  const Metrics<M2, R> m =
      stage_metrics<M2>(mets, A.dxc, A.dxf, A.dyc, A.dyf, A.azf, A.fff, t, Xe, Ye);

  const int tx = threadIdx.x, ty = threadIdx.y;
  const bool own = tx < t.nx && ty < t.ny;
  ColumnT<R> oc = {ty, tx, own};
  ColumnT<R> ac = {};
  if (kMom) ac = apron_column<R>(t);
  if (oc.on) start_column<M2>(oc, A, t, Xe);
  if (ac.on) start_column<M2>(ac, A, t, Xe);

  if (kMom) {
    if (oc.on) oc.tot = column_total<GEN>(A, t.Y0 + oc.y, t.X0 + oc.x);
    if (ac.on) ac.tot = column_total<GEN>(A, t.Y0 + ac.y, t.X0 + ac.x);
  }

  // this thread's column
  const int X = t.X0 + tx, Y = t.Y0 + ty;
  const size_t ij = own ? (size_t)(t.j0 + ty) * A.Nx + t.i0 + tx : 0;
  const size_t plane_i = (size_t)A.Ny * A.Nx;
  R r_dxc = R(0.0), r_dyf = R(0.0);
  R cz[NT > 0 ? NT : 1][6];  // c(Z - 2 .. Z + 3) of each tracer
  if (own) {
    r_dxc = R(1.0) / metric_at<M2>(A.dxc, Y, X, Xe);
    r_dyf = R(1.0) / metric_at<M2>(A.dyf, Y, X, Xe);
#pragma unroll
    for (int q = 0; q < NT; ++q)
#pragma unroll
      for (int r = 0; r < 6; ++r) cz[q][r] = A.tr[q](A.hz - 2 + r, Y, X);
  }
  // the vertical terms at the bottom face of the level, carried from the
  // level below: w = 0 on the sea floor
  R xu = R(0.0), xv = R(0.0), fz[NT > 0 ? NT : 1];
#pragma unroll
  for (int q = 0; q < NT; ++q) fz[q] = R(0.0);

  for (int k = 0; k < A.Nz; ++k) {
    const int Z = k + A.hz;
    const R dzc = A.dzc[Z];
    // the own column's device-memory operands of this level, loaded before
    // the wait: u, v one level up and the tracers three levels up
    R un1 = R(0.0), vn1 = R(0.0), cnext[NT > 0 ? NT : 1];
    if (own) {
      if (kMom) {
        un1 = A.u(Z + 1, Y, X);
        vn1 = A.v(Z + 1, Y, X);
      }
#pragma unroll
      for (int q = 0; q < NT; ++q) cnext[q] = k + 1 < A.Nz ? A.tr[q](Z + 4, Y, X) : R(0.0);
    }

    cp_async_wait<kStages - 2>();
    __syncthreads();  // level k staged; every read of the slot reused next is done
    if (k + kStages - 1 < A.Nz)
      stage_window<NF, kSXS>(ring + ((k + kStages - 1) % kStages) * NF * kSlotS, A.stage,
                             (size_t)(Z + kStages - 1) * plane, t, Xe, vec, a);
    cp_async_commit();

    const R* slot;
    if constexpr (!kWide) {
      slot = ring + (k % kStages) * NF * kSF + t.origin();
    } else {
      float* wide = reinterpret_cast<float*>(ring + kStages * NF * kSlotS);
      widen_level<NF>(wide, ring + (k % kStages) * NF * kSlotS, t, a);
      __syncthreads();  // the level widened
      slot = wide + t.origin();
    }
    const WinT<R> u{slot}, v{slot + kSF};
    // shared quantities of the level
    if (kMom) {
      const WinT<R> Tw{slot + (2 + A.iT) * kSF}, Sw{slot + (2 + A.iS) * kSF};
      auto level = [&](ColumnT<R>& c) {
        const R bdz = buoyancy<GEN>(A, Tw(c.y, c.x), Sw(c.y, c.x), A.zc[Z]) * dzc;
        column_level<true, M2>(c, u, v, m, dzc, bdz, keq, wq, pq, sch);
      };
      if (oc.on) level(oc);
      if (ac.on) level(ac);
      if (sch.mom != kMomNone) corner_pv<M2>(u, v, m, t, pvq);
    } else if (oc.on) {
      column_level<false, M2>(oc, u, v, m, dzc, R(0.0), keq, wq, pq, sch);
    }
    if (sch.tr != kTrNone) {
#pragma unroll
      for (int q = 0; q < NT; ++q)
        tracer_faces<M2>(WinT<R>{slot + (2 + q) * kSF}, u, v, m, t, A.eps, sch.tr,
                         fxq + q * kTY * kCX, fyq + q * kCY * kTX);
    }
    __syncthreads();

    if (own) {
      const size_t o = (size_t)k * plane_i + ij;
      R Gu = R(0.0), Gv = R(0.0), Gc[NT > 0 ? NT : 1];
      if (kMom)
        momentum<M2>(u, v, m, pvq, keq, wq, pq, ty, tx, r_dxc, r_dyf, un1, vn1,
                     R(1.0) / A.dzf[Z + 1], A.eps, sch, xu, xv, Gu, Gv);
      const R w = wq[centre(ty, tx)];
      const R r_dzc = R(1.0) / dzc;
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        Gc[q] = sch.tr == kTrNone
                    ? R(0.0)
                    : tracer(fxq + q * kTY * kCX, fyq + q * kCY * kTX, cz[q], w, fz[q], ty, tx,
                             oc.razc, r_dzc, A.eps, sch.tr);
#pragma unroll
        for (int r = 0; r < 5; ++r) cz[q][r] = cz[q][r + 1];
        cz[q][5] = cnext[q];
      }
      if (kMom) {
        store(A.Gu + o, Gu);
        store(A.Gv + o, Gv);
      }
#pragma unroll
      for (int q = 0; q < NT; ++q) store(A.Gtr[q] + o, Gc[q]);
    }
  }
}

template <int NTR, int MODE, bool M2, bool GEN = false, class S = float>
cudaError_t launch(const ArgsT<S>& A, dim3 grid, dim3 block, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<NTR, MODE, M2, S>();
  const cudaError_t err = allow_shared(tendency_stage_kernel<NTR, MODE, M2, GEN, S>, smem);
  if (err != cudaSuccess) return err;
  tendency_stage_kernel<NTR, MODE, M2, GEN, S><<<grid, block, smem, s>>>(A);
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

template <int NTR, int MODE, bool M2, bool GEN = false, class S = float>
cudaError_t info(int* out) {
  return launch_info(tendency_stage_kernel<NTR, MODE, M2, GEN, S>,
                     smem_bytes<NTR, MODE, M2, S>(), out);
}

bool aligned16(const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; }

}  // namespace

extern "C" const char* gb25_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Every instance, by [general][mode][n - 1][metric2d]: n is the tracer
// count, and for the momentum launch the count of its buoyancy fields (2:
// T and S; 1: b); the flagship's instances have no one-tracer form.
#define GB25_K6_TABLE(F)                                                               \
  {{{{nullptr, nullptr},                                                               \
     {F<2, kAll, false>, F<2, kAll, true>},                                            \
     {F<3, kAll, false>, F<3, kAll, true>},                                            \
     {F<4, kAll, false>, F<4, kAll, true>}},                                           \
    {{nullptr, nullptr},                                                               \
     {F<2, kMomentum, false>, F<2, kMomentum, true>},                                  \
     {nullptr, nullptr},                                                               \
     {nullptr, nullptr}},                                                              \
    {{nullptr, nullptr},                                                               \
     {F<2, kTracers, false>, F<2, kTracers, true>},                                    \
     {F<3, kTracers, false>, F<3, kTracers, true>},                                    \
     {F<4, kTracers, false>, F<4, kTracers, true>}}},                                  \
   {{{F<1, kAll, false, true>, F<1, kAll, true, true>},                                \
     {F<2, kAll, false, true>, F<2, kAll, true, true>},                                \
     {F<3, kAll, false, true>, F<3, kAll, true, true>},                                \
     {F<4, kAll, false, true>, F<4, kAll, true, true>}},                               \
    {{F<1, kMomentum, false, true>, F<1, kMomentum, true, true>},                      \
     {F<2, kMomentum, false, true>, F<2, kMomentum, true, true>},                      \
     {nullptr, nullptr},                                                               \
     {nullptr, nullptr}},                                                              \
    {{F<1, kTracers, false, true>, F<1, kTracers, true, true>},                        \
     {F<2, kTracers, false, true>, F<2, kTracers, true, true>},                        \
     {F<3, kTracers, false, true>, F<3, kTracers, true, true>},                        \
     {F<4, kTracers, false, true>, F<4, kTracers, true, true>}}}}

namespace {

// Every bfloat16 instance, by [ntr - 1][metric2d]: the general variant of
// the one-launch form (mode 0).
#define GB25_K6_BF16_TABLE(F)                                                          \
  {{F<1, kAll, false, true, bf16>, F<1, kAll, true, true, bf16>},                      \
   {F<2, kAll, false, true, bf16>, F<2, kAll, true, true, bf16>},                      \
   {F<3, kAll, false, true, bf16>, F<3, kAll, true, true, bf16>},                      \
   {F<4, kAll, false, true, bf16>, F<4, kAll, true, true, bf16>}}

// Every float64 instance, by [ntr - 1][metric2d]: the general variant of
// the one-launch form (mode 0).
#define GB25_K6_F64_TABLE(F)                                                           \
  {{F<1, kAll, false, true, double>, F<1, kAll, true, true, double>},                  \
   {F<2, kAll, false, true, double>, F<2, kAll, true, true, double>},                  \
   {F<3, kAll, false, true, double>, F<3, kAll, true, true, double>},                  \
   {F<4, kAll, false, true, double>, F<4, kAll, true, true, double>}}

// The entry points' common body: check the arguments, fill ArgsT<S> and
// launch the instance. R: the metrics', profiles' and scalars' type.
template <class S, class R = Real<S>>
int launch_stage(const S* u, const S* v, const S* T, const S* S_, const S* const* tr,
                 const R* dxc, const R* dxf, const R* dyc, const R* dyf, const R* azc,
                 const R* azf, const R* fff, const R* dzc, const R* dzf, const R* zc, S* Gu,
                 S* Gv, S* const* Gtr, int ntr, int Nx, int Ny, int Nz, int hx, int hy, int hz,
                 int metric2d, int mode, R eps, R inv_sau, R inv_ctu, R inv_zu, R neg_g, R rho0,
                 R inv_rho0, R lin_g, R lin_alpha, R lin_T0, R lin_beta, R lin_S0, int mom,
                 int ke, int trs, int eos, void* stream) {
  constexpr bool kF32 = std::is_same<S, float>::value;
  if (ntr < 1 || ntr > kMaxTracers || mode < kAll || mode > kTracers || hx < 3 || hy < 3 ||
      hz < 3 || mom < kMomWenoVI || mom > kMomNone || ke < kKeHollingsworth ||
      ke > kKeStandard || trs < kTrWeno5 || trs > kTrNone || eos < kEosTeos10 ||
      eos > kEosTracer || (!kF32 && mode != kAll))
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode != kTracers && (Gu == nullptr || Gv == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool btracer = eos == kEosTracer;
  if (btracer && T != S_) return static_cast<int>(cudaErrorInvalidValue);
  const int Xe = Nx + 2 * hx;
  const size_t plane = (size_t)(Ny + 2 * hy) * Xe;
  ArgsT<S> A = {};
  A.inv_sau = inv_sau; A.inv_ctu = inv_ctu; A.inv_zu = inv_zu;
  A.neg_g = neg_g; A.rho0 = rho0; A.inv_rho0 = inv_rho0;
  A.lin_g = lin_g; A.lin_alpha = lin_alpha; A.lin_T0 = lin_T0;
  A.lin_beta = lin_beta; A.lin_S0 = lin_S0;
  A.sch = Schemes{mom, ke, trs};
  A.eos = eos;
  A.u = FieldT<S>{u, Xe, plane};
  A.v = FieldT<S>{v, Xe, plane};
  A.T = FieldT<S>{T, Xe, plane};
  A.S_ = FieldT<S>{S_, Xe, plane};
  A.iT = A.iS = -1;
  for (int t = 0; t < kMaxTracers; ++t) {
    const bool used = t < ntr;
    A.tr[t] = FieldT<S>{used ? tr[t] : nullptr, Xe, plane};
    A.Gtr[t] = used && mode != kMomentum ? Gtr[t] : nullptr;
    if (used && mode != kMomentum && A.Gtr[t] == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    if (used && tr[t] == T) A.iT = t;
    if (used && tr[t] == S_) A.iS = t;
  }
  if (A.iT < 0 || A.iS < 0) return static_cast<int>(cudaErrorInvalidValue);
  // the staged fields: u, v, then the tracers, or for the momentum launch
  // T, S (b alone in b mode)
  const S* staged[2 + kMaxTracers] = {u, v};
  int nstaged = 2;
  if (mode == kMomentum) {
    staged[nstaged++] = T;
    if (!btracer) staged[nstaged++] = S_;
    A.iT = 0;
    A.iS = btracer ? 0 : 1;
  } else {
    for (int t = 0; t < ntr; ++t) staged[nstaged++] = tr[t];
  }
  constexpr int kPer = 16 / sizeof(S);  // values a 16-byte copy carries
  bool vec = Xe % kPer == 0;
  for (int f = 0; f < 2 + kMaxTracers; ++f) {
    A.stage[f] = f < nstaged ? staged[f] : nullptr;
    vec = vec && (f >= nstaged || aligned16(staged[f]));
  }
  A.dxc = dxc; A.dxf = dxf; A.dyc = dyc; A.dyf = dyf; A.azc = azc; A.azf = azf; A.fff = fff;
  A.dzc = dzc; A.dzf = dzf; A.zc = zc;
  A.Gu = Gu; A.Gv = Gv;
  A.Nx = Nx; A.Ny = Ny; A.Nz = Nz; A.hx = hx; A.hy = hy; A.hz = hz;
  // (X0 - 3) % kPer: i0 is a multiple of 32
  A.align = vec ? ((hx - 3) % kPer + kPer) % kPer : -1;
  A.eps = eps;
  dim3 block(kTX, kTY, 1);
  dim3 grid((Nx + kTX - 1) / kTX, (Ny + kTY - 1) / kTY, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using Launch = cudaError_t (*)(const ArgsT<S>&, dim3, dim3, cudaStream_t);
  if constexpr (kF32) {
    const bool gen = eos != kEosTeos10 || !is_flagship(A.sch, ntr);
    const int n = mode == kMomentum ? nstaged - 2 : ntr;
    static const Launch launchers[2][3][4][2] = GB25_K6_TABLE(launch);
    return static_cast<int>(launchers[gen][mode][n - 1][metric2d ? 1 : 0](A, grid, block, s));
  } else if constexpr (std::is_same<S, bf16>::value) {
    static const Launch launchers[4][2] = GB25_K6_BF16_TABLE(launch);
    return static_cast<int>(launchers[ntr - 1][metric2d ? 1 : 0](A, grid, block, s));
  } else {
    static const Launch launchers[4][2] = GB25_K6_F64_TABLE(launch);
    return static_cast<int>(launchers[ntr - 1][metric2d ? 1 : 0](A, grid, block, s));
  }
}

}  // namespace

// u, v, T, S and the ntr tracers tr[0..ntr) (1 to 4; the pointer arrays
// hold kMaxTracers entries, the unused ones null) are extended (Nz+2hz,
// Ny+2hy, Nx+2hx); T and S are also among tr (in b mode T and S are both
// the b tracer). metric2d: the six metrics and fff are (Ny+2hy, Nx+2hx)
// planes (the tripolar grid), else (Ny+2hy) profiles. mode: 0 every output,
// 1 Gu and Gv only (Gtr may be null), 2 the tracers' G only (Gu, Gv may be
// null). The TEOS-10 scalars: 1 / SAU, 1 / CTU, 1 / ZU, -g, rho0 and
// 1 / rho0 as float32; the linear equation's g, alpha, T0, beta, S0 as
// float32. mom, ke, trs: the scheme codes of tendency_tile.cuh; eos: where
// b comes from (kEosTeos10, kEosLinear, kEosTracer). The flagship's
// schemes under TEOS-10 with two to four tracers launch the instances
// compiled for them, anything else the general instances.
extern "C" int tendencies_f32(
    const float* u, const float* v, const float* T, const float* S, const float* const* tr,
    const float* dxc, const float* dxf, const float* dyc, const float* dyf, const float* azc,
    const float* azf, const float* fff, const float* dzc, const float* dzf, const float* zc,
    float* Gu, float* Gv, float* const* Gtr, int ntr, int Nx, int Ny, int Nz, int hx, int hy,
    int hz, int metric2d, int mode, float eps, float inv_sau, float inv_ctu, float inv_zu,
    float neg_g, float rho0, float inv_rho0, float lin_g, float lin_alpha, float lin_T0,
    float lin_beta, float lin_S0, int mom, int ke, int trs, int eos, void* stream) {
  return launch_stage<float>(u, v, T, S, tr, dxc, dxf, dyc, dyf, azc, azf, fff, dzc, dzf, zc,
                             Gu, Gv, Gtr, ntr, Nx, Ny, Nz, hx, hy, hz, metric2d, mode, eps,
                             inv_sau, inv_ctu, inv_zu, neg_g, rho0, inv_rho0, lin_g, lin_alpha,
                             lin_T0, lin_beta, lin_S0, mom, ke, trs, eos, stream);
}

// The bfloat16 instances (the "pallas" route under compute_dtype="bfloat16"):
// u, v, T, S, the tracers and the outputs bfloat16, the metrics, f and the
// profiles float (the widened bfloat16 grid); every operation float32, each
// output rounded to bfloat16 once. mode 0 only; the schemes and eos read at
// run time (general instances). Arguments as tendencies_f32's.
extern "C" int tendencies_bf16(
    const bf16* u, const bf16* v, const bf16* T, const bf16* S, const bf16* const* tr,
    const float* dxc, const float* dxf, const float* dyc, const float* dyf, const float* azc,
    const float* azf, const float* fff, const float* dzc, const float* dzf, const float* zc,
    bf16* Gu, bf16* Gv, bf16* const* Gtr, int ntr, int Nx, int Ny, int Nz, int hx, int hy,
    int hz, int metric2d, int mode, float eps, float inv_sau, float inv_ctu, float inv_zu,
    float neg_g, float rho0, float inv_rho0, float lin_g, float lin_alpha, float lin_T0,
    float lin_beta, float lin_S0, int mom, int ke, int trs, int eos, void* stream) {
  return launch_stage<bf16>(u, v, T, S, tr, dxc, dxf, dyc, dyf, azc, azf, fff, dzc, dzf, zc,
                            Gu, Gv, Gtr, ntr, Nx, Ny, Nz, hx, hy, hz, metric2d, mode, eps,
                            inv_sau, inv_ctu, inv_zu, neg_g, rho0, inv_rho0, lin_g, lin_alpha,
                            lin_T0, lin_beta, lin_S0, mom, ke, trs, eos, stream);
}

// The launch shape of one bfloat16 instance (ntr, metric2d), as
// tendencies_info's.
extern "C" int tendencies_bf16_info(int ntr, int metric2d, int* out) {
  if (ntr < 1 || ntr > kMaxTracers) return static_cast<int>(cudaErrorInvalidValue);
  using Info = cudaError_t (*)(int*);
  static const Info infos[4][2] = GB25_K6_BF16_TABLE(info);
  return static_cast<int>(infos[ntr - 1][metric2d ? 1 : 0](out));
}

// The float64 instance (a float64 state, or compute_dtype="float64", on the
// "pallas" route): u, v, T, S, the tracers, the outputs, the metrics, f, the
// profiles and the scalars double; every operation double. The TEOS-10
// scalars 1 / SAU, 1 / CTU, 1 / ZU, -g, rho0 and 1 / rho0 and the linear
// equation's g, alpha, T0, beta, S0 as torch applies them to a float64
// tensor. mode 0 only; the schemes and eos read at run time (general
// instances). Arguments otherwise as tendencies_f32's.
extern "C" int tendencies_f64(
    const double* u, const double* v, const double* T, const double* S,
    const double* const* tr, const double* dxc, const double* dxf, const double* dyc,
    const double* dyf, const double* azc, const double* azf, const double* fff,
    const double* dzc, const double* dzf, const double* zc, double* Gu, double* Gv,
    double* const* Gtr, int ntr, int Nx, int Ny, int Nz, int hx, int hy, int hz, int metric2d,
    int mode, double eps, double inv_sau, double inv_ctu, double inv_zu, double neg_g,
    double rho0, double inv_rho0, double lin_g, double lin_alpha, double lin_T0,
    double lin_beta, double lin_S0, int mom, int ke, int trs, int eos, void* stream) {
  return launch_stage<double>(u, v, T, S, tr, dxc, dxf, dyc, dyf, azc, azf, fff, dzc, dzf, zc,
                              Gu, Gv, Gtr, ntr, Nx, Ny, Nz, hx, hy, hz, metric2d, mode, eps,
                              inv_sau, inv_ctu, inv_zu, neg_g, rho0, inv_rho0, lin_g, lin_alpha,
                              lin_T0, lin_beta, lin_S0, mom, ke, trs, eos, stream);
}

// The launch shape of one float64 instance (ntr, metric2d), as
// tendencies_info's.
extern "C" int tendencies_f64_info(int ntr, int metric2d, int* out) {
  if (ntr < 1 || ntr > kMaxTracers) return static_cast<int>(cudaErrorInvalidValue);
  using Info = cudaError_t (*)(int*);
  static const Info infos[4][2] = GB25_K6_F64_TABLE(info);
  return static_cast<int>(infos[ntr - 1][metric2d ? 1 : 0](out));
}

// The launch shape of one instance (ntr, mode, metric2d, general; the
// momentum launch's ntr counts its buoyancy fields), as tendency_tile.cuh's
// launch_info reports it into out[0..5).
extern "C" int tendencies_info(int ntr, int mode, int metric2d, int general, int* out) {
  if (ntr < 1 || ntr > kMaxTracers || mode < kAll || mode > kTracers ||
      (mode == kMomentum && ntr > 2) || (ntr == 1 && !general))
    return static_cast<int>(cudaErrorInvalidValue);
  using Info = cudaError_t (*)(int*);
  static const Info infos[2][3][4][2] = GB25_K6_TABLE(info);
  return static_cast<int>(infos[general ? 1 : 0][mode][ntr - 1][metric2d ? 1 : 0](out));
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
