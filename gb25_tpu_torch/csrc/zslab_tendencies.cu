// Tendency stage of the hydrostatic step, with the quasi-AB2 update, the
// south-wall row and the four barotropic depth integrals fused in, or
// (unfused) the tendencies and the wall row alone.
//
// Replaces: gb25_tpu/ops/pallas_zslab.py::zslab_tendencies (the z-slab
// Pallas kernel, pallas_call at :769). Fused (ab2, wall_v and
// integrals=True): the flagship instance (tracers T, S), the climate
// instance (tracers T, S, e, with the immersed-masked u*/v* integrals), the
// tripolar climate instance (the same, with the metrics and f as 2-D
// planes: the JAX kernel's metric_spec 2-D branch, :555-564) and the
// k-epsilon instance (tracers T, S, e, eps). Unfused (no ab2, no
// integrals: the step's route under a compute_dtype or the explicit free
// surface, gb25_tpu/models/hydrostatic.py:876-904), with two to four
// tracers (T, S; T, S, e; T, S, e, eps) and the metrics as lat-lon
// columns or tripolar planes: the float32 instances and the
// bfloat16-storage instances (storage_dtype=bfloat16, :296-310, 384-391;
// the unfused form has no immersed variant, as the face bottoms matter
// only to the fused integrals): u, v, the tracers
// and b are read as bfloat16 and widened to float32 (the Pallas kernel's
// window upcast, :626-631); every operation and the column total of b dz
// stay float32, and the tendencies are written in float32. Each of these
// runs the flagship's schemes (WENO vector-invariant momentum, WENO-5
// tracers, Hollingsworth kinetic energy) compiled in; each has a general
// variant that reads the schemes from its arguments (the JAX kernel runs
// every scheme of the config, :249-254), and the general variants add one
// tracer (the b-tracer configuration, whose b the JAX kernel reads from
// the tracer, :200-201): fused on flat, immersed and tripolar grids,
// unfused float32 and bfloat16.
//
// What bounds it on an H100: device memory. Per step the flagship instance
// reads four extended fields (u, v, T, S; T and S twice, the second time
// for the column totals) and four previous tendencies and writes eight
// interior fields (~5 GB at 1536x768x64 f32, ~1.6 ms at 3.35 TB/s) against
// ~600 flop per cell of stencils and twice TEOS-10's ~120 (~8e10 flop,
// ~1.2 ms at the float32 rate); the climate instance reads b and its
// column total instead of making them and adds one tracer (~6.6 GB, ~2.0
// ms). The unfused float32 instance reads the four extended fields and
// writes four (~2.8 GB, ~0.85 ms), the bfloat16 instance reads u, v, T, S
// and b at 2 bytes a value (~2.0 GB, ~0.6 ms): the ~1 ms of operations
// bound both.
//
// Design (the level tile of tendency_tile.cuh, shared with kernel K6): a
// block of 32 x kTY threads owns 32 x kTY interior columns and marches z
// from the floor. Per level it stages u, v and the tracers with the
// WENO-5 reach of 3 into a shared-memory ring by cp.async, the next level's
// copies in flight while this level computes; computes each corner's PV,
// each centre's kinetic energy and each tracer face's WENO-5 flux once
// into shared memory; and each thread then differences them for its own
// cell. The carries stay in registers: each thread's column sums (w from
// continuity, the running sum of b dz for p) and, for 32 + kTY threads,
// those of one column of the tile's south or west apron, which the
// momentum stencil reads at j - 1 and i - 1; the bottom-face vertical
// terms; a six-level register ring per tracer for the vertical WENO-5
// (one new load a level); the AB2 update, the wall row and the depth
// integrals of u, v, u*, v*. b and its column total come either from the
// caller, in device memory (where a closure reads the same b: K4 and K1
// must agree to the ulp, which decides the sign of N^2), or, with the
// template flag OWN, from the kernel itself, as K6 makes them (eos.cuh):
// before its first level each carried column's owner walks down its column
// from device memory and sums b dz up from the floor, and on each level b
// is the equation of state of the T and S staged for the tracers (the b
// tracer itself in b mode), so no b field is read. OWN has the instances
// of one and two tracers (b; T, S; b and one closure tracer) in float32.
// The tracer count (1 to 4), the general schemes, the immersed
// integrals, the 2-D metrics, the fused epilogue (AB2 update, wall row of
// v*, integrals) and the storage type of the streamed fields are template
// parameters. The bfloat16 instance stages each level by 16-byte copies of
// 8 values (rows of 48 from a 16-byte boundary, where Nx + 2hx is a
// multiple of 8 and the fields are 16-byte aligned; else value by value)
// into a ring of bfloat16 slots, then widens the level once into one
// float32 slot, which the stencils read as they read the float32 ring: one
// more block barrier a level; 30848 B of shared memory a block at 2
// tracers against 29952 B for the float32 ring. On immersed
// grids only the accumulation of Us and Vs is masked, with the fluid test
// z_c > face bottom of grids/immersed.py; the stored u*, v* stay unmasked
// and the caller re-masks them. Outputs are fresh buffers: nothing is
// updated in place (the caller may still hold the previous state).
//
// Semantics follow the array path of the JAX package (ops/operators.py,
// models/hydrostatic.py): w = 0 below the bottom and the surface value
// above it; the fields' z ghosts (zero gradient) come with the extended
// inputs; the WENO-5 upwind test is strict (vel > 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstddef>
#include <type_traits>

// the equation of state's sums and products rounded by intrinsics: K1 is
// built without -fmad=false (eos.cuh)
#define GB25_EOS_RN
#include "eos.cuh"
#include "tendency_tile.cuh"

// Where the kernel makes b itself (OWN): mode (kEosTeos10, kEosLinear or
// kEosTracer), the indices of T and S among the tracers (b's twice in b
// mode), and the equations' scalars as K6 takes them
// (ops/pallas_tendency.py::eos_scalars, linear_scalars). Outside the
// unnamed namespace: the entry points take it, and a type of internal
// linkage in their signatures would make them internal too.
struct OwnB {
  int mode, iT, iS;
  float inv_sau, inv_ctu, inv_zu, neg_g, rho0, inv_rho0;
  float lin_g, lin_alpha, lin_T0, lin_beta, lin_S0;
};

namespace {

constexpr int kMaxTracers = 4;
using bf16 = __nv_bfloat16;

// S: the storage type of u, v, b and the tracers (float or bf16).
template <class S>
struct Args {
  using R = float;  // the arithmetic type (eos.cuh)
  const S* stage[2 + kMaxTracers];  // u, v, tracers: the staged fields
  FieldT<S> u, v, b;
  FieldT<S> tr[kMaxTracers];
  const float* btot;  // (Ny+2hy, Nx+2hx): column total of b dz
  // OWN: T and S (the b tracer twice in b mode) as fields and among the
  // staged tracers, the source of b and its scalars
  FieldT<S> T, S_;
  int iT, iS, eos;
  float inv_sau, inv_ctu, inv_zu, neg_g, rho0, inv_rho0;
  float lin_g, lin_alpha, lin_T0, lin_beta, lin_S0;
  // (Ny+2hy) y profiles, or (Ny+2hy, Nx+2hx) planes on the tripolar grid
  const float *dxc, *dxf, *dyc, *dyf, *azc, *azf, *fff;
  const float *dzc, *dzf, *zc;                           // (Nz+2hz) z profiles
  const float *bu, *bv;                                  // (Ny, Nx) face bottoms (immersed)
  const float *Gu_p, *Gv_p;                              // (Nz, Ny, Nx) previous G
  const float* Gtr_p[kMaxTracers];
  float *Gu, *Gv;                                        // (Nz, Ny, Nx) new G
  float* Gtr[kMaxTracers];
  float *un, *vn;                                        // (Nz, Ny, Nx) updated fields
  float* trn[kMaxTracers];
  float *U0, *V0, *Us, *Vs;                              // (Ny, Nx) depth integrals
  int Nx, Ny, Nz, hx, hy, hz;
  int align;             // staged column -3 - align is 16-byte aligned; -1: value by value
  int wall_row;          // 0: row 0 is the south wall; -1: no wall row on this tile
  float a, b_prev, eps;  // dt*c1, dt*c2, WENO epsilon
  Schemes sch;           // the advection and kinetic-energy schemes (general instances)
};

// A carried column's column total of b dz (the caller's, or with OWN its
// own, down the column from device memory) and 1 / azc.
template <bool M2, bool OWN, bool GEN, class A_>
__device__ __forceinline__ void start_column(Column& c, const A_& A, const Tile& t, int Xe) {
  const int Y = t.Y0 + c.y, X = t.X0 + c.x;
  if constexpr (OWN)
    c.tot = column_total<GEN>(A, Y, X);
  else
    c.tot = A.btot[(size_t)Y * Xe + X];
  c.razc = 1.0f / metric_at<M2>(A.azc, Y, X, Xe);
}

template <class S, int NF, int NTR, bool M2>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * (tile_floats<NF, NTR, M2>() - kStages * NF * kSF + ring_floats<S, NF>());
}

// FUSED: the AB2 update, the wall row of v* and the depth integrals; else
// the tendencies and the wall row of Gv alone. S: the storage type. GEN:
// the general instance, whose schemes are A.sch (and with OWN whose b is
// A.eos's); else the flagship's (and TEOS-10). OWN: b and its column
// totals made in the kernel, not read.
template <int NTR, bool IMM, bool M2, bool FUSED, class S, bool GEN, bool OWN>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    zslab_tendencies_kernel(const Args<S> A) {
  constexpr int NF = 2 + NTR;
  constexpr bool kF32 = std::is_same<S, float>::value;
  constexpr int kSXS = kF32 ? kSX : kSXH;  // a staged row of S
  constexpr int kSlotS = kSXS * kSY;
  static_assert(FUSED || !IMM, "the unfused form has no integrals to mask");
  static_assert(kF32 || !OWN, "the bf16-storage instance reads the b of the rounded T and S");
  const Schemes sch = GEN ? A.sch : kFlagship;
  extern __shared__ __align__(16) float smem[];
  const bool vec = A.align >= 0;
  const int a = vec ? A.align : 0;  // the staged rows' alignment
  // the float layout the stencils read: the float ring's, or the widened
  // slot's (columns from -3)
  const Tile t(A.Nx, A.Ny, A.hx, A.hy, kF32 ? a : 0);
  const int Xe = A.Nx + 2 * A.hx, Ye = A.Ny + 2 * A.hy;
  const size_t plane = (size_t)Ye * Xe;
  S* ring = reinterpret_cast<S*>(smem);  // [kStages][NF][kSlotS], then (bf16) [NF][kSF]
  float* mets = smem + ring_floats<S, NF>();
  float* pvq = mets + metric_floats<M2>();  // [kPY][kPX]
  float* keq = pvq + kPY * kPX;              // [kCY][kCX]
  float* wq = keq + kCY * kCX;
  float* pq = wq + kCY * kCX;
  float* fxq = pq + kCY * kCX;               // [NTR][kTY][kCX]
  float* fyq = fxq + NTR * kTY * kCX;        // [NTR][kCY][kTX]

  // the first levels in flight, then the metrics
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < A.Nz)
      stage_window<NF, kSXS>(ring + s * NF * kSlotS, A.stage, (size_t)(s + A.hz) * plane, t, Xe,
                             vec, a);
    cp_async_commit();
  }
  const Metrics<M2> m =
      stage_metrics<M2>(mets, A.dxc, A.dxf, A.dyc, A.dyf, A.azf, A.fff, t, Xe, Ye);

  const int tx = threadIdx.x, ty = threadIdx.y;
  const bool own = tx < t.nx && ty < t.ny;
  Column oc = {ty, tx, own};
  Column ac = apron_column(t);
  if (oc.on) start_column<M2, OWN, GEN>(oc, A, t, Xe);
  if (ac.on) start_column<M2, OWN, GEN>(ac, A, t, Xe);

  // this thread's column
  const int i = t.i0 + tx, j = t.j0 + ty;
  const int X = t.X0 + tx, Y = t.Y0 + ty;
  const size_t ij = own ? (size_t)j * A.Nx + i : 0;
  const size_t plane_i = (size_t)A.Ny * A.Nx;
  float r_dxc = 0.f, r_dyf = 0.f;
  float cz[NTR][6];  // c(Z - 2 .. Z + 3) of each tracer
  float bu = 0.f, bv = 0.f;  // face bottoms of this column (immersed)
  if (own) {
    r_dxc = 1.0f / metric_at<M2>(A.dxc, Y, X, Xe);
    r_dyf = 1.0f / metric_at<M2>(A.dyf, Y, X, Xe);
#pragma unroll
    for (int q = 0; q < NTR; ++q)
#pragma unroll
      for (int r = 0; r < 6; ++r) cz[q][r] = A.tr[q](A.hz - 2 + r, Y, X);
    if (IMM) {
      bu = A.bu[ij];
      bv = A.bv[ij];
    }
  }
  // the vertical terms at the bottom face of the level, carried from the
  // level below: w = 0 on the sea floor
  float xu = 0.f, xv = 0.f, fz[NTR];
#pragma unroll
  for (int q = 0; q < NTR; ++q) fz[q] = 0.f;
  const float wall = (j != A.wall_row) ? 1.0f : 0.0f;  // v and Gv vanish on the south wall
  float U0 = 0.f, V0 = 0.f, Us = 0.f, Vs = 0.f;

  for (int k = 0; k < A.Nz; ++k) {
    const int Z = k + A.hz;
    const float dzc = A.dzc[Z];
    // device-memory operands of this level, loaded before the wait: b of
    // the carried columns (unless OWN); for the own column u, v one level
    // up, the tracers three levels up (the vertical ring) and the previous G
    const float b_o = !OWN && oc.on ? A.b(Z, t.Y0 + oc.y, t.X0 + oc.x) : 0.f;
    const float b_a = !OWN && ac.on ? A.b(Z, t.Y0 + ac.y, t.X0 + ac.x) : 0.f;
    float un1 = 0.f, vn1 = 0.f, Gu_p = 0.f, Gv_p = 0.f, cnext[NTR], Gtr_p[NTR];
    const size_t o = (size_t)k * plane_i + ij;
    if (own) {
      un1 = A.u(Z + 1, Y, X);
      vn1 = A.v(Z + 1, Y, X);
      if (FUSED) {
        Gu_p = A.Gu_p[o];
        Gv_p = A.Gv_p[o];
      }
#pragma unroll
      for (int q = 0; q < NTR; ++q) {
        cnext[q] = k + 1 < A.Nz ? A.tr[q](Z + 4, Y, X) : 0.f;
        Gtr_p[q] = FUSED ? A.Gtr_p[q][o] : 0.f;
      }
    }

    cp_async_wait<kStages - 2>();
    __syncthreads();  // level k staged; every read of the slot reused next is done
    if (k + kStages - 1 < A.Nz)
      stage_window<NF, kSXS>(ring + ((k + kStages - 1) % kStages) * NF * kSlotS, A.stage,
                             (size_t)(Z + kStages - 1) * plane, t, Xe, vec, a);
    cp_async_commit();

    const float* slot;
    if constexpr (kF32) {
      slot = ring + (k % kStages) * NF * kSF + t.origin();
    } else {
      float* wide = reinterpret_cast<float*>(ring + kStages * NF * kSlotS);
      widen_level<NF>(wide, ring + (k % kStages) * NF * kSlotS, t, a);
      __syncthreads();  // the level widened
      slot = wide + t.origin();
    }
    const Win u{slot}, v{slot + kSF};
    // b dz of a carried column: b from device memory, or with OWN the
    // equation of state of its staged T and S
    auto bdz = [&](const Column& c, float b) {
      if constexpr (OWN)
        b = buoyancy<GEN>(A, Win{slot + (2 + A.iT) * kSF}(c.y, c.x),
                          Win{slot + (2 + A.iS) * kSF}(c.y, c.x), A.zc[Z]);
      return __fmul_rn(b, dzc);
    };
    // shared quantities of the level
    if (oc.on) column_level<true, M2>(oc, u, v, m, dzc, bdz(oc, b_o), keq, wq, pq, sch);
    if (ac.on) column_level<true, M2>(ac, u, v, m, dzc, bdz(ac, b_a), keq, wq, pq, sch);
    if (sch.mom != kMomNone) corner_pv<M2>(u, v, m, t, pvq);
    if (sch.tr != kTrNone) {
#pragma unroll
      for (int q = 0; q < NTR; ++q)
        tracer_faces<M2>(Win{slot + (2 + q) * kSF}, u, v, m, t, A.eps, sch.tr,
                         fxq + q * kTY * kCX, fyq + q * kCY * kTX);
    }
    __syncthreads();

    if (own) {
      float Gu, Gv;
      momentum<M2>(u, v, m, pvq, keq, wq, pq, ty, tx, r_dxc, r_dyf, un1, vn1,
                   1.0f / A.dzf[Z + 1], A.eps, sch, xu, xv, Gu, Gv);
      Gv = Gv * wall;
      const float w = wq[centre(ty, tx)];
      const float r_dzc = 1.0f / dzc;
      float Gc[NTR];
#pragma unroll
      for (int q = 0; q < NTR; ++q)
        Gc[q] = sch.tr == kTrNone
                    ? 0.0f
                    : tracer(fxq + q * kTY * kCX, fyq + q * kCY * kTX, cz[q], w, fz[q], ty, tx,
                             oc.razc, r_dzc, A.eps, sch.tr);

      A.Gu[o] = Gu;
      A.Gv[o] = Gv;
#pragma unroll
      for (int q = 0; q < NTR; ++q) {
        A.Gtr[q][o] = Gc[q];
        // quasi-AB2 update: x* = x + dt c1 G + dt c2 G_prev
        if (FUSED) A.trn[q][o] = (cz[q][2] + A.a * Gc[q]) + A.b_prev * Gtr_p[q];
#pragma unroll
        for (int r = 0; r < 5; ++r) cz[q][r] = cz[q][r + 1];
        cz[q][5] = cnext[q];
      }
      if (FUSED) {
        const float u0 = u(ty, tx), v0 = v(ty, tx);
        const float un = (u0 + A.a * Gu) + A.b_prev * Gu_p;
        const float vn = ((v0 + A.a * Gv) + A.b_prev * Gv_p) * wall;
        A.un[o] = un;
        A.vn[o] = vn;
        U0 = U0 + u0 * dzc;
        V0 = V0 + v0 * dzc;
        if (IMM) {
          const float zc = A.zc[Z];
          Us = Us + (un * (zc > bu ? 1.0f : 0.0f)) * dzc;
          Vs = Vs + (vn * (zc > bv ? 1.0f : 0.0f)) * dzc;
        } else {
          Us = Us + un * dzc;
          Vs = Vs + vn * dzc;
        }
      }
    }
  }
  if (FUSED && own) {
    A.U0[ij] = U0;
    A.V0[ij] = V0;
    A.Us[ij] = Us;
    A.Vs[ij] = Vs;
  }
}

template <int NTR, bool IMM, bool M2, bool FUSED = true, class S = float, bool GEN = false,
          bool OWN = false>
cudaError_t launch(const Args<S>& A, cudaStream_t s) {
  const size_t smem = smem_bytes<S, 2 + NTR, NTR, M2>();
  const cudaError_t err =
      allow_shared(zslab_tendencies_kernel<NTR, IMM, M2, FUSED, S, GEN, OWN>, smem);
  if (err != cudaSuccess) return err;
  const dim3 block(kTX, kTY, 1);
  const dim3 grid((A.Nx + kTX - 1) / kTX, (A.Ny + kTY - 1) / kTY, 1);
  zslab_tendencies_kernel<NTR, IMM, M2, FUSED, S, GEN, OWN><<<grid, block, smem, s>>>(A);
  return cudaGetLastError();
}

// out: registers per thread, shared memory per block (bytes), the tile's
// columns in x and in y, blocks resident on one SM.
template <int NTR, bool IMM, bool M2, bool FUSED = true, class S = float, bool GEN = false,
          bool OWN = false>
cudaError_t info(int* out) {
  return launch_info(zslab_tendencies_kernel<NTR, IMM, M2, FUSED, S, GEN, OWN>,
                     smem_bytes<S, 2 + NTR, NTR, M2>(), out);
}

bool valid(int mom, int ke, int tr) {
  return mom >= kMomWenoVI && mom <= kMomNone && ke >= kKeHollingsworth && ke <= kKeStandard &&
         tr >= kTrWeno5 && tr <= kTrNone;
}

bool aligned16(const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; }

// Whether a launch reads b and its column total (both given) or makes them
// (both null, own set: one or two tracers, T and S or b among them);
// 0, else cudaErrorInvalidValue.
int check_b(const void* b, const float* btot, const OwnB* own, int ntr) {
  if ((b == nullptr) != (btot == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (b != nullptr) return 0;
  if (own == nullptr || ntr > 2 || own->mode < kEosTeos10 || own->mode > kEosTracer ||
      own->iT < 0 || own->iT >= ntr || own->iS < 0 || own->iS >= ntr ||
      (own->iT == own->iS) != (own->mode == kEosTracer))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// The operands every instance reads; the staged rows' alignment for 16-byte
// copies of S (8 bfloat16 or 4 floats), or -1 where rows or fields are not
// 16-byte aligned. own: where b is made in the kernel, its source (null
// where b and btot are read).
template <class S>
Args<S> field_args(const S* u, const S* v, const S* b, const S* const* tr, int ntr,
                   const float* btot, const OwnB* own, const float* dxc, const float* dxf,
                   const float* dyc, const float* dyf, const float* azc, const float* azf,
                   const float* fff, const float* dzc, const float* dzf, const float* zc, int Nx,
                   int Ny, int Nz, int hx, int hy, int hz, int wall_v, float eps) {
  constexpr int kPer = 16 / sizeof(S);
  const int Xe = Nx + 2 * hx;
  const size_t plane = (size_t)(Ny + 2 * hy) * Xe;
  Args<S> A = {};
  A.u = FieldT<S>{u, Xe, plane};
  A.v = FieldT<S>{v, Xe, plane};
  A.b = FieldT<S>{b, Xe, plane};
  A.stage[0] = u;
  A.stage[1] = v;
  bool vec = Xe % kPer == 0 && aligned16(u) && aligned16(v);
  for (int t = 0; t < kMaxTracers; ++t) {
    const bool used = t < ntr;
    A.tr[t] = FieldT<S>{used ? tr[t] : nullptr, Xe, plane};
    A.stage[2 + t] = used ? tr[t] : nullptr;
    vec = vec && (!used || aligned16(tr[t]));
  }
  A.btot = btot;
  if (b == nullptr && own != nullptr) {
    A.T = A.tr[own->iT];
    A.S_ = A.tr[own->iS];
    A.iT = own->iT; A.iS = own->iS; A.eos = own->mode;
    A.inv_sau = own->inv_sau; A.inv_ctu = own->inv_ctu; A.inv_zu = own->inv_zu;
    A.neg_g = own->neg_g; A.rho0 = own->rho0; A.inv_rho0 = own->inv_rho0;
    A.lin_g = own->lin_g; A.lin_alpha = own->lin_alpha; A.lin_T0 = own->lin_T0;
    A.lin_beta = own->lin_beta; A.lin_S0 = own->lin_S0;
  }
  A.dxc = dxc; A.dxf = dxf; A.dyc = dyc; A.dyf = dyf; A.azc = azc; A.azf = azf; A.fff = fff;
  A.dzc = dzc; A.dzf = dzf; A.zc = zc;
  A.Nx = Nx; A.Ny = Ny; A.Nz = Nz; A.hx = hx; A.hy = hy; A.hz = hz;
  // (X0 - 3) % kPer: i0 is a multiple of 32
  A.align = vec ? ((hx - 3) % kPer + kPer) % kPer : -1;
  A.wall_row = wall_v ? 0 : -1;
  A.eps = eps;
  return A;
}

// Whether a launch takes the general instance: other schemes, one tracer,
// or (with own b) an equation of state other than TEOS-10.
bool general_instance(const Schemes& sch, int ntr, const OwnB* own) {
  return !is_flagship(sch, ntr) || (own != nullptr && own->mode != kEosTeos10);
}

// The fused instances of NTR tracers on the flat, immersed and tripolar
// grids.
#define GB25_K1_FUSED(F, NTR, GEN, OWN)                                                  \
  {F<NTR, false, false, true, float, GEN, OWN>, F<NTR, true, false, true, float, GEN, OWN>, \
   F<NTR, true, true, true, float, GEN, OWN>}

// Every fused instance that reads b, by [general][ntr - 1][flat, immersed,
// tripolar] (no flagship instance of one tracer), and every one that makes
// it, one or two tracers.
#define GB25_K1_FUSED_TABLE(F)                                                           \
  {{{nullptr, nullptr, nullptr}, GB25_K1_FUSED(F, 2, false, false),                      \
    GB25_K1_FUSED(F, 3, false, false), GB25_K1_FUSED(F, 4, false, false)},               \
   {GB25_K1_FUSED(F, 1, true, false), GB25_K1_FUSED(F, 2, true, false),                  \
    GB25_K1_FUSED(F, 3, true, false), GB25_K1_FUSED(F, 4, true, false)}}
#define GB25_K1_FUSED_OWN_TABLE(F)                                                       \
  {{{nullptr, nullptr, nullptr}, GB25_K1_FUSED(F, 2, false, true)},                      \
   {GB25_K1_FUSED(F, 1, true, true), GB25_K1_FUSED(F, 2, true, true)}}

// Every unfused instance of storage type S, by [general][ntr - 1][metric2d]
// (the flagship's instances have no one-tracer form).
#define GB25_K1_UNFUSED_TABLE(F, S)                                                      \
  {{{nullptr, nullptr},                                                                  \
    {F<2, false, false, false, S>, F<2, false, true, false, S>},                         \
    {F<3, false, false, false, S>, F<3, false, true, false, S>},                         \
    {F<4, false, false, false, S>, F<4, false, true, false, S>}},                        \
   {{F<1, false, false, false, S, true>, F<1, false, true, false, S, true>},             \
    {F<2, false, false, false, S, true>, F<2, false, true, false, S, true>},             \
    {F<3, false, false, false, S, true>, F<3, false, true, false, S, true>},             \
    {F<4, false, false, false, S, true>, F<4, false, true, false, S, true>}}}

// The unfused float32 instances that make b, by [general][ntr - 1][metric2d].
#define GB25_K1_UNFUSED_OWN_TABLE(F)                                                     \
  {{{nullptr, nullptr},                                                                  \
    {F<2, false, false, false, float, false, true>,                                      \
     F<2, false, true, false, float, false, true>}},                                     \
   {{F<1, false, false, false, float, true, true>, F<1, false, true, false, float, true, true>}, \
    {F<2, false, false, false, float, true, true>, F<2, false, true, false, float, true, true>}}}

template <class S>
int launch_unfused(const S* u, const S* v, const S* b, const S* const* tr, const float* btot,
                   const OwnB* own, const float* dxc, const float* dxf, const float* dyc,
                   const float* dyf, const float* azc, const float* azf, const float* fff,
                   const float* dzc, const float* dzf, const float* zc, float* Gu, float* Gv,
                   float* const* Gtr, int ntr, int Nx, int Ny, int Nz, int hx, int hy, int hz,
                   int metric2d, int wall_v, float eps, int mom, int ke, int trs, void* stream) {
  constexpr bool kF32 = std::is_same<S, float>::value;
  if (ntr < 1 || ntr > kMaxTracers || hx < 3 || hy < 3 || hz < 3 || !valid(mom, ke, trs))
    return static_cast<int>(cudaErrorInvalidValue);
  if (const int err = check_b(b, btot, own, ntr)) return err;
  const bool made = b == nullptr;
  if (made && (!kF32 || zc == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  Args<S> A = field_args<S>(u, v, b, tr, ntr, btot, own, dxc, dxf, dyc, dyf, azc, azf, fff, dzc,
                            dzf, zc, Nx, Ny, Nz, hx, hy, hz, wall_v, eps);
  A.Gu = Gu;
  A.Gv = Gv;
  for (int t = 0; t < ntr; ++t) A.Gtr[t] = Gtr[t];
  A.sch = Schemes{mom, ke, trs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using Launch = cudaError_t (*)(const Args<S>&, cudaStream_t);
  const bool gen = general_instance(A.sch, ntr, made ? own : nullptr);
  if constexpr (kF32) {
    if (made) {
      static const Launch owns[2][2][2] = GB25_K1_UNFUSED_OWN_TABLE(launch);
      return static_cast<int>(owns[gen][ntr - 1][metric2d ? 1 : 0](A, s));
    }
  }
  static const Launch launchers[2][4][2] = GB25_K1_UNFUSED_TABLE(launch, S);
  return static_cast<int>(launchers[gen][ntr - 1][metric2d ? 1 : 0](A, s));
}

}  // namespace

extern "C" const char* gb25_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// ntr tracers (1 to 4) in tr[0..ntr); the pointer arrays hold kMaxTracers
// entries, the unused ones null. b and btot: the extended buoyancy and its
// column total of b dz; in the b-tracer configuration b and tr[0] are the
// same field (both are only read). Both null: the kernel makes them from
// its staged tracers as own says (one or two tracers; own is read only
// then). mom, ke and trs: the scheme codes of tendency_tile.cuh; the
// flagship's (all 0) with two to four tracers, under TEOS-10 where b is
// made, launch the instances compiled for them, any other the general
// instances. bu and bv are null unless the grid is immersed; then zc (the
// extended z_c profile, which b made in the kernel reads too) is read.
// metric2d: the six metrics and fff are (Ny+2hy, Nx+2hx) planes (the
// tripolar grid, which is always immersed). wall_v: local row 0 is the
// south wall (serially, and on the south-most tiles of the decomposed
// path), so v* and Gv are 0 there; 0 on the other tiles, whose row 0 is an
// interior row.
extern "C" int zslab_tendencies_f32(
    const float* u, const float* v, const float* b, const float* const* tr, const float* btot,
    const OwnB* own, const float* dxc, const float* dxf, const float* dyc, const float* dyf,
    const float* azc, const float* azf, const float* fff, const float* dzc, const float* dzf,
    const float* zc, const float* bu, const float* bv, const float* Gu_p, const float* Gv_p,
    const float* const* Gtr_p, float* Gu, float* Gv, float* const* Gtr, float* un, float* vn,
    float* const* trn, float* U0, float* V0, float* Us, float* Vs, int ntr, int Nx, int Ny,
    int Nz, int hx, int hy, int hz, int metric2d, int wall_v, float a, float b_prev, float eps,
    int mom, int ke, int trs, void* stream) {
  if (ntr < 1 || ntr > kMaxTracers || hx < 3 || hy < 3 || hz < 3 || !valid(mom, ke, trs))
    return static_cast<int>(cudaErrorInvalidValue);
  if (const int err = check_b(b, btot, own, ntr)) return err;
  const bool made = b == nullptr;
  const bool imm = bu != nullptr;
  if (imm && (bv == nullptr || zc == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if ((metric2d && !imm) || (made && zc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args<float> A = field_args<float>(u, v, b, tr, ntr, btot, own, dxc, dxf, dyc, dyf, azc, azf,
                                    fff, dzc, dzf, zc, Nx, Ny, Nz, hx, hy, hz, wall_v, eps);
  for (int t = 0; t < ntr; ++t) {
    A.Gtr_p[t] = Gtr_p[t];
    A.Gtr[t] = Gtr[t];
    A.trn[t] = trn[t];
  }
  A.bu = bu; A.bv = bv;
  A.Gu_p = Gu_p; A.Gv_p = Gv_p;
  A.Gu = Gu; A.Gv = Gv;
  A.un = un; A.vn = vn;
  A.U0 = U0; A.V0 = V0; A.Us = Us; A.Vs = Vs;
  A.a = a; A.b_prev = b_prev;
  A.sch = Schemes{mom, ke, trs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using Launch = cudaError_t (*)(const Args<float>&, cudaStream_t);
  static const Launch read[2][4][3] = GB25_K1_FUSED_TABLE(launch);
  static const Launch owns[2][2][3] = GB25_K1_FUSED_OWN_TABLE(launch);
  const int geometry = imm ? (metric2d ? 2 : 1) : 0;
  const bool gen = general_instance(A.sch, ntr, made ? own : nullptr);
  return static_cast<int>((made ? owns[gen][ntr - 1] : read[gen][ntr - 1])[geometry](A, s));
}
// The unfused instances (no AB2 update, no integrals; the wall row of Gv
// where wall_v): one to four tracers, the metrics as y profiles or, with
// metric2d, as (Ny+2hy, Nx+2hx) planes (the tripolar grid; no immersed
// variant: only the fused integrals read the face bottoms). u, v, b and
// the tracers float32, or bfloat16 in the bf16-storage instances; btot,
// the metrics and the outputs float32. b and btot null: the float32
// instances make them as own says, as zslab_tendencies_f32's, reading zc
// (the bf16-storage instances read them always, and not zc). The schemes
// as zslab_tendencies_f32's.
extern "C" int zslab_tendencies_unfused_f32(
    const float* u, const float* v, const float* b, const float* const* tr, const float* btot,
    const OwnB* own, const float* dxc, const float* dxf, const float* dyc, const float* dyf,
    const float* azc, const float* azf, const float* fff, const float* dzc, const float* dzf,
    const float* zc, float* Gu, float* Gv, float* const* Gtr, int ntr, int Nx, int Ny, int Nz,
    int hx, int hy, int hz, int metric2d, int wall_v, float eps, int mom, int ke, int trs,
    void* stream) {
  return launch_unfused<float>(u, v, b, tr, btot, own, dxc, dxf, dyc, dyf, azc, azf, fff, dzc,
                               dzf, zc, Gu, Gv, Gtr, ntr, Nx, Ny, Nz, hx, hy, hz, metric2d,
                               wall_v, eps, mom, ke, trs, stream);
}

extern "C" int zslab_tendencies_unfused_bf16(
    const bf16* u, const bf16* v, const bf16* b, const bf16* const* tr, const float* btot,
    const OwnB* own, const float* dxc, const float* dxf, const float* dyc, const float* dyf,
    const float* azc, const float* azf, const float* fff, const float* dzc, const float* dzf,
    const float* zc, float* Gu, float* Gv, float* const* Gtr, int ntr, int Nx, int Ny, int Nz,
    int hx, int hy, int hz, int metric2d, int wall_v, float eps, int mom, int ke, int trs,
    void* stream) {
  return launch_unfused<bf16>(u, v, b, tr, btot, own, dxc, dxf, dyc, dyf, azc, azf, fff, dzc,
                              dzf, zc, Gu, Gv, Gtr, ntr, Nx, Ny, Nz, hx, hy, hz, metric2d,
                              wall_v, eps, mom, ke, trs, stream);
}

// The launch shape of one instance (ntr, immersed, metric2d; form 0 the
// fused instances, 1 the unfused float32 one, 2 the unfused bf16-storage
// one; general: the general instance; own: the float32 instance that makes
// b, of one or two tracers), as tendency_tile.cuh's launch_info reports it
// into out[0..5).
extern "C" int zslab_tendencies_info(int ntr, int immersed, int metric2d, int form, int general,
                                     int own, int* out) {
  using Info = cudaError_t (*)(int*);
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  const int g = general ? 1 : 0;
  if (ntr < 1 || ntr > kMaxTracers || form < 0 || form > 2 || (ntr == 1 && !g) ||
      (own && (ntr > 2 || form == 2)))
    return invalid;
  if (form != 0) {
    if (immersed) return invalid;
    static const Info f32[2][4][2] = GB25_K1_UNFUSED_TABLE(info, float);
    static const Info h16[2][4][2] = GB25_K1_UNFUSED_TABLE(info, bf16);
    static const Info owns[2][2][2] = GB25_K1_UNFUSED_OWN_TABLE(info);
    const int m = metric2d ? 1 : 0;
    return static_cast<int>(
        (own ? owns[g][ntr - 1][m] : (form == 1 ? f32 : h16)[g][ntr - 1][m])(out));
  }
  if (metric2d && !immersed) return invalid;
  static const Info read[2][4][3] = GB25_K1_FUSED_TABLE(info);
  static const Info owns[2][2][3] = GB25_K1_FUSED_OWN_TABLE(info);
  const int geometry = immersed ? (metric2d ? 2 : 1) : 0;
  return static_cast<int>((own ? owns[g][ntr - 1] : read[g][ntr - 1])[geometry](out));
}
