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
// reads five extended fields (u, v, T, S, b) and four previous tendencies
// and writes eight interior fields (~5 GB at 1536x768x64 f32, ~1.6 ms at
// 3.35 TB/s) against ~600 flop per cell (~6e10 flop, ~1 ms at the float32
// rate); the climate instance adds one tracer (~6.6 GB, ~2.0 ms). The
// unfused float32 instance reads the five extended fields and writes four
// (~2.8 GB, ~0.85 ms), the bfloat16 instance reads those five at 2 bytes a
// value (~2.0 GB, ~0.6 ms): the ~1 ms of operations bound both.
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
// integrals of u, v, u*, v*. b and its column total come from device
// memory (the caller's equation of state, or the b tracer itself). The
// tracer count (1 to 4), the general schemes, the immersed
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

#include "tendency_tile.cuh"

namespace {

constexpr int kMaxTracers = 4;
using bf16 = __nv_bfloat16;

// S: the storage type of u, v, b and the tracers (float or bf16).
template <class S>
struct Args {
  const S* stage[2 + kMaxTracers];  // u, v, tracers: the staged fields
  FieldT<S> u, v, b;
  FieldT<S> tr[kMaxTracers];
  const float* btot;  // (Ny+2hy, Nx+2hx): column total of b dz
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

// A carried column's column total of b dz and 1 / azc.
template <bool M2, class A_>
__device__ __forceinline__ void start_column(Column& c, const A_& A, const Tile& t, int Xe) {
  const int Y = t.Y0 + c.y, X = t.X0 + c.x;
  c.tot = A.btot[(size_t)Y * Xe + X];
  c.razc = 1.0f / metric_at<M2>(A.azc, Y, X, Xe);
}

template <class S, int NF, int NTR, bool M2>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * (tile_floats<NF, NTR, M2>() - kStages * NF * kSF + ring_floats<S, NF>());
}

// FUSED: the AB2 update, the wall row of v* and the depth integrals; else
// the tendencies and the wall row of Gv alone. S: the storage type. GEN:
// the general instance, whose schemes are A.sch; else the flagship's.
template <int NTR, bool IMM, bool M2, bool FUSED, class S, bool GEN>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    zslab_tendencies_kernel(const Args<S> A) {
  constexpr int NF = 2 + NTR;
  constexpr bool kF32 = std::is_same<S, float>::value;
  constexpr int kSXS = kF32 ? kSX : kSXH;  // a staged row of S
  constexpr int kSlotS = kSXS * kSY;
  static_assert(FUSED || !IMM, "the unfused form has no integrals to mask");
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
  if (oc.on) start_column<M2>(oc, A, t, Xe);
  if (ac.on) start_column<M2>(ac, A, t, Xe);

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
    // the carried columns; for the own column u, v one level up, the
    // tracers three levels up (the vertical ring) and the previous G
    const float b_o = oc.on ? A.b(Z, t.Y0 + oc.y, t.X0 + oc.x) : 0.f;
    const float b_a = ac.on ? A.b(Z, t.Y0 + ac.y, t.X0 + ac.x) : 0.f;
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
    // shared quantities of the level
    if (oc.on)
      column_level<true, M2>(oc, u, v, m, dzc, __fmul_rn(b_o, dzc), keq, wq, pq, sch);
    if (ac.on)
      column_level<true, M2>(ac, u, v, m, dzc, __fmul_rn(b_a, dzc), keq, wq, pq, sch);
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

template <int NTR, bool IMM, bool M2, bool FUSED = true, class S = float, bool GEN = false>
cudaError_t launch(const Args<S>& A, cudaStream_t s) {
  const size_t smem = smem_bytes<S, 2 + NTR, NTR, M2>();
  const cudaError_t err =
      allow_shared(zslab_tendencies_kernel<NTR, IMM, M2, FUSED, S, GEN>, smem);
  if (err != cudaSuccess) return err;
  const dim3 block(kTX, kTY, 1);
  const dim3 grid((A.Nx + kTX - 1) / kTX, (A.Ny + kTY - 1) / kTY, 1);
  zslab_tendencies_kernel<NTR, IMM, M2, FUSED, S, GEN><<<grid, block, smem, s>>>(A);
  return cudaGetLastError();
}

// out: registers per thread, shared memory per block (bytes), the tile's
// columns in x and in y, blocks resident on one SM.
template <int NTR, bool IMM, bool M2, bool FUSED = true, class S = float, bool GEN = false>
cudaError_t info(int* out) {
  return launch_info(zslab_tendencies_kernel<NTR, IMM, M2, FUSED, S, GEN>,
                     smem_bytes<S, 2 + NTR, NTR, M2>(), out);
}

bool valid(int mom, int ke, int tr) {
  return mom >= kMomWenoVI && mom <= kMomNone && ke >= kKeHollingsworth && ke <= kKeStandard &&
         tr >= kTrWeno5 && tr <= kTrNone;
}

bool aligned16(const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; }

// The operands every instance reads; the staged rows' alignment for 16-byte
// copies of S (8 bfloat16 or 4 floats), or -1 where rows or fields are not
// 16-byte aligned.
template <class S>
Args<S> field_args(const S* u, const S* v, const S* b, const S* const* tr, int ntr,
                   const float* btot, const float* dxc, const float* dxf, const float* dyc,
                   const float* dyf, const float* azc, const float* azf, const float* fff,
                   const float* dzc, const float* dzf, const float* zc, int Nx, int Ny, int Nz,
                   int hx, int hy, int hz, int wall_v, float eps) {
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
  A.dxc = dxc; A.dxf = dxf; A.dyc = dyc; A.dyf = dyf; A.azc = azc; A.azf = azf; A.fff = fff;
  A.dzc = dzc; A.dzf = dzf; A.zc = zc;
  A.Nx = Nx; A.Ny = Ny; A.Nz = Nz; A.hx = hx; A.hy = hy; A.hz = hz;
  // (X0 - 3) % kPer: i0 is a multiple of 32
  A.align = vec ? ((hx - 3) % kPer + kPer) % kPer : -1;
  A.wall_row = wall_v ? 0 : -1;
  A.eps = eps;
  return A;
}

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

template <class S>
int launch_unfused(const S* u, const S* v, const S* b, const S* const* tr, const float* btot,
                   const float* dxc, const float* dxf, const float* dyc, const float* dyf,
                   const float* azc, const float* azf, const float* fff, const float* dzc,
                   const float* dzf, float* Gu, float* Gv, float* const* Gtr, int ntr, int Nx,
                   int Ny, int Nz, int hx, int hy, int hz, int metric2d, int wall_v, float eps,
                   int mom, int ke, int trs, void* stream) {
  if (ntr < 1 || ntr > kMaxTracers || hx < 3 || hy < 3 || hz < 3 || !valid(mom, ke, trs))
    return static_cast<int>(cudaErrorInvalidValue);
  Args<S> A = field_args<S>(u, v, b, tr, ntr, btot, dxc, dxf, dyc, dyf, azc, azf, fff, dzc, dzf,
                            nullptr, Nx, Ny, Nz, hx, hy, hz, wall_v, eps);
  A.Gu = Gu;
  A.Gv = Gv;
  for (int t = 0; t < ntr; ++t) A.Gtr[t] = Gtr[t];
  A.sch = Schemes{mom, ke, trs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using Launch = cudaError_t (*)(const Args<S>&, cudaStream_t);
  static const Launch launchers[2][4][2] = GB25_K1_UNFUSED_TABLE(launch, S);
  return static_cast<int>(
      launchers[!is_flagship(A.sch, ntr)][ntr - 1][metric2d ? 1 : 0](A, s));
}

}  // namespace

extern "C" const char* gb25_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// ntr tracers (1 to 4) in tr[0..ntr); the pointer arrays hold kMaxTracers
// entries, the unused ones null. In the b-tracer configuration b and tr[0]
// are the same field: both are only read. mom, ke and trs: the scheme
// codes of tendency_tile.cuh; the flagship's (all 0) with two to four
// tracers launch the instances compiled for them, any other the general
// instances. bu and bv are null unless the grid is
// immersed; then zc (the extended z_c profile) is read too. metric2d: the
// six metrics and fff are (Ny+2hy, Nx+2hx) planes (the tripolar grid,
// which is always immersed). wall_v: local row 0 is the south wall (serially,
// and on the south-most tiles of the decomposed path), so v* and Gv are 0
// there; 0 on the other tiles, whose row 0 is an interior row.
extern "C" int zslab_tendencies_f32(
    const float* u, const float* v, const float* b, const float* const* tr, const float* btot,
    const float* dxc, const float* dxf, const float* dyc, const float* dyf, const float* azc,
    const float* azf, const float* fff, const float* dzc, const float* dzf, const float* zc,
    const float* bu, const float* bv, const float* Gu_p, const float* Gv_p,
    const float* const* Gtr_p, float* Gu, float* Gv, float* const* Gtr, float* un, float* vn,
    float* const* trn, float* U0, float* V0, float* Us, float* Vs, int ntr, int Nx, int Ny,
    int Nz, int hx, int hy, int hz, int metric2d, int wall_v, float a, float b_prev, float eps,
    int mom, int ke, int trs, void* stream) {
  if (ntr < 1 || ntr > kMaxTracers || hx < 3 || hy < 3 || hz < 3 || !valid(mom, ke, trs))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool imm = bu != nullptr;
  if (imm && (bv == nullptr || zc == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (metric2d && !imm) return static_cast<int>(cudaErrorInvalidValue);
  Args<float> A = field_args<float>(u, v, b, tr, ntr, btot, dxc, dxf, dyc, dyf, azc, azf, fff,
                                    dzc, dzf, zc, Nx, Ny, Nz, hx, hy, hz, wall_v, eps);
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
  // [general][ntr - 1][flat, immersed, tripolar]; no flagship instance of one tracer
  using Launch = cudaError_t (*)(const Args<float>&, cudaStream_t);
  static const Launch launchers[2][4][3] = {
      {{nullptr, nullptr, nullptr},
       {launch<2, false, false>, launch<2, true, false>, launch<2, true, true>},
       {launch<3, false, false>, launch<3, true, false>, launch<3, true, true>},
       {launch<4, false, false>, launch<4, true, false>, launch<4, true, true>}},
      {{launch<1, false, false, true, float, true>, launch<1, true, false, true, float, true>,
        launch<1, true, true, true, float, true>},
       {launch<2, false, false, true, float, true>, launch<2, true, false, true, float, true>,
        launch<2, true, true, true, float, true>},
       {launch<3, false, false, true, float, true>, launch<3, true, false, true, float, true>,
        launch<3, true, true, true, float, true>},
       {launch<4, false, false, true, float, true>, launch<4, true, false, true, float, true>,
        launch<4, true, true, true, float, true>}},
  };
  const int geometry = imm ? (metric2d ? 2 : 1) : 0;
  return static_cast<int>(launchers[!is_flagship(A.sch, ntr)][ntr - 1][geometry](A, s));
}

// The unfused instances (no AB2 update, no integrals; the wall row of Gv
// where wall_v): one to four tracers, the metrics as y profiles or, with
// metric2d, as (Ny+2hy, Nx+2hx) planes (the tripolar grid; no immersed
// variant: only the fused integrals read the face bottoms). u, v, b and
// the tracers float32, or bfloat16 in the bf16-storage instances; btot,
// the metrics and the outputs float32. The schemes as
// zslab_tendencies_f32's.
extern "C" int zslab_tendencies_unfused_f32(
    const float* u, const float* v, const float* b, const float* const* tr, const float* btot,
    const float* dxc, const float* dxf, const float* dyc, const float* dyf, const float* azc,
    const float* azf, const float* fff, const float* dzc, const float* dzf, float* Gu, float* Gv,
    float* const* Gtr, int ntr, int Nx, int Ny, int Nz, int hx, int hy, int hz, int metric2d,
    int wall_v, float eps, int mom, int ke, int trs, void* stream) {
  return launch_unfused<float>(u, v, b, tr, btot, dxc, dxf, dyc, dyf, azc, azf, fff, dzc, dzf,
                               Gu, Gv, Gtr, ntr, Nx, Ny, Nz, hx, hy, hz, metric2d, wall_v, eps,
                               mom, ke, trs, stream);
}

extern "C" int zslab_tendencies_unfused_bf16(
    const bf16* u, const bf16* v, const bf16* b, const bf16* const* tr, const float* btot,
    const float* dxc, const float* dxf, const float* dyc, const float* dyf, const float* azc,
    const float* azf, const float* fff, const float* dzc, const float* dzf, float* Gu, float* Gv,
    float* const* Gtr, int ntr, int Nx, int Ny, int Nz, int hx, int hy, int hz, int metric2d,
    int wall_v, float eps, int mom, int ke, int trs, void* stream) {
  return launch_unfused<bf16>(u, v, b, tr, btot, dxc, dxf, dyc, dyf, azc, azf, fff, dzc, dzf,
                              Gu, Gv, Gtr, ntr, Nx, Ny, Nz, hx, hy, hz, metric2d, wall_v, eps,
                              mom, ke, trs, stream);
}

// The launch shape of one instance (ntr, immersed, metric2d; form 0 the
// fused instances, 1 the unfused float32 one, 2 the unfused bf16-storage
// one; general: the general instance), as tendency_tile.cuh's launch_info
// reports it into out[0..5).
extern "C" int zslab_tendencies_info(int ntr, int immersed, int metric2d, int form, int general,
                                     int* out) {
  using Info = cudaError_t (*)(int*);
  if (form != 0) {
    if (form > 2 || ntr < 1 || ntr > kMaxTracers || immersed || (ntr == 1 && !general))
      return static_cast<int>(cudaErrorInvalidValue);
    static const Info f32[2][4][2] = GB25_K1_UNFUSED_TABLE(info, float);
    static const Info h16[2][4][2] = GB25_K1_UNFUSED_TABLE(info, bf16);
    return static_cast<int>(
        (form == 1 ? f32 : h16)[general ? 1 : 0][ntr - 1][metric2d ? 1 : 0](out));
  }
  if (ntr < 1 || ntr > kMaxTracers || (metric2d && !immersed) || (ntr == 1 && !general))
    return static_cast<int>(cudaErrorInvalidValue);
  static const Info infos[2][4][3] = {
      {{nullptr, nullptr, nullptr},
       {info<2, false, false>, info<2, true, false>, info<2, true, true>},
       {info<3, false, false>, info<3, true, false>, info<3, true, true>},
       {info<4, false, false>, info<4, true, false>, info<4, true, true>}},
      {{info<1, false, false, true, float, true>, info<1, true, false, true, float, true>,
        info<1, true, true, true, float, true>},
       {info<2, false, false, true, float, true>, info<2, true, false, true, float, true>,
        info<2, true, true, true, float, true>},
       {info<3, false, false, true, float, true>, info<3, true, false, true, float, true>,
        info<3, true, true, true, float, true>},
       {info<4, false, false, true, float, true>, info<4, true, false, true, float, true>,
        info<4, true, true, true, float, true>}},
  };
  return static_cast<int>(infos[general ? 1 : 0][ntr - 1][immersed ? (metric2d ? 2 : 1) : 0](out));
}
