// The level tile shared by kernel K1 (zslab_tendencies.cu) and kernel K6
// (tendencies.cu): a block owns kTX x kTY interior columns and marches z
// from the floor. At each level it stages u, v and the tracers, with the
// WENO-5 reach of 3 in x and y, into a ring of shared-memory slots by
// cp.async (level k + kStages - 1 is in flight while level k computes),
// computes every quantity that several cells share once per level into
// shared memory (the potential vorticity at the corners, the kinetic
// energy, the tracers' WENO-5 face fluxes), and each thread then
// differences them for its own cell. On the tripolar grid the six metric
// planes are staged once per block; elsewhere their y profiles.
//
// Each stencil keeps the expression and rounding order of the array path
// of the JAX package (ops/operators.py, models/hydrostatic.py) as the
// port's plain versions evaluate it; a reciprocal of a metric is taken
// once (the same float either way). The WENO-5 and first-order upwind
// tests are strict (vel > 0).
//
// The advection and kinetic-energy schemes (models/config.py) arrive as a
// Schemes value: the flagship's instances pass the constant kFlagship, so
// every scheme branch folds away at compile time and their code is that of
// the flagship alone; the general instances read the codes from the launch
// arguments, the same for every thread, so the branches are uniform.
//
// The arithmetic type R of every helper below is a template parameter
// that defaults to float: K1 and K6's float32 and bfloat16 instances use
// the float helpers, K6's float64 instance the same expressions in double
// (each float literal is R(literal), which is the same float).
//
// Coordinates: (y, x) are relative to the tile's first interior cell;
// extended index Y = Y0 + y, X = X0 + x.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstddef>
#include <type_traits>

#include "cp_async.cuh"

namespace {

// The tile shape, the ring depth and the register cap are measured
// choices (32 x 4 and 32 x 16 tiles, a three-level ring, 1, 2 and 4
// blocks per SM were slower: PERF.md section 6).
constexpr int kTX = 32;  // a warp along x
constexpr int kTY = 8;   // rows of a tile
constexpr int kThreads = kTX * kTY;
constexpr int kStages = 2;  // levels in the shared-memory ring
// Blocks per SM the registers must allow: 3 caps a thread at 80 registers
// and gives an SM 24 warps to hide the barriers and the copies; left free,
// the compiler takes 105-150 and an SM holds one or two blocks, 1.1-1.7x
// slower.
constexpr int kMinBlocks = 3;
// A staged (y, x) window: rows -3 .. kTY + 2 and columns -3 - a ..
// kTX + 2, where a <= 3 starts each row on a 16-byte boundary.
constexpr int kSX = kTX + 12, kSY = kTY + 6, kSF = kSX * kSY;
// The same window of bfloat16 (K1's bf16-storage instance): 16 bytes hold
// 8 values, so a <= 7 and a row is 48 values.
constexpr int kSXH = kTX + 16, kSFH = kSXH * kSY;
constexpr int kPX = kTX + 5, kPY = kTY + 5;  // corners -2 .. kT + 2
constexpr int kCX = kTX + 1, kCY = kTY + 1;  // centres -1 .. kT - 1
constexpr int kApron = kTX + kTY;  // the south row and the west column of centres
constexpr int kMetrics = 6;        // dxc, dxf, dyc, dyf, 1 / azf, f
enum { kDXC, kDXF, kDYC, kDYF, kRAZF, kFFF };
static_assert(kSX % 4 == 0 && kSXH % 8 == 0, "staged rows are whole 16-byte copies");

// Scheme codes, in the order of models/config.py's MOMENTUM_ADVECTION,
// KE_SCHEMES and TRACER_ADVECTION.
enum { kMomWenoVI = 0, kMomVI = 1, kMomNone = 2 };
enum { kKeHollingsworth = 0, kKeStandard = 1 };
enum { kTrWeno5 = 0, kTrCentered2 = 1, kTrUpwind1 = 2, kTrNone = 3 };

struct Schemes {
  int mom, ke, tr;
};
constexpr Schemes kFlagship = {kMomWenoVI, kKeHollingsworth, kTrWeno5};

// Whether a launch takes the compiled (flagship) instance: the flagship's
// schemes with two or more tracers (one tracer has no compiled instance).
inline bool is_flagship(const Schemes& sch, int ntr) {
  return ntr >= 2 && sch.mom == kFlagship.mom && sch.ke == kFlagship.ke &&
         sch.tr == kFlagship.tr;
}
static_assert(2 * kApron <= kThreads, "apron columns and apron faces need their own threads");

// The arithmetic type of a storage type: float for float and bfloat16,
// double for double.
template <class S>
using Real = typename std::conditional<std::is_same<S, double>::value, double, float>::type;

// T itself, in a parameter that must not take part in deducing T.
template <class T>
struct NoDeduceT {
  using type = T;
};
template <class T>
using NoDeduce = typename NoDeduceT<T>::type;

// A value of device memory in its arithmetic type (bfloat16 widens
// exactly to float).
__device__ __forceinline__ float load_real(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_real(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ double load_real(const double* p) { return __ldg(p); }

// Sums and products rounded on their own, never fused into a
// multiply-add.
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// A halo-extended (Z, Y, X) field in device memory, stored as T (float,
// bfloat16 in K1's bf16-storage instance, double in K6's float64
// instance), read in its arithmetic type.
template <class T>
struct FieldT {
  const T* p;
  int Xe;
  size_t plane;  // (Ny + 2hy) * (Nx + 2hx)
  __device__ __forceinline__ Real<T> operator()(int z, int y, int x) const {
    return load_real(p + (size_t)z * plane + (size_t)y * Xe + x);
  }
};
using Field = FieldT<float>;

// This block's tile.
struct Tile {
  int i0, j0;  // first interior column
  int nx, ny;  // interior columns it holds (fewer at the ragged east and north edges)
  int X0, Y0;  // extended index of (0, 0)
  int a;       // staged column of x = -3 - a is 16-byte aligned
  __device__ Tile(int Nx, int Ny, int hx, int hy, int align)
      : i0(blockIdx.x * kTX), j0(blockIdx.y * kTY), nx(min(kTX, Nx - i0)),
        ny(min(kTY, Ny - j0)), X0(i0 + hx), Y0(j0 + hy), a(align) {}
  // the offset of (0, 0) in a staged window
  __device__ __forceinline__ int origin() const { return 3 * kSX + 3 + a; }
};

// A staged window; (0, 0) at the tile's first interior cell.
template <class R = float>
struct WinT {
  const R* p;
  __device__ __forceinline__ R operator()(int y, int x) const { return p[y * kSX + x]; }
};
using Win = WinT<>;

// A metric: a staged window (M2) or a staged y profile.
template <bool M2, class R = float>
struct Met {
  const R* p;
  __device__ __forceinline__ R operator()(int y, int x) const {
    return M2 ? p[y * kSX + x] : p[y];
  }
};

template <bool M2, class R = float>
struct Metrics {
  Met<M2, R> dxc, dxf, dyc, dyf, razf, fff;
};

template <bool M2>
__host__ __device__ constexpr int metric_floats() {
  return kMetrics * (M2 ? kSF : kSY);
}

// Shared memory of a tile kernel, in values of its arithmetic type (floats,
// or doubles in K6's float64 instance): the ring of NF staged fields,
// the metrics, the corner PV, the kinetic energy, w and p at the centres
// with their west and south apron, and the tracers' x- and y-face fluxes.
template <int NF, int NTR, bool M2>
__host__ __device__ constexpr int tile_floats() {
  return kStages * NF * kSF + metric_floats<M2>() + kPY * kPX + 3 * kCY * kCX +
         NTR * (kTY * kCX + kCY * kTX);
}

// Values of shared memory (as tile_floats counts them) the ring of staged
// fields takes: kStages slots of S; with bfloat16 storage, kStages
// bfloat16 slots (rows of kSXH) and the one float slot the level is
// widened into.
template <class S, int NF>
__host__ __device__ constexpr int ring_floats() {
  return !std::is_same<S, __nv_bfloat16>::value ? kStages * NF * kSF
                                                : kStages * NF * kSFH / 2 + NF * kSF;
}

// Widen the staged bfloat16 slot of a level (columns from -3 - a) into the
// float slot (columns from -3), over the rows and columns the tile reads.
template <int NF>
__device__ __forceinline__ void widen_level(float* dst, const __nv_bfloat16* src, const Tile& t, int a) {
  const int tid = threadIdx.y * kTX + threadIdx.x;
  const int rows = t.ny + 6, cols = t.nx + 6;
  for (int n = tid; n < NF * kSF; n += kThreads) {
    const int q = n / kSF, r = n - q * kSF;
    const int y = r / kSX, x = r - y * kSX;
    if (y < rows && x < cols) dst[n] = __bfloat162float(src[q * kSFH + y * kSXH + x + a]);
  }
}

// Index of the corner (y, x), of the centre (y, x), of the x face (y, xf)
// and of the y face (yf, x) in their shared arrays.
__device__ __forceinline__ int corner(int y, int x) { return (y + 2) * kPX + x + 2; }
__device__ __forceinline__ int centre(int y, int x) { return (y + 1) * kCX + x + 1; }
__device__ __forceinline__ int xface(int y, int xf) { return y * kCX + xf; }
__device__ __forceinline__ int yface(int yf, int x) { return yf * kTX + x; }

// The first NF fields' level at offset zoff into one ring slot of T, rows
// of SX values: rows -3 .. ny + 2, columns -3 .. nx + 2 of the tile, as
// 16-byte copies from column -3 - a (vec), else value by value from column
// -3 (a = 0): float by 4-byte copies, bfloat16 (whose cp.async has no
// 2-byte form) and double by plain loads, which the block barrier after
// the wait publishes as it does the copies.
template <int NF, int SX, class T, int N>
__device__ __forceinline__ void stage_window(T* slot, const T* const (&f)[N], size_t zoff,
                                             const Tile& t, int Xe, bool vec, int a) {
  static_assert(NF <= N, "more staged fields than field pointers");
  constexpr int kPer = 16 / sizeof(T);  // values a 16-byte copy carries
  constexpr int kVec = SX / kPer;       // 16-byte copies per staged row
  constexpr int kSlot = SX * kSY;
  const int tid = threadIdx.y * kTX + threadIdx.x;
  const int rows = t.ny + 6;
  const size_t base = zoff + (size_t)(t.Y0 - 3) * Xe + (t.X0 - 3 - a);
  if (vec) {
    const int nvec = (a + t.nx + 6 + kPer - 1) / kPer;
    for (int n = tid; n < kSY * kVec; n += kThreads) {
      const int y = n / kVec, v = n - y * kVec;
      if (y < rows && v < nvec) {
#pragma unroll
        for (int q = 0; q < NF; ++q)
          cp_async16(slot + q * kSlot + y * SX + kPer * v,
                     f[q] + base + (size_t)y * Xe + kPer * v);
      }
    }
  } else {
    const int cols = t.nx + 6;
    for (int n = tid; n < kSY * SX; n += kThreads) {
      const int y = n / SX, x = n - y * SX;
      if (y < rows && x < cols) {
#pragma unroll
        for (int q = 0; q < NF; ++q) {
          if constexpr (sizeof(T) == 4)
            cp_async4(slot + q * kSlot + y * SX + x, f[q] + base + (size_t)y * Xe + x);
          else
            slot[q * kSlot + y * SX + x] = f[q][base + (size_t)y * Xe + x];
        }
      }
    }
  }
}

// The float ring's staging: columns from -3 - t.a.
template <int NF, int N>
__device__ __forceinline__ void stage_level(float* slot, const float* const (&f)[N],
                                            size_t zoff, const Tile& t, int Xe, bool vec) {
  stage_window<NF, kSX>(slot, f, zoff, t, Xe, vec, t.a);
}

// The metrics, once per block (plain loads): on M2 grids the six planes
// over the staged window, else the six y profiles over its rows; 1 / azf
// in place of azf. Returns the accessors.
template <bool M2, class R = float>
__device__ Metrics<M2, R> stage_metrics(R* m, const R* dxc, const R* dxf, const R* dyc,
                                        const R* dyf, const R* azf, const R* fff, const Tile& t,
                                        int Xe, int Ye) {
  const int tid = threadIdx.y * kTX + threadIdx.x;
  if (M2) {
    for (int n = tid; n < kSF; n += kThreads) {
      const int y = n / kSX, x = n - y * kSX;
      const int Y = t.Y0 - 3 + y, X = t.X0 - 3 - t.a + x;
      if (Y < Ye && X < Xe) {
        const size_t g = (size_t)Y * Xe + X;
        m[kDXC * kSF + n] = dxc[g];
        m[kDXF * kSF + n] = dxf[g];
        m[kDYC * kSF + n] = dyc[g];
        m[kDYF * kSF + n] = dyf[g];
        m[kRAZF * kSF + n] = R(1.0) / azf[g];
        m[kFFF * kSF + n] = fff[g];
      }
    }
  } else {
    for (int n = tid; n < kSY; n += kThreads) {
      const int Y = t.Y0 - 3 + n;
      if (Y < Ye) {
        m[kDXC * kSY + n] = dxc[Y];
        m[kDXF * kSY + n] = dxf[Y];
        m[kDYC * kSY + n] = dyc[Y];
        m[kDYF * kSY + n] = dyf[Y];
        m[kRAZF * kSY + n] = R(1.0) / azf[Y];
        m[kFFF * kSY + n] = fff[Y];
      }
    }
  }
  const int stride = M2 ? kSF : kSY, o = M2 ? t.origin() : 3;
  return {{m + kDXC * stride + o}, {m + kDXF * stride + o}, {m + kDYC * stride + o},
          {m + kDYF * stride + o}, {m + kRAZF * stride + o}, {m + kFFF * stride + o}};
}

// A metric at extended (Y, X) from device memory: a plane or a profile.
template <bool M2, class R = float>
__device__ __forceinline__ R metric_at(const R* m, int Y, int X, int Xe) {
  return M2 ? m[(size_t)Y * Xe + X] : m[Y];
}

// WENO-5 from five upwind-ordered samples, factored division-free form
// (ops/weno.py::_weno5_from_shifts).
template <class R>
__device__ __forceinline__ R weno5(R m2, R m1, R s0, R p1, R p2, NoDeduce<R> eps) {
  const R sixth = R(1.0) / R(6.0);
  const R c13 = R(13.0) / R(12.0);
  R d1 = m1 - m2, d2 = s0 - m1, d3 = p1 - s0, d4 = p2 - p1;
  R q0 = s0 + (R(5.0) * d2 - R(2.0) * d1) * sixth;
  R q1 = s0 + (d2 + R(2.0) * d3) * sixth;
  R q2 = s0 + (R(4.0) * d3 - d4) * sixth;
  R x0 = d2 - d1, x1 = d3 - d2, x2 = d4 - d3, y1 = d2 + d3;
  R e0 = x0 + R(2.0) * d2, e2 = x2 - R(2.0) * d3;
  R b0 = c13 * x0 * x0 + R(0.25) * (e0 * e0);
  R b1 = c13 * x1 * x1 + R(0.25) * y1 * y1;
  R b2 = c13 * x2 * x2 + R(0.25) * (e2 * e2);
  R t0 = (b0 + eps) * (b0 + eps);
  R t1 = (b1 + eps) * (b1 + eps);
  R t2 = (b2 + eps) * (b2 + eps);
  R w0 = R(0.1) * (t1 * t2), w1 = R(0.6) * (t0 * t2), w2 = R(0.3) * (t0 * t1);
  return (w0 * q0 + w1 * q1 + w2 * q2) / (w0 + w1 + w2);
}

// Upwind selection over six samples s[0..5] ordered along the axis, with
// the reconstruction point between s[2] and s[3]: from below when vel > 0.
template <class R>
__device__ __forceinline__ R weno_upwind(const R s[6], NoDeduce<R> vel, NoDeduce<R> eps) {
  return vel > R(0.0) ? weno5(s[0], s[1], s[2], s[3], s[4], eps)
                      : weno5(s[5], s[4], s[3], s[2], s[1], eps);
}

// A tracer's reconstruction at the face between s[2] and s[3] of six
// samples ordered along the axis, with the face velocity vel: WENO-5,
// centred 0.5 (a + a[i - 1]) or the donor cell (ops/weno.py).
template <class R>
__device__ __forceinline__ R reconstruct(const R s[6], NoDeduce<R> vel, NoDeduce<R> eps,
                                         int tr) {
  if (tr == kTrCentered2) return R(0.5) * (s[3] + s[2]);
  if (tr == kTrUpwind1) return vel > R(0.0) ? s[2] : s[3];
  return weno_upwind(s, vel, eps);
}

// q = f + zeta at the corner (y, x).
template <bool M2, class R>
__device__ __forceinline__ R pv(const WinT<R>& u, const WinT<R>& v, const Metrics<M2, R>& m,
                                int y, int x) {
  R zeta = ((v(y, x) * m.dyf(y, x) - v(y, x - 1) * m.dyf(y, x - 1)) -
            (u(y, x) * m.dxc(y, x) - u(y - 1, x) * m.dxc(y - 1, x))) *
           m.razf(y, x);
  return m.fff(y, x) + zeta;
}

// Kinetic energy at the centre (y, x): the plain C-grid form (ke =
// kKeStandard) or Hollingsworth-corrected.
template <class R>
__device__ __forceinline__ R kinetic(const WinT<R>& u, const WinT<R>& v, int y, int x, int ke) {
  R u0 = u(y, x), u1 = u(y, x + 1);
  R v0 = v(y, x), v1 = v(y + 1, x);
  R Ks = R(0.5) * (R(0.5) * (u1 * u1 + u0 * u0) + R(0.5) * (v1 * v1 + v0 * v0));
  if (ke == kKeStandard) return Ks;
  R ub0 = R(0.5) * (u(y + 1, x) + u(y - 1, x));
  R ub1 = R(0.5) * (u(y + 1, x + 1) + u(y - 1, x + 1));
  R vb0 = R(0.5) * (v(y, x + 1) + v(y, x - 1));
  R vb1 = R(0.5) * (v(y + 1, x + 1) + v(y + 1, x - 1));
  R Kb = R(0.5) * (R(0.5) * (ub1 * ub1 + ub0 * ub0) + R(0.5) * (vb1 * vb1 + vb0 * vb0));
  const R third = R(1.0) / R(3.0);
  return (R(2.0) * third) * Ks + third * Kb;
}

// Horizontal divergence of (u, v) at the centre (y, x); razc = 1 / azc there.
template <bool M2, class R>
__device__ __forceinline__ R divergence(const WinT<R>& u, const WinT<R>& v,
                                        const Metrics<M2, R>& m, int y, int x,
                                        NoDeduce<R> razc) {
  return ((u(y, x + 1) * m.dyc(y, x + 1) - u(y, x) * m.dyc(y, x)) +
          (v(y + 1, x) * m.dxf(y + 1, x) - v(y, x) * m.dxf(y, x))) *
         razc;
}

// Tracer flux through the x face (y, xf) and through the y face (yf, x).
template <bool M2, class R>
__device__ __forceinline__ R xface_flux(const WinT<R>& c, const WinT<R>& u,
                                        const Metrics<M2, R>& m, int y, int xf,
                                        NoDeduce<R> eps, int tr) {
  R s[6];
#pragma unroll
  for (int r = 0; r < 6; ++r) s[r] = c(y, xf - 3 + r);
  const R vel = u(y, xf);
  return (vel * m.dyc(y, xf)) * reconstruct(s, vel, eps, tr);
}

template <bool M2, class R>
__device__ __forceinline__ R yface_flux(const WinT<R>& c, const WinT<R>& v,
                                        const Metrics<M2, R>& m, int yf, int x,
                                        NoDeduce<R> eps, int tr) {
  R s[6];
#pragma unroll
  for (int r = 0; r < 6; ++r) s[r] = c(yf - 3 + r, x);
  const R vel = v(yf, x);
  return (vel * m.dxf(yf, x)) * reconstruct(s, vel, eps, tr);
}

// A column whose vertical sums the block carries: its own column for each
// thread of the tile, and for the first kApron threads one column of the
// south row (y = -1) or the west column (x = -1), which the momentum
// stencil reads at j - 1 and i - 1.
template <class R = float>
struct ColumnT {
  int y, x;
  bool on;  // the column exists in this tile
  R sw;     // continuity sum: w at the top face = -sw
  R cs;     // running sum of b dz
  R tot;    // the column total of b dz
  R razc;   // 1 / azc
};
using Column = ColumnT<>;

template <class R = float>
__device__ __forceinline__ ColumnT<R> apron_column(const Tile& t) {
  const int tid = threadIdx.y * kTX + threadIdx.x;
  ColumnT<R> c = {};
  if (tid < kTX) {
    c.y = -1;
    c.x = tid;
    c.on = tid < t.nx;
  } else if (tid < kApron) {
    c.y = tid - kTX;
    c.x = -1;
    c.on = c.y < t.ny;
  }
  return c;
}

// One level of a column: w at the top face (continuity) into wq and, with
// MOM, the kinetic energy into keq (none without momentum advection) and
// p = csum - total - b dz / 2 into pq.
// The sums are rounded term by term (no fused multiply-add), as a cumsum
// of the products rounds them: p ~ 500 m^2/s^2 against horizontal
// differences far smaller, so one ulp of p shows in the pressure gradient.
template <bool MOM, bool M2, class R>
__device__ __forceinline__ void column_level(ColumnT<R>& c, const WinT<R>& u, const WinT<R>& v,
                                             const Metrics<M2, R>& m, NoDeduce<R> dzc,
                                             NoDeduce<R> bdz, R* keq, R* wq, R* pq,
                                             const Schemes& sch) {
  const int ci = centre(c.y, c.x);
  c.sw = add_rn(c.sw, mul_rn(divergence<M2>(u, v, m, c.y, c.x, c.razc), dzc));
  wq[ci] = -c.sw;
  if (MOM) {
    if (sch.mom != kMomNone) keq[ci] = kinetic(u, v, c.y, c.x, sch.ke);
    c.cs = add_rn(c.cs, bdz);
    pq[ci] = sub_rn(sub_rn(c.cs, c.tot), mul_rn(R(0.5), bdz));
  }
}

// The potential vorticity at every corner the tile's vorticity fluxes read.
template <bool M2, class R>
__device__ __forceinline__ void corner_pv(const WinT<R>& u, const WinT<R>& v,
                                          const Metrics<M2, R>& m, const Tile& t, R* pvq) {
  const int tid = threadIdx.y * kTX + threadIdx.x;
  for (int n = tid; n < kPY * kPX; n += kThreads) {
    const int y = n / kPX - 2, x = n % kPX - 2;
    if (y < t.ny + 3 && x < t.nx + 3) pvq[n] = pv<M2>(u, v, m, y, x);
  }
}

// Tracer c's fluxes through the west face and the south face of this
// thread's cell and, for the last kApron threads, through one east face of
// the tile's east column or one north face of its north row.
template <bool M2, class R>
__device__ __forceinline__ void tracer_faces(const WinT<R>& c, const WinT<R>& u,
                                             const WinT<R>& v, const Metrics<M2, R>& m,
                                             const Tile& t, NoDeduce<R> eps, int tr, R* fx,
                                             R* fy) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  if (tx < t.nx && ty < t.ny) {
    fx[xface(ty, tx)] = xface_flux<M2>(c, u, m, ty, tx, eps, tr);
    fy[yface(ty, tx)] = yface_flux<M2>(c, v, m, ty, tx, eps, tr);
  }
  const int b = kThreads - 1 - (ty * kTX + tx);
  if (b < kTX) {
    if (b < t.nx) fy[yface(t.ny, b)] = yface_flux<M2>(c, v, m, t.ny, b, eps, tr);
  } else if (b < kApron) {
    if (b - kTX < t.ny)
      fx[xface(b - kTX, t.nx)] = xface_flux<M2>(c, u, m, b - kTX, t.nx, eps, tr);
  }
}

// The momentum tendencies (Gu, Gv) of the cell (y, x) from the shared
// corner PV, kinetic energy, w and p: the vorticity flux (q upwinded by
// WENO-5, or interpolated under kMomVI), the Bernoulli gradient, the
// vertical advection centred between the carried bottom-face terms (xu,
// xv, updated to the top face) and the pressure gradient. un1, vn1: u and
// v one level up; r_dzf1 = 1 / dz_f there. Under kMomNone q is f at the
// corners, interpolated, and neither the kinetic energy nor w is read
// (the caller stages no corner PV).
template <bool M2, class R>
__device__ __forceinline__ void momentum(const WinT<R>& u, const WinT<R>& v,
                                         const Metrics<M2, R>& m, const R* pvq, const R* keq,
                                         const R* wq, const R* pq, int y, int x,
                                         NoDeduce<R> r_dxc, NoDeduce<R> r_dyf, NoDeduce<R> un1,
                                         NoDeduce<R> vn1, NoDeduce<R> r_dzf1, NoDeduce<R> eps,
                                         const Schemes& sch, R& xu, R& xv, R& Gu, R& Gv) {
  const bool advect = sch.mom != kMomNone;
  auto vbar_at = [&] {
    return R(0.5) * (R(0.5) * (v(y + 1, x) + v(y + 1, x - 1)) + R(0.5) * (v(y, x) + v(y, x - 1)));
  };
  auto ubar_at = [&] {
    return R(0.5) * (R(0.5) * (u(y, x + 1) + u(y - 1, x + 1)) + R(0.5) * (u(y, x) + u(y - 1, x)));
  };
  if (advect) {
    R s[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) s[r] = pvq[corner(y - 2 + r, x)];
    const R vbar = vbar_at();
    Gu = (sch.mom == kMomWenoVI ? weno_upwind(s, vbar, eps) : R(0.5) * (s[3] + s[2])) * vbar;
#pragma unroll
    for (int r = 0; r < 6; ++r) s[r] = pvq[corner(y, x - 2 + r)];
    const R ubar = ubar_at();
    Gv = -(sch.mom == kMomWenoVI ? weno_upwind(s, ubar, eps) : R(0.5) * (s[3] + s[2])) * ubar;
  } else {
    Gu = R(0.5) * (m.fff(y + 1, x) + m.fff(y, x)) * vbar_at();
    Gv = -(R(0.5) * (m.fff(y, x + 1) + m.fff(y, x))) * ubar_at();
  }

  const int c = centre(y, x), cw = centre(y, x - 1), cs = centre(y - 1, x);
  if (advect) {
    const R K = keq[c];
    Gu = Gu - (K - keq[cw]) * r_dxc;
    Gv = Gv - (K - keq[cs]) * r_dyf;

    const R w_c1 = wq[c];
    const R xu1 = R(0.5) * (w_c1 + wq[cw]) * ((un1 - u(y, x)) * r_dzf1);
    const R xv1 = R(0.5) * (w_c1 + wq[cs]) * ((vn1 - v(y, x)) * r_dzf1);
    Gu = Gu - R(0.5) * (xu1 + xu);
    Gv = Gv - R(0.5) * (xv1 + xv);
    xu = xu1;
    xv = xv1;
  }

  const R p_c = pq[c];
  Gu = Gu - (p_c - pq[cw]) * r_dxc;
  Gv = Gv - (p_c - pq[cs]) * r_dyf;
}

// Let a tile kernel take smem bytes of dynamic shared memory.
template <class Kernel>
cudaError_t allow_shared(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The launch shape of a tile kernel with smem bytes of shared memory:
// registers per thread, shared memory per block, the tile's columns in x
// and in y, and the blocks one SM holds at once.
template <class Kernel>
cudaError_t launch_info(Kernel kernel, size_t smem, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], kernel, kThreads, smem);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(smem + attr.sharedSizeBytes);
  out[2] = kTX;
  out[3] = kTY;
  return err;
}

// A tracer's tendency at the cell (y, x): the flux-form divergence of its
// shared face fluxes and its vertical flux, reconstructed in the scheme tr
// from the column's six levels cz = c(Z - 2 .. Z + 3) at the top face (w)
// and carried from the level below (fz, updated to the top face).
template <class R>
__device__ __forceinline__ R tracer(const R* fx, const R* fy, const R cz[6], NoDeduce<R> w,
                                    R& fz, int y, int x, NoDeduce<R> r_azc, NoDeduce<R> r_dzc,
                                    NoDeduce<R> eps, int tr) {
  const R fz1 = w * reconstruct(cz, w, eps, tr);
  const R h = -((fx[xface(y, x + 1)] - fx[xface(y, x)]) +
                (fy[yface(y + 1, x)] - fy[yface(y, x)])) *
              r_azc;
  const R G = h - (fz1 - fz) * r_dzc;
  fz = fz1;
  return G;
}

}  // namespace
