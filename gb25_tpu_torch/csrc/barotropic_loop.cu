// All M forward-backward substeps of the split-explicit barotropic solve of
// one model step in one launch, with the filtered (parabolic-weighted)
// accumulators, the planes they need and the un-weighting.
//
// Replaces: gb25_tpu/ops/pallas_barotropic.py::pallas_barotropic_loop (the
// whole-loop VMEM kernel, pallas_call at :262): x periodic, eta mirrored at
// the south wall (detay = 0 on row 0), no flux through the north wall face
// (Vd[Ny] = 0). On immersed grids two optional solid-face mask planes
// multiply Ud and Vd after every substep's update (no transport through
// coastlines). On the tripolar grid the flux above the seam row is the
// fold's ghost, -Vd[Ny-1, (2p - x) mod Nx] (the JAX kernel's permutation
// matmul, :213-221), and the metrics are (Ny, Nx) planes.
//
// What bounds it on an H100: the per-substep round trips, not the bytes. A
// loop reads its inputs once and writes three planes (~0.014-0.024 ms of
// device memory at 1536x768 f32), but its 30 substeps each depend on the
// last across the whole grid. One launch a substep (the earlier design)
// streamed the state and the constant planes, ~66 MB, more than the 50 MB
// L2, from device memory 30 times (~36 us a substep). The TPU kernel keeps
// the whole loop in VMEM.
//
// Design: one cooperative launch, every block resident (one an SM), a grid
// barrier between substeps. Each block owns one tile of at most kMaxTX x
// kMaxTY cells for all M substeps (the tile plan comes from the caller,
// ops/pallas_barotropic.py::loop_plan; 128 x 70 at 1536x768 on 132 SMs),
// and the whole working set stays on chip: shared memory holds the tile's
// eta, Ud, Vd and three accumulators (24 B a cell, ~215 KB); registers hold
// each cell's gHuW, gHvW, GUd, GVd (1 / area on the tripolar grid) and its
// two mask bits (masks of 0 and 1 only; the caller checks). A thread owns
// kVec consecutive cells in each of kCY rows and moves each row's cells as
// one float4, so that most west and east neighbours come from its own
// registers. A substep: the edges (below), a block barrier, continuity over
// the tile, a block barrier, momentum, the masks and the accumulators, then
// the tile's outer ring of (eta, Ud, Vd) goes to global planes,
// double-buffered by substep parity, and a grid barrier. After it a block
// reads from the ring what crosses its edges: the Ud east of it, the Vd
// north of it (at the top, the fold's ghost from the whole published top
// row), and the west column and south row of (eta, Ud, Vd), from which it
// recomputes the new eta of the cells west and south of its tile, so that
// one grid barrier a substep is enough. The parity makes a fast block's
// writes of substep m + 1 land in the buffer that no block reads after the
// barrier of substep m; data written during the launch is read through L2
// (__ldcg), never through the non-coherent path. The prologue forms the
// state and the constants from the raw inputs, the epilogue writes
// eta_b, U_b / dyc and V_b / dxf: the wrapper launches nothing else.
// Where the co-resident tiles cannot hold the grid, the L2 instance runs the
// same loop in one launch with the state in global ping-pong planes, the
// constants in scratch planes and the accumulators in the output planes, a
// grid-stride loop over cells that recomputes the west and south new eta
// of each cell.
//
// The operations are barotropic_loop_plain's (and its plane building's) in
// its order, built with -fmad=false: the two agree bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstddef>

namespace cg = cooperative_groups;

namespace {

constexpr int kTX = 32;     // threads in x
constexpr int kTY = 8;      // threads in y
constexpr int kVec = 4;     // consecutive cells a thread owns in x
constexpr int kCY = 9;      // rows a thread owns, kTY apart
constexpr int kThreads = kTX * kTY;
constexpr int kMaxTX = kTX * kVec;  // the largest tile
constexpr int kMaxTY = kTY * kCY;
constexpr int kMaxSubsteps = 256;

struct Args {
  const float *eta0, *U0, *V0, *GU, *GV, *Hu, *Hv;  // (Ny, Nx) inputs
  const float *dyc, *dxf, *dxc, *dyf, *azc;         // (Ny) columns, or (Ny, Nx) planes
  const float *mu, *mv;                             // (Ny, Nx) solid-face masks, or null
  float *etab, *Ub, *Vb;                            // (Ny, Nx) filtered outputs
  float* cst;   // scratch: gHuW, gHvW, GUd, GVd planes, then 1 / azc ((Ny) or (Ny, Nx))
  float* ring;  // scratch: [parity][eta, Ud, Vd] (Ny, Nx) planes
  float dtau, dtau_g;  // dtau, and dtau g rounded to float
  int M, Nx, Ny, pole;
  int TX, TY, GX;      // the tile plan (on-chip instance)
  float w[kMaxSubsteps];
};

__device__ __forceinline__ float* ring_plane(const Args& A, int parity, int field) {
  return A.ring + (size_t)(3 * parity + field) * A.Nx * A.Ny;
}

// the metric or 1 / area of cell (y, o): a column entry or a plane entry
template <bool TRIPOLAR>
__device__ __forceinline__ size_t mi(int y, size_t o) {
  return TRIPOLAR ? o : (size_t)y;
}

// gHuW, gHvW, GUd, GVd of cell o of row y, in the plain version's order:
// (Hu (dyc / dxc)) (dtau g), (GU dyc) dtau
struct Constants {
  float gu, gv, fu, fv;
};

template <bool TRIPOLAR>
__device__ __forceinline__ Constants cell_constants(const Args& A, int y, size_t o) {
  const size_t m = mi<TRIPOLAR>(y, o);
  const float dyc = __ldg(A.dyc + m), dxf = __ldg(A.dxf + m);
  return {(__ldg(A.Hu + o) * (dyc / __ldg(A.dxc + m))) * A.dtau_g,
          (__ldg(A.Hv + o) * (dxf / __ldg(A.dyf + m))) * A.dtau_g,
          (__ldg(A.GU + o) * dyc) * A.dtau, (__ldg(A.GV + o) * dxf) * A.dtau};
}

// The L2 instance's constant planes of cell o, and 1 / azc on the tripolar
// grid
template <bool TRIPOLAR>
__device__ __forceinline__ void constants(const Args& A, int y, size_t o) {
  const size_t N = (size_t)A.Nx * A.Ny;
  const Constants c = cell_constants<TRIPOLAR>(A, y, o);
  A.cst[o] = c.gu;
  A.cst[N + o] = c.gv;
  A.cst[2 * N + o] = c.fu;
  A.cst[3 * N + o] = c.fv;
  if (TRIPOLAR) A.cst[4 * N + o] = 1.0f / __ldg(A.azc + o);
}

// 1 / azc of the lat-lon rows, spread over the grid's threads
template <bool TRIPOLAR>
__device__ __forceinline__ void row_areas(const Args& A) {
  if (TRIPOLAR) return;
  float* raz = A.cst + 4 * (size_t)A.Nx * A.Ny;
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x * blockDim.y;
  for (int r = blockIdx.x * blockDim.x * blockDim.y + t; r < A.Ny; r += stride)
    raz[r] = 1.0f / __ldg(A.azc + r);
}

// continuity: eta - dtau div, div = (((Ud_e - Ud) + Vd_n) - Vd) / area
__device__ __forceinline__ float continuity(float eta, float Ud, float Ud_e, float Vd, float Vd_n,
                                            float raz, float dtau) {
  const float div = (((Ud_e - Ud) + Vd_n) - Vd) * raz;
  return eta - dtau * div;
}

// The flux through the top face of column x of the seam row: 0 at the north
// wall, or the fold's ghost -Vd[Ny-1, (2p - x) mod Nx] of the substep's input.
template <bool TRIPOLAR>
__device__ __forceinline__ float top_flux(const Args& A, const float* Vd, int x) {
  if (!TRIPOLAR) return 0.0f;
  int xf = 2 * A.pole - x;
  if (xf < 0) xf += A.Nx;
  if (xf >= A.Nx) xf -= A.Nx;
  return -__ldcg(Vd + (size_t)(A.Ny - 1) * A.Nx + xf);
}

// momentum from the new eta of the cell and of its west and south
// neighbours, then the masks
template <bool MASK>
__device__ __forceinline__ void momentum(const Args& A, size_t o, float e, float e_w, float e_s,
                                         float& Ud, float& Vd) {
  const size_t N = (size_t)A.Nx * A.Ny;
  Ud = (Ud - __ldcg(A.cst + o) * (e - e_w)) + __ldcg(A.cst + 2 * N + o);
  Vd = (Vd - __ldcg(A.cst + N + o) * (e - e_s)) + __ldcg(A.cst + 3 * N + o);
  if (MASK) {
    Ud = Ud * __ldg(A.mu + o);
    Vd = Vd * __ldg(A.mv + o);
  }
}

__device__ __forceinline__ void publish(const Args& A, int parity, size_t o, float e, float Ud,
                                        float Vd) {
  ring_plane(A, parity, 0)[o] = e;
  ring_plane(A, parity, 1)[o] = Ud;
  ring_plane(A, parity, 2)[o] = Vd;
}

// the row stride of a tile's shared planes: TX rounded up to whole float4s
__host__ __device__ __forceinline__ int row_stride(int TX) {
  return (TX + kVec - 1) / kVec * kVec;
}

// shared memory of a TX x TY tile: eta, Ud, Vd and the three accumulators;
// the new eta south of it and the Vd north of it; the new eta west of it,
// the Ud east of it, 1 / azc of its rows and the row south of it (lat-lon)
size_t tile_bytes(int TX, int TY) {
  const size_t SX = row_stride(TX);
  return (6 * SX * TY + 2 * SX + 3 * TY + 1) * sizeof(float);
}

// x times a solid-face mask of 0 or 1 (the caller checks that it is one of
// them), given as one bit
__device__ __forceinline__ float masked(float x, unsigned bit) {
  return x * (bit ? 1.0f : 0.0f);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float& at(float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The on-chip instance: block b owns the tile (b / GX, b % GX) of TX x TY
// cells for all substeps. Shared memory holds its eta, Ud, Vd and
// accumulators, [ly][lx] with row stride SX, and the edge values; a thread
// owns kVec consecutive cells of kCY rows (kTY apart) and moves each row's
// cells as one float4; registers hold gHuW, gHvW, GUd, GVd (1 / azc on the
// tripolar grid) and the two mask bits of each of its cells. A substep: the
// edges from the previous substep's ring, a block barrier, continuity, a
// block barrier, momentum (the ring goes out), a grid barrier.
template <bool MASK, bool TRIPOLAR>
__global__ void __launch_bounds__(kThreads, 1) barotropic_loop_on_chip(const Args A) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int TX = A.TX, TY = A.TY, Nx = A.Nx, Ny = A.Ny, SX = row_stride(TX);
  const int cells = SX * TY;
  float* s_eta = smem;
  float* s_Ud = s_eta + cells;
  float* s_Vd = s_Ud + cells;
  float* s_ae = s_Vd + cells;  // the accumulators of eta, Ud, Vd
  float* s_aU = s_ae + cells;
  float* s_aV = s_aU + cells;
  float* s_es = s_aV + cells;  // [SX] new eta south of the tile
  float* s_Vn = s_es + SX;     // [SX] Vd north of it (or the top flux)
  float* s_ew = s_Vn + SX;     // [TY] new eta west of it
  float* s_Ue = s_ew + TY;     // [TY] Ud east of it
  float* s_raz = s_Ue + TY;    // [TY + 1] 1 / azc of rows y0 - 1 .. (lat-lon)
  const int x0 = (blockIdx.x % A.GX) * TX, y0 = (blockIdx.x / A.GX) * TY;
  const int nx = min(TX, Nx - x0), ny = min(TY, Ny - y0);
  const int tx = threadIdx.x, ty = threadIdx.y, t = ty * kTX + tx;
  const int lx0 = kVec * tx;  // the thread's first column
  const int xw = x0 == 0 ? Nx - 1 : x0 - 1, xe = x0 + nx == Nx ? 0 : x0 + nx;

  float gu[kCY][kVec], gv[kCY][kVec], fu[kCY][kVec], fv[kCY][kVec], rz[kCY][kVec];
  unsigned mb[kCY];  // bit i: mu of cell i is 1, bit kVec + i: mv
#pragma unroll
  for (int j = 0; j < kCY; ++j) {
    mb[j] = 0u;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      gu[j][i] = gv[j][i] = fu[j][i] = fv[j][i] = rz[j][i] = 0.0f;
      const int lx = lx0 + i, ly = ty + kTY * j;
      if (lx >= nx || ly >= ny) continue;
      const int y = y0 + ly;
      const size_t o = (size_t)y * Nx + x0 + lx, m = mi<TRIPOLAR>(y, o);
      const float dyc = __ldg(A.dyc + m), dxf = __ldg(A.dxf + m);
      const float e = __ldg(A.eta0 + o);
      const float Ud = __ldg(A.U0 + o) * dyc;
      const float Vd = __ldg(A.V0 + o) * dxf;
      const int k = ly * SX + lx;
      s_eta[k] = e;
      s_Ud[k] = Ud;
      s_Vd[k] = Vd;
      s_ae[k] = s_aU[k] = s_aV[k] = 0.0f;
      const Constants cst = cell_constants<TRIPOLAR>(A, y, o);
      gu[j][i] = cst.gu;
      gv[j][i] = cst.gv;
      fu[j][i] = cst.fu;
      fv[j][i] = cst.fv;
      if (TRIPOLAR) rz[j][i] = 1.0f / __ldg(A.azc + o);
      if (MASK)
        mb[j] |= (__ldg(A.mu + o) == 1.0f ? 1u << i : 0u) |
                 (__ldg(A.mv + o) == 1.0f ? 1u << (kVec + i) : 0u);
      if (lx == 0 || lx == nx - 1 || ly == 0 || ly == ny - 1) publish(A, 1, o, e, Ud, Vd);
    }
  }
  if (!TRIPOLAR) {
    for (int r = t; r <= ny; r += kThreads)
      if (y0 - 1 + r >= 0) s_raz[r] = 1.0f / __ldg(A.azc + y0 - 1 + r);
  }
  grid.sync();

  for (int m = 0; m < A.M; ++m) {
    const int prev = (m + 1) & 1, cur = m & 1;
    const float* eta_p = ring_plane(A, prev, 0);
    const float* Ud_p = ring_plane(A, prev, 1);
    const float* Vd_p = ring_plane(A, prev, 2);
    // the edges, one item a thread: the Ud east of row r and the new eta
    // west of it; the Vd north of column c and the new eta south of it,
    // from the ring and the tile's own old Ud (west) and Vd (south)
    for (int q = t; q < ny + nx; q += kThreads) {
      if (q < ny) {
        const int y = y0 + q;
        const size_t o = (size_t)y * Nx + xw;
        s_Ue[q] = __ldcg(Ud_p + (size_t)y * Nx + xe);
        const float Vd_n = y + 1 < Ny ? __ldcg(Vd_p + o + Nx) : top_flux<TRIPOLAR>(A, Vd_p, xw);
        const float raz = TRIPOLAR ? 1.0f / __ldg(A.azc + o) : s_raz[q + 1];
        s_ew[q] = continuity(__ldcg(eta_p + o), __ldcg(Ud_p + o), s_Ud[q * SX], __ldcg(Vd_p + o),
                             Vd_n, raz, A.dtau);
      } else {
        const int c = q - ny, x = x0 + c;
        s_Vn[c] = y0 + ny < Ny ? __ldcg(Vd_p + (size_t)(y0 + ny) * Nx + x)
                               : top_flux<TRIPOLAR>(A, Vd_p, x);
        if (y0 > 0) {
          const int y = y0 - 1;
          const size_t o = (size_t)y * Nx + x;
          const float Ud_e = __ldcg(Ud_p + (size_t)y * Nx + (x + 1 == Nx ? 0 : x + 1));
          const float raz = TRIPOLAR ? 1.0f / __ldg(A.azc + o) : s_raz[0];
          s_es[c] = continuity(__ldcg(eta_p + o), __ldcg(Ud_p + o), Ud_e, __ldcg(Vd_p + o),
                               s_Vd[c], raz, A.dtau);
        }
      }
    }
    __syncthreads();
    // continuity: the tile's new eta, a row of kVec cells at a time
    if (lx0 < nx) {
#pragma unroll
      for (int j = 0; j < kCY; ++j) {
        const int ly = ty + kTY * j;
        if (ly >= ny) break;
        const int k = ly * SX + lx0;
        float4 e = ld4(s_eta + k);
        const float4 U = ld4(s_Ud + k), V = ld4(s_Vd + k);
        const float4 Vn = ly + 1 < ny ? ld4(s_Vd + k + SX) : ld4(s_Vn + lx0);
        const float Ue = lx0 + kVec < nx ? s_Ud[k + kVec] : s_Ue[ly];
        float4 Ux = U;  // Ud east of each cell
        Ux.x = lx0 + 1 < nx ? U.y : s_Ue[ly];
        Ux.y = lx0 + 2 < nx ? U.z : s_Ue[ly];
        Ux.z = lx0 + 3 < nx ? U.w : s_Ue[ly];
        Ux.w = Ue;
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float raz = TRIPOLAR ? rz[j][i] : s_raz[ly + 1];
          at(e, i) = continuity(at(e, i), at(U, i), at(Ux, i), at(V, i), at(Vn, i), raz, A.dtau);
        }
        st4(s_eta + k, e);
      }
    }
    __syncthreads();
    // momentum from the new eta of the cell and of its west and south
    // neighbours, the masks, the accumulators; the ring goes out
    const float w = A.w[m];
    if (lx0 < nx) {
#pragma unroll
      for (int j = 0; j < kCY; ++j) {
        const int ly = ty + kTY * j;
        if (ly >= ny) break;
        const int k = ly * SX + lx0;
        const size_t row = (size_t)(y0 + ly) * Nx + x0;
        const bool edge_row = ly == 0 || ly == ny - 1;
        // the ring cells of this row of kVec cells
        unsigned ring = 0u;
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          ring |= lx0 + i < nx && (edge_row || lx0 + i == 0 || lx0 + i == nx - 1) ? 1u << i : 0u;
        const float4 e = ld4(s_eta + k);
        {
          float4 a = ld4(s_ae + k);
#pragma unroll
          for (int i = 0; i < kVec; ++i) {
            at(a, i) = at(a, i) + w * at(e, i);
            if (ring >> i & 1u) ring_plane(A, cur, 0)[row + lx0 + i] = at(e, i);
          }
          st4(s_ae + k, a);
        }
        {
          float4 ew = e;  // new eta west of each cell
          ew.x = lx0 > 0 ? s_eta[k - 1] : s_ew[ly];
          ew.y = e.x;
          ew.z = e.y;
          ew.w = e.z;
          float4 U = ld4(s_Ud + k), a = ld4(s_aU + k);
#pragma unroll
          for (int i = 0; i < kVec; ++i) {
            float Ud = (at(U, i) - gu[j][i] * (at(e, i) - at(ew, i))) + fu[j][i];
            if (MASK) Ud = masked(Ud, mb[j] >> i & 1u);
            at(U, i) = Ud;
            at(a, i) = at(a, i) + w * Ud;
            if (ring >> i & 1u) ring_plane(A, cur, 1)[row + lx0 + i] = Ud;
          }
          st4(s_Ud + k, U);
          st4(s_aU + k, a);
        }
        {
          // new eta south of each cell; mirrored at y = 0
          const float4 es = ly > 0 ? ld4(s_eta + k - SX) : y0 == 0 ? e : ld4(s_es + lx0);
          float4 V = ld4(s_Vd + k), a = ld4(s_aV + k);
#pragma unroll
          for (int i = 0; i < kVec; ++i) {
            float Vd = (at(V, i) - gv[j][i] * (at(e, i) - at(es, i))) + fv[j][i];
            if (MASK) Vd = masked(Vd, mb[j] >> (kVec + i) & 1u);
            at(V, i) = Vd;
            at(a, i) = at(a, i) + w * Vd;
            if (ring >> i & 1u) ring_plane(A, cur, 2)[row + lx0 + i] = Vd;
          }
          st4(s_Vd + k, V);
          st4(s_aV + k, a);
        }
      }
    }
    if (m + 1 < A.M) grid.sync();
  }

  __syncthreads();
  for (int k = t; k < nx * ny; k += kThreads) {
    const int ly = k / nx, lx = k - ly * nx, y = y0 + ly;
    const size_t o = (size_t)y * Nx + x0 + lx, m = mi<TRIPOLAR>(y, o);
    const int kk = ly * SX + lx;
    A.etab[o] = s_ae[kk];
    A.Ub[o] = s_aU[kk] / __ldg(A.dyc + m);
    A.Vb[o] = s_aV[kk] / __ldg(A.dxf + m);
  }
}

// the new eta of cell (y, x) from the state of the previous substep
template <bool TRIPOLAR>
__device__ __forceinline__ float eta_new(const Args& A, const float* eta, const float* Ud,
                                         const float* Vd, int y, int x) {
  const size_t o = (size_t)y * A.Nx + x;
  const float Ud_e = __ldcg(Ud + (size_t)y * A.Nx + (x + 1 == A.Nx ? 0 : x + 1));
  const float Vd_n = y + 1 < A.Ny ? __ldcg(Vd + o + A.Nx) : top_flux<TRIPOLAR>(A, Vd, x);
  return continuity(__ldcg(eta + o), __ldcg(Ud + o), Ud_e, __ldcg(Vd + o), Vd_n,
                    __ldcg(A.cst + 4 * (size_t)A.Nx * A.Ny + mi<TRIPOLAR>(y, o)), A.dtau);
}

// The L2 instance, for grids that the co-resident tiles cannot hold: the
// state in the ring planes in full (ping-pong by parity), the accumulators
// in the output planes, a grid-stride loop over cells; each cell recomputes
// the new eta of its west and south neighbours.
template <bool MASK, bool TRIPOLAR>
__global__ void __launch_bounds__(kThreads) barotropic_loop_in_l2(const Args A) {
  cg::grid_group grid = cg::this_grid();
  const int Nx = A.Nx;
  const size_t N = (size_t)Nx * A.Ny;
  const size_t stride = (size_t)gridDim.x * kThreads;
  const size_t first = (size_t)blockIdx.x * kThreads + threadIdx.y * kTX + threadIdx.x;
  for (size_t o = first; o < N; o += stride) {
    const int y = (int)(o / Nx);
    const size_t m = mi<TRIPOLAR>(y, o);
    publish(A, 1, o, __ldg(A.eta0 + o), __ldg(A.U0 + o) * __ldg(A.dyc + m),
            __ldg(A.V0 + o) * __ldg(A.dxf + m));
    constants<TRIPOLAR>(A, y, o);
  }
  row_areas<TRIPOLAR>(A);
  grid.sync();

  for (int m = 0; m < A.M; ++m) {
    const int prev = (m + 1) & 1, cur = m & 1;
    const float* eta_p = ring_plane(A, prev, 0);
    const float* Ud_p = ring_plane(A, prev, 1);
    const float* Vd_p = ring_plane(A, prev, 2);
    const float w = A.w[m];
    for (size_t o = first; o < N; o += stride) {
      const int y = (int)(o / Nx), x = (int)(o - (size_t)y * Nx);
      const float e = eta_new<TRIPOLAR>(A, eta_p, Ud_p, Vd_p, y, x);
      const float e_w = eta_new<TRIPOLAR>(A, eta_p, Ud_p, Vd_p, y, x == 0 ? Nx - 1 : x - 1);
      const float e_s = y > 0 ? eta_new<TRIPOLAR>(A, eta_p, Ud_p, Vd_p, y - 1, x) : e;
      float Ud = __ldcg(Ud_p + o), Vd = __ldcg(Vd_p + o);
      momentum<MASK>(A, o, e, e_w, e_s, Ud, Vd);
      publish(A, cur, o, e, Ud, Vd);
      const float be = m == 0 ? 0.0f : A.etab[o];
      const float bU = m == 0 ? 0.0f : A.Ub[o];
      const float bV = m == 0 ? 0.0f : A.Vb[o];
      A.etab[o] = be + w * e;
      A.Ub[o] = bU + w * Ud;
      A.Vb[o] = bV + w * Vd;
    }
    if (m + 1 < A.M) grid.sync();
  }

  for (size_t o = first; o < N; o += stride) {
    const size_t m = mi<TRIPOLAR>((int)(o / Nx), o);
    A.Ub[o] = A.Ub[o] / __ldg(A.dyc + m);
    A.Vb[o] = A.Vb[o] / __ldg(A.dxf + m);
  }
}

// Let a kernel take `smem` bytes of dynamic shared memory (above 48 KB only
// after this attribute is set).
template <class Kernel>
cudaError_t allow_shared(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

cudaError_t device_attribute(int* value, cudaDeviceAttr attr) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(value, attr, dev);
  return err;
}

// the most rows a tile of kMaxTX columns may have in the shared memory
// that one block can take
cudaError_t max_rows(int* rows) {
  int limit;
  const cudaError_t err = device_attribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin);
  *rows = kMaxTY;
  while (*rows > 0 && tile_bytes(kMaxTX, *rows) > (size_t)limit) --*rows;
  return err;
}

template <bool MASK, bool TRIPOLAR>
cudaError_t launch(Args& A, cudaStream_t s) {
  void* params[] = {&A};
  const dim3 block(kTX, kTY, 1);
  if (A.TX > 0) {
    const auto kernel = barotropic_loop_on_chip<MASK, TRIPOLAR>;
    const size_t smem = tile_bytes(A.TX, A.TY);
    cudaError_t err = allow_shared(kernel, smem);
    if (err != cudaSuccess) return err;
    const int blocks = A.GX * ((A.Ny + A.TY - 1) / A.TY);
    return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(blocks, 1, 1), block,
                                       params, smem, s);
  }
  const auto kernel = barotropic_loop_in_l2<MASK, TRIPOLAR>;
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err == cudaSuccess) err = device_attribute(&sms, cudaDevAttrMultiProcessorCount);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(per_sm * sms, 1, 1),
                                     block, params, 0, s);
}

// registers per thread and shared memory per block of the on-chip
// instance at its largest tile, that tile's columns and rows (the rows
// that the block's shared memory allows), the blocks one SM holds at once
// at that tile, the SM count, the L2 instance's registers and blocks per
// SM
template <bool MASK, bool TRIPOLAR>
cudaError_t info(int* out) {
  const auto on_chip = barotropic_loop_on_chip<MASK, TRIPOLAR>;
  const auto in_l2 = barotropic_loop_in_l2<MASK, TRIPOLAR>;
  cudaFuncAttributes attr, attr_l2;
  cudaError_t err = max_rows(&out[3]);
  const size_t smem = tile_bytes(kMaxTX, out[3]);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, on_chip);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr_l2, in_l2);
  if (err == cudaSuccess) err = allow_shared(on_chip, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], on_chip, kThreads, smem);
  if (err == cudaSuccess) err = device_attribute(&out[5], cudaDevAttrMultiProcessorCount);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[7], in_l2, kThreads, 0);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(smem + attr.sharedSizeBytes);
  out[2] = kMaxTX;
  out[6] = attr_l2.numRegs;
  return cudaSuccess;
}

}  // namespace

extern "C" const char* gb25_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// M substeps (weights w[0..M)) of the loop from (eta0, U0 dyc, V0 dxf):
// writes (eta_b, U_b / dyc, V_b / dxf). pole < 0: the lat-lon instance
// (metrics and azc (Ny) columns); pole >= 0: the tripolar instance, folding
// about column pole (metrics (Ny, Nx) planes). mu, mv: both null or both
// set. cst: 4 Ny Nx + Ny (lat-lon) or 5 Ny Nx (tripolar) floats of
// scratch; ring: 6 Ny Nx. TX > 0: the on-chip instance on tiles of TX x TY
// cells, GX tiles a row of tiles (ceil(Ny / TY) rows of them, one block
// each, all co-resident); TX = 0: the L2 instance. A grid that the card
// cannot hold at once returns cudaErrorCooperativeLaunchTooLarge.
extern "C" int barotropic_loop_f32(const float* eta0, const float* U0, const float* V0,
                                   const float* GU, const float* GV, const float* Hu,
                                   const float* Hv, const float* dyc, const float* dxf,
                                   const float* dxc, const float* dyf, const float* azc,
                                   const float* mu, const float* mv, float* etab, float* Ub,
                                   float* Vb, float* cst, float* ring, const float* w, int M,
                                   float dtau, float dtau_g, int Nx, int Ny, int pole, int TX,
                                   int TY, int GX, void* stream) {
  const bool bad_plan =
      TX < 0 || (TX > 0 && (TX > kMaxTX || TY < 1 || TY > kMaxTY || GX < 1 ||
                            (long long)GX * TX < Nx || (long long)(GX - 1) * TX >= Nx));
  if ((mu == nullptr) != (mv == nullptr) || pole >= Nx || Nx < 1 || Ny < 1 || M < 1 ||
      M > kMaxSubsteps || bad_plan)
    return static_cast<int>(cudaErrorInvalidValue);
  Args A{eta0, U0, V0, GU, GV, Hu, Hv, dyc, dxf, dxc, dyf, azc, mu, mv, etab, Ub, Vb, cst, ring};
  A.dtau = dtau;
  A.dtau_g = dtau_g;
  A.M = M;
  A.Nx = Nx;
  A.Ny = Ny;
  A.pole = pole;
  A.TX = TX;
  A.TY = TY;
  A.GX = GX;
  for (int m = 0; m < kMaxSubsteps; ++m) A.w[m] = m < M ? w[m] : 0.0f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tripolar = pole >= 0;
  cudaError_t err;
  if (mu != nullptr && tripolar)
    err = launch<true, true>(A, s);
  else if (mu != nullptr)
    err = launch<true, false>(A, s);
  else if (tripolar)
    err = launch<false, true>(A, s);
  else
    err = launch<false, false>(A, s);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

// The launch shape of the instance with or without masks, lat-lon or
// tripolar, into out[0..8) (see info).
extern "C" int barotropic_loop_info(int masked, int tripolar, int* out) {
  cudaError_t err;
  if (masked && tripolar)
    err = info<true, true>(out);
  else if (masked)
    err = info<true, false>(out);
  else if (tripolar)
    err = info<false, true>(out);
  else
    err = info<false, false>(out);
  return static_cast<int>(err);
}
