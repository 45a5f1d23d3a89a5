// Device pieces of a whole Procrustes-fixing round, shared by B5/B6
// (fused_round.cu) and B7 (fused_ring_remote.cu): the Gram and apply
// phases over the grid (tile_products.cuh), the split sums, the guarded
// Cholesky of an r x r Gram with its triangular inverse, and the
// CholeskyQR2 tail that turns V-bar into the round's output.  Each kernel
// that uses them is one cooperative launch of kThreads-thread blocks with
// round_smem_bytes(r) (or more) of dynamic shared memory.  Up to r =
// kNsSmemMaxR block 0 factors the whole Gram in that shared memory
// (inverse_factor); past it the factor runs in panels on the whole grid
// (grid_factor), its trailing matrix in a global scratch the wrapper
// allocates.  See fused_round.cu for the design notes.
#pragma once

#include <cooperative_groups.h>

#include <algorithm>
#include <cstddef>

#include "common.cuh"
#include "ns_polar.cuh"
#include "tile_products.cuh"

namespace rt {
namespace round {

constexpr int kThreads = 256;
static_assert(kThreads == gram::kThreads && kThreads == apply::kThreads,
              "one block shape for every phase");

// part[z * splits + s] (r x r, row stride r) = A_z[rows of split s]^T B
// [same rows] for z < nz, every (z, 128 x 128 tile, split) unit on the
// blocks in turn; A_z = a + z a_z, (d, r) of type TA (int8 times
// scales[z r + column]), B (d, r) f32.  VEC: r % 4 == 0 and a (f32), b,
// part 16-byte aligned.
template <bool VEC, typename TA>
__device__ void gram_units(const TA* a, size_t a_z, const float* scales,
                           const float* b, int nz, int d, int r, int rows,
                           int splits, float* part, float* smem) {
  const int tiles = (r + gram::kBM - 1) / gram::kBM;
  const int per_z = tiles * tiles * splits;
  const size_t rr = static_cast<size_t>(r) * r;
  for (int u = blockIdx.x; u < nz * per_z; u += gridDim.x) {
    const int z = u / per_z;
    const int s = (u % per_z) / (tiles * tiles);
    const int t = u % (tiles * tiles);
    const int i0 = (t / tiles) * gram::kBM;
    const int j0 = (t % tiles) * gram::kBM;
    const int k_begin = min(d, s * rows);
    const int k_end = min(d, k_begin + rows);
    const TA* az = a + z * a_z;
    const float* sz = scales ? scales + static_cast<size_t>(z) * r : nullptr;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    gram::tile_acc<TA, VEC>(az, sz, r, r, b, r, r, k_begin, k_end, i0, j0,
                            smem, acc);
    gram::store_tile(acc, part + (static_cast<size_t>(z) * splits + s) * rr, r,
                     r, r, i0, j0, VEC);
  }
}

// out (d, r) = (S + sum_{z < nz} A_z Z_z) / div over its 64 x 128 blocks
// in turn (apply::rows; S = out when add, else 0).
template <bool VEC, typename TA>
__device__ void apply_units(const TA* a, size_t a_z, const float* scales,
                            const float* zs, int nz, int d, int r, float div,
                            bool add, float* out, float* smem) {
  const int ctiles = (r + apply::kBN - 1) / apply::kBN;
  const int units = ((d + apply::kBM - 1) / apply::kBM) * ctiles;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int i0 = (u / ctiles) * apply::kBM;
    const int j0 = (u % ctiles) * apply::kBN;
    apply::rows<TA, VEC>(a, a_z, scales, zs, nz, d, r, i0, j0, div, add, out,
                         smem);
  }
}

// s[e] = sum over splits of part[sp][e] in split order, e < n, over the
// grid.
inline __device__ void sum_splits(const float* part, int splits, size_t n,
                                  float* __restrict__ s) {
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n; e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float acc = 0.f;
    for (int sp = 0; sp < splits; ++sp) acc += __ldcg(part + sp * n + e);
    s[e] = acc;
  }
}

// The updates below give warp w the rows row0 + w + 8 u and lane l the
// columns l + 32 c (so a warp reads along one row, bank-conflict free),
// four rows at a time: a thread issues the loads of a batch before any of
// its stores, so their latencies overlap.
constexpr int kRowBatch = 4;  // rows a batch
constexpr int kColBatch = 4;  // columns a lane takes a pass
constexpr int kBatchCols = 32 * kColBatch;

// Guarded lower Cholesky of the r x r tile l (row stride ld, lower
// triangle, in place) and X = L^-1 in the tile x (lower triangle), in one
// sweep; lc: r floats of shared memory.  Returns true when every pivot is
// above thr (false on a non-positive or NaN pivot), the guard of
// _masked_cholesky's minpiv.  Step k: every thread reads the pivot, the
// scaled column k goes to lc and row k of X, now final, is divided by
// L_kk; a barrier; then every row p > k takes, in one pass over its
// columns j <= p, the Cholesky update L[p][j] -= L[p][k] L[j][k] (k < j)
// and the inverse's X[p][j] -= L[p][k] X[k][j] (j <= k); a barrier.  Each
// element of L and X is its sum in ascending k, then the division: the
// bits of the column-by-column Cholesky and forward substitution.
inline __device__ bool cholesky_inverse(float* __restrict__ l,
                                        float* __restrict__ x, int r, int ld,
                                        float thr, float* __restrict__ lc) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nw = blockDim.x / 32;
  for (int i = warp; i < r; i += nw) {
    for (int j = lane; j <= i; j += 32) x[i * ld + j] = i == j ? 1.f : 0.f;
  }
  __syncthreads();
  bool ok = true;
  for (int k = 0; k < r; ++k) {
    const float akk = l[k * ld + k];
    ok = ok && (akk > thr);
    const float piv = rsqrtf(fmaxf(akk, 1e-30f));
    const float dkk = akk * piv;
    for (int i = k + 1 + threadIdx.x; i < r; i += blockDim.x) lc[i] = l[i * ld + k] * piv;
    for (int j = threadIdx.x; j <= k; j += blockDim.x) x[k * ld + j] = x[k * ld + j] / dkk;
    __syncthreads();
    if (threadIdx.x == 0) l[k * ld + k] = dkk;
    for (int i = k + 1 + threadIdx.x; i < r; i += blockDim.x) l[i * ld + k] = lc[i];
    for (int p0 = k + 1 + warp; p0 < r; p0 += nw * kRowBatch) {
      const int pmax = min(r - 1, p0 + nw * (kRowBatch - 1));
      for (int c0 = 0; c0 <= pmax; c0 += kBatchCols) {
        // Column j's multiplier: X[k][j] (j <= k) or L[j][k] (j > k).
        float cj[kColBatch];
#pragma unroll
        for (int c = 0; c < kColBatch; ++c) {
          const int j = c0 + lane + 32 * c;
          cj[c] = j <= k ? x[k * ld + j] : lc[min(j, r - 1)];
        }
        float lp[kRowBatch];
        float v[kRowBatch][kColBatch];
#pragma unroll
        for (int u = 0; u < kRowBatch; ++u) {
          const int p = min(p0 + nw * u, r - 1);
          lp[u] = lc[p];
#pragma unroll
          for (int c = 0; c < kColBatch; ++c) {
            const int j = min(c0 + lane + 32 * c, p);
            v[u][c] = (j <= k ? x : l)[p * ld + j];
          }
        }
#pragma unroll
        for (int u = 0; u < kRowBatch; ++u) {
          const int p = p0 + nw * u;
#pragma unroll
          for (int c = 0; c < kColBatch; ++c) {
            const int j = c0 + lane + 32 * c;
            if (p < r && j <= p) (j <= k ? x : l)[p * ld + j] = v[u][c] - lp[u] * cj[c];
          }
        }
      }
    }
    __syncthreads();
  }
  return ok;
}

// Block 0's step up to kNsSmemMaxR: S (r x r in global memory, row stride
// r), guarded Cholesky S = L L^T (if a pivot is not above pivot_c tr(S),
// the factor of S + (shift_c tr(S) + 1e-30) I), W = L^-T written to w
// (r, r).  tiles: two r x (r + 1) tiles of shared memory, L and L^-1; lc:
// r floats of shared memory.
inline __device__ void inverse_factor(const float* s, int r, float pivot_c,
                                      float shift_c, float* __restrict__ w,
                                      float* __restrict__ tiles,
                                      float* __restrict__ lc) {
  const int ld = r + 1;
  float* l = tiles;
  float* x = tiles + r * ld;
  __shared__ float tr_s;
  // S, with shift on its diagonal, into l: eight loads in flight a thread.
  auto load = [&](float shift) {
    const int n = r * r;
    for (int e0 = threadIdx.x; e0 < n; e0 += 8 * blockDim.x) {
      float v[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int e = e0 + t * blockDim.x;
        v[t] = e < n ? __ldcg(s + e) : 0.f;
      }
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int e = e0 + t * blockDim.x;
        const int i = e / r;
        const int j = e % r;
        if (e < n) l[i * ld + j] = v[t] + (i == j ? shift : 0.f);
      }
    }
    __syncthreads();
  };
  load(0.f);
  if (threadIdx.x == 0) {
    float tr = 0.f;
    for (int i = 0; i < r; ++i) tr += l[i * ld + i];
    tr_s = tr;
  }
  __syncthreads();
  const float tr = tr_s;
  if (!cholesky_inverse(l, x, r, ld, pivot_c * tr, lc)) {
    // The 1e-30 floor keeps an all-zero V-bar finite (Q = 0).
    load(shift_c * tr + 1e-30f);
    cholesky_inverse(l, x, r, ld, 0.f, lc);
  }
  for (int e = threadIdx.x; e < r * r; e += blockDim.x) {
    const int i = e / r;
    const int j = e % r;
    w[e] = j >= i ? x[j * ld + i] : 0.f;  // W = (L^-1)^T, upper triangular
  }
  __syncthreads();
}

// ---------------------------------------------------------- grid factor --
// Past kNsSmemMaxR the guarded factor runs on the whole cooperative grid
// in panels of kPanel columns, np = ceil(r / kPanel) of them; tile (I, J)
// holds rows I kPanel .. and columns J kPanel .. of a matrix.  No L is
// stored: with S = L L^T and D_K = L_KK^-1,
//   L_IK = A_IK D_K^T,
// A_IK being tile (I, K) of the Schur complement left by panels 0 .. K - 1.
// X = L^-1 comes by block forward substitution, right-looking like the
// factor: X_KK = D_K and X_KJ = D_K B_KJ (J < K), where B_IJ (I > J)
// starts at panel J as -L_IJ D_J and takes -L_IK X_KJ at each later panel
// K < I.  Panel K's phase, each unit one tile on one block:
//   A_IJ -= L_IK L_JK^T   K < J <= I, into the scratch a; the block of
//                         tile (K + 1, K + 1) then factors it in shared
//                         memory (tile_cholesky_inverse) into D_{K+1};
//   B_IJ -= L_IK X_KJ     I > K, J <= K, into the scratch b;
//   X_KJ = D_K B_KJ       J < K, written to W's tile (J, K) as X_KJ^T,
// L_IK, L_JK and X_KJ formed where they are used (no unit of the phase
// writes column K of A or row K of B, so every block reads the same
// ones); D_K lives in b's diagonal tile (K, K), and its transpose is W's
// tile (K, K).  A start phase factors tile (0, 0) on block 0 and zeroes
// W's lower tiles; panel 0 reads S itself (S stays whole for a retry).
// One grid barrier a phase: np + 1 an attempt.  Every element is one
// thread's sum in ascending depth, written by one block: the result is
// the same from run to run.  The guard of _cholqr_inverse_factor: the
// block that factors a diagonal tile checks its pivots against
// pivot_c tr(S) and writes the verdict to the tile's own word; after the
// next grid barrier every block reads it, and on a failure all of them
// start over on S + (shift_c tr(S) + 1e-30) I.  That attempt takes no
// verdict and writes none, so no word changes while a block may still
// read it.
constexpr int kPanel = 32;                  // columns a panel, a tile's edge
constexpr int kTileLd = kPanel + 1;         // staged tiles' row stride
constexpr int kTileFloats = kPanel * kTileLd;
constexpr int kFactorTiles = 5;             // staged tiles a unit uses
static_assert(kThreads == 8 * kPanel, "a thread takes 4 rows of one column");

__host__ __device__ inline int factor_panels(int r) { return (r + kPanel - 1) / kPanel; }

// Floats of the grid factor's global scratch at edge r: a and b (r x r
// each), tr(S), and one verdict word a diagonal tile.
__host__ __device__ inline size_t factor_scratch_floats(int r) {
  return 2 * static_cast<size_t>(r) * r + 1 + factor_panels(r);
}

// Shared memory of the grid factor: its staged tiles and S's diagonal.
__host__ __device__ inline size_t grid_factor_smem_bytes(int r) {
  return (static_cast<size_t>(kFactorTiles) * kTileFloats + r) * sizeof(float);
}

// A thread's place in a staged tile: rows warp + 8 u (u < 4), column lane.
__device__ __forceinline__ int tile_row(int u) { return threadIdx.x / 32 + 8 * u; }

// Tile (i0, j0) of the r x r matrix src (row stride r) into registers (a
// thread's place in the tile), zero past r, shift added on the matrix's
// diagonal; through L2 (other blocks wrote it during the launch).  A unit
// fetches all its tiles before it puts any, so their loads overlap.
__device__ __forceinline__ void fetch_tile(float (&v)[4], const float* src, int r,
                                           int i0, int j0, float shift) {
  const int j = j0 + threadIdx.x % 32;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + tile_row(u);
    v[u] = i < r && j < r
               ? __ldcg(src + static_cast<size_t>(i) * r + j) + (i == j ? shift : 0.f)
               : 0.f;
  }
}

// out[u] = sum_t a[tile_row(u)][t] op(b)[t][lane] over staged tiles, t
// ascending; op(b) = b, or b^T when kTransB.
template <bool kTransB>
__device__ __forceinline__ void tile_product(const float* __restrict__ a,
                                             const float* __restrict__ b,
                                             float (&out)[4]) {
  const int c = threadIdx.x % 32;
#pragma unroll
  for (int u = 0; u < 4; ++u) out[u] = 0.f;
#pragma unroll 8
  for (int t = 0; t < kPanel; ++t) {
    const float bv = kTransB ? b[c * kTileLd + t] : b[t * kTileLd + c];
#pragma unroll
    for (int u = 0; u < 4; ++u) out[u] = fmaf(a[tile_row(u) * kTileLd + t], bv, out[u]);
  }
}

__device__ __forceinline__ void put_tile(float* __restrict__ t, const float (&v)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) t[tile_row(u) * kTileLd + threadIdx.x % 32] = v[u];
}

// v into tile (i0, j0) of dst (r x r, row stride r), within r.
__device__ __forceinline__ void store_tile(float* dst, int r, int i0, int j0,
                                           const float (&v)[4]) {
  const int j = j0 + threadIdx.x % 32;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + tile_row(u);
    if (i < r && j < r) dst[static_cast<size_t>(i) * r + j] = v[u];
  }
}

// The staged tile t into tile (i0, j0) of dst, transposed (trans) or not.
__device__ __forceinline__ void store_staged(float* dst, int r, int i0, int j0,
                                             const float* __restrict__ t, bool trans) {
  const int c = threadIdx.x % 32;
  float v[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    v[u] = trans ? t[c * kTileLd + tile_row(u)] : t[tile_row(u) * kTileLd + c];
  }
  store_tile(dst, r, i0, j0, v);
}

struct GridFactor {
  const float* s;   // S (r x r)
  float* a;         // Schur complement tiles (r x r)
  float* b;         // B's tiles and the D_K (r x r)
  float* w;         // W = L^-T (r x r)
  float* trailer;   // [0] tr(S), [1 + K] tile K's verdict (nonzero: failed)
  int r, np;
  float thr;        // pivot_c tr(S) in a guarded attempt, else 0
  float shift;      // on S's diagonal: 0, or shift_c tr(S) + 1e-30
  bool guard;
};

// All threads: the guarded factor of the staged tile t (n x n, n <=
// kPanel, both triangles; made an identity past n, and overwritten) by
// elimination without pivoting, and D = L^-1 into the staged tile x.  Step
// k takes the pivot a_kk = t[k][k], checks it against thr (k < n), and
// every row i > k subtracts m_ik = t[i][k] / a_kk times row k from its
// trailing part (columns > k) and from its part of Y (columns <= k; Y = I
// at the start): a step writes only rows below k and reads only row k,
// column k and the pivot, so one block barrier a step.  Then L = M
// diag(l_ii), l_ii = a_ii rsqrt(a_ii) (the pivot floored at 1e-30, as
// cholesky_inverse), and D = diag(1 / l_ii) Y.  Returns, in every thread,
// whether every pivot k < n is above thr (false on a non-positive or NaN
// pivot).
inline __device__ bool tile_cholesky_inverse(float* __restrict__ t,
                                             float* __restrict__ x, int n,
                                             float thr) {
  const int c = threadIdx.x % 32;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = tile_row(u);
    if (i >= n || c >= n) t[i * kTileLd + c] = i == c ? 1.f : 0.f;
    x[i * kTileLd + c] = i == c ? 1.f : 0.f;
  }
  __syncthreads();
  bool ok = true;
  for (int k = 0; k < n; ++k) {
    const float akk = t[k * kTileLd + k];
    ok = ok && akk > thr;
    const float rinv = 1.f / fmaxf(akk, 1e-30f);
    const float tkc = t[k * kTileLd + c];
    const float xkc = x[k * kTileLd + c];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = tile_row(u);
      if (i > k) {
        const float m = t[i * kTileLd + k] * rinv;
        if (c > k) {
          t[i * kTileLd + c] = t[i * kTileLd + c] - m * tkc;
        } else {
          x[i * kTileLd + c] = x[i * kTileLd + c] - m * xkc;
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = tile_row(u);
    const float aii = t[i * kTileLd + i];
    x[i * kTileLd + c] = x[i * kTileLd + c] / (aii * rsqrtf(fmaxf(aii, 1e-30f)));
  }
  __syncthreads();
  return ok;
}

// The staged tile t (diagonal tile K of the Schur complement, overwritten)
// factored on this block (tile_cholesky_inverse): D_K into b's tile (K, K)
// and its transpose into W's; its verdict to its word in a guarded
// attempt.  x: a staged tile of scratch.
inline __device__ void factor_diagonal(const GridFactor& f, int k,
                                       float* __restrict__ t, float* __restrict__ x) {
  const int k0 = k * kPanel;
  const bool ok = tile_cholesky_inverse(t, x, min(kPanel, f.r - k0), f.thr);
  if (threadIdx.x == 0 && f.guard) f.trailer[1 + k] = ok ? 0.f : 1.f;
  store_staged(f.b, f.r, k0, k0, x, false);
  store_staged(f.w, f.r, k0, k0, x, true);
}

// Panel K's phase: its units over the grid's blocks in turn, tile
// (K + 1, K + 1) first.  smem: kFactorTiles staged tiles.
inline __device__ void factor_panel(const GridFactor& f, int k, float* smem) {
  float* const dk = smem;                  // D_K
  float* const t1 = smem + kTileFloats;    // A_IK, then L_IK
  float* const t2 = t1 + kTileFloats;      // A_JK, then L_JK; or B_KJ, then X_KJ
  float* const t3 = t2 + kTileFloats;      // A_IJ or B_IJ
  float* const t4 = t3 + kTileFloats;      // D_{K+1}
  const int r = f.r;
  const int k0 = k * kPanel;
  const float* const src = k == 0 ? f.s : f.a;
  const float shift = k == 0 ? f.shift : 0.f;
  const int below = f.np - k - 1;
  const int n_a = below * (below + 1) / 2;
  const int n_b = below * (k + 1);
  const int units = n_a + n_b + k;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    float p[4];
    float q[4];
    float v[4];
    float g[4];
    fetch_tile(g, f.b, r, k0, k0, 0.f);
    __syncthreads();  // the staged tiles of the last unit are read
    if (u < n_a) {
      // A_IJ -= L_IK L_JK^T: (I, J) row by row from (K + 1, K + 1).
      int i = k + 1;
      int w = u;
      while (w > i - k - 1) {
        w -= i - k;
        ++i;
      }
      const int j = k + 1 + w;
      const int i0 = i * kPanel;
      const int j0 = j * kPanel;
      fetch_tile(p, src, r, i0, k0, shift);
      if (j != i) fetch_tile(q, src, r, j0, k0, shift);
      fetch_tile(v, src, r, i0, j0, shift);
      put_tile(dk, g);
      put_tile(t1, p);
      if (j != i) put_tile(t2, q);
      __syncthreads();
      tile_product<true>(t1, dk, p);
      if (j != i) tile_product<true>(t2, dk, q);
      __syncthreads();
      put_tile(t1, p);
      if (j != i) put_tile(t2, q);
      __syncthreads();
      tile_product<true>(t1, j != i ? t2 : t1, p);
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = v[e] - p[e];
      if (u == 0) {
        put_tile(t3, p);
        __syncthreads();
        factor_diagonal(f, k + 1, t3, t4);
      } else {
        store_tile(f.a, r, i0, j0, p);
      }
    } else if (u < n_a + n_b) {
      // B_IJ -= L_IK X_KJ (B_IK = -L_IK D_K at J = K).
      const int i = k + 1 + (u - n_a) / (k + 1);
      const int j = (u - n_a) % (k + 1);
      const int i0 = i * kPanel;
      const int j0 = j * kPanel;
      fetch_tile(p, src, r, i0, k0, shift);
      if (j < k) {
        fetch_tile(q, f.b, r, k0, j0, 0.f);
        fetch_tile(v, f.b, r, i0, j0, 0.f);
      }
      put_tile(dk, g);
      put_tile(t1, p);
      if (j < k) put_tile(t2, q);
      __syncthreads();
      tile_product<true>(t1, dk, p);
      if (j < k) tile_product<false>(dk, t2, q);
      __syncthreads();
      put_tile(t1, p);
      if (j < k) put_tile(t2, q);
      __syncthreads();
      tile_product<false>(t1, j < k ? t2 : dk, p);
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = (j < k ? v[e] : 0.f) - p[e];
      store_tile(f.b, r, i0, j0, p);
    } else {
      // X_KJ = D_K B_KJ, into W's tile (J, K) as its transpose.
      const int j0 = (u - n_a - n_b) * kPanel;
      fetch_tile(q, f.b, r, k0, j0, 0.f);
      put_tile(dk, g);
      put_tile(t2, q);
      __syncthreads();
      tile_product<false>(dk, t2, p);
      put_tile(t1, p);
      __syncthreads();
      store_staged(f.w, r, j0, k0, t1, true);
    }
  }
}

// All blocks of the grid: the guarded factor of S (r x r, r >
// kNsSmemMaxR), W = L^-T written to w (r, r).  fs:
// factor_scratch_floats(r) floats of global scratch; smem:
// grid_factor_smem_bytes(r).  Starts with reads of s (the caller ends its
// writes with a grid.sync()) and ends with a grid barrier.
inline __device__ void grid_factor(cooperative_groups::grid_group& grid,
                                   const float* s, int r, float pivot_c,
                                   float shift_c, float* w, float* fs,
                                   float* smem) {
  const size_t rr = static_cast<size_t>(r) * r;
  GridFactor f{s, fs, fs + rr, w, fs + 2 * rr, r, factor_panels(r), 0.f, 0.f, true};
  __shared__ float tr_s;
  for (int attempt = 0; attempt < 2; ++attempt) {
    f.guard = attempt == 0;
    if (blockIdx.x == 0) {
      // tr(S) (the diagonal staged, then summed in order by one thread),
      // then S's tile (0, 0) factored.
      if (f.guard) {
        float* diag = smem + kFactorTiles * kTileFloats;
        for (int i = threadIdx.x; i < r; i += blockDim.x) {
          diag[i] = __ldcg(s + static_cast<size_t>(i) * r + i);
        }
        __syncthreads();
        if (threadIdx.x == 0) {
          float tr = 0.f;
          for (int i = 0; i < r; ++i) tr += diag[i];
          tr_s = tr;
          f.trailer[0] = tr;
        }
        __syncthreads();
      }
      const float tr = f.guard ? tr_s : __ldcg(f.trailer);
      f.thr = f.guard ? pivot_c * tr : 0.f;
      // The 1e-30 floor keeps an all-zero V-bar finite (Q = 0).
      f.shift = f.guard ? 0.f : shift_c * tr + 1e-30f;
      float v[4];
      fetch_tile(v, s, r, 0, 0, f.shift);
      put_tile(smem, v);
      __syncthreads();
      factor_diagonal(f, 0, smem, smem + kTileFloats);
    }
    if (f.guard) {
      // W's tiles below the diagonal.
      for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
           e < rr; e += static_cast<size_t>(gridDim.x) * blockDim.x) {
        if (e / r / kPanel > e % r / kPanel) w[e] = 0.f;
      }
    }
    grid.sync();
    const float trace = __ldcg(f.trailer);
    f.thr = f.guard ? pivot_c * trace : 0.f;
    f.shift = f.guard ? 0.f : shift_c * trace + 1e-30f;
    bool failed = f.guard && __ldcg(f.trailer + 1) != 0.f;
    for (int k = 0; k < f.np && !failed; ++k) {
      factor_panel(f, k, smem);
      grid.sync();
      failed = f.guard && k + 1 < f.np && __ldcg(f.trailer + 2 + k) != 0.f;
    }
    if (!failed) return;
  }
}

// Shared memory of the factor step at edge r: block 0's two r x (r + 1)
// tiles and lc up to kNsSmemMaxR, the grid factor's past it.
__host__ __device__ inline size_t chol_smem_bytes(int r) {
  if (r > kNsSmemMaxR) return grid_factor_smem_bytes(r);
  return (2 * static_cast<size_t>(r) * (r + 1) + r) * sizeof(float);
}

// The round's tail, all blocks of the cooperative grid: Q = CholeskyQR2
// of the (d, r) V-bar in global memory, the guard of
// _cholqr_inverse_factor on each pass.  q1 (d, r), w (2, r, r), part
// (splits2, r, r) and s (r, r) are scratch, and fs
// (factor_scratch_floats(r)) past kNsSmemMaxR; Q goes to out.  Starts
// with reads of vbar: the caller ends V-bar's last writes with a
// grid.sync().
//   S1 partials -> S1 -> W1 = chol(S1)^-T -> Q1 = V-bar W1
//   -> S2 partials of the measured Q1 -> S2 -> W2 -> Q = Q1 W2
// Each W by block 0 (inverse_factor) up to kNsSmemMaxR, by the grid
// (grid_factor) past it.  Not inlined: the kernels' registers stay those
// of their own phases (inlined, the VEC instances spilled, and unrolling
// the passes instead made the second pass's Gram slower).
template <bool VEC>
__noinline__ __device__ void cholqr2_tail(cooperative_groups::grid_group& grid,
                             const float* vbar, float* q1,
                             float* __restrict__ w, float* part, float* s,
                             float* __restrict__ out, int d, int r, int rows2,
                             int splits2, float pivot_c, float shift_c,
                             float* smem, float* fs) {
  const size_t rr = static_cast<size_t>(r) * r;
  for (int pass = 0; pass < 2; ++pass) {
    const float* const x = pass ? q1 : vbar;
    gram_units<VEC>(x, 0, nullptr, x, 1, d, r, rows2, splits2, part, smem);
    grid.sync();
    sum_splits(part, splits2, rr, s);
    grid.sync();
    if (r <= kNsSmemMaxR) {
      if (blockIdx.x == 0) {
        inverse_factor(s, r, pivot_c, shift_c, w + pass * rr, smem,
                       smem + 2 * r * (r + 1));
      }
      grid.sync();
    } else {
      grid_factor(grid, s, r, pivot_c, shift_c, w + pass * rr, fs, smem);
    }
    apply_units<VEC>(x, 0, nullptr, w + pass * rr, 1, d, r, 1.f, false,
                     pass ? out : q1, smem);
    if (pass == 0) {
      grid.sync();
    }
  }
}

// Dynamic shared memory of a round kernel: the largest of the phases'
// working sets (the Gram ring, the apply ring, the grouped Newton-Schulz
// form's and the factor step's).
inline size_t round_smem_bytes(int r) {
  size_t bytes = std::max(gram::kSmemBytes,
                          static_cast<size_t>(apply::kSmemFloats) * sizeof(float));
  bytes = std::max(bytes, chol_smem_bytes(r));
  return std::max(bytes, ns_grouped_smem_bytes(r));
}

}  // namespace round
}  // namespace rt
