// Device pieces of a whole Procrustes-fixing round, shared by B5/B6
// (fused_round.cu) and B7 (fused_ring_remote.cu): the Gram and apply
// phases over the grid (tile_products.cuh), the split sums, the guarded
// Cholesky of an r x r Gram with its triangular inverse, and the
// CholeskyQR2 tail that turns V-bar into the round's output.  Each kernel
// that uses them is one cooperative launch of kThreads-thread blocks with
// round_smem_bytes(r) (or more) of dynamic shared memory.  The Cholesky
// tile sits in that shared memory up to r = kNsSmemMaxR and in a global
// workspace slot past it (ns_polar.cuh).  See fused_round.cu for the
// design notes.
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

// Block 0's step: S (r x r in global memory, row stride r), guarded
// Cholesky S = L L^T (if a pivot is not above pivot_c tr(S), the factor of
// S + (shift_c tr(S) + 1e-30) I), W = L^-T written to w (r, r).  tiles:
// two r x (r + 1) tiles, L and L^-1 (shared memory, or a workspace slot
// past kNsSmemMaxR); lc: r floats of shared memory.
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

// Shared memory of the Cholesky step at edge r: its two tiles and lc up to
// kNsSmemMaxR, lc alone past it (the tiles are in the workspace).
__host__ __device__ inline size_t chol_smem_bytes(int r) {
  const size_t tiles = r <= kNsSmemMaxR ? 2 * static_cast<size_t>(r) * (r + 1) : 0;
  return (tiles + r) * sizeof(float);
}

// The round's tail, all blocks of the cooperative grid: Q = CholeskyQR2
// of the (d, r) V-bar in global memory, the guard of
// _cholqr_inverse_factor on each pass.  q1 (d, r), w (2, r, r), part
// (splits2, r, r) and s (r, r) are scratch; Q goes to out.  Starts with
// reads of vbar: the caller ends V-bar's last writes with a grid.sync().
//   S1 partials -> S1 -> W1 = chol(S1)^-T (block 0) -> Q1 = V-bar W1
//   -> S2 partials of the measured Q1 -> S2 -> W2 (block 0) -> Q = Q1 W2
template <bool VEC>
__device__ void cholqr2_tail(cooperative_groups::grid_group& grid,
                             const float* vbar, float* q1,
                             float* __restrict__ w, float* part, float* s,
                             float* __restrict__ out, int d, int r, int rows2,
                             int splits2, float pivot_c, float shift_c,
                             float* smem, float* ws) {
  const size_t rr = static_cast<size_t>(r) * r;
  // Block 0's step; the factor tile in shared memory or the workspace.
  auto factor = [&](float* wk) {
    if (r <= kNsSmemMaxR) {
      inverse_factor(s, r, pivot_c, shift_c, wk, smem, smem + 2 * r * (r + 1));
    } else {
      inverse_factor(s, r, pivot_c, shift_c, wk, ws, smem);
    }
  };
  const float* const x[2] = {vbar, q1};
  float* const dst[2] = {q1, out};
  for (int pass = 0; pass < 2; ++pass) {
    gram_units<VEC>(x[pass], 0, nullptr, x[pass], 1, d, r, rows2, splits2, part,
                    smem);
    grid.sync();
    sum_splits(part, splits2, rr, s);
    grid.sync();
    if (blockIdx.x == 0) factor(w + pass * rr);
    grid.sync();
    apply_units<VEC>(x[pass], 0, nullptr, w + pass * rr, 1, d, r, 1.f, false,
                     dst[pass], smem);
    if (pass == 0) {
      grid.sync();
    }
  }
}

// Dynamic shared memory of a round kernel: the largest of the phases'
// working sets (the Gram ring, the apply ring, the grouped Newton-Schulz
// tiles and the Cholesky tile up to kNsSmemMaxR).
inline size_t round_smem_bytes(int r) {
  size_t bytes = std::max(gram::kSmemBytes,
                          static_cast<size_t>(apply::kSmemFloats) * sizeof(float));
  bytes = std::max(bytes, chol_smem_bytes(r));
  if (r <= kNsSmemMaxR) bytes = std::max(bytes, ns_group_smem_bytes(r));
  return bytes;
}

// Floats of one workspace slot past kNsSmemMaxR: Newton-Schulz's three
// padded tiles, which also hold the Cholesky step's two r x (r + 1).
__host__ __device__ inline size_t round_ws_floats(int r) {
  return rt::ns_tile_floats(r);
}

}  // namespace round
}  // namespace rt
