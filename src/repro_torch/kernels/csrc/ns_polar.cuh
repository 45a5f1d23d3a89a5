// Newton-Schulz polar factor of an r x r Gram, shared by B3
// (batched_gram_polar, procrustes_align.cu) and B5/B6/B7 (fused_round.cu,
// fused_ring_remote.cu).
//
// Replaces _ns_polar_tile of src/repro/kernels/procrustes_align.py (:90-98):
// X <- G / max(||G||_F, 1e-30), then ns_iters steps of
// X <- 0.5 * X (3I - X^T X), all in f32.  One block owns one machine's
// tile: X, X^T X and a temporary take ns_tile_floats(r) = 3 rp (rp + 1)
// floats (rp = r rounded up to 4).  Up to kNsSmemMaxR (136; 218 KB) they
// live in dynamic shared memory, and the caller sets
// cudaFuncAttributeMaxDynamicSharedMemorySize to ns_smem_bytes(r).  Past
// it they live in a global-memory workspace slot of ns_tile_floats(r)
// floats that the wrapper allocates (0.8 MB a machine at r = 256, held in
// L2): the same code, instantiated with kGlobal, reads those tiles with
// ld.global.ca (the block's own writes, ordered by __syncthreads, never
// the non-coherent read-only path).
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace rt {

// Largest r whose three padded tiles fit the 227 KB a block may use.
constexpr int kNsSmemMaxR = 136;

// Load of a working-tile element: a plain (shared-memory) load, or an
// L1-cached global load for the workspace form.
template <bool kGlobal>
__device__ __forceinline__ float tile_ld(const float* p) {
  if constexpr (kGlobal) {
    return __ldca(p);
  } else {
    return *p;
  }
}

// C = op(X) * Y over rp x rp tiles (row stride ld), one 4x4 strided patch
// per thread per step: rows ti + u*nt, cols tj + v*nt.  kTransA selects
// C = X^T Y (reads rows of X) over C = X Y.
template <bool kTransA, bool kGlobal>
__device__ void small_matmul(const float* __restrict__ x,
                             const float* __restrict__ y,
                             float* __restrict__ c, int rp, int ld, int r,
                             float scale, bool minus_from_3i) {
  const int nt = rp / 4;
  for (int t = threadIdx.x; t < nt * nt; t += blockDim.x) {
    const int ti = t / nt;
    const int tj = t % nt;
    float acc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
    for (int k = 0; k < rp; ++k) {
      float a[4];
      float b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        a[u] = tile_ld<kGlobal>(kTransA ? x + k * ld + ti + u * nt
                                        : x + (ti + u * nt) * ld + k);
#pragma unroll
      for (int v = 0; v < 4; ++v) b[v] = tile_ld<kGlobal>(y + k * ld + tj + v * nt);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = ti + u * nt;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int j = tj + v * nt;
        float val = acc[u][v];
        if (minus_from_3i) val = ((i == j && i < r) ? 3.f : 0.f) - val;
        c[i * ld + j] = scale * val;
      }
    }
  }
}

// Floats of the three working tiles at edge r.
__host__ __device__ inline size_t ns_tile_floats(int r) {
  const size_t rp = static_cast<size_t>((r + 3) & ~3);
  return 3 * rp * (rp + 1);
}

// Dynamic shared memory of ns_polar_block at edge r: the tiles up to
// kNsSmemMaxR, none past it (they are in the workspace).
inline size_t ns_smem_bytes(int r) {
  return r <= kNsSmemMaxR ? ns_tile_floats(r) * sizeof(float) : 0;
}

// One block: reduce the splits of one machine's partial Grams
// (part_z: (splits, r, r)) into the r x r Gram, Frobenius-normalise it
// (1e-30 floor) and run ns_iters Newton-Schulz steps on the tiles (shared
// memory, or a workspace slot when kGlobal); write Z (r, r) to out_z.
// tiles holds ns_tile_floats(r); warp_sums one float per warp of the
// block.  Ends with a block barrier, so the caller may reuse tiles at once.
template <bool kGlobal>
__device__ inline void ns_polar_tiles(const float* __restrict__ part_z,
                                      float* __restrict__ out_z, int splits,
                                      int r, int ns_iters, float* tiles,
                                      float* warp_sums) {
  const int rp = (r + 3) & ~3;  // padded edge: rows/cols >= r stay zero
  const int ld = rp + 1;        // odd stride: column reads hit distinct banks
  float* x = tiles;
  float* t = x + rp * ld;
  float* y = t + rp * ld;
  const size_t rr = static_cast<size_t>(r) * r;
  const int nwarps = blockDim.x / 32;

  float sq = 0.f;
  for (int e = threadIdx.x; e < rp * rp; e += blockDim.x) {
    const int i = e / rp;
    const int j = e % rp;
    float g = 0.f;
    if (i < r && j < r) {
      for (int s = 0; s < splits; ++s) g += part_z[s * rr + i * r + j];
    }
    x[i * ld + j] = g;
    sq = fmaf(g, g, sq);
  }
  // Deterministic block reduction of sum(g * g): warp tree, then thread 0
  // adds the per-warp sums in order.
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_down_sync(0xffffffffu, sq, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = sq;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < nwarps; ++w) total += warp_sums[w];
    warp_sums[0] = total;
  }
  __syncthreads();
  const float norm = fmaxf(sqrtf(warp_sums[0]), 1e-30f);
  for (int e = threadIdx.x; e < rp * rp; e += blockDim.x) {
    const int i = e / rp;
    const int j = e % rp;
    x[i * ld + j] = x[i * ld + j] / norm;
  }
  __syncthreads();

  for (int it = 0; it < ns_iters; ++it) {
    small_matmul<true, kGlobal>(x, x, t, rp, ld, r, 1.f, true);  // t = 3I - x^T x
    __syncthreads();
    small_matmul<false, kGlobal>(x, t, y, rp, ld, r, 0.5f, false);  // y = 0.5 x t
    __syncthreads();
    float* tmp = x;
    x = y;
    y = tmp;
  }

  for (int e = threadIdx.x; e < r * r; e += blockDim.x) {
    const int i = e / r;
    const int j = e % r;
    out_z[e] = x[i * ld + j];
  }
  __syncthreads();
}

// ns_polar_tiles with the tiles in shared memory (smem, r <= kNsSmemMaxR)
// or in the workspace slot ws (ns_tile_floats(r) floats, r past it).
__device__ inline void ns_polar_block(const float* __restrict__ part_z,
                                      float* __restrict__ out_z, int splits,
                                      int r, int ns_iters, float* smem,
                                      float* ws, float* warp_sums) {
  if (r <= kNsSmemMaxR) {
    ns_polar_tiles<false>(part_z, out_z, splits, r, ns_iters, smem, warp_sums);
  } else {
    ns_polar_tiles<true>(part_z, out_z, splits, r, ns_iters, ws, warp_sums);
  }
}

}  // namespace rt
