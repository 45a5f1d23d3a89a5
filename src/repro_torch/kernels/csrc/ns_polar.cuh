// Newton-Schulz polar factor of an r x r Gram, shared by B3
// (batched_gram_polar, procrustes_align.cu) and B5/B6/B7 (fused_round.cu,
// fused_ring_remote.cu).
//
// Replaces _ns_polar_tile of src/repro/kernels/procrustes_align.py (:90-98):
// X <- G / max(||G||_F, 1e-30), then ns_iters steps of
// X <- 0.5 * X (3I - X^T X), all in f32.  Two forms:
//
// * ns_polar_block: one block owns one machine's tile (B3, B7's hops, and
//   B5/B6 past kNsSmemMaxR).  X, X^T X and a temporary take
//   ns_tile_floats(r) = 3 rp (rp + 1) floats (rp = r rounded up to 4).  Up
//   to kNsSmemMaxR (136; 218 KB) they live in dynamic shared memory, and
//   the caller sets cudaFuncAttributeMaxDynamicSharedMemorySize to
//   ns_smem_bytes(r).  Past it they live in a global-memory workspace slot
//   of ns_tile_floats(r) floats that the wrapper allocates (0.8 MB a
//   machine at r = 256, held in L2): the same code, instantiated with
//   kGlobal, reads those tiles with ld.global.ca (the block's own writes,
//   ordered by __syncthreads, never the non-coherent read-only path).
// * ns_polar_group: a group of g blocks of a cooperative launch owns one
//   machine (B5/B6 up to kNsSmemMaxR), each block r / g columns of X.  A
//   step stages the whole of X in shared memory from L2, computes the
//   block's columns of M = 3I - X^T X (M is symmetric: they are its rows)
//   and then its columns of 0.5 X M into the other of two iterate
//   buffers, and the group meets once.  The group meets at a counter in
//   global memory (group_sync), which is safe because a cooperative
//   launch keeps every block resident.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "tile_products.cuh"

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

// Barrier of the g blocks that share counter ctr (zero before the first
// barrier): the n-th barrier waits for target = n g arrivals.  Writes
// before it, by any thread of the group, are visible after it to loads
// through L2 (ld.global.cg, cp.async.cg).
__device__ __forceinline__ void group_sync(unsigned* ctr, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(ctr, 1u);
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen)
                   : "l"(ctr)
                   : "memory");
    } while (seen < target);
  }
  __syncthreads();
}

// Sum of one float a thread over the block, the same on every thread:
// a warp tree, then the warps' sums in order (red: one float a warp).
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) total += red[w];
  __syncthreads();  // red may be rewritten by the next call
  return total;
}

// Shared memory of ns_polar_group at edge r (r <= kNsSmemMaxR): the whole
// X, rp rows of rp + 4 floats; the block's columns of X and of M,
// depth-major (2 rp nr floats, nr <= rp the block's columns rounded up to
// 4); and, when a block has few columns, the depth-split partial sums (at
// most 4096 floats, and then rp nr < 4096).
__host__ __device__ inline size_t ns_group_smem_bytes(int r) {
  const size_t rp = static_cast<size_t>((r + 3) & ~3);
  const size_t rest = 2 * rp * rp > 12288 ? 2 * rp * rp : 12288;
  return (rp * (rp + 4) + rest) * sizeof(float);
}

// Depth splits of a product of `tasks` tasks: up to 4 groups of threads
// share the depth when there are fewer tasks than threads.
__device__ __forceinline__ int depth_splits(int tasks) {
  return tasks >= static_cast<int>(blockDim.x)
             ? 1
             : min(4, static_cast<int>(blockDim.x) / tasks);
}

// The block's columns of M = 3I - X^T X, depth-major: mt[k][c] =
// M[k][i0 + c] = M[i0 + c][k] (M is symmetric), c < nr, k < rp, as
// sum_t X[t][i0 + c] X[t][k] from F = X (rp x rp in shared memory, row
// stride ld, zero past r) and xc[t][c] = X[t][i0 + c] (zero past n).  A
// task is a 4 x 4 register tile (columns c of xc by k of F), a float4 of
// each a step of the depth; the depth splits add their partial sums
// (part) in order.
inline __device__ void ns_gram_cols(const float* __restrict__ f, const float* __restrict__ xc,
                             int nr, int ld, int rp, int i0,
                             float* __restrict__ mt, float* __restrict__ part) {
  const int nk4 = rp / 4;
  const int tasks = nr / 4 * nk4;
  const int splits = depth_splits(tasks);
  const int kd = (rp + splits - 1) / splits;
  auto store = [&](int c, int k, float sum) {
    mt[k * nr + c] = (k == i0 + c ? 3.f : 0.f) - sum;
  };
  for (int t = threadIdx.x; t < tasks * splits; t += blockDim.x) {
    const int task = t % tasks;
    const int ks = t / tasks;
    const int c0 = (task / nk4) * 4;
    const int k0 = (task % nk4) * 4;
    const int t1 = min(rp, (ks + 1) * kd);
    float acc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
#pragma unroll 4
    for (int d = ks * kd; d < t1; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(xc + d * nr + c0);
      const float4 b = *reinterpret_cast<const float4*>(f + d * ld + k0);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        if (splits > 1) {
          part[(ks * nr + c0 + u) * rp + k0 + v] = acc[u][v];
        } else {
          store(c0 + u, k0 + v, acc[u][v]);
        }
      }
  }
  if (splits > 1) {
    __syncthreads();
    for (int e = threadIdx.x; e < nr * rp; e += blockDim.x) {
      const int c = e / rp;
      const int k = e % rp;
      float sum = 0.f;
      for (int ks = 0; ks < splits; ++ks) sum += part[(ks * nr + c) * rp + k];
      store(c, k, sum);
    }
  }
}

// Columns i0 .. i0 + n - 1 of 0.5 X M (rows i < r) into y (global, row
// stride r): y[i][i0 + c] = 0.5 sum_k X[i][k] M[k][i0 + c], from F = X
// and mt (ns_gram_cols).  A task is one row by 4 columns, four steps of
// the depth at a time (a float4 of X's row, four of mt's rows).
inline __device__ void ns_apply_cols(const float* __restrict__ f, const float* __restrict__ mt,
                              int nr, int ld, int rp, int r, int i0, int n,
                              float* __restrict__ y, float* __restrict__ part) {
  const int nc4 = nr / 4;
  const int tasks = r * nc4;
  const int splits = depth_splits(tasks);
  const int kd = (rp / 4 + splits - 1) / splits * 4;
  auto store = [&](int i, int c, float sum) {
    y[static_cast<size_t>(i) * r + i0 + c] = 0.5f * sum;
  };
  for (int t = threadIdx.x; t < tasks * splits; t += blockDim.x) {
    const int task = t % tasks;
    const int ks = t / tasks;
    const int i = task / nc4;
    const int c0 = (task % nc4) * 4;
    const int k1 = min(rp, (ks + 1) * kd);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
    for (int k = ks * kd; k < k1; k += 4) {
      const float4 a = *reinterpret_cast<const float4*>(f + i * ld + k);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 b = *reinterpret_cast<const float4*>(mt + (k + q) * nr + c0);
        acc[0] = fmaf(av[q], b.x, acc[0]);
        acc[1] = fmaf(av[q], b.y, acc[1]);
        acc[2] = fmaf(av[q], b.z, acc[2]);
        acc[3] = fmaf(av[q], b.w, acc[3]);
      }
    }
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      if (splits > 1) {
        part[(ks * r + i) * nr + c0 + v] = acc[v];
      } else if (c0 + v < n) {
        store(i, c0 + v, acc[v]);
      }
    }
  }
  if (splits > 1) {
    __syncthreads();
    for (int e = threadIdx.x; e < r * n; e += blockDim.x) {
      const int i = e / n;
      const int c = e % n;
      float sum = 0.f;
      for (int ks = 0; ks < splits; ++ks) sum += part[(ks * r + i) * nr + c];
      store(i, c, sum);
    }
  }
}

// The r x r matrix src (global, row stride r) into the rp x rp tile f
// (row stride ld), zero past r; vec: r % 4 == 0 (16-byte copies).
__device__ inline void stage_square(float* __restrict__ f, const float* src,
                                    int r, int rp, int ld, bool vec) {
  if (vec) {
    const int c4 = r / 4;
    for (int e = threadIdx.x; e < r * c4; e += blockDim.x) {
      const int row = e / c4;
      const int col = (e % c4) * 4;
      cp_async16(f + row * ld + col, src + static_cast<size_t>(row) * r + col, true);
    }
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    for (int e = threadIdx.x; e < rp * rp; e += blockDim.x) {
      const int row = e / rp;
      const int col = e % rp;
      f[row * ld + col] =
          row < r && col < r ? __ldcg(src + static_cast<size_t>(row) * r + col) : 0.f;
    }
  }
  __syncthreads();
}

// Block q of the g blocks of machine z (r <= kNsSmemMaxR): columns
// q ceil(r / g) .. of Z = NS-polar(sum of the splits of part_z), written to
// x (the machine's (r, r) slot).  The iterates alternate between x and
// alt ((r, r) scratch of the machine, which may be part_z's first slot):
// a step stages the whole iterate, computes the block's columns of M and
// then of the next iterate into the other buffer, and the group meets
// once, so no block overwrites an iterate another is still staging; the
// Gram starts in the buffer that leaves the last step's result in x.
// nsn: g floats, the blocks' sums of squares; ctr: the machine's barrier
// counter, zero on entry.  The Gram's norm is the blocks' sums in block
// order, each a block_sum of its rows: the same on every block and from
// run to run.
__device__ inline void ns_polar_group(const float* __restrict__ part_z,
                                      int splits, float* x, float* alt,
                                      float* nsn, unsigned* ctr, int g, int q,
                                      int r, int ns_iters, float* smem,
                                      float* red) {
  const int rp = (r + 3) & ~3;
  const int ld = rp + 4;
  const bool vec = r % 4 == 0;
  const int rb = (r + g - 1) / g;
  const int i0 = min(r, q * rb);
  const int n = min(r, i0 + rb) - i0;
  const int nr = (n + 3) & ~3;
  float* f = smem;
  float* xc = f + rp * ld;   // X's columns i0 .., depth-major [rp][nr]
  float* mt = xc + rp * nr;  // M's columns i0 .., depth-major [rp][nr]
  float* part = mt + rp * nr;
  float* const buf[2] = {x, alt};
  const size_t rr = static_cast<size_t>(r) * r;
  const int first = ns_iters % 2;  // the Gram's buffer
  unsigned arrivals = 0;

  // The block's rows of G, the splits summed in order, and their squares
  // (each element read before it is written: alt may be part_z's slot 0).
  float sq = 0.f;
  for (int e = threadIdx.x; e < n * r; e += blockDim.x) {
    const size_t idx = static_cast<size_t>(i0) * r + e;
    float gv = 0.f;
    for (int s = 0; s < splits; ++s) gv += __ldcg(part_z + s * rr + idx);
    buf[first][idx] = gv;
    sq = fmaf(gv, gv, sq);
  }
  sq = block_sum(sq, red);
  if (threadIdx.x == 0) nsn[q] = sq;
  group_sync(ctr, arrivals += g);
  float total = 0.f;
  for (int b = 0; b < g; ++b) total += __ldcg(nsn + b);
  const float norm = fmaxf(sqrtf(total), 1e-30f);
  if (ns_iters == 0) {
    for (int e = threadIdx.x; e < n * r; e += blockDim.x) {
      const size_t idx = static_cast<size_t>(i0) * r + e;
      x[idx] = __ldcg(x + idx) / norm;
    }
    return;
  }

  for (int it = 0; it < ns_iters; ++it) {
    stage_square(f, buf[(first + it) % 2], r, rp, ld, vec);
    if (it == 0) {
      for (int i = threadIdx.x / 32; i < r; i += blockDim.x / 32) {
        for (int j = threadIdx.x % 32; j < r; j += 32) f[i * ld + j] = f[i * ld + j] / norm;
      }
      __syncthreads();
    }
    for (int e = threadIdx.x; e < rp * nr; e += blockDim.x) {
      const int k = e / nr;
      const int c = e % nr;
      xc[e] = c < n ? f[k * ld + i0 + c] : 0.f;
    }
    __syncthreads();
    ns_gram_cols(f, xc, nr, ld, rp, i0, mt, part);
    __syncthreads();
    ns_apply_cols(f, mt, nr, ld, rp, r, i0, n, buf[(first + it + 1) % 2], part);
    if (it + 1 < ns_iters) group_sync(ctr, arrivals += g);
  }
}

}  // namespace rt
