// Newton-Schulz polar factor of an r x r Gram, shared by B3
// (batched_gram_polar, procrustes_align.cu) and B5/B6/B7 (fused_round.cu,
// fused_ring_remote.cu).
//
// Replaces _ns_polar_tile of src/repro/kernels/procrustes_align.py (:90-98):
// X <- G / max(||G||_F, 1e-30), then ns_iters steps of
// X <- 0.5 * X (3I - X^T X), all in f32, on a group of g blocks of a
// cooperative launch a machine.  Two forms:
//
// * ns_polar_group: up to kNsSmemMaxR (B3, B5/B6 and B7's hops), each
//   block r / g columns of X.  A step stages the whole of X in shared
//   memory from L2, computes the block's columns of M = 3I - X^T X (M is
//   symmetric: they are its rows) and then its columns of 0.5 X M into the
//   other of two iterate buffers, and the group meets once.  The group
//   meets at a counter in global memory (group_sync), which is safe
//   because a cooperative launch keeps every block resident.
// * ns_polar_group_wide: the same group past kNsSmemMaxR (B3, B5/B6 and
//   B7's hops), where the whole X no longer fits a block's shared memory
//   (r = 256: 266 KB).  Each block holds only its own columns of M and
//   streams X from L2 in slices of rows through a two-stage cp.async ring,
//   twice a step: once for its columns of M (sum over the rows t of
//   X[t][k] X[t][i0 + c]), once for its columns of 0.5 X M.  At r = 256 a
//   machine's iterate is 256 KB, and the card's 50 MB L2 holds every
//   machine's.
//   ns_polar_grouped picks the form from r.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "tile_products.cuh"

namespace rt {

// Largest r whose grouped form stages the whole iterate
// (ns_group_smem_bytes) in the 227 KB a block may use.
constexpr int kNsSmemMaxR = 136;

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
__host__ __device__ constexpr size_t ns_group_smem_bytes(int r) {
  const size_t rp = static_cast<size_t>((r + 3) & ~3);
  const size_t rest = 2 * rp * rp > 12288 ? 2 * rp * rp : 12288;
  return (rp * (rp + 4) + rest) * sizeof(float);
}
static_assert(ns_group_smem_bytes(kNsSmemMaxR) <= 232448 &&
                  ns_group_smem_bytes(kNsSmemMaxR + 1) > 232448,
              "kNsSmemMaxR is the widest edge whose staged iterate fits");

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


// ---------------------------------------------------------------- wide --
// Columns of M a pass of ns_polar_group_wide, its ring depth, the floats
// of its depth-split partial sums, and the shared memory a block may use.
constexpr int kWideCols = 16;
constexpr int kWideStages = 2;
constexpr int kWidePart = 4096;
constexpr size_t kBlockSmemMax = 232448;
// Largest r the wide form takes: its working set with 4-row slices.
constexpr int kNsGroupMaxR = 2248;

// Floats of the wide form's shared memory at padded edge rp and `rows`
// rows a slice: the ring, the block's M columns, the partial sums.
__host__ __device__ constexpr size_t ns_wide_floats(int rp, int rows) {
  return static_cast<size_t>(kWideStages) * rows * (rp + 4) +
         static_cast<size_t>(rp) * kWideCols + kWidePart;
}
static_assert(ns_wide_floats(kNsGroupMaxR, 4) * sizeof(float) <= kBlockSmemMax &&
                  ns_wide_floats(kNsGroupMaxR + 4, 4) * sizeof(float) > kBlockSmemMax,
              "kNsGroupMaxR is the widest edge whose 4-row ring fits");

// Rows a slice of the wide form at edge r: the most of 64, 32, 16, 8, 4
// that fits (0 past kNsGroupMaxR).
__host__ __device__ inline int ns_wide_rows(int r) {
  const int rp = (r + 3) & ~3;
  for (int rows = 64; rows >= 4; rows /= 2) {
    if (ns_wide_floats(rp, rows) * sizeof(float) <= kBlockSmemMax) return rows;
  }
  return 0;
}

// Dynamic shared memory of the grouped form at edge r (0: r is too wide).
__host__ __device__ inline size_t ns_grouped_smem_bytes(int r) {
  if (r <= kNsSmemMaxR) return ns_group_smem_bytes(r);
  const int rows = ns_wide_rows(r);
  return rows ? ns_wide_floats((r + 3) & ~3, rows) * sizeof(float) : 0;
}

// Rows t0 .. t0 + rows - 1 of the r x r matrix src (row stride r) into
// the slice s (row stride ld, rp columns), zero past r either way, as one
// cp.async group: 16-byte copies through L2 when vec (r % 4 == 0, src
// 16-byte aligned), else plain loads through L2 and an empty group.
__device__ inline void stage_rows(float* __restrict__ s, const float* src,
                                  int t0, int rows, int r, int rp, int ld,
                                  bool vec) {
  if (vec) {
    const int c4 = rp / 4;
    for (int e = threadIdx.x; e < rows * c4; e += blockDim.x) {
      const int row = e / c4;
      const int col = (e % c4) * 4;
      const bool ok = t0 + row < r;
      cp_async16(s + row * ld + col,
                 src + static_cast<size_t>(ok ? t0 + row : 0) * r + col, ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * rp; e += blockDim.x) {
      const int row = e / rp;
      const int col = e % rp;
      const int t = t0 + row;
      s[row * ld + col] =
          t < r && col < r ? __ldcg(src + static_cast<size_t>(t) * r + col) : 0.f;
    }
  }
  cp_async_commit();
}

// The block's M columns col0 .. col0 + nc - 1 (col0 % 4 == 0), depth-major:
// mt[k][c] = (k == col0 + c ? 3 : 0) - sum_t X[t][k] X[t][col0 + c], k < rp,
// c < nc rounded up to 4, X = src streamed by slices.  A task is a 4 x 4
// register tile (4 columns by 4 rows k); a wave of at most blockDim.x
// tasks streams X once.  When a wave has fewer tasks than threads, up to 4
// groups of threads split each slice's rows and add their sums in order
// (part).
__device__ inline void ns_wide_gram(const float* src, int r, int rp, int ld,
                                    int rows, bool vec, int col0, int nc,
                                    float* __restrict__ mt, float* __restrict__ part,
                                    float* slices) {
  const int ncc = (nc + 3) / 4;
  const int tasks = ncc * (rp / 4);
  const int nslices = (r + rows - 1) / rows;
  for (int w0 = 0; w0 < tasks; w0 += blockDim.x) {
    const int tw = min(tasks - w0, static_cast<int>(blockDim.x));
    const int splits = depth_splits(tw);
    const bool busy = threadIdx.x < tw * splits;
    const int task = w0 + threadIdx.x % tw;
    const int ks = threadIdx.x / tw;
    const int k0 = task / ncc * 4;
    const int c0 = task % ncc * 4;
    float acc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
    stage_rows(slices, src, 0, rows, r, rp, ld, vec);
    for (int sl = 0; sl < nslices; ++sl) {
      if (sl + 1 < nslices) {
        stage_rows(slices + ((sl + 1) % kWideStages) * rows * ld, src,
                   (sl + 1) * rows, rows, r, rp, ld, vec);
      } else {
        cp_async_commit();
      }
      cp_async_wait<1>();
      __syncthreads();
      const float* s = slices + (sl % kWideStages) * rows * ld;
      const int nt = min(rows, r - sl * rows);
      if (busy) {
#pragma unroll 4
        for (int t = ks; t < nt; t += splits) {
          const float4 a = *reinterpret_cast<const float4*>(s + t * ld + col0 + c0);
          const float4 b = *reinterpret_cast<const float4*>(s + t * ld + k0);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
        }
      }
      __syncthreads();  // the next stage overwrites this slice
    }
    if (busy) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          if (splits > 1) {
            part[(ks * tw + task - w0) * 16 + u * 4 + v] = acc[u][v];
          } else {
            mt[(k0 + v) * kWideCols + c0 + u] =
                (k0 + v == col0 + c0 + u ? 3.f : 0.f) - acc[u][v];
          }
        }
    }
    if (splits > 1) {
      __syncthreads();
      for (int e = threadIdx.x; e < tw * 16; e += blockDim.x) {
        const int tk = e / 16;
        const int u = e % 16 / 4;
        const int v = e % 4;
        float sum = 0.f;
        for (int q = 0; q < splits; ++q) sum += part[(q * tw + tk) * 16 + e % 16];
        const int k = (w0 + tk) / ncc * 4 + v;
        const int c = (w0 + tk) % ncc * 4 + u;
        mt[k * kWideCols + c] = (k == col0 + c ? 3.f : 0.f) - sum;
      }
      __syncthreads();  // part is rewritten by the next wave
    }
  }
}

// Columns col0 .. col0 + nc - 1 of 0.5 X M into y (global, row stride r):
// y[i][col0 + c] = 0.5 sum_k X[i][k] mt[k][c], i < r, X = src streamed by
// slices.  A task is a 4 x 4 register tile: slice rows ri, ri + q, ri + 2q,
// ri + 3q (q = rows / 4, so a warp reads distinct banks) by 4 columns; up
// to 4 groups of threads split the depth when a slice has fewer tasks than
// threads and add their sums in order (part).
__device__ inline void ns_wide_apply(const float* src, int r, int rp, int ld,
                                     int rows, bool vec, int col0, int nc,
                                     const float* __restrict__ mt,
                                     float* __restrict__ part, float* slices,
                                     float* __restrict__ y) {
  const int ncc = (nc + 3) / 4;
  const int q = rows / 4;
  const int tasks = q * ncc;
  const int splits = depth_splits(tasks);
  const int kd = (rp / 4 + splits - 1) / splits * 4;
  const bool busy = threadIdx.x < tasks * splits;
  const int task = threadIdx.x % tasks;
  const int ks = threadIdx.x / tasks;
  const int ri = task / ncc;
  const int c0 = task % ncc * 4;
  const int kb = ks * kd;
  const int ke = min(rp, kb + kd);
  const int nslices = (r + rows - 1) / rows;
  auto store = [&](int row, int c, float sum) {
    if (row < r && c < nc) y[static_cast<size_t>(row) * r + col0 + c] = 0.5f * sum;
  };
  stage_rows(slices, src, 0, rows, r, rp, ld, vec);
  for (int sl = 0; sl < nslices; ++sl) {
    if (sl + 1 < nslices) {
      stage_rows(slices + ((sl + 1) % kWideStages) * rows * ld, src,
                 (sl + 1) * rows, rows, r, rp, ld, vec);
    } else {
      cp_async_commit();
    }
    cp_async_wait<1>();
    __syncthreads();
    const float* s = slices + (sl % kWideStages) * rows * ld;
    const int t0 = sl * rows;
    if (busy) {
      float acc[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
#pragma unroll 2
      for (int k = kb; k < ke; k += 4) {
        float4 xr[4];
        float4 mr[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          xr[u] = *reinterpret_cast<const float4*>(s + (ri + u * q) * ld + k);
#pragma unroll
        for (int p = 0; p < 4; ++p)
          mr[p] = *reinterpret_cast<const float4*>(mt + (k + p) * kWideCols + c0);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float xv[4] = {xr[u].x, xr[u].y, xr[u].z, xr[u].w};
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            acc[u][0] = fmaf(xv[p], mr[p].x, acc[u][0]);
            acc[u][1] = fmaf(xv[p], mr[p].y, acc[u][1]);
            acc[u][2] = fmaf(xv[p], mr[p].z, acc[u][2]);
            acc[u][3] = fmaf(xv[p], mr[p].w, acc[u][3]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          if (splits > 1) {
            part[(ks * tasks + task) * 16 + u * 4 + v] = acc[u][v];
          } else {
            store(t0 + ri + u * q, c0 + v, acc[u][v]);
          }
        }
    }
    if (splits > 1) {
      __syncthreads();
      for (int e = threadIdx.x; e < tasks * 16; e += blockDim.x) {
        const int tk = e / 16;
        float sum = 0.f;
        for (int p = 0; p < splits; ++p) sum += part[(p * tasks + tk) * 16 + e % 16];
        store(t0 + tk / ncc + (e % 16 / 4) * q, tk % ncc * 4 + e % 4, sum);
      }
    }
    __syncthreads();  // the next stage overwrites this slice (and part)
  }
}

// The grouped form past kNsSmemMaxR (r <= kNsGroupMaxR): block q of the g
// blocks of machine z owns columns q cb .. of Z (cb = ceil(r / g) rounded
// up to 4, so that its float4 reads stay aligned).  Arguments and the
// ping-pong of the iterate as ns_polar_group.  The block's rows of the
// Gram are read twice, once for the norm and once to write them
// normalised, and the group meets before the first step.  Each step
// streams the iterate twice for every kWideCols of the block's columns
// (M's columns, then the next iterate's), and the group meets once.
__device__ inline void ns_polar_group_wide(const float* part_z, int splits,
                                           float* x, float* alt, float* nsn,
                                           unsigned* ctr, int g, int q, int r,
                                           int ns_iters, float* smem,
                                           float* red) {
  const int rp = (r + 3) & ~3;
  const int ld = rp + 4;
  const int rows = ns_wide_rows(r);
  const int cb = ((r + g - 1) / g + 3) & ~3;
  const int i0 = min(r, q * cb);
  const int n = min(r, i0 + cb) - i0;
  float* mt = smem;
  float* part = mt + rp * kWideCols;
  float* slices = part + kWidePart;
  float* const buf[2] = {x, alt};
  const size_t rr = static_cast<size_t>(r) * r;
  const int first = ns_iters % 2;
  unsigned arrivals = 0;
  auto gram_at = [&](size_t idx) {
    float gv = 0.f;
    for (int s = 0; s < splits; ++s) gv += __ldcg(part_z + s * rr + idx);
    return gv;
  };

  float sq = 0.f;
  for (int e = threadIdx.x; e < n * r; e += blockDim.x) {
    const float gv = gram_at(static_cast<size_t>(i0) * r + e);
    sq = fmaf(gv, gv, sq);
  }
  sq = block_sum(sq, red);
  if (threadIdx.x == 0) nsn[q] = sq;
  group_sync(ctr, arrivals += g);
  float total = 0.f;
  for (int b = 0; b < g; ++b) total += __ldcg(nsn + b);
  const float norm = fmaxf(sqrtf(total), 1e-30f);
  // Each element is read before it is written: alt may be part_z's slot 0.
  for (int e = threadIdx.x; e < n * r; e += blockDim.x) {
    const size_t idx = static_cast<size_t>(i0) * r + e;
    buf[first][idx] = gram_at(idx) / norm;
  }
  if (ns_iters == 0) return;
  group_sync(ctr, arrivals += g);

  for (int it = 0; it < ns_iters; ++it) {
    const float* cur = buf[(first + it) % 2];
    const bool vec = r % 4 == 0 && reinterpret_cast<uintptr_t>(cur) % 16 == 0;
    for (int c0 = 0; c0 < n; c0 += kWideCols) {
      const int nc = min(kWideCols, n - c0);
      ns_wide_gram(cur, r, rp, ld, rows, vec, i0 + c0, nc, mt, part, slices);
      __syncthreads();
      ns_wide_apply(cur, r, rp, ld, rows, vec, i0 + c0, nc, mt, part, slices,
                    buf[(first + it + 1) % 2]);
    }
    if (it + 1 < ns_iters) group_sync(ctr, arrivals += g);
  }
}

// The grouped form at edge r: ns_polar_group up to kNsSmemMaxR,
// ns_polar_group_wide past it.  Shared memory: ns_grouped_smem_bytes(r).
__device__ inline void ns_polar_grouped(const float* part_z, int splits,
                                        float* x, float* alt, float* nsn,
                                        unsigned* ctr, int g, int q, int r,
                                        int ns_iters, float* smem, float* red) {
  if (r <= kNsSmemMaxR) {
    ns_polar_group(part_z, splits, x, alt, nsn, ctr, g, q, r, ns_iters, smem, red);
  } else {
    ns_polar_group_wide(part_z, splits, x, alt, nsn, ctr, g, q, r, ns_iters, smem,
                        red);
  }
}

}  // namespace rt
