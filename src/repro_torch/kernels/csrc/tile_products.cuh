// FP32 tile products shared by the Procrustes-fixing kernels (B2-B7).
//
//   gram::tile_acc    C = A^T B over a range of rows, one 128 x 128 output
//                     tile a block (B2's tile; the Gram phases of B5-B7)
//   apply::rows       C = (S + sum_z A_z Z_z) / div, one 64 x 128 output
//                     block (B4's tile; B5-B7's V-bar, Q1 and Q)
//
// Both stream their operands through a 3-stage ring of slices in shared
// memory, one __syncthreads a slice.  A slice of an f32 matrix whose row
// length is a multiple of 4 at a 16-byte aligned address comes by 16-byte
// cp.async.cg copies (L2 only, so data that other blocks or another
// process wrote during the kernel is never read from a stale L1 line).
// A bf16 / int8 wire stack (decoded to f32 and multiplied by its
// per-column scale as each element is loaded) is fetched into registers
// through L2 (__ldcg) one slice ahead and stored after the current
// slice's products.  Any slice of an operand that is not VEC (r % 4 != 0,
// or an unaligned pointer) is fetched and stored at once, so that no
// register stays live across the products.  Elements past the matrix load as
// zeros.  Every output element is one thread's sum over the depth in
// ascending order, so a result depends only on the split of the depth.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace rt {

__device__ __forceinline__ void cp_async16(float* smem, const void* gmem,
                                           bool ok) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A ROWS x COLS window of a row-major matrix (row stride ld) at (r0, c0),
// rows below row_end and columns below ncols, into shared memory
// [ROWS][COLS]; the rest zero.  ASYNC: 16-byte cp.async copies (f32, ld
// and c0 multiples of 4, 16-byte aligned base).  Else fetch() loads the
// window into registers (decoded, times scales[column] for int8) and
// store() writes them out.
template <typename T, bool ASYNC, int ROWS, int COLS, int THREADS>
struct Window {
  static_assert(!ASYNC || std::is_same<T, float>::value, "cp.async moves f32");
  static_assert(ROWS * COLS % (4 * THREADS) == 0, "copies split evenly");
  static constexpr int kRegs = ASYNC ? 1 : ROWS * COLS / THREADS;
  float v[kRegs];

  __device__ __forceinline__ void fetch(float* dst, const T* __restrict__ src,
                                        const float* __restrict__ scales,
                                        size_t ld, int r0, int row_end,
                                        int c0, int ncols) {
    const int tid = threadIdx.x;
    if constexpr (ASYNC) {
#pragma unroll
      for (int c = 0; c < ROWS * COLS / 4 / THREADS; ++c) {
        const int e = tid + c * THREADS;
        const int row = e / (COLS / 4);
        const int col = (e % (COLS / 4)) * 4;
        const bool ok = r0 + row < row_end && c0 + col < ncols;
        cp_async16(dst + row * COLS + col,
                   ok ? src + static_cast<size_t>(r0 + row) * ld + c0 + col : src,
                   ok);
      }
    } else {
      static_assert(THREADS % COLS == 0, "a thread keeps its column");
      const int col = tid % COLS;
      float scale = 1.f;
      if constexpr (std::is_same<T, int8_t>::value) {
        scale = c0 + col < ncols ? scales[c0 + col] : 0.f;
      }
#pragma unroll
      for (int c = 0; c < kRegs; ++c) {
        const int row = (tid + c * THREADS) / COLS;
        float x = 0.f;
        if (r0 + row < row_end && c0 + col < ncols) {
          x = to_f32(__ldcg(src + static_cast<size_t>(r0 + row) * ld + c0 + col));
          if constexpr (std::is_same<T, int8_t>::value) x *= scale;
        }
        v[c] = x;
      }
    }
  }

  __device__ __forceinline__ void store(float* dst) const {
    if constexpr (!ASYNC) {
#pragma unroll
      for (int c = 0; c < kRegs; ++c) dst[threadIdx.x + c * THREADS] = v[c];
    }
  }
};

namespace gram {

constexpr int kBM = 128;    // output tile edge
constexpr int kBK = 32;     // rows a slice
constexpr int kStages = 3;  // ring depth
constexpr int kThreads = 256;
constexpr int kSlice = kBK * kBM;  // floats of one operand's slice
// The ring: 96 KB; after tile_acc returns it may be reused (B2 stages
// its 64 KB output tile there).
constexpr size_t kSmemBytes = size_t(kStages) * 2 * kSlice * sizeof(float);

// Thread coordinates: a warp is a 4 x 8 patch of (ty, tx), each 0..15.
__device__ __forceinline__ int ty() {
  return (threadIdx.x / 64) * 4 + (threadIdx.x % 32) / 8;
}
__device__ __forceinline__ int tx() {
  return ((threadIdx.x / 32) % 2) * 8 + threadIdx.x % 8;
}
// Tile row (column) of accumulator index w (0..7) of coordinate t.
__device__ __forceinline__ int ofs(int t, int w) {
  return (w < 4 ? 0 : 64) + t * 4 + (w & 3);
}

// acc[u][v] += sum over rows k in [k_begin, k_end) of
//   A[k][i0 + ofs(ty, u)] * B[k][j0 + ofs(tx, v)]
// for A (rows, p) of type TA (row stride lda; int8 times a_scales[column])
// and B (rows, q) f32 (row stride ldb).  VEC: lda, ldb, p and q are
// multiples of 4 and a, b 16-byte aligned.  Ends with the ring drained and
// a block barrier, so the caller may reuse it.
template <typename TA, bool VEC>
__device__ __forceinline__ void tile_acc(const TA* __restrict__ a,
                                         const float* __restrict__ a_scales,
                                         int lda, int p,
                                         const float* __restrict__ b, int ldb,
                                         int q, int k_begin, int k_end,
                                         int i0, int j0,
                                         float* __restrict__ ring,
                                         float (&acc)[8][8]) {
  constexpr bool kAsyncA = VEC && std::is_same<TA, float>::value;
  Window<TA, kAsyncA, kBK, kBM, kThreads> wa;
  Window<float, VEC, kBK, kBM, kThreads> wb;
  const int ty_ = ty();
  const int tx_ = tx();
  const int slices = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;
  auto stage = [&](int sl) { return ring + (sl % kStages) * 2 * kSlice; };
  auto fetch = [&](int sl) {
    const int k0 = k_begin + sl * kBK;
    wa.fetch(stage(sl), a, a_scales, lda, k0, k_end, i0, p);
    wb.fetch(stage(sl) + kSlice, b, nullptr, ldb, k0, k_end, j0, q);
  };
  auto store = [&](int sl) {
    wa.store(stage(sl));
    wb.store(stage(sl) + kSlice);
  };

#pragma unroll
  for (int sl = 0; sl < kStages - 1; ++sl) {
    if (sl < slices) {
      fetch(sl);
      store(sl);
    }
    cp_async_commit();
  }
  for (int sl = 0; sl < slices; ++sl) {
    // Slice sl has landed; every thread is done with slice sl - 1, whose
    // stage the fetch below refills.
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = sl + kStages - 1;
    if (next < slices) {
      fetch(next);
      if (!VEC) store(next);
    }
    cp_async_commit();
    const float* as = stage(sl);
    const float* bs = as + kSlice;
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + k * kBM + ty_ * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(as + k * kBM + 64 + ty_ * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + k * kBM + tx_ * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + k * kBM + 64 + tx_ * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
    }
    if (VEC && next < slices) store(next);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// c[i][j] (row stride ldc) = acc for the tile at (i0, j0), i < p, j < q.
// vec: q and ldc multiples of 4, c 16-byte aligned.
__device__ __forceinline__ void store_tile(const float (&acc)[8][8],
                                           float* __restrict__ c, int ldc,
                                           int p, int q, int i0, int j0,
                                           bool vec) {
  const int ty_ = ty();
  const int tx_ = tx();
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int i = i0 + ofs(ty_, u);
    if (i >= p) continue;
    float* row = c + static_cast<size_t>(i) * ldc;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + ofs(tx_, 4 * h);
      if (vec) {
        if (j < q)
          *reinterpret_cast<float4*>(row + j) =
              make_float4(acc[u][4 * h], acc[u][4 * h + 1], acc[u][4 * h + 2],
                          acc[u][4 * h + 3]);
      } else {
#pragma unroll
        for (int w = 0; w < 4; ++w)
          if (j + w < q) row[j + w] = acc[u][4 * h + w];
      }
    }
  }
}

}  // namespace gram

namespace apply {

constexpr int kBM = 64;     // output rows a block
constexpr int kBN = 128;    // output columns a block
constexpr int kBK = 16;     // depth of a slice
constexpr int kStages = 3;  // ring depth
constexpr int kThreads = 256;
constexpr int kSmemFloats = kStages * (kBM * kBK + kBK * kBN);  // 36 KB

// out[i][j] = (S + sum_{z < nz} sum_k A_z[i][k] Z_z[k][j]) / div for rows
// i0 .. i0 + 63 (< d) and columns j0 .. j0 + 127 (< r), S = out's own value
// when add (a running sum), else 0.  A_z = a + z * a_z, (d, r) of type TA
// (int8 times scales[z * r + k]); Z_z = zs + z r^2, (r, r) f32.  One
// product of depth nz r, walked in 16-deep slices (machine z, depth k0)
// in order.  Warp w owns rows 8 w .. 8 w + 7, lane l columns 4 l ..
// 4 l + 3: an 8 x 4 register tile fed by float4 shared-memory reads, A's
// slice staged row-major (a broadcast across the warp), Z's row-major.
// VEC: r % 4 == 0 and a (f32), zs, out 16-byte aligned.
template <typename TA, bool VEC>
__device__ __forceinline__ void rows(const TA* __restrict__ a, size_t a_z,
                                     const float* __restrict__ scales,
                                     const float* __restrict__ zs, int nz,
                                     int d, int r, int i0, int j0, float div,
                                     bool add, float* __restrict__ out,
                                     float* __restrict__ smem) {
  constexpr bool kAsyncA = VEC && std::is_same<TA, float>::value;
  Window<TA, kAsyncA, kBM, kBK, kThreads> wa;
  Window<float, VEC, kBK, kBN, kThreads> wz;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int depth = (r + kBK - 1) / kBK;  // slices a machine
  const int slices = nz * depth;
  const size_t rr = static_cast<size_t>(r) * r;
  auto as = [&](int sl) { return smem + (sl % kStages) * kBM * kBK; };
  auto bs = [&](int sl) {
    return smem + kStages * kBM * kBK + (sl % kStages) * kBK * kBN;
  };
  auto fetch = [&](int sl) {
    const int z = sl / depth;
    const int k0 = (sl % depth) * kBK;
    wa.fetch(as(sl), a + z * a_z, scales ? scales + static_cast<size_t>(z) * r : nullptr,
             r, i0, d, k0, r);
    wz.fetch(bs(sl), zs + z * rr, nullptr, r, k0, r, j0, r);
  };
  auto store = [&](int sl) {
    wa.store(as(sl));
    wz.store(bs(sl));
  };

  float acc[8][4];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;

#pragma unroll
  for (int sl = 0; sl < kStages - 1; ++sl) {
    if (sl < slices) {
      fetch(sl);
      store(sl);
    }
    cp_async_commit();
  }
  for (int sl = 0; sl < slices; ++sl) {
    // Slice sl has landed; every thread is done with slice sl - 1, whose
    // stage the fetch below refills.
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = sl + kStages - 1;
    if (next < slices) {
      fetch(next);
      if (!VEC) store(next);
    }
    cp_async_commit();
    const float* av_s = as(sl);
    const float* bv_s = bs(sl);
#pragma unroll
    for (int k4 = 0; k4 < kBK; k4 += 4) {
      float4 av4[8];
      float4 b[4];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        av4[u] = *reinterpret_cast<const float4*>(av_s + (warp * 8 + u) * kBK + k4);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        b[q] = *reinterpret_cast<const float4*>(bv_s + (k4 + q) * kBN + lane * 4);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float av[4] = {av4[u].x, av4[u].y, av4[u].z, av4[u].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[u][0] = fmaf(av[q], b[q].x, acc[u][0]);
          acc[u][1] = fmaf(av[q], b[q].y, acc[u][1]);
          acc[u][2] = fmaf(av[q], b[q].z, acc[u][2]);
          acc[u][3] = fmaf(av[q], b[q].w, acc[u][3]);
        }
      }
    }
    if (VEC && next < slices) store(next);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring may be refilled by the caller's next block

  const int j = j0 + lane * 4;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int i = i0 + warp * 8 + u;
    if (i >= d) continue;
    float* row = out + static_cast<size_t>(i) * r;
    if (VEC) {
      if (j < r) {
        float4 o = make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
        if (add) {
          const float4 s = *reinterpret_cast<const float4*>(row + j);
          o = make_float4(s.x + o.x, s.y + o.y, s.z + o.z, s.w + o.w);
        }
        *reinterpret_cast<float4*>(row + j) =
            make_float4(o.x / div, o.y / div, o.z / div, o.w / div);
      }
    } else {
#pragma unroll
      for (int v = 0; v < 4; ++v)
        if (j + v < r) row[j + v] = (add ? row[j + v] + acc[u][v] : acc[u][v]) / div;
    }
  }
}

}  // namespace apply
}  // namespace rt
