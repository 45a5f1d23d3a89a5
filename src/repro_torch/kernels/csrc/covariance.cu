// B1: Gram matrix X^T X of a sample stack, the local-covariance hot spot.
//
// Replaces the Pallas TPU kernel src/repro/kernels/covariance.py::gram
// (pallas_call at :82, body _gram_kernel :34): (n, d) f32/bf16 -> (d, d)
// f32, f32 accumulation whatever the input type, and an (m, n, d) stack
// per leading index in one launch (blockIdx.y).
//
// What bounds it on an H100: operations.  One shard at the production
// width (n = 65536, d = 8192) is 2 n d^2 = 8.8 TFLOP over 2.1 GB of input,
// about 4000 FLOP per byte, far above the FP32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20 FLOP/byte).  The reference accumulates plain f32
// products, so the tensor cores (TF32/bf16) are not used; the ceiling is
// the CUDA cores' 67 TFLOP/s, and the work is to keep the FMA pipes fed.
//
// Design:
//   * 128x128 output tiles, 256 threads, an 8x8 accumulator a thread
//     (rows 4 ty + 0..3 and 64 + 4 ty + 0..3, columns likewise with tx;
//     a warp is a 4 x 8 patch of threads), at most 128 registers
//     (__launch_bounds__(256, 2)): two blocks an SM hide each other's
//     latency.
//   * Both operand slices are 32 rows of X, contiguous along d, brought
//     by a 3-stage ring of 16-byte cp.async.cg copies (32 KB a stage in
//     f32, 16 KB in bf16: 96 KB a block, two blocks in 192 KB an SM); one
//     __syncthreads a slice.  bf16 slices are copied raw and widened when
//     read.  Each k-step reads two float4s (bf16: two 8-byte words) per
//     operand from shared memory for 64 FMAs.  The block barrier a slice,
//     not the copies' latency, is what deeper slices pay down: more
//     stages of shallower slices did not time faster.
//   * Symmetry: the grid is the T (T + 1) / 2 upper tiles, mapped from
//     the linear block index row by row (no block exits early); an
//     off-diagonal tile writes itself and its mirror (float4 stores along
//     the mirrored rows: each covers whole 32-byte sectors, so the mirror
//     is not staged).  A diagonal tile loads its one slice once.  Every
//     output element is one thread's sum over the rows in ascending
//     order, fmaf(x_ki, x_kj, acc), and fmaf is symmetric in its first two
//     operands, so a mirrored element has the bits its own tile would
//     have computed.
//   * Blocks are issued in linear order, so the blocks resident at once
//     walk the same rows of X at about the same pace and each slice comes
//     from HBM about once a wave (the 50 MB L2 holds ~100 slices of drift).
//   * Ragged n and d: rows past n and columns past d copy as zeros (a
//     16-byte copy is whole when d is a multiple of its width); a d or a
//     pointer that is not 16-byte aligned takes plain loads into the same
//     ring, and masked scalar stores.  Offsets are 64-bit: an
//     (8, 65536, 8192) stack has 4.3e9 elements.
#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kBM = 128;     // output tile edge
constexpr int kBK = 32;      // rows per slice
constexpr int kStages = 3;   // cp.async ring depth
constexpr int kThreads = 256;
constexpr int kSlice = kBK * kBM;  // elements of one operand's slice

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool ok) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(ok ? 16 : 0)
               : "memory");
}

// Four consecutive staged elements, widened to f32.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <typename T>
__device__ __forceinline__ T zero_of() {
  return T(0.f);
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}

// Output tile (ti, tj) of linear block b, row-major over the upper
// triangle: row i starts at i T - i (i - 1) / 2.
__device__ __forceinline__ void tile_of(int b, int tiles, int& ti, int& tj) {
  auto start = [&](long long i) { return i * tiles - i * (i - 1) / 2; };
  const double t2 = 2.0 * tiles + 1.0;
  int i = static_cast<int>((t2 - sqrt(t2 * t2 - 8.0 * b)) / 2.0);
  i = max(0, min(i, tiles - 1));
  while (i > 0 && start(i) > b) --i;
  while (i + 1 < tiles && start(i + 1) <= b) ++i;
  ti = i;
  tj = i + static_cast<int>(b - start(i));
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
    gram_kernel(const T* __restrict__ x, float* __restrict__ out, int n,
                int d, int tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // [kStages][2][kBK][kBM]
  int ti, tj;
  tile_of(static_cast<int>(blockIdx.x), tiles, ti, tj);
  const bool diag = ti == tj;
  const int i0 = ti * kBM;
  const int j0 = tj * kBM;
  const size_t dd = static_cast<size_t>(d);
  const T* xz = x + static_cast<size_t>(blockIdx.y) * static_cast<size_t>(n) * dd;
  float* oz = out + static_cast<size_t>(blockIdx.y) * dd * dd;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int ty = (warp / 2) * 4 + lane / 8;  // 0..15
  const int tx = (warp % 2) * 8 + lane % 8;  // 0..15

  // Rows k0 .. k0 + kBK - 1, columns c0 .. c0 + 127 of X into dst [kBK][kBM].
  auto load_operand = [&](T* dst, int k0, int c0) {
    if constexpr (VEC) {
      constexpr int W = 16 / static_cast<int>(sizeof(T));  // per copy
      static_assert(kSlice / W % kThreads == 0, "copies split evenly");
#pragma unroll
      for (int c = 0; c < kSlice / W / kThreads; ++c) {
        const int e = tid + c * kThreads;
        const int row = e / (kBM / W);
        const int col = (e % (kBM / W)) * W;
        const bool ok = k0 + row < n && c0 + col < d;
        const T* src = ok ? xz + static_cast<size_t>(k0 + row) * dd + c0 + col : x;
        cp_async16(dst + row * kBM + col, src, ok);
      }
    } else {
      // Thread tid copies column tid % kBM of every (kThreads / kBM)-th row.
      const int col = tid % kBM;
      const bool col_ok = c0 + col < d;
      const T* src = xz + c0 + col;
      for (int row = tid / kBM; row < kBK; row += kThreads / kBM) {
        const bool ok = col_ok && k0 + row < n;
        dst[row * kBM + col] = ok ? src[static_cast<size_t>(k0 + row) * dd] : zero_of<T>();
      }
    }
  };
  auto load = [&](int sl) {
    T* st = ring + (sl % kStages) * 2 * kSlice;
    load_operand(st, sl * kBK, i0);
    if (!diag) load_operand(st + kSlice, sl * kBK, j0);
  };

  float acc[8][8];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[u][v] = 0.f;

  const int slices = (n + kBK - 1) / kBK;
#pragma unroll
  for (int sl = 0; sl < kStages - 1; ++sl) {
    if (sl < slices) load(sl);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int sl = 0; sl < slices; ++sl) {
    // Slice sl has landed; every thread is done with slice sl - 1, whose
    // stage the load below refills.
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    __syncthreads();
    if (sl + kStages - 1 < slices) load(sl + kStages - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const T* as = ring + (sl % kStages) * 2 * kSlice;
    const T* bs = diag ? as : as + kSlice;
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = ld4(as + k * kBM + ty * 4);
      const float4 a1 = ld4(as + k * kBM + 64 + ty * 4);
      const float4 b0 = ld4(bs + k * kBM + tx * 4);
      const float4 b1 = ld4(bs + k * kBM + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
    }
  }

  // Thread element (u, v) is out[i0 + rofs(u)][j0 + rofs(v)].
  auto rofs = [](int t, int w) { return (w < 4 ? 0 : 64) + t * 4 + (w & 3); };
  if constexpr (VEC) {  // d % 4 == 0: a group of 4 columns is whole or out
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + rofs(ty, u);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = j0 + rofs(tx, 4 * h);
        if (i < d && j < d)
          *reinterpret_cast<float4*>(oz + static_cast<size_t>(i) * dd + j) =
              make_float4(acc[u][4 * h], acc[u][4 * h + 1], acc[u][4 * h + 2],
                          acc[u][4 * h + 3]);
      }
    }
    if (!diag) {
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const int j = j0 + rofs(tx, v);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = i0 + rofs(ty, 4 * h);
          if (i < d && j < d)
            *reinterpret_cast<float4*>(oz + static_cast<size_t>(j) * dd + i) =
                make_float4(acc[4 * h][v], acc[4 * h + 1][v], acc[4 * h + 2][v],
                            acc[4 * h + 3][v]);
        }
      }
    }
  } else {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + rofs(ty, u);
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const int j = j0 + rofs(tx, v);
        if (i < d && j < d) {
          oz[static_cast<size_t>(i) * dd + j] = acc[u][v];
          if (!diag) oz[static_cast<size_t>(j) * dd + i] = acc[u][v];
        }
      }
    }
  }
}

template <typename T>
int launch_gram(int device, const void* x, void* out, int m, int n, int d,
                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (d + kBM - 1) / kBM;
  const long long blocks = tiles * (tiles + 1) / 2;
  if (blocks > INT_MAX || m > 65535) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int W = 16 / static_cast<int>(sizeof(T));
  const bool vec = d % W == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  constexpr int smem = kStages * 2 * kSlice * static_cast<int>(sizeof(T));
  auto kernel = vec ? gram_kernel<T, true> : gram_kernel<T, false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(static_cast<unsigned>(blocks), m), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<float*>(out), n, d,
      static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: (m, n, d) row-major, out: (m, d, d) f32, from the upper tiles, each
// off-diagonal one also written mirrored.
int rt_gram_f32(int device, const void* x, void* out, int m, int n, int d,
                void* stream) {
  return launch_gram<float>(device, x, out, m, n, d, stream);
}

int rt_gram_bf16(int device, const void* x, void* out, int m, int n, int d,
                 void* stream) {
  return launch_gram<__nv_bfloat16>(device, x, out, m, n, d, stream);
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
