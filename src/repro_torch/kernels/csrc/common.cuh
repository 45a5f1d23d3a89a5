// Shared pieces of the port's hand-written Hopper (sm_90a) kernels.
//
// Every kernel here accumulates plain FP32 products on the CUDA cores:
// no TF32 or bf16 tensor-core path, because the JAX reference accumulates
// f32 products and the port is held against it.  The C entry points take
// raw device pointers and a cudaStream_t, launch on that stream, never
// synchronise, allocate nothing, and return the cudaGetLastError() code
// of their launches (0 on success) for the Python wrapper to raise on.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace rt {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(signed char v) {
  return static_cast<float>(v);
}

// Register-blocked FP32 tile product over one BK-deep slice staged in
// shared memory:  acc[u][v] += sum_k As[k][ty + u*TY] * Bs[k][tx + v*TX].
// Thread (ty, tx) owns rows ty + u*TY and columns tx + v*TX (a strided,
// not a contiguous, TMxTN patch): the 16 threads of a half-warp then read
// 16 consecutive words of Bs and one broadcast word of As, which keeps
// the shared-memory reads free of bank conflicts.
template <int TY, int TX, int TM, int TN, int BK, int LDA, int LDB>
__device__ __forceinline__ void tile_fma(const float* __restrict__ As,
                                         const float* __restrict__ Bs,
                                         int ty, int tx,
                                         float (&acc)[TM][TN]) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    float a[TM];
    float b[TN];
#pragma unroll
    for (int u = 0; u < TM; ++u) a[u] = As[k * LDA + ty + u * TY];
#pragma unroll
    for (int v = 0; v < TN; ++v) b[v] = Bs[k * LDB + tx + v * TX];
#pragma unroll
    for (int u = 0; u < TM; ++u)
#pragma unroll
      for (int v = 0; v < TN; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
  }
}

// C[z][s] = sum over rows k of split s of A[z][k, :]^T B[z][k, :], for a
// row-major A (rows, p) and B (rows, q); f32 out (p, q) per (z, s).
//
// Block (tile, s, z) owns one BMxBM output tile, loops over its split's
// rows BK at a time, and keeps the whole tile in registers (TMxTM per
// thread).  Both operand slices are BK full rows of A and B, so the loads
// are coalesced along the row.  The next slice is fetched into registers
// while the current one is multiplied (one-deep register prefetch).
// Ragged rows and columns load as zero; stores are masked.  Offsets are
// 64-bit: a (8, 65536, 8192) stack has 4.3e9 elements.
template <typename T, int BM, int TM, int BK>
__global__ void __launch_bounds__((BM / TM) * (BM / TM))
    atb_kernel(const T* __restrict__ a, long long a_z,
               const T* __restrict__ b, long long b_z,
               float* __restrict__ c, int rows, int rows_per_split, int p,
               int q) {
  constexpr int T1 = BM / TM;
  constexpr int NT = T1 * T1;
  constexpr int LOADS = BK * BM / NT;
  static_assert(BK * BM % NT == 0, "slice must split evenly over threads");
  __shared__ float As[BK * BM];
  __shared__ float Bs[BK * BM];

  const int tiles_q = (q + BM - 1) / BM;
  const int ti = blockIdx.x / tiles_q;
  const int tj = blockIdx.x % tiles_q;
  const int s = blockIdx.y;
  const int z = blockIdx.z;
  const int i0 = ti * BM;
  const int j0 = tj * BM;
  const int k_begin = s * rows_per_split;
  const int k_end = min(rows, k_begin + rows_per_split);
  const T* az = a + static_cast<size_t>(z) * static_cast<size_t>(a_z);
  const T* bz = b + static_cast<size_t>(z) * static_cast<size_t>(b_z);
  const int tid = threadIdx.x;
  const int ty = tid / T1;
  const int tx = tid % T1;

  float acc[TM][TM];
#pragma unroll
  for (int u = 0; u < TM; ++u)
#pragma unroll
    for (int v = 0; v < TM; ++v) acc[u][v] = 0.f;

  float ra[LOADS];
  float rb[LOADS];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int t = 0; t < LOADS; ++t) {
      const int e = tid + t * NT;
      const int k = k0 + e / BM;
      const int col = e % BM;
      const bool in_k = k < k_end;
      const size_t row = static_cast<size_t>(k);
      ra[t] = (in_k && i0 + col < p)
                  ? to_f32(az[row * static_cast<size_t>(p) + i0 + col])
                  : 0.f;
      rb[t] = (in_k && j0 + col < q)
                  ? to_f32(bz[row * static_cast<size_t>(q) + j0 + col])
                  : 0.f;
    }
  };

  if (k_begin < k_end) fetch(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
#pragma unroll
    for (int t = 0; t < LOADS; ++t) {
      As[tid + t * NT] = ra[t];
      Bs[tid + t * NT] = rb[t];
    }
    __syncthreads();
    if (k0 + BK < k_end) fetch(k0 + BK);
    tile_fma<T1, T1, TM, TM, BK, BM, BM>(As, Bs, ty, tx, acc);
    __syncthreads();
  }

  float* cz = c + (static_cast<size_t>(z) * gridDim.y + s) *
                      static_cast<size_t>(p) * static_cast<size_t>(q);
#pragma unroll
  for (int u = 0; u < TM; ++u) {
    const int i = i0 + ty + u * T1;
#pragma unroll
    for (int v = 0; v < TM; ++v) {
      const int j = j0 + tx + v * T1;
      if (i < p && j < q) cz[static_cast<size_t>(i) * q + j] = acc[u][v];
    }
  }
}

}  // namespace rt
