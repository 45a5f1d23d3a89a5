// B2-B4: the per-stage Procrustes-fixing kernels of one aggregation round.
//
// Replace the Pallas TPU kernels of src/repro/kernels/procrustes_align.py:
//   B2 batched_gram        (:141, body :80)   G_i = V_i^T ref      -> (m, r, r)
//   B3 batched_gram_polar  (:155, body :101)  Z_i = NS-polar(G_i)  -> (m, r, r)
//   B4 align_average       (:198, body :179)  (1/m) sum_i V_i Z_i  -> (d, r)
//
// What bounds them on an H100: FP32 operations, narrowly.  At the
// production width (m = 8, d = 8192, r = 128) B2 and B4 each do
// 2 m d r^2 = 2.15 GFLOP (32 us at 67 TFLOP/s) over the 33.5 MB stack
// (10 us at 3.35 TB/s); both are small enough that launch latency and
// filling 132 SMs matter as much as either floor.  B3 adds 24
// Newton-Schulz steps on eight r x r tiles, each on one SM.
//
// The TPU kernels walk d sequentially per machine.  Here a
// machine-per-block grid would fill 8 of 132 SMs, so:
//   * B2/B3 split d across blocks.  Pass 1 (rt::atb_kernel, 64x64 tiles,
//     4x4 per thread) writes partial r x r Grams into an (m, splits, r, r)
//     f32 scratch that the wrapper allocates; pass 2 reduces them in a
//     fixed split order, so the result is deterministic and needs no
//     atomics.  B3's pass 2 is one block per machine that then runs the
//     24 Newton-Schulz steps on the r x r tile in shared memory.  At
//     r = 128 that tile, X^T X and a temporary take 3 * 128 * 129 * 4 B =
//     198 KB, above the 48 KB static limit: the launch asks for it as
//     dynamic shared memory after cudaFuncSetAttribute, and a refused
//     launch comes back as the cudaGetLastError() code.  Past r = 136 the
//     three tiles no longer fit and go to a global workspace of one slot
//     per machine (ns_polar.cuh), which stays in L2.
//   * B4 is one (d x m r) . (m r x r) product over the stack as it lies in
//     memory: the sum over machines and over r is one reduction of depth
//     K = m r, walked in 16-deep slices (one machine each) in a fixed
//     order, so the result is deterministic.  A block owns 64 rows of d
//     and up to 128 columns (all of r at r <= 128; a wider r adds column
//     tiles, each reading its rows of V again), so at r <= 128 every V_i
//     element is read once: at d = 8192, r = 128 that is 128 blocks, one wave on 132
//     SMs.  With one block an SM the FMAs must not wait on shared memory
//     or on the loads: 256 threads each hold an 8x4 register tile fed by
//     float4 shared-memory reads (12 loads per 128 FMAs), and a 3-stage
//     cp.async ring (36 KB of static shared memory) keeps two slices of V
//     and Z in flight.  FP32 FMAs only (no TF32); 1/m is applied in the
//     store.
// The 1e-30 norm floor and the 3I form of _ns_polar_tile (:90-98) are
// kept exactly.
#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "ns_polar.cuh"

namespace {

constexpr int kBM = 64;   // Gram output tile edge
constexpr int kTM = 4;    // per-thread register tile edge
constexpr int kBK = 16;   // rows per Gram slice
constexpr int kThreads = (kBM / kTM) * (kBM / kTM);
constexpr int kNsThreads = 256;

// Pass 1 of B2/B3: partial Grams of each (machine, d-split) into part.
int launch_partial(const float* vs, const float* ref, float* part, int m,
                   int d, int r, int rows_per_split, int splits,
                   cudaStream_t stream) {
  const int tiles = (r + kBM - 1) / kBM;
  const dim3 grid(static_cast<unsigned>(tiles) * tiles, splits, m);
  rt::atb_kernel<float, kBM, kTM, kBK><<<grid, kThreads, 0, stream>>>(
      vs, static_cast<long long>(d) * r, ref, 0LL, part, d, rows_per_split,
      r, r);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2 of B2: out[z] = sum_s part[z][s], splits summed in order.
__global__ void reduce_splits_kernel(const float* __restrict__ part,
                                     float* __restrict__ out, int m,
                                     int splits, int rr) {
  const size_t total = static_cast<size_t>(m) * rr;
  for (size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t z = idx / rr;
    const size_t e = idx % rr;
    const float* pz = part + z * splits * static_cast<size_t>(rr) + e;
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += pz[static_cast<size_t>(s) * rr];
    out[idx] = acc;
  }
}

// Pass 2 of B3: one block per machine reduces its splits into the r x r
// Gram and runs the Newton-Schulz steps on its tiles (ns_polar.cuh): in
// shared memory, or past rt::kNsSmemMaxR in machine z's slot of ws.
__global__ void __launch_bounds__(kNsThreads)
    ns_polar_kernel(const float* __restrict__ part, float* __restrict__ out,
                    float* ws, int splits, int r, int ns_iters) {
  extern __shared__ float smem[];
  __shared__ float warp_sums[kNsThreads / 32];
  const int z = blockIdx.x;
  const size_t rr = static_cast<size_t>(r) * r;
  rt::ns_polar_block(part + static_cast<size_t>(z) * splits * rr,
                     out + static_cast<size_t>(z) * rr, splits, r, ns_iters,
                     smem, ws + z * rt::ns_tile_floats(r), warp_sums);
}

// B4: out (d, r) = (1/m) sum_i vs[i] (d, r) @ zs[i] (r, r), one product
// over K = m r.  Block (x, y) owns output rows 64 y .. 64 y + 63 and
// columns 128 x .. 128 x + 127 and walks the K-slices (machine z, depth
// k0 .. k0 + 15) in order; warp w owns rows 8 w .. 8 w + 7, lane l
// columns 4 l .. 4 l + 3.  V's slice is staged row-major (float4 reads of
// four depths of one row, the same address across the warp: a broadcast),
// Z's slice row-major (float4 reads, a warp's 32 lanes on 512 contiguous
// bytes).  VEC: 16-byte copies (r % 4 == 0 and aligned pointers), else
// 4-byte ones; out-of-range elements copy as zeros.
constexpr int kAvgBM = 64;
constexpr int kAvgBN = 128;
constexpr int kAvgBK = 16;
constexpr int kAvgStages = 3;
constexpr int kAvgThreads = 256;

template <int BYTES>
__device__ __forceinline__ void cp_async(float* smem, const float* gmem,
                                         bool ok) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = ok ? BYTES : 0;  // 0: fill with zeros
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(gmem), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(gmem), "r"(n)
                 : "memory");
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kAvgThreads)
    align_average_kernel(const float* __restrict__ vs,
                         const float* __restrict__ zs,
                         float* __restrict__ out, int m, int d, int r) {
  __shared__ __align__(16) float As[kAvgStages][kAvgBM][kAvgBK];
  __shared__ __align__(16) float Bs[kAvgStages][kAvgBK][kAvgBN];
  const int i0 = blockIdx.y * kAvgBM;
  const int j0 = blockIdx.x * kAvgBN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int depth = (r + kAvgBK - 1) / kAvgBK;  // slices per machine
  const int slices = m * depth;
  const size_t dr = static_cast<size_t>(d) * r;
  const size_t rr = static_cast<size_t>(r) * r;

  auto load = [&](int sl) {
    const int st = sl % kAvgStages;
    const int k0 = (sl % depth) * kAvgBK;
    const float* vz = vs + static_cast<size_t>(sl / depth) * dr;
    const float* zz = zs + static_cast<size_t>(sl / depth) * rr;
    constexpr int W = VEC ? 4 : 1;  // floats per copy
#pragma unroll
    for (int e = tid; e < kAvgBM * kAvgBK / W; e += kAvgThreads) {
      const int row = e / (kAvgBK / W);
      const int kk = (e % (kAvgBK / W)) * W;
      const int gi = i0 + row;
      const int gk = k0 + kk;
      const bool ok = gi < d && gk < r;
      cp_async<4 * W>(&As[st][row][kk],
                      ok ? vz + static_cast<size_t>(gi) * r + gk : vs, ok);
    }
#pragma unroll
    for (int e = tid; e < kAvgBK * kAvgBN / W; e += kAvgThreads) {
      const int kk = e / (kAvgBN / W);
      const int col = (e % (kAvgBN / W)) * W;
      const int gk = k0 + kk;
      const int gj = j0 + col;
      const bool ok = gk < r && gj < r;
      cp_async<4 * W>(&Bs[st][kk][col],
                      ok ? zz + static_cast<size_t>(gk) * r + gj : zs, ok);
    }
  };

  float acc[8][4];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;

#pragma unroll
  for (int sl = 0; sl < kAvgStages - 1; ++sl) {
    if (sl < slices) load(sl);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int sl = 0; sl < slices; ++sl) {
    // Slice sl has landed; every thread is done with slice sl - 1, whose
    // stage the load below refills.
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kAvgStages - 2) : "memory");
    __syncthreads();
    if (sl + kAvgStages - 1 < slices) load(sl + kAvgStages - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const int st = sl % kAvgStages;
#pragma unroll
    for (int k4 = 0; k4 < kAvgBK; k4 += 4) {
      float4 a[8];
      float4 b[4];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        a[u] = *reinterpret_cast<const float4*>(&As[st][warp * 8 + u][k4]);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        b[q] = *reinterpret_cast<const float4*>(&Bs[st][k4 + q][lane * 4]);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float av[4] = {a[u].x, a[u].y, a[u].z, a[u].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[u][0] = fmaf(av[q], b[q].x, acc[u][0]);
          acc[u][1] = fmaf(av[q], b[q].y, acc[u][1]);
          acc[u][2] = fmaf(av[q], b[q].z, acc[u][2]);
          acc[u][3] = fmaf(av[q], b[q].w, acc[u][3]);
        }
      }
    }
  }

  const float fm = static_cast<float>(m);
  const int j = j0 + lane * 4;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int i = i0 + warp * 8 + u;
    if (i >= d) continue;
    float* row = out + static_cast<size_t>(i) * r;
    if (VEC) {
      if (j < r)
        *reinterpret_cast<float4*>(row + j) =
            make_float4(acc[u][0] / fm, acc[u][1] / fm, acc[u][2] / fm,
                        acc[u][3] / fm);
    } else {
#pragma unroll
      for (int v = 0; v < 4; ++v)
        if (j + v < r) row[j + v] = acc[u][v] / fm;
    }
  }
}

}  // namespace

extern "C" {

// vs: (m, d, r), ref: (d, r), part: (m, splits, r, r) scratch, out: (m, r, r).
int rt_batched_gram(int device, const void* vs, const void* ref, void* part,
                    void* out, int m, int d, int r, int rows_per_split,
                    int splits, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int code = launch_partial(static_cast<const float*>(vs),
                            static_cast<const float*>(ref),
                            static_cast<float*>(part), m, d, r,
                            rows_per_split, splits, s);
  if (code) return code;
  const int rr = r * r;
  const long long total = static_cast<long long>(m) * rr;
  const int blocks = static_cast<int>(std::min(4096LL, (total + 255) / 256));
  reduce_splits_kernel<<<blocks, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(out), m, splits, rr);
  return static_cast<int>(cudaGetLastError());
}

// ws: (m, ns_tile_floats(r)) f32 workspace when r > rt::kNsSmemMaxR, else
// unused (may be null).
int rt_batched_gram_polar(int device, const void* vs, const void* ref,
                          void* part, void* out, void* ws, int m, int d,
                          int r, int rows_per_split, int splits, int ns_iters,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (r > rt::kNsSmemMaxR && !ws) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int code = launch_partial(static_cast<const float*>(vs),
                            static_cast<const float*>(ref),
                            static_cast<float*>(part), m, d, r,
                            rows_per_split, splits, s);
  if (code) return code;
  const size_t smem = rt::ns_smem_bytes(r);
  err = cudaFuncSetAttribute(ns_polar_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ns_polar_kernel<<<m, kNsThreads, smem, s>>>(
      static_cast<const float*>(part), static_cast<float*>(out),
      static_cast<float*>(ws), splits, r, ns_iters);
  return static_cast<int>(cudaGetLastError());
}

// vs: (m, d, r), zs: (m, r, r), out: (d, r).
int rt_align_average(int device, const void* vs, const void* zs, void* out,
                     int m, int d, int r, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((r + kAvgBN - 1) / kAvgBN, (d + kAvgBM - 1) / kAvgBM);
  const bool vec =
      r % 4 == 0 && (reinterpret_cast<uintptr_t>(vs) |
                     reinterpret_cast<uintptr_t>(zs) |
                     reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vs);
  const float* z = static_cast<const float*>(zs);
  float* o = static_cast<float*>(out);
  if (vec) {
    align_average_kernel<true><<<grid, kAvgThreads, 0, s>>>(v, z, o, m, d, r);
  } else {
    align_average_kernel<false><<<grid, kAvgThreads, 0, s>>>(v, z, o, m, d, r);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
