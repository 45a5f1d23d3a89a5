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
// The TPU kernels walk d sequentially per machine on one core.  Here a
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
//     launch comes back as the cudaGetLastError() code.
//   * B4 tiles the (d, r) output in 64x64 blocks; each block walks the m
//     machines in order and each machine's r-deep product in 16-deep
//     slices of V_i and Z_i staged in shared memory, accumulating in
//     registers, and scales by 1/m at the end.  Slicing the r axis keeps
//     shared memory at 8.3 KB static for any r, so B4 needs no dynamic
//     shared memory at r = 128.
// The 1e-30 norm floor and the 3I form of _ns_polar_tile (:90-98) are
// kept exactly.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kBM = 64;   // Gram / apply output tile edge
constexpr int kTM = 4;    // per-thread register tile edge
constexpr int kBK = 16;   // rows (Gram) or r-depth (apply) per slice
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
      r, r, 0);
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

// C = op(X) * Y over rp x rp tiles in shared memory (row stride ld), one
// 4x4 strided patch per thread per step: rows ti + u*nt, cols tj + v*nt.
// kTransA selects C = X^T Y (reads rows of X) over C = X Y.
template <bool kTransA>
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
        a[u] = kTransA ? x[k * ld + ti + u * nt] : x[(ti + u * nt) * ld + k];
#pragma unroll
      for (int v = 0; v < 4; ++v) b[v] = y[k * ld + tj + v * nt];
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

// Pass 2 of B3: one block per machine reduces its splits into the r x r
// Gram, Frobenius-normalises it (1e-30 floor) and runs ns_iters steps of
// X <- 0.5 * X (3I - X^T X), all in shared memory; writes Z_i.
__global__ void __launch_bounds__(kNsThreads)
    ns_polar_kernel(const float* __restrict__ part, float* __restrict__ out,
                    int splits, int r, int ns_iters) {
  extern __shared__ float smem[];
  __shared__ float warp_sums[kNsThreads / 32];
  const int rp = (r + 3) & ~3;  // padded edge: rows/cols >= r stay zero
  const int ld = rp + 1;        // odd stride: column reads hit distinct banks
  float* x = smem;
  float* t = x + rp * ld;
  float* y = t + rp * ld;
  const int z = blockIdx.x;
  const size_t rr = static_cast<size_t>(r) * r;
  const float* pz = part + static_cast<size_t>(z) * splits * rr;

  float sq = 0.f;
  for (int e = threadIdx.x; e < rp * rp; e += blockDim.x) {
    const int i = e / rp;
    const int j = e % rp;
    float g = 0.f;
    if (i < r && j < r) {
      for (int s = 0; s < splits; ++s) g += pz[s * rr + i * r + j];
    }
    x[i * ld + j] = g;
    sq = fmaf(g, g, sq);
  }
  // Deterministic block reduction of sum(g * g): warp tree, then warp 0
  // adds the per-warp sums in order.
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_down_sync(0xffffffffu, sq, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = sq;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < kNsThreads / 32; ++w) total += warp_sums[w];
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
    small_matmul<true>(x, x, t, rp, ld, r, 1.f, true);   // t = 3I - x^T x
    __syncthreads();
    small_matmul<false>(x, t, y, rp, ld, r, 0.5f, false);  // y = 0.5 x t
    __syncthreads();
    float* tmp = x;
    x = y;
    y = tmp;
  }

  float* oz = out + static_cast<size_t>(z) * rr;
  for (int e = threadIdx.x; e < r * r; e += blockDim.x) {
    const int i = e / r;
    const int j = e % r;
    oz[e] = x[i * ld + j];
  }
}

size_t ns_smem_bytes(int r) {
  const size_t rp = static_cast<size_t>((r + 3) & ~3);
  return 3 * rp * (rp + 1) * sizeof(float);
}

// B4: out (d, r) = (1/m) sum_i vs[i] (d, r) @ zs[i] (r, r).
__global__ void __launch_bounds__(kThreads)
    align_average_kernel(const float* __restrict__ vs,
                         const float* __restrict__ zs,
                         float* __restrict__ out, int m, int d, int r) {
  constexpr int T1 = kBM / kTM;
  constexpr int LDA = kBM + 1;  // As is stored transposed: pad its stride
  __shared__ float As[kBK * LDA];
  __shared__ float Bs[kBK * kBM];
  const int i0 = blockIdx.y * kBM;
  const int j0 = blockIdx.x * kBM;
  const int tid = threadIdx.x;
  const int ty = tid / T1;
  const int tx = tid % T1;
  float acc[kTM][kTM];
#pragma unroll
  for (int u = 0; u < kTM; ++u)
#pragma unroll
    for (int v = 0; v < kTM; ++v) acc[u][v] = 0.f;

  const size_t dr = static_cast<size_t>(d) * r;
  const size_t rr = static_cast<size_t>(r) * r;
  for (int z = 0; z < m; ++z) {
    const float* vz = vs + static_cast<size_t>(z) * dr;
    const float* zz = zs + static_cast<size_t>(z) * rr;
    for (int k0 = 0; k0 < r; k0 += kBK) {
      for (int e = tid; e < kBK * kBM; e += kThreads) {
        // V_i slice: rows i0.., depth k0..: read along the row, store
        // transposed so tile_fma sees As[k][row].
        const int row = e / kBK;
        const int kk = e % kBK;
        const int gi = i0 + row;
        const int gk = k0 + kk;
        As[kk * LDA + row] =
            (gi < d && gk < r) ? vz[static_cast<size_t>(gi) * r + gk] : 0.f;
        // Z_i slice: depth k0.., cols j0..
        const int bk = e / kBM;
        const int col = e % kBM;
        const int zk = k0 + bk;
        const int zj = j0 + col;
        Bs[bk * kBM + col] =
            (zk < r && zj < r) ? zz[static_cast<size_t>(zk) * r + zj] : 0.f;
      }
      __syncthreads();
      rt::tile_fma<T1, T1, kTM, kTM, kBK, LDA, kBM>(As, Bs, ty, tx, acc);
      __syncthreads();
    }
  }
  const float fm = static_cast<float>(m);
#pragma unroll
  for (int u = 0; u < kTM; ++u) {
    const int i = i0 + ty + u * T1;
#pragma unroll
    for (int v = 0; v < kTM; ++v) {
      const int j = j0 + tx + v * T1;
      if (i < d && j < r) out[static_cast<size_t>(i) * r + j] = acc[u][v] / fm;
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

int rt_batched_gram_polar(int device, const void* vs, const void* ref,
                          void* part, void* out, int m, int d, int r,
                          int rows_per_split, int splits, int ns_iters,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int code = launch_partial(static_cast<const float*>(vs),
                            static_cast<const float*>(ref),
                            static_cast<float*>(part), m, d, r,
                            rows_per_split, splits, s);
  if (code) return code;
  const size_t smem = ns_smem_bytes(r);
  err = cudaFuncSetAttribute(ns_polar_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ns_polar_kernel<<<m, kNsThreads, smem, s>>>(
      static_cast<const float*>(part), static_cast<float*>(out), splits, r,
      ns_iters);
  return static_cast<int>(cudaGetLastError());
}

// vs: (m, d, r), zs: (m, r, r), out: (d, r).
int rt_align_average(int device, const void* vs, const void* zs, void* out,
                     int m, int d, int r, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((r + kBM - 1) / kBM, (d + kBM - 1) / kBM);
  align_average_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vs), static_cast<const float*>(zs),
      static_cast<float*>(out), m, d, r);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
