// B5/B6: one whole Procrustes-fixing round (Algorithm 1) in one launch.
//
// Replace the Pallas TPU kernels of src/repro/kernels/procrustes_align.py:
//   B5 fused_round       (:425, pallas_call :393, body _fused_round_kernel
//                         :299, _masked_cholesky :232,
//                         _cholqr_inverse_factor :261)
//   B6 fused_ring_round  (:593, pallas_call :651, body :497)
// Both compute  Q = cholesky_qr2( (1/m) sum_i V_i polar(V_i^T ref) )  for an
// (m, d, r) stack V and a (d, r) f32 reference, and write Q (d, r) f32.
// B5 takes an f32 stack; B6 takes the ring's staged wire stack, f32, bf16
// (upcast with __bfloat162float) or int8 with (m, r) f32 per-column scales,
// decoded as each element is loaded.  One kernel body serves both: it is
// templated on the wire type, and B5 is its f32 instance.
//
// What bounds it on an H100: FP32 operations.  At (m, d, r) =
// (8, 8192, 128) the round does 2 m d r^2 (Grams) + 2 m d r^2 (aligned
// average) + 4 * 2 d r^2 (S1, Q1, S2, Q) = 5.4 GFLOP plus
// m * 24 * 4 r^3 = 1.6 GFLOP of Newton-Schulz: 0.10 ms at 67 TFLOP/s,
// against 42 MB in and out (13 us at 3.35 TB/s).
//
// The TPU kernel walks a sequential (phase, d-block, machine) grid with the
// round's state resident in VMEM.  On the card the blocks run in parallel,
// and every phase needs a reduction over all of d before the next can start,
// so the kernel is one cooperative launch (cudaLaunchCooperativeKernel) of
// as many blocks as fit on the card at once, with grid.sync() between
// phases; the wrapper allocates the global scratch the phases hand over:
//
//   1  Gram partials: units (machine, 64x64 tile, d-split) -> part
//   2  Newton-Schulz: one block per machine (blocks take machines in turn)
//      reduces its splits in order and writes Z_i to zs          (B3's code)
//   3  V-bar = (1/m) sum_i V_i Z_i: 64x64 output tiles -> vbar (d, r)
//   4  S1 partials = V-bar^T V-bar over d-splits -> part
//   5  block 0: S1 = sum of partials in order, guarded Cholesky, W1 = L^-T
//   6  Q1 = V-bar W1 -> q1 (d, r)
//   7  S2 partials of Q1 -> part
//   8  block 0: S2, guarded Cholesky, W2
//   9  Q = Q1 W2 -> out
//
// Every cross-block sum goes through scratch and is added in a fixed order:
// no atomics, and the result is the same from run to run.  V-bar and Q1 are
// kept in global memory (L2-resident at the main shape) instead of being
// recomputed from the stack as the TPU kernel does.  The guarded Cholesky
// mirrors _cholqr_inverse_factor: if any pivot is not above pivot_c * tr(S)
// the factor of S + (shift_c * tr(S) + 1e-30) I is taken instead; W is the
// exact triangular inverse by column substitution (the TPU kernel's
// log-depth nilpotent product is a VMEM idiom).  The r x r work runs in
// dynamic shared memory: 3 * rp * (rp + 1) floats (198 KB at r = 128), so
// r <= 136 and one block fits per SM at r = 128.  Offsets into the stack
// are 64-bit.
#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "ns_polar.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBM = 64;   // output tile edge
constexpr int kTM = 4;    // per-thread register tile edge
constexpr int kBK = 16;   // depth of one shared-memory slice
constexpr int kT1 = kBM / kTM;
constexpr int kThreads = kT1 * kT1;  // 256
constexpr int kLDA = kBM + 1;        // transposed A slice: padded stride

template <typename T>
struct RoundArgs {
  const T* vs;          // (m, d, r) wire stack
  const float* scales;  // (m, r) int8 column scales, else null
  const float* ref;     // (d, r)
  float* out;           // (d, r)
  float* part;          // (max(m * splits, splits2), r, r) partial Grams
  float* zs;            // (m, r, r) polar factors
  float* vbar;          // (d, r)
  float* q1;            // (d, r)
  float* w;             // (2, r, r): W1, W2
  int m, d, r;
  int rows1, splits1;   // d-split of the stack's Grams (phase 1)
  int rows2, splits2;   // d-split of S1 / S2 (phases 4, 7)
  int ns_iters;
  float pivot_c, shift_c;
};

// Element (row, col) of machine z's basis, decoded to f32.
template <typename T>
__device__ __forceinline__ float wire_at(const RoundArgs<T>& a, int z,
                                         int row, int col) {
  const size_t off = (static_cast<size_t>(z) * a.d + row) * a.r + col;
  const float x = rt::to_f32(a.vs[off]);
  if constexpr (std::is_same<T, int8_t>::value) {
    return x * a.scales[static_cast<size_t>(z) * a.r + col];
  }
  return x;
}

// c[i0.., j0..] (row stride q) = sum over rows k in [k_begin, k_end) of
// A[k, i]^T B[k, j], one 64x64 tile; lda(k, i) and ldb(k, j) load elements
// (callers keep k, i, j in range through the masks here).
template <class LA, class LB>
__device__ void atb_tile(LA lda, LB ldb, int k_begin, int k_end, int p, int q,
                         int i0, int j0, float* __restrict__ c,
                         float* __restrict__ smem) {
  float* As = smem;
  float* Bs = smem + kBK * kBM;
  const int ty = threadIdx.x / kT1;
  const int tx = threadIdx.x % kT1;
  float acc[kTM][kTM];
#pragma unroll
  for (int u = 0; u < kTM; ++u)
#pragma unroll
    for (int v = 0; v < kTM; ++v) acc[u][v] = 0.f;
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    for (int e = threadIdx.x; e < kBK * kBM; e += kThreads) {
      const int k = k0 + e / kBM;
      const int col = e % kBM;
      As[e] = (k < k_end && i0 + col < p) ? lda(k, i0 + col) : 0.f;
      Bs[e] = (k < k_end && j0 + col < q) ? ldb(k, j0 + col) : 0.f;
    }
    __syncthreads();
    rt::tile_fma<kT1, kT1, kTM, kTM, kBK, kBM, kBM>(As, Bs, ty, tx, acc);
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < kTM; ++u) {
    const int i = i0 + ty + u * kT1;
#pragma unroll
    for (int v = 0; v < kTM; ++v) {
      const int j = j0 + tx + v * kT1;
      if (i < p && j < q) c[static_cast<size_t>(i) * q + j] = acc[u][v];
    }
  }
}

// out[i0.., j0..] (d, r) = (sum_{z < nz} A_z[i, :] Z_z[:, j]) / div, one
// 64x64 tile, r-deep products in kBK-deep slices; la(z, i, k) loads A_z,
// zs holds nz (r, r) factors.
template <class LA>
__device__ void apply_tile(LA la, const float* __restrict__ zs, int nz, int d,
                           int r, int i0, int j0, float div,
                           float* __restrict__ out, float* __restrict__ smem) {
  float* As = smem;              // [kBK][kLDA], A slice transposed
  float* Bs = smem + kBK * kLDA;  // [kBK][kBM]
  const int ty = threadIdx.x / kT1;
  const int tx = threadIdx.x % kT1;
  float acc[kTM][kTM];
#pragma unroll
  for (int u = 0; u < kTM; ++u)
#pragma unroll
    for (int v = 0; v < kTM; ++v) acc[u][v] = 0.f;
  const size_t rr = static_cast<size_t>(r) * r;
  for (int z = 0; z < nz; ++z) {
    const float* zz = zs + z * rr;
    for (int k0 = 0; k0 < r; k0 += kBK) {
      for (int e = threadIdx.x; e < kBK * kBM; e += kThreads) {
        const int row = e / kBK;
        const int kk = e % kBK;
        const int gi = i0 + row;
        const int gk = k0 + kk;
        As[kk * kLDA + row] = (gi < d && gk < r) ? la(z, gi, gk) : 0.f;
        const int bk = e / kBM;
        const int col = e % kBM;
        const int zk = k0 + bk;
        const int zj = j0 + col;
        Bs[bk * kBM + col] =
            (zk < r && zj < r) ? zz[static_cast<size_t>(zk) * r + zj] : 0.f;
      }
      __syncthreads();
      rt::tile_fma<kT1, kT1, kTM, kTM, kBK, kLDA, kBM>(As, Bs, ty, tx, acc);
      __syncthreads();
    }
  }
#pragma unroll
  for (int u = 0; u < kTM; ++u) {
    const int i = i0 + ty + u * kT1;
#pragma unroll
    for (int v = 0; v < kTM; ++v) {
      const int j = j0 + tx + v * kT1;
      if (i < d && j < r) out[static_cast<size_t>(i) * r + j] = acc[u][v] / div;
    }
  }
}

// Lower Cholesky of the r x r tile l (row stride ld) in place, lower
// triangle only.  Returns true when every pivot is above thr (false on a
// non-positive or NaN pivot), the guard of _masked_cholesky's minpiv.
__device__ bool cholesky_lower(float* __restrict__ l, int r, int ld,
                               float thr) {
  bool ok = true;
  for (int k = 0; k < r; ++k) {
    __syncthreads();
    const float akk = l[k * ld + k];
    ok = ok && (akk > thr);
    const float piv = rsqrtf(fmaxf(akk, 1e-30f));
    __syncthreads();  // every thread has read akk before column k changes
    for (int i = k + threadIdx.x; i < r; i += blockDim.x) l[i * ld + k] *= piv;
    __syncthreads();
    const int n = r - k - 1;
    for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
      const int i = k + 1 + e / n;
      const int j = k + 1 + e % n;
      if (j <= i) l[i * ld + j] -= l[i * ld + k] * l[j * ld + k];
    }
  }
  __syncthreads();
  return ok;
}

// Block 0's step: S = sum of the splits partial Grams in part (in order),
// guarded Cholesky S = L L^T (shifted retry), W = L^-T written to w (r, r).
__device__ void inverse_factor(const float* __restrict__ part, int splits,
                               int r, float pivot_c, float shift_c,
                               float* __restrict__ w, float* __restrict__ smem) {
  const int ld = r + 1;
  float* s = smem;             // S, kept for the shifted retry
  float* l = s + r * ld;       // factor
  float* x = l + r * ld;       // L^-1
  __shared__ float tr_s;
  const size_t rr = static_cast<size_t>(r) * r;
  for (int e = threadIdx.x; e < r * r; e += blockDim.x) {
    float acc = 0.f;
    for (int sp = 0; sp < splits; ++sp) acc += part[sp * rr + e];
    s[(e / r) * ld + e % r] = acc;
    l[(e / r) * ld + e % r] = acc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float tr = 0.f;
    for (int i = 0; i < r; ++i) tr += s[i * ld + i];
    tr_s = tr;
  }
  __syncthreads();
  const float tr = tr_s;
  if (!cholesky_lower(l, r, ld, pivot_c * tr)) {
    // The 1e-30 floor keeps an all-zero V-bar finite (Q = 0).
    const float shift = shift_c * tr + 1e-30f;
    for (int e = threadIdx.x; e < r * r; e += blockDim.x) {
      const int i = e / r;
      const int j = e % r;
      l[i * ld + j] = s[i * ld + j] + (i == j ? shift : 0.f);
    }
    cholesky_lower(l, r, ld, 0.f);
  }
  // L^-1 by forward substitution, one column per thread.
  for (int j = threadIdx.x; j < r; j += blockDim.x) {
    for (int i = 0; i < r; ++i) {
      if (i < j) {
        x[i * ld + j] = 0.f;
        continue;
      }
      float acc = (i == j) ? 1.f : 0.f;
      for (int k = j; k < i; ++k) acc -= l[i * ld + k] * x[k * ld + j];
      x[i * ld + j] = acc / l[i * ld + i];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < r * r; e += blockDim.x) {
    w[e] = x[(e % r) * ld + e / r];  // W = (L^-1)^T
  }
  __syncthreads();
}

// S partials of a (d, r) f32 matrix x: units (64x64 tile, d-split).
__device__ void self_gram_partials(const float* __restrict__ x, int d, int r,
                                   int rows, int splits, float* part,
                                   float* smem) {
  const int tiles = (r + kBM - 1) / kBM;
  const int units = tiles * tiles * splits;
  auto ld = [&](int k, int j) { return x[static_cast<size_t>(k) * r + j]; };
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int s = u / (tiles * tiles);
    const int t = u % (tiles * tiles);
    const int k_begin = s * rows;
    const int k_end = min(d, k_begin + rows);
    atb_tile(ld, ld, k_begin, k_end, r, r, (t / tiles) * kBM, (t % tiles) * kBM,
             part + static_cast<size_t>(s) * r * r, smem);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_round_kernel(const RoundArgs<T> a) {
  extern __shared__ float smem[];
  __shared__ float warp_sums[kThreads / 32];
  cg::grid_group grid = cg::this_grid();
  const int m = a.m;
  const int d = a.d;
  const int r = a.r;
  const size_t rr = static_cast<size_t>(r) * r;
  const int tiles = (r + kBM - 1) / kBM;
  const int dtiles = (d + kBM - 1) / kBM;

  // 1: Gram partials G_i[s] = V_i[split s]^T ref[split s].
  {
    const int per_z = tiles * tiles * a.splits1;
    for (int u = blockIdx.x; u < m * per_z; u += gridDim.x) {
      const int z = u / per_z;
      const int s = (u % per_z) / (tiles * tiles);
      const int t = u % (tiles * tiles);
      const int k_begin = s * a.rows1;
      const int k_end = min(d, k_begin + a.rows1);
      atb_tile([&](int k, int i) { return wire_at(a, z, k, i); },
               [&](int k, int j) { return a.ref[static_cast<size_t>(k) * r + j]; },
               k_begin, k_end, r, r, (t / tiles) * kBM, (t % tiles) * kBM,
               a.part + (static_cast<size_t>(z) * a.splits1 + s) * rr, smem);
    }
  }
  grid.sync();

  // 2: Z_i = NS-polar(G_i), one machine per block.
  for (int z = blockIdx.x; z < m; z += gridDim.x) {
    rt::ns_polar_block(a.part + static_cast<size_t>(z) * a.splits1 * rr,
                       a.zs + z * rr, a.splits1, r, a.ns_iters, smem,
                       warp_sums);
  }
  grid.sync();

  // 3: V-bar = (1/m) sum_i V_i Z_i.
  for (int u = blockIdx.x; u < dtiles * tiles; u += gridDim.x) {
    apply_tile([&](int z, int i, int k) { return wire_at(a, z, i, k); },
               a.zs, m, d, r, (u / tiles) * kBM, (u % tiles) * kBM,
               static_cast<float>(m), a.vbar, smem);
  }
  grid.sync();

  // 4-5: S1 = V-bar^T V-bar, W1 = chol(S1)^-T.
  self_gram_partials(a.vbar, d, r, a.rows2, a.splits2, a.part, smem);
  grid.sync();
  if (blockIdx.x == 0) {
    inverse_factor(a.part, a.splits2, r, a.pivot_c, a.shift_c, a.w, smem);
  }
  grid.sync();

  // 6: Q1 = V-bar W1.
  auto load_vbar = [&](int, int i, int k) {
    return a.vbar[static_cast<size_t>(i) * r + k];
  };
  for (int u = blockIdx.x; u < dtiles * tiles; u += gridDim.x) {
    apply_tile(load_vbar, a.w, 1, d, r, (u / tiles) * kBM, (u % tiles) * kBM,
               1.f, a.q1, smem);
  }
  grid.sync();

  // 7-8: S2 = Q1^T Q1 (the Gram of the measured Q1), W2 = chol(S2)^-T.
  self_gram_partials(a.q1, d, r, a.rows2, a.splits2, a.part, smem);
  grid.sync();
  if (blockIdx.x == 0) {
    inverse_factor(a.part, a.splits2, r, a.pivot_c, a.shift_c, a.w + rr, smem);
  }
  grid.sync();

  // 9: Q = Q1 W2.
  auto load_q1 = [&](int, int i, int k) {
    return a.q1[static_cast<size_t>(i) * r + k];
  };
  for (int u = blockIdx.x; u < dtiles * tiles; u += gridDim.x) {
    apply_tile(load_q1, a.w + rr, 1, d, r, (u / tiles) * kBM,
               (u % tiles) * kBM, 1.f, a.out, smem);
  }
}

// Dynamic shared memory: the largest of the phases' working sets.
size_t round_smem_bytes(int r) {
  const size_t ns = rt::ns_smem_bytes(r);
  const size_t chol = 3 * static_cast<size_t>(r) * (r + 1) * sizeof(float);
  const size_t tiles = static_cast<size_t>(kBK) * (kLDA + kBM) * sizeof(float);
  return std::max(ns, std::max(chol, tiles));
}

template <typename T>
int launch_round(int device, const void* vs, const void* scales,
                 const void* ref, void* out, void* part, void* zs, void* vbar,
                 void* q1, void* w, int m, int d, int r, int rows1,
                 int splits1, int rows2, int splits2, int ns_iters,
                 float pivot_c, float shift_c, int* grid_out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  RoundArgs<T> a{static_cast<const T*>(vs), static_cast<const float*>(scales),
                 static_cast<const float*>(ref), static_cast<float*>(out),
                 static_cast<float*>(part), static_cast<float*>(zs),
                 static_cast<float*>(vbar), static_cast<float*>(q1),
                 static_cast<float*>(w), m, d, r, rows1, splits1, rows2,
                 splits2, ns_iters, pivot_c, shift_c};
  const size_t smem = round_smem_bytes(r);
  auto kernel = fused_round_kernel<T>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Every block must be resident at once for grid.sync(): the grid is the
  // co-resident count, capped where more blocks would find no work.
  const int tiles = (r + kBM - 1) / kBM;
  const int most_units = std::max(
      {m * tiles * tiles * splits1, ((d + kBM - 1) / kBM) * tiles,
       tiles * tiles * splits2, m});
  const int blocks = std::min(per_sm * sms, most_units);
  if (grid_out) *grid_out = blocks;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(blocks), dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// vs: (m, d, r) wire stack; scales: (m, r) f32 for int8, else null;
// ref, out, vbar, q1: (d, r) f32; part: (max(m * splits1, splits2), r, r);
// zs: (m, r, r); w: (2, r, r).  grid_out (may be null) receives the grid.
#define RT_FUSED_ROUND(NAME, T)                                               \
  int NAME(int device, const void* vs, const void* scales, const void* ref,   \
           void* out, void* part, void* zs, void* vbar, void* q1, void* w,    \
           int m, int d, int r, int rows1, int splits1, int rows2,            \
           int splits2, int ns_iters, float pivot_c, float shift_c,           \
           int* grid_out, void* stream) {                                     \
    return launch_round<T>(device, vs, scales, ref, out, part, zs, vbar, q1,  \
                           w, m, d, r, rows1, splits1, rows2, splits2,        \
                           ns_iters, pivot_c, shift_c, grid_out, stream);     \
  }

RT_FUSED_ROUND(rt_fused_round_f32, float)
RT_FUSED_ROUND(rt_fused_round_bf16, __nv_bfloat16)
RT_FUSED_ROUND(rt_fused_round_i8, int8_t)

#undef RT_FUSED_ROUND

}  // extern "C"
