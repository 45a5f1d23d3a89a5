// Device pieces of a whole Procrustes-fixing round, shared by B5/B6
// (fused_round.cu) and B7 (fused_ring_remote.cu): the 64x64 FP32 tile
// products (A^T B over a range of rows, and the aligned apply A Z), the
// guarded Cholesky of an r x r Gram with its triangular inverse, and the
// CholeskyQR2 tail that turns V-bar into the round's output.  Each kernel
// that uses them is one cooperative launch of kThreads-thread blocks with
// round_smem_bytes(r) of dynamic shared memory.  See fused_round.cu for
// the design notes.
#pragma once

#include <cooperative_groups.h>

#include <algorithm>
#include <cstddef>

#include "common.cuh"
#include "ns_polar.cuh"

namespace rt {
namespace round {

constexpr int kBM = 64;   // output tile edge
constexpr int kTM = 4;    // per-thread register tile edge
constexpr int kBK = 16;   // depth of one shared-memory slice
constexpr int kT1 = kBM / kTM;
constexpr int kThreads = kT1 * kT1;  // 256
constexpr int kLDA = kBM + 1;        // transposed A slice: padded stride

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

// out[i0.., j0..] (d, r) = (S + sum_{z < nz} A_z[i, :] Z_z[:, j]) / div, one
// 64x64 tile, r-deep products in kBK-deep slices; S is out's own value when
// ``add`` (a running sum, B7's V-bar), else 0.  la(z, i, k) loads A_z, zs
// holds nz (r, r) factors.
template <class LA>
__device__ void apply_tile(LA la, const float* __restrict__ zs, int nz, int d,
                           int r, int i0, int j0, float div, bool add,
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
      if (i < d && j < r) {
        float* o = out + static_cast<size_t>(i) * r + j;
        *o = (add ? *o + acc[u][v] : acc[u][v]) / div;
      }
    }
  }
}

// Lower Cholesky of the r x r tile l (row stride ld) in place, lower
// triangle only.  Returns true when every pivot is above thr (false on a
// non-positive or NaN pivot), the guard of _masked_cholesky's minpiv.
inline __device__ bool cholesky_lower(float* __restrict__ l, int r, int ld,
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
inline __device__ void inverse_factor(const float* __restrict__ part,
                                      int splits, int r, float pivot_c,
                                      float shift_c, float* __restrict__ w,
                                      float* __restrict__ smem) {
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
inline __device__ void self_gram_partials(const float* __restrict__ x, int d,
                                          int r, int rows, int splits,
                                          float* part, float* smem) {
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

// The round's tail, all blocks of the cooperative grid: Q = CholeskyQR2
// of the (d, r) V-bar in global memory, the guard of
// _cholqr_inverse_factor on each pass.  q1 (d, r), w (2, r, r) and part
// (splits2, r, r) are scratch; Q goes to out.  Starts with reads of vbar:
// the caller ends V-bar's last writes with a grid.sync().
//   S1 partials -> W1 = chol(S1)^-T (block 0) -> Q1 = V-bar W1
//   -> S2 partials of the measured Q1 -> W2 (block 0) -> Q = Q1 W2
inline __device__ void cholqr2_tail(cooperative_groups::grid_group& grid,
                                    const float* __restrict__ vbar,
                                    float* __restrict__ q1,
                                    float* __restrict__ w, float* part,
                                    float* __restrict__ out, int d, int r,
                                    int rows2, int splits2, float pivot_c,
                                    float shift_c, float* smem) {
  const size_t rr = static_cast<size_t>(r) * r;
  const int tiles = (r + kBM - 1) / kBM;
  const int dtiles = (d + kBM - 1) / kBM;
  self_gram_partials(vbar, d, r, rows2, splits2, part, smem);
  grid.sync();
  if (blockIdx.x == 0) {
    inverse_factor(part, splits2, r, pivot_c, shift_c, w, smem);
  }
  grid.sync();
  auto load_vbar = [&](int, int i, int k) {
    return vbar[static_cast<size_t>(i) * r + k];
  };
  for (int u = blockIdx.x; u < dtiles * tiles; u += gridDim.x) {
    apply_tile(load_vbar, w, 1, d, r, (u / tiles) * kBM, (u % tiles) * kBM,
               1.f, false, q1, smem);
  }
  grid.sync();
  self_gram_partials(q1, d, r, rows2, splits2, part, smem);
  grid.sync();
  if (blockIdx.x == 0) {
    inverse_factor(part, splits2, r, pivot_c, shift_c, w + rr, smem);
  }
  grid.sync();
  auto load_q1 = [&](int, int i, int k) {
    return q1[static_cast<size_t>(i) * r + k];
  };
  for (int u = blockIdx.x; u < dtiles * tiles; u += gridDim.x) {
    apply_tile(load_q1, w + rr, 1, d, r, (u / tiles) * kBM, (u % tiles) * kBM,
               1.f, false, out, smem);
  }
}

// Dynamic shared memory of a round kernel: the largest of the phases'
// working sets (Newton-Schulz, the Cholesky tiles, the tile products).
inline size_t round_smem_bytes(int r) {
  const size_t ns = rt::ns_smem_bytes(r);
  const size_t chol = 3 * static_cast<size_t>(r) * (r + 1) * sizeof(float);
  const size_t tiles = static_cast<size_t>(kBK) * (kLDA + kBM) * sizeof(float);
  return std::max(ns, std::max(chol, tiles));
}

}  // namespace round
}  // namespace rt
