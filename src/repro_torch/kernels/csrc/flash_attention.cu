// B8: causal / sliding-window GQA flash attention, forward.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (def :122, body _flash_kernel :40, pallas_call :174).
// What it computes (the plain version is repro_torch/kernels/ref.py::
// flash_attention):
//   * q is scaled by 1/sqrt(hd) in f32 and rounded back to q's dtype
//     before the products (the reference does this outside its kernel);
//   * q, k, v are taken in f32; the logits and the PV product accumulate
//     in f32; the softmax statistics are f32 and online; the
//     probabilities P stay f32 (the reference rebinds v to f32, so
//     p.astype(v.dtype) keeps P in f32);
//   * queries are right-aligned, q_pos = (t - s) + i; causal mask
//     q_pos >= k_pos, window mask q_pos - k_pos < window; keys past t are
//     masked; masked probabilities are 0; a row with no visible key gives
//     zeros (l == 0 guard), not the uniform mean of v.
//
// What bounds it on an H100: operations.  At the serving shape (b 4,
// hq 24, hkv 8, s = t = 4096, hd 128, causal) the two products are
// 4 b hq hd sum_rows(visible keys) = 0.41 TFLOP over 0.27 GB of q, k, v
// and o: about 1500 FLOP a byte, far above the bf16 ridge (~295).  Only
// the tensor cores reach the 989 TFLOP/s bf16 peak.
//
// Design.  One block per (query tile of 64 rows, batch x query head);
// query head h reads KV head h / (hq / hkv) in place (K and V are never
// repeated in memory), and a loop inside the block over 64-key tiles
// takes the place of the TPU's sequential grid axis.  The loop visits
// only the tiles that hold a visible key (the reference's block skip),
// computed from the tile's row range, the causal bound and the window.
// Ragged s, t and head_dim are masked in the kernel: rows past s are not
// stored, keys past t and columns past hd load as zeros (cp.async
// zero-fill), so no host-side padding copy exists.
//   * bf16: 4 warps, 16 query rows each, mma.sync m16n8k16 (bf16 in, f32
//     accumulate).  S = Q K^T is exact products summed in f32, as the
//     reference.  For O += P V, P is split into bf16 hi + lo parts
//     (p_hi = bf16(p), p_lo = bf16(p - p_hi)) and both go through the
//     tensor cores: P keeps ~16 significant bits (relative error <= 2^-16)
//     instead of the 8 of a plain bf16 P.  That is the reference's f32 P
//     up to ~1e-5 relative, at 1.5x the MMA work of a bf16-P kernel;
//     dropping p_lo is the first lever for speed, and it would round P to
//     bf16 as ref.attention(probs_bf16=True) does.  K and V tiles are
//     double-buffered in shared memory by cp.async; fragments come from
//     ldmatrix (V transposed by ldmatrix.trans).
//   * f32: the reference's numerics exactly (no TF32): one thread per
//     query row, plain FMAs on the CUDA cores over 32-key tiles staged in
//     shared memory.  A correctness path; the model serves in bf16.
// head_dim 16..128 in steps of 8, padded inside the kernel to 32, 64 or
// 128.  Not yet done: wgmma/TMA, warp specialisation, a bf16-P variant.
#include "common.cuh"

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int b, hq, hkv, s, t, hd;
  int causal;
  int window;  // <= 0: no window
  float scale;
};

__device__ __forceinline__ bool visible(const FlashParams& p, int qpos,
                                        int kpos) {
  bool ok = kpos < p.t;
  if (p.causal) ok = ok && qpos >= kpos;
  if (p.window > 0) ok = ok && (qpos - kpos) < p.window;
  return ok;
}

// Key tiles [j0, j1) of width bk holding a key visible to some query row
// of [row_lo, row_hi] (rows of q, 0-based).
__device__ __forceinline__ void kv_tiles(const FlashParams& p, int row_lo,
                                         int row_hi, int bk, int& j0,
                                         int& j1) {
  const int q_lo = p.t - p.s + row_lo;
  const int q_hi = p.t - p.s + row_hi;
  int k_max = p.t - 1;
  if (p.causal) k_max = min(k_max, q_hi);
  const int k_min = p.window > 0 ? max(0, q_lo - p.window + 1) : 0;
  if (k_max < k_min) {
    j0 = j1 = 0;
    return;
  }
  j0 = k_min / bk;
  j1 = k_max / bk + 1;
}

// True when every query row of [row_lo, row_hi] sees every key of
// [k_lo, k_lo + bk): the tile needs no per-element mask.
__device__ __forceinline__ bool tile_whole(const FlashParams& p, int row_lo,
                                           int row_hi, int k_lo, int bk) {
  const int k_hi = k_lo + bk - 1;
  bool whole = k_hi < p.t;
  if (p.causal) whole = whole && p.t - p.s + row_lo >= k_hi;
  if (p.window > 0) whole = whole && (p.t - p.s + row_hi) - k_lo < p.window;
  return whole;
}

// --------------------------------------------------------------- bf16 --
using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;  // query rows per block (16 per warp)
constexpr int kBK = 64;  // keys per tile
constexpr int kThreads = 128;

template <int HDP>
struct Tile {
  static constexpr int LD = HDP + 8;  // row stride: ldmatrix rows hit distinct banks
  static constexpr int ELEMS = kBQ * LD;
  static constexpr size_t SMEM = 5 * ELEMS * sizeof(bf16);  // Q, 2 K, 2 V
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [row0, row0 + 64) x cols [0, HDP) of a (nrows, hd) row-major matrix
// into shared memory (stride LD); out-of-range rows and columns are zeros.
template <int HDP>
__device__ __forceinline__ void load_tile(bf16* sm, const bf16* g, int row0,
                                          int nrows, int hd, int tid) {
  constexpr int CPR = HDP / 8;  // 16-byte chunks per row
  static_assert(kBQ * CPR % kThreads == 0, "tile must split evenly over threads");
#pragma unroll
  for (int i = 0; i < kBQ * CPR / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / CPR;
    const int col = (c % CPR) * 8;
    const int row = row0 + r;
    const bool ok = row < nrows && col < hd;
    const bf16* src = ok ? g + static_cast<size_t>(row) * hd + col : g;
    cp_async16(sm + r * Tile<HDP>::LD + col, src, ok);
  }
}

template <int HDP>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_bf16(const FlashParams p) {
  constexpr int LD = Tile<HDP>::LD;
  constexpr int ELEMS = Tile<HDP>::ELEMS;
  constexpr int KQ = HDP / 16;  // k-steps of S = Q K^T
  constexpr int NS = kBK / 8;   // 8-key column tiles of S
  constexpr int NO = HDP / 8;   // 8-wide column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + ELEMS;      // two stages
  bf16* sV = sK + 2 * ELEMS;  // two stages

  const int n_qt = (p.s + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);  // long rows first
  const int bh = blockIdx.y;
  const int bi = bh / p.hq;
  const int hk = (bh % p.hq) / (p.hq / p.hkv);
  const size_t hd = static_cast<size_t>(p.hd);
  const bf16* q = static_cast<const bf16*>(p.q) + static_cast<size_t>(bh) * p.s * hd;
  const size_t kv_off = (static_cast<size_t>(bi) * p.hkv + hk) * p.t * hd;
  const bf16* k = static_cast<const bf16*>(p.k) + kv_off;
  const bf16* v = static_cast<const bf16*>(p.v) + kv_off;
  bf16* o = static_cast<bf16*>(p.o) + static_cast<size_t>(bh) * p.s * hd;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int tq = lane & 3;  // fragment column pair
  const int row0 = qt * kBQ;

  const int row_hi = min(row0 + kBQ, p.s) - 1;
  int j0, j1;
  kv_tiles(p, row0, row_hi, kBK, j0, j1);

  load_tile<HDP>(sQ, q, row0, p.s, p.hd, tid);
  if (j0 < j1) {
    load_tile<HDP>(sK, k, j0 * kBK, p.t, p.hd, tid);
    load_tile<HDP>(sV, v, j0 * kBK, p.t, p.hd, tid);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // q * scale in f32, rounded back to bf16, as the reference does.
  for (int e = tid; e < kBQ * HDP; e += kThreads) {
    bf16& x = sQ[(e / HDP) * LD + e % HDP];
    x = __float2bfloat16_rn(__bfloat162float(x) * p.scale);
  }
  __syncthreads();

  uint32_t qf[KQ][4];
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk)
    ldsm_x4(qf[kk], sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
  const int qpos = p.t - p.s + row0 + warp * 16 + g;  // row g; row g+8 is +8

  for (int j = j0; j < j1; ++j) {
    const int st = (j - j0) & 1;
    if (j + 1 < j1) {  // prefetch the next tile into the other stage
      load_tile<HDP>(sK + (st ^ 1) * ELEMS, k, (j + 1) * kBK, p.t, p.hd, tid);
      load_tile<HDP>(sV + (st ^ 1) * ELEMS, v, (j + 1) * kBK, p.t, p.hd, tid);
    }
    cp_async_commit();
    const bf16* cK = sK + st * ELEMS;
    const bf16* cV = sV + st * ELEMS;

    float sc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk)
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        uint32_t kb[4];
        ldsm_x4(kb, cK + (n * 8 + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        mma_bf16(sc[n], qf[kk], kb[0], kb[1]);
        mma_bf16(sc[n + 1], qf[kk], kb[2], kb[3]);
      }

    // Masks (only on tiles some row of the block does not see whole),
    // online softmax statistics (f32), P in registers.
    uint32_t vis = 0xffffffffu;
    if (!tile_whole(p, row0, row_hi, j * kBK, kBK)) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = j * kBK + n * 8 + 2 * tq + (e & 1);
          if (!visible(p, qpos + 8 * (e >> 1), kpos)) {
            vis &= ~(1u << (n * 4 + e));
            sc[n][e] = kNegInf;
          }
        }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = __expf(m_run[r] - m_new);
      m_run[r] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float pe = (vis >> (n * 4 + e)) & 1u ? __expf(sc[n][e] - m_run[r]) : 0.f;
        sc[n][e] = pe;
        psum[r] += pe;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = alpha[r] * l_run[r] + psum[r];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V with P = p_hi + p_lo (two bf16 MMAs on the same V fragment).
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // A fragment a: rows g (a even) / g + 8 (a odd), keys 16 kk + 2 tq
      // (+1) for a < 2 and 16 kk + 8 + 2 tq (+1) for a >= 2.
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float x0 = sc[2 * kk + (a >> 1)][2 * (a & 1)];
        const float x1 = sc[2 * kk + (a >> 1)][2 * (a & 1) + 1];
        const float h0 = __bfloat162float(__float2bfloat16_rn(x0));
        const float h1 = __bfloat162float(__float2bfloat16_rn(x1));
        ahi[a] = pack_bf16(h0, h1);
        alo[a] = pack_bf16(x0 - h0, x1 - h1);
      }
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t vb[4];
        ldsm_x4_t(vb, cV + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                          n * 8 + (lane >> 4) * 8);
        mma_bf16(acc[n], ahi, vb[0], vb[1]);
        mma_bf16(acc[n], alo, vb[0], vb[1]);
        mma_bf16(acc[n + 1], ahi, vb[2], vb[3]);
        mma_bf16(acc[n + 1], alo, vb[2], vb[3]);
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    if (l_run[r] == 0.f) l_run[r] = 1.f;  // no visible key: zeros, not NaN
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + g + 8 * r;
    if (row >= p.s) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = n * 8 + 2 * tq;
      if (col >= p.hd) continue;
      __nv_bfloat162 out = __floats2bfloat162_rn(acc[n][2 * r] / l_run[r],
                                                 acc[n][2 * r + 1] / l_run[r]);
      *reinterpret_cast<__nv_bfloat162*>(o + static_cast<size_t>(row) * hd + col) = out;
    }
  }
}

// ---------------------------------------------------------------- f32 --
constexpr int kBQF = 64;  // query rows per block, one per thread
constexpr int kBKF = 32;  // keys per tile

template <int HDP>
__global__ void __launch_bounds__(kBQF) flash_fwd_f32(const FlashParams p) {
  __shared__ float sK[kBKF][HDP];
  __shared__ float sV[kBKF][HDP];
  const int n_qt = (p.s + kBQF - 1) / kBQF;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);
  const int bh = blockIdx.y;
  const int bi = bh / p.hq;
  const int hk = (bh % p.hq) / (p.hq / p.hkv);
  const size_t hd = static_cast<size_t>(p.hd);
  const float* q = static_cast<const float*>(p.q) + static_cast<size_t>(bh) * p.s * hd;
  const size_t kv_off = (static_cast<size_t>(bi) * p.hkv + hk) * p.t * hd;
  const float* k = static_cast<const float*>(p.k) + kv_off;
  const float* v = static_cast<const float*>(p.v) + kv_off;
  float* o = static_cast<float*>(p.o) + static_cast<size_t>(bh) * p.s * hd;

  const int tid = threadIdx.x;
  const int row0 = qt * kBQF;
  const int row = row0 + tid;
  const int qpos = p.t - p.s + row;
  int j0, j1;
  kv_tiles(p, row0, min(row0 + kBQF, p.s) - 1, kBKF, j0, j1);

  float qr[HDP];
  float acc[HDP];
#pragma unroll
  for (int c = 0; c < HDP; ++c) {
    qr[c] = (row < p.s && c < p.hd) ? q[static_cast<size_t>(row) * hd + c] * p.scale : 0.f;
    acc[c] = 0.f;
  }
  float m_run = kNegInf;
  float l_run = 0.f;

  for (int j = j0; j < j1; ++j) {
    for (int e = tid; e < kBKF * HDP; e += kBQF) {
      const int r = e / HDP;
      const int c = e % HDP;
      const int key = j * kBKF + r;
      const bool ok = key < p.t && c < p.hd;
      sK[r][c] = ok ? k[static_cast<size_t>(key) * hd + c] : 0.f;
      sV[r][c] = ok ? v[static_cast<size_t>(key) * hd + c] : 0.f;
    }
    __syncthreads();
    // Key loops stay rolled (sc lives in local memory): this path is
    // for checks, and unrolling 32 x HDP FMAs costs minutes of nvcc.
    float sc[kBKF];
    float mx = kNegInf;
    uint32_t vis = 0;
#pragma unroll 1
    for (int kk = 0; kk < kBKF; ++kk) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < HDP; ++c) dot = fmaf(qr[c], sK[kk][c], dot);
      if (visible(p, qpos, j * kBKF + kk)) {
        vis |= 1u << kk;
      } else {
        dot = kNegInf;
      }
      sc[kk] = dot;
      mx = fmaxf(mx, dot);
    }
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    m_run = m_new;
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < HDP; ++c) acc[c] *= alpha;
#pragma unroll 1
    for (int kk = 0; kk < kBKF; ++kk) {
      if (!((vis >> kk) & 1u)) continue;
      const float pe = expf(sc[kk] - m_new);
      psum += pe;
#pragma unroll
      for (int c = 0; c < HDP; ++c) acc[c] = fmaf(pe, sV[kk][c], acc[c]);
    }
    l_run = alpha * l_run + psum;
    __syncthreads();
  }
  if (row >= p.s) return;
  const float l = l_run == 0.f ? 1.f : l_run;
#pragma unroll
  for (int c = 0; c < HDP; ++c)
    if (c < p.hd) o[static_cast<size_t>(row) * hd + c] = acc[c] / l;
}

template <int HDP>
int launch(const FlashParams& p, int bf16_in, cudaStream_t stream) {
  const dim3 grid_mma((p.s + kBQ - 1) / kBQ, p.b * p.hq);
  const dim3 grid_f32((p.s + kBQF - 1) / kBQF, p.b * p.hq);
  if (bf16_in) {
    const size_t smem = Tile<HDP>::SMEM;
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_fwd_bf16<HDP><<<grid_mma, kThreads, smem, stream>>>(p);
  } else {
    flash_fwd_f32<HDP><<<grid_f32, kBQF, 0, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q: (b, hq, s, hd), k, v: (b, hkv, t, hd), o: (b, hq, s, hd), all
// row-major, one dtype (bf16 if bf16_in, else f32); hq % hkv == 0,
// 16 <= hd <= 128, hd % 8 == 0, 16-byte aligned.  window <= 0: none.
int rt_flash_attention(int device, int bf16_in, const void* q, const void* k,
                       const void* v, void* o, int b, int hq, int hkv, int s,
                       int t, int hd, int causal, int window, float scale,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const FlashParams p{q, k, v, o, b, hq, hkv, s, t, hd, causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 32) return launch<32>(p, bf16_in, st);
  if (hd <= 64) return launch<64>(p, bf16_in, st);
  return launch<128>(p, bf16_in, st);
}

}  // extern "C"
