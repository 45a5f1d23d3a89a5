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
// and o: about 1500 FLOP a byte, far above the bf16 ridge (~295).  With
// P carried as p_hi + p_lo (below) the tensor cores do 0.62 TFLOP, 0.63 ms
// at the 989 TFLOP/s bf16 peak, which only wgmma reaches.
//
// Design, bf16 (the serving path): one block of three warpgroups per
// (128 query rows, batch x query head); query head h reads KV head
// h / (hq / hkv) in place (K and V are never repeated in memory).
//   * Warpgroup 0 is the producer (setmaxnreg down to 24 registers): one
//     thread issues TMA loads (cp.async.bulk.tensor) of the Q tile once,
//     then of 128-key K and V tiles into a ring of kStages stages, each
//     with a "full" mbarrier (the TMA's byte count) and an "empty" one
//     (one arrival per consumer warp once its products have read the
//     stage).  The tensor maps are 3-D, (hd, rows, batch x head), so a
//     box at a ragged s or t edge, or past hd, zero-fills inside its own
//     head: no load masks, and no host-side padding copy.  Boxes are 64
//     bf16 columns (128 bytes, the 128-byte swizzle's span); hd <= 64
//     takes one, hd <= 128 two, padded with zeros inside the kernel.
//   * Warpgroups 1 and 2 are the consumers (setmaxnreg up to 240), 64
//     query rows each.  Each scales its Q rows in shared memory (f32, then
//     bf16, the reference's rounding) and publishes them to the tensor
//     cores (fence.proxy.async, then its own named barrier).  Per tile,
//     S = Q K^T is wgmma m64n128k16 with both operands in shared memory
//     (K-major, 128-byte swizzle); the online softmax runs on the f32
//     accumulator in registers, as exp2(s log2e - m log2e); masks are
//     applied only on tiles that some row of the warpgroup does not see
//     whole.  O += P V is wgmma with A from registers (the accumulator
//     layout of S is the A-fragment layout of the next product) and V as
//     the MN-major B operand (the transpose bit).  P is split into bf16
//     p_hi = bf16(p) and p_lo = bf16(p - p_hi), two products on the same
//     V: P keeps ~16 significant bits (relative error <= 2^-16) where a
//     plain bf16 P keeps 8, at 1.5x the MMA work of a bf16-P kernel.
//   * The loop visits only the key tiles that hold a visible key (the
//     reference's block skip), long query rows first.  Rows past s are
//     not stored.  A row that has seen no key keeps m = -inf; its
//     probabilities are exp2(-inf) = 0 and its output zeros.
//   * Every mbarrier wait is bounded by %globaltimer (FlashParams::
//     wait_ns): a wait that runs out writes its code to a host-mapped
//     status word and traps, so a lost arrival is a launch failure, not a
//     hang.  The trap ends the context: the caller sees CUDA's own launch
//     failure at its next synchronisation, and rt_flash_status (host
//     memory, still readable) says which wait ran out.  Unverified: no
//     test makes a wait run out (try_wait itself suspends until the phase
//     completes, so a zero bound does not trip it).
// Not yet done: ping-pong scheduling of the two consumers around the
// softmax, a persistent tile scheduler, packing the query heads of one KV
// head into one block (ROADMAP B.8).
//
// f32: the reference's numerics exactly (no TF32): one thread per query
// row, plain FMAs on the CUDA cores over 32-key tiles staged in shared
// memory.  A correctness path; the model serves in bf16.
#include "common.cuh"

#include <cuda.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;  // the f32 path's masked logit

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int b, hq, hkv, s, t, hd;
  int causal;
  int window;  // <= 0: no window
  float scale;
  int* status;                 // host-mapped: the code of a wait that ran out
  unsigned long long wait_ns;  // bound on every mbarrier wait (bf16 path)
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

constexpr int kConsumers = 2;  // consumer warpgroups, 64 query rows each
constexpr int kStages = 2;     // K/V ring depth
constexpr int kProducerRegs = 24;   // setmaxnreg: the producer's registers
constexpr int kConsumerRegs = 240;  // and each consumer thread's
constexpr int kBQ = 64 * kConsumers;  // query rows per block
constexpr int kBK = 128;       // keys per K/V tile
constexpr int kBox = 64;       // bf16 columns per TMA box: 128 bytes
constexpr int kWG = 128;       // threads per warpgroup
constexpr int kThreads = (1 + kConsumers) * kWG;
static_assert(kWG * (kProducerRegs + kConsumers * kConsumerRegs) <= 65536,
              "setmaxnreg must stay within the SM's register file");
// Codes of a wait that ran out (FlashParams::status).
constexpr int kTimedOutQ = 1, kTimedOutFull = 2, kTimedOutEmpty = 3;

// Dynamic shared memory: Q | K stages | V stages | mbarriers, each tile a
// row of 128-byte-swizzled boxes of 64 columns, every box 1024-aligned.
template <int HDP>
struct Layout {
  static constexpr int kChunks = HDP / kBox;  // boxes per tile row
  static constexpr int kBoxQ = kBQ * kBox * 2;
  static constexpr int kBoxKV = kBK * kBox * 2;
  static constexpr int kQ = kChunks * kBoxQ;
  static constexpr int kKV = kChunks * kBoxKV;  // one K or one V tile
  static constexpr int kOffK = kQ;
  static constexpr int kOffV = kOffK + kStages * kKV;
  static constexpr int kOffBar = kOffV + kStages * kKV;
  // q_full, full[kStages], empty[kStages]; 1024 bytes of alignment slack.
  static constexpr int kBytes = kOffBar + 8 * (1 + 2 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` of the mbarrier at `bar` has
// completed.  Bounded: past p.wait_ns the code goes to the host-mapped
// status word and the kernel traps.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity,
                                          const FlashParams& p, int code) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (global_ns() - t0 > p.wait_ns) {
      *reinterpret_cast<volatile int*>(p.status) = code;
      __threadfence_system();
      __trap();
    }
  }
}

// One TMA box of a 3-D tensor map (hd, rows, batch x head) into shared
// memory; completion is counted in bytes on the mbarrier at `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map,
                                         uint32_t bar, int col, int row,
                                         int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(col), "r"(row),
      "r"(head)
      : "memory");
}

// wgmma shared-memory matrix descriptor for an operand in the 128-byte
// swizzle the TMA boxes write: start address, leading and stride byte
// offsets (16-byte units), layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Ties every register of an accumulator to the point after a wgmma wait,
// so that no read of it is scheduled before the product has landed.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x 128 f32, accumulator layout) (+)= A (64 x 16, shared memory,
// K-major) * B (16 x 128, shared memory, K-major); accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128 f32) += A (64 x 16 bf16, registers: the A fragment) * B
// (16 x 128, shared memory, MN-major: the transpose bit is set).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64 f32) += A (64 x 16 bf16, registers: the A fragment) * B
// (16 x 64, shared memory, MN-major: the transpose bit is set).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, "
      "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const FlashParams p) {
  using L = Layout<HDP>;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle's alignment
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sQ = base;
  const uint32_t sK = base + L::kOffK;
  const uint32_t sV = base + L::kOffV;
  const uint32_t bar_q = base + L::kOffBar;
  const uint32_t bar_full = bar_q + 8;
  const uint32_t bar_empty = bar_full + 8 * kStages;

  const int n_qt = (p.s + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);  // long rows first
  const int bh = blockIdx.y;
  const int row0 = qt * kBQ;
  int j0, j1;
  kv_tiles(p, row0, min(row0 + kBQ, p.s) - 1, kBK, j0, j1);

  const int tid = threadIdx.x;
  const int wg = tid / kWG;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the TMA loads in flight ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs)
                 : "memory");
    if (tid == 0) {
      mbar_expect_tx(bar_q, L::kQ);
      for (int c = 0; c < L::kChunks; ++c)
        tma_load(sQ + c * L::kBoxQ, tm_q, bar_q, c * kBox, row0, bh);
      const int bi = bh / p.hq;
      const int kvh = bi * p.hkv + (bh % p.hq) / (p.hq / p.hkv);
      for (int j = j0; j < j1; ++j) {
        const int it = j - j0;
        const int st = it % kStages;
        mbar_wait(bar_empty + 8 * st, ((it / kStages) & 1) ^ 1, p,
                  kTimedOutEmpty);
        const uint32_t full = bar_full + 8 * st;
        mbar_expect_tx(full, 2 * L::kKV);
        for (int c = 0; c < L::kChunks; ++c) {
          tma_load(sK + st * L::kKV + c * L::kBoxKV, tm_k, full, c * kBox,
                   j * kBK, kvh);
          tma_load(sV + st * L::kKV + c * L::kBoxKV, tm_v, full, c * kBox,
                   j * kBK, kvh);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs)
                 : "memory");
    const int cw = wg - 1;
    const int ct = tid - wg * kWG;  // thread within the warpgroup
    const int warp = ct / 32;
    const int lane = ct % 32;
    const int g = lane >> 2;  // accumulator row (and row + 8) of the warp
    const int tq = lane & 3;  // accumulator column pair

    // q * scale in f32, rounded back to bf16, on this warpgroup's rows.
    // The swizzle permutes 16-byte chunks within a row, so a flat pass
    // over the rows' bytes scales every element once.
    mbar_wait(bar_q, 0, p, kTimedOutQ);
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c) {
      uint4* rows = reinterpret_cast<uint4*>(smem + c * L::kBoxQ + cw * 64 * 128);
#pragma unroll
      for (int e = ct; e < 64 * 128 / 16; e += kWG) {
        uint4 x = rows[e];
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(h[i]);
          h[i] = __floats2bfloat162_rn(f.x * p.scale, f.y * p.scale);
        }
        rows[e] = x;
      }
    }
    // Publish the generic-proxy writes to the tensor cores' (async) proxy.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + cw), "n"(kWG) : "memory");

    float o[HDP / 2];
    float sc[kBK / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.f;
    float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
    float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
    const int wrow = row0 + cw * 64;  // first query row of the warpgroup
    const int qpos = p.t - p.s + wrow + warp * 16 + g;  // row g; g + 8 is +8
    const uint32_t q_rows = sQ + cw * 64 * 128;

    for (int j = j0; j < j1; ++j) {
      const int it = j - j0;
      const int st = it % kStages;
      mbar_wait(bar_full + 8 * st, (it / kStages) & 1, p, kTimedOutFull);
      const uint32_t k_tile = sK + st * L::kKV;
      const uint32_t v_tile = sV + st * L::kKV;

      // S = Q K^T: a 16-deep step is 32 bytes into the swizzled 128-byte
      // rows of one box; every fourth step moves to the next box.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        const uint32_t qa = q_rows + (kk / 4) * L::kBoxQ + (kk % 4) * 32;
        const uint32_t kb = k_tile + (kk / 4) * L::kBoxKV + (kk % 4) * 32;
        wgmma_ss(sc, sw128_desc(qa, 16, 1024), sw128_desc(kb, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(sc);

      // Register i of the accumulator: row g + 8 ((i >> 1) & 1), column
      // 8 (i >> 2) + 2 tq + (i & 1).
      if (!tile_whole(p, wrow, wrow + 63, j * kBK, kBK)) {
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) {
          const int kpos = j * kBK + (i >> 2) * 8 + 2 * tq + (i & 1);
          if (!visible(p, qpos + 8 * ((i >> 1) & 1), kpos)) sc[i] = -CUDART_INF_F;
        }
      }
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float alpha[2];
      float mb[2];  // m log2e, or 0 while the row has seen no key
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[r], mx[r]);
        mb[r] = m_new == -CUDART_INF_F ? 0.f : m_new * kLog2e;
        alpha[r] = exp2_approx(m_run[r] * kLog2e - mb[r]);
        m_run[r] = m_new;
      }
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const int r = (i >> 1) & 1;
        const float pe = exp2_approx(fmaf(sc[i], kLog2e, -mb[r]));
        sc[i] = pe;
        psum[r] += pe;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = alpha[r] * l_run[r] + psum[r];
#pragma unroll
      for (int i = 0; i < HDP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

      // P = p_hi + p_lo in the A-fragment layout of the register form:
      // 16-key step kk takes the accumulator's column tiles 2 kk and
      // 2 kk + 1, register a = rows g / g + 8 (a & 1), tile 2 kk + (a >> 1).
      uint32_t ph[kBK / 16][4];
      uint32_t pl[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = 4 * (2 * kk + (a >> 1)) + 2 * (a & 1);
          const __nv_bfloat162 h = __floats2bfloat162_rn(sc[i], sc[i + 1]);
          const float2 hf = __bfloat1622float2(h);
          ph[kk][a] = *reinterpret_cast<const uint32_t*>(&h);
          pl[kk][a] = pack_bf16(sc[i] - hf.x, sc[i + 1] - hf.y);
        }

      // O += P V: V is the MN-major B operand; 16 keys are two 8-row groups
      // 1024 bytes apart (stride offset), the 64-column boxes kBoxKV apart
      // (leading offset).
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t vb = sw128_desc(v_tile + kk * 16 * 128, L::kBoxKV, 1024);
        wgmma_rs(o, ph[kk], vb);
        wgmma_rs(o, pl[kk], vb);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);  // stage read
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
      if (l_run[r] == 0.f) l_run[r] = 1.f;  // no visible key: zeros, not NaN
    }
    bf16* out = static_cast<bf16*>(p.o) + static_cast<size_t>(bh) * p.s * p.hd;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wrow + warp * 16 + g + 8 * r;
      if (row >= p.s) continue;
#pragma unroll
      for (int n = 0; n < HDP / 8; ++n) {
        const int col = n * 8 + 2 * tq;
        if (col >= p.hd) continue;
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row) * p.hd + col) =
            __floats2bfloat162_rn(o[4 * n + 2 * r] / l_run[r],
                                  o[4 * n + 2 * r + 1] / l_run[r]);
      }
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

// ---------------------------------------------------------------- host --
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime
// (cudaGetDriverEntryPoint*) so that the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A (hd, rows, heads) bf16 tensor map read in (64, box_rows, 1) boxes with
// the 128-byte swizzle; out-of-range elements load as zeros.
int encode_map(CUtensorMap* map, const void* ptr, int hd, int rows, int heads,
               int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(rows) * hd * 2};
  const cuuint32_t box[3] = {kBox, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                          const_cast<void*>(ptr), dims, strides, box, unit,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int HDP>
int launch_bf16(const FlashParams& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int code = encode_map(&tq, p.q, p.hd, p.s, p.b * p.hq, kBQ);
  if (!code) code = encode_map(&tk, p.k, p.hd, p.t, p.b * p.hkv, kBK);
  if (!code) code = encode_map(&tv, p.v, p.hd, p.t, p.b * p.hkv, kBK);
  if (code) return code;
  constexpr int smem = Layout<HDP>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.s + kBQ - 1) / kBQ, p.b * p.hq);
  flash_fwd_bf16<HDP><<<grid, kThreads, smem, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

template <int HDP>
int launch_f32(const FlashParams& p, cudaStream_t stream) {
  const dim3 grid((p.s + kBQF - 1) / kBQF, p.b * p.hq);
  flash_fwd_f32<HDP><<<grid, kBQF, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The status word of the bf16 waits: host memory mapped into every
// device's address space, readable after a trap has ended the context.
int* g_status = nullptr;

int status_word(int** dev) {
  if (!g_status) {
    void* h = nullptr;
    const cudaError_t err =
        cudaHostAlloc(&h, sizeof(int), cudaHostAllocMapped | cudaHostAllocPortable);
    if (err != cudaSuccess) return static_cast<int>(err);
    *static_cast<volatile int*>(h) = 0;
    g_status = static_cast<int*>(h);
  }
  void* d = nullptr;
  const cudaError_t err = cudaHostGetDevicePointer(&d, g_status, 0);
  *dev = static_cast<int*>(d);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// q: (b, hq, s, hd), k, v: (b, hkv, t, hd), o: (b, hq, s, hd), all
// row-major, one dtype (bf16 if bf16_in, else f32); hq % hkv == 0,
// 16 <= hd <= 128, hd % 8 == 0, 16-byte aligned.  window <= 0: none.
// wait_ns bounds every mbarrier wait of the bf16 kernel.
int rt_flash_attention(int device, int bf16_in, const void* q, const void* k,
                       const void* v, void* o, int b, int hq, int hkv, int s,
                       int t, int hd, int causal, int window, float scale,
                       unsigned long long wait_ns, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int* status = nullptr;
  const int code = status_word(&status);
  if (code) return code;
  const FlashParams p{q, k, v, o, b, hq, hkv, s, t, hd, causal, window,
                      scale, status, wait_ns};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16_in) return hd <= 64 ? launch_bf16<64>(p, st) : launch_bf16<128>(p, st);
  if (hd <= 32) return launch_f32<32>(p, st);
  if (hd <= 64) return launch_f32<64>(p, st);
  return launch_f32<128>(p, st);
}

// The code of the bf16 kernel's first wait that ran out (0: none); read
// on the host, with no CUDA call.
int rt_flash_status(void) {
  return g_status ? *static_cast<volatile int*>(g_status) : 0;
}

}  // extern "C"
