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
// are 64-bit.  The tile products, the guarded Cholesky and the tail
// (phases 4-9) live in round_tiles.cuh, shared with B7.
#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "ns_polar.cuh"
#include "round_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace rt::round;

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
               static_cast<float>(m), false, a.vbar, smem);
  }
  grid.sync();

  // 4-9: Q = CholeskyQR2(V-bar).
  cholqr2_tail(grid, a.vbar, a.q1, a.w, a.part, a.out, d, r, a.rows2,
               a.splits2, a.pivot_c, a.shift_c, smem);
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
