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
// the grid the wrapper plans (at most as many blocks as fit on the card at
// once), with grid.sync() between phases; the wrapper allocates the global
// scratch the phases hand over:
//
//   1  Gram partials: units (machine, 128x128 tile, d-split) -> part,
//      B2's tile (tile_products.cuh); block 0 zeroes the group counters
//   2  Newton-Schulz on the whole grid: machine z takes a group of g
//      blocks, each owning r / g columns of the iterate (ns_polar_group):
//      a step stages the whole iterate, computes the block's columns of
//      M = 3I - X^T X and of 0.5 X M, and the group meets once at a
//      counter in global memory; Z_i ends in zs.  When m exceeds the
//      grid, g = 1 and the blocks take machines in turn; past
//      r = kNsSmemMaxR one block a machine runs the one-block form on a
//      workspace slot (ns_polar_block)
//   3  V-bar = (1/m) sum_i V_i Z_i: B4's 64x128 blocks -> vbar (d, r)
//   4  S1 partials = V-bar^T V-bar over d-splits -> part
//   5  S1 = the partials summed in order, over the grid -> s (zs[0])
//   6  block 0: guarded Cholesky of S1 and L^-1 in one sweep, W1 = L^-T
//   7  Q1 = V-bar W1 -> q1 (d, r)
//   8-11  the same for S2 of Q1, W2, and Q = Q1 W2 -> out
//
// Every cross-block sum goes through scratch and is added in a fixed order:
// no atomics (the group counters count arrivals only), and the result is
// the same from run to run.  V-bar and Q1 are kept in global memory
// (L2-resident at the main shape) instead of being recomputed from the
// stack as the TPU kernel does.  The guarded Cholesky mirrors
// _cholqr_inverse_factor: if any pivot is not above pivot_c * tr(S) the
// factor of S + (shift_c * tr(S) + 1e-30) I is taken instead; W is the
// exact triangular inverse, computed beside the Cholesky: step k of the
// sweep finishes column k of L and row k of L^-1 and updates every later
// row of both at once, two block barriers a step (the TPU kernel's
// log-depth nilpotent product is a VMEM idiom).  Dynamic shared memory is
// the largest phase's (round_smem_bytes: the grouped Newton-Schulz tiles,
// 199 KB at r = 128), so one block fits an SM.  Past r = 136 the Newton-Schulz and
// Cholesky tiles go to a global workspace of one slot per machine.
// Offsets into the stack are 64-bit.  The phase pieces and the tail
// (phases 4-11) live in round_tiles.cuh, shared with B7.
#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>
#include <initializer_list>
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
  float* part;          // (max(m * splits1, splits2), r, r) partial Grams
  float* zs;            // (m, r, r) Newton-Schulz iterates, then Z; S
  float* vbar;          // (d, r)
  float* q1;            // (d, r)
  float* w;             // (2, r, r): W1, W2
  float* ws;            // (m, round_ws_floats(r)) past kNsSmemMaxR, else null
  float* nsn;           // (m, group) the group blocks' sums of squares
  unsigned* ctr;        // (m) the groups' barrier counters
  int m, d, r;
  int rows1, splits1;   // d-split of the stack's Grams (phase 1)
  int rows2, splits2;   // d-split of S1 / S2
  int ns_iters;
  int group;            // blocks a machine in phase 2
  float pivot_c, shift_c;
};

// VEC: r % 4 == 0 and 16-byte aligned operands (16-byte copies).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
    fused_round_kernel(const RoundArgs<T> a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kThreads / 32];
  cg::grid_group grid = cg::this_grid();
  const int m = a.m;
  const int d = a.d;
  const int r = a.r;
  const size_t rr = static_cast<size_t>(r) * r;

  // 1: Gram partials G_i[s] = V_i[split s]^T ref[split s].
  if (blockIdx.x == 0) {
    for (int z = threadIdx.x; z < m; z += blockDim.x) a.ctr[z] = 0;
  }
  gram_units<VEC>(a.vs, static_cast<size_t>(d) * r, a.scales, a.ref, m, d, r,
                  a.rows1, a.splits1, a.part, smem);
  grid.sync();

  // 2: Z_i = NS-polar(G_i): machine z on blocks z g .. z g + g - 1; a
  // machine's first partial slot is its second iterate buffer once its
  // Gram is summed.
  const int g = a.group;
  for (int z = blockIdx.x / g; z < m; z += max(1, static_cast<int>(gridDim.x) / g)) {
    float* part_z = a.part + static_cast<size_t>(z) * a.splits1 * rr;
    if (r <= rt::kNsSmemMaxR) {
      rt::ns_polar_group(part_z, a.splits1, a.zs + z * rr, part_z,
                         a.nsn + static_cast<size_t>(z) * g, a.ctr + z, g,
                         blockIdx.x % g, r, a.ns_iters, smem, red);
    } else {
      rt::ns_polar_block(part_z, a.zs + z * rr, a.splits1, r, a.ns_iters, smem,
                         a.ws + z * round_ws_floats(r), red);
    }
  }
  grid.sync();

  // 3: V-bar = (1/m) sum_i V_i Z_i.
  apply_units<VEC>(a.vs, static_cast<size_t>(d) * r, a.scales, a.zs, m, d, r,
                   static_cast<float>(m), false, a.vbar, smem);
  grid.sync();

  // 4-11: Q = CholeskyQR2(V-bar); zs holds S.
  cholqr2_tail<VEC>(grid, a.vbar, a.q1, a.w, a.part, a.zs, a.out, d, r,
                    a.rows2, a.splits2, a.pivot_c, a.shift_c, smem, a.ws);
}

// Co-resident blocks of the round kernel on the card at edge r.
template <typename T>
int coresident(int device, int r, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = round_smem_bytes(r);
  for (auto kernel : {fused_round_kernel<T, true>, fused_round_kernel<T, false>}) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // The smaller count of the two instances: either may be launched.
  int per_sm = 1 << 30;
  for (auto kernel : {fused_round_kernel<T, true>, fused_round_kernel<T, false>}) {
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    per_sm = std::min(per_sm, n);
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = per_sm * sms;
  return 0;
}

template <typename T>
int launch_round(int device, const void* vs, const void* scales,
                 const void* ref, void* out, void* part, void* zs, void* vbar,
                 void* q1, void* w, void* ws, void* nsn, void* ctr, int m,
                 int d, int r, int rows1, int splits1, int rows2, int splits2,
                 int ns_iters, int grid, int group, float pivot_c,
                 float shift_c, int* form_out, void* stream) {
  int most = 0;
  int code = coresident<T>(device, r, &most);
  if (code) return code;
  // Every block must be resident at once for grid.sync(), and a group of
  // more than one block takes one machine only.
  if (grid < 1 || grid > most || group < 1 || (group > 1 && m * group > grid) ||
      (r > rt::kNsSmemMaxR && (group != 1 || !ws))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = r % 4 == 0 && aligned(vs) && aligned(ref) && aligned(part) &&
                   aligned(vbar) && aligned(out);
  RoundArgs<T> a{static_cast<const T*>(vs), static_cast<const float*>(scales),
                 static_cast<const float*>(ref), static_cast<float*>(out),
                 static_cast<float*>(part), static_cast<float*>(zs),
                 static_cast<float*>(vbar), static_cast<float*>(q1),
                 static_cast<float*>(w), static_cast<float*>(ws),
                 static_cast<float*>(nsn), static_cast<unsigned*>(ctr), m, d, r,
                 rows1, splits1, rows2, splits2, ns_iters, group, pivot_c,
                 shift_c};
  // The Newton-Schulz form that runs: g blocks a machine, or 0 for one
  // block a machine on a workspace slot.
  if (form_out) *form_out = r > rt::kNsSmemMaxR ? 0 : group;
  void* args[] = {&a};
  auto kernel = vec ? fused_round_kernel<T, true> : fused_round_kernel<T, false>;
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(grid),
      dim3(kThreads), args, round_smem_bytes(r),
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// vs: (m, d, r) wire stack; scales: (m, r) f32 for int8, else null;
// ref, out, vbar, q1: (d, r) f32; part: (max(m * splits1, splits2), r, r);
// zs: (m, r, r); w: (2, r, r); ws: (m, round_ws_floats(r)) when
// r > kNsSmemMaxR, else unused (may be null); nsn: (m, group) f32; ctr:
// (m) 32-bit words.  grid and group come from the wrapper's plan; form_out
// (may be null) receives the Newton-Schulz form (group, or 0).
#define RT_FUSED_ROUND(NAME, T)                                               \
  int NAME(int device, const void* vs, const void* scales, const void* ref,   \
           void* out, void* part, void* zs, void* vbar, void* q1, void* w,    \
           void* ws, void* nsn, void* ctr, int m, int d, int r, int rows1,    \
           int splits1, int rows2, int splits2, int ns_iters, int grid,       \
           int group, float pivot_c, float shift_c, int* form_out,            \
           void* stream) {                                                    \
    return launch_round<T>(device, vs, scales, ref, out, part, zs, vbar, q1,  \
                           w, ws, nsn, ctr, m, d, r, rows1, splits1, rows2,   \
                           splits2, ns_iters, grid, group, pivot_c, shift_c,  \
                           form_out, stream);                                 \
  }

RT_FUSED_ROUND(rt_fused_round_f32, float)
RT_FUSED_ROUND(rt_fused_round_bf16, __nv_bfloat16)
RT_FUSED_ROUND(rt_fused_round_i8, int8_t)

#undef RT_FUSED_ROUND

// *blocks: the co-resident blocks of the round kernel for wire type wire
// (0 f32, 1 bf16, 2 int8) at edge r: the most a launch may have.
int rt_fused_round_coresident(int device, int wire, int r, int* blocks) {
  switch (wire) {
    case 0: return coresident<float>(device, r, blocks);
    case 1: return coresident<__nv_bfloat16>(device, r, blocks);
    case 2: return coresident<int8_t>(device, r, blocks);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
