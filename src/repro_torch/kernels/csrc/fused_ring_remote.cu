// B7: one fused ring round whose hops are peer writes between ranks.
//
// Replaces the Pallas TPU kernel fused_ring_round_remote of
// src/repro/kernels/procrustes_align.py (:744, pallas_call :794, body
// _fused_ring_remote_kernel :675).  Each rank of an m-rank ring holds only
// its own (d, r) f32 basis V and the shared (d, r) f32 reference; hop i
// (0 <= i < m) works on the basis of rank (me - i) mod m:
//
//   push it to the right neighbour (not at the last hop),
//   G = x^T ref, Z = NS-polar(G), V-bar += x Z,
//
// and after the last hop Q = CholeskyQR2(V-bar / m), the guard constants
// of the reference (pivot_c = r eps, shift_c = 11 (d + r + 1) eps).
//
// Where the TPU kernel pushes by remote DMA over ICI, a rank here writes
// straight into its right neighbour's exchange buffer, mapped into this
// process with cudaIpcOpenMemHandle: another process on the same card, or
// another card over NVLink peer memory.  Each rank's buffer (cudaMalloc,
// not a sub-range of a caching-allocator segment) holds two (d, r) f32
// slots and two sequence words.  Hop i of call c has the global index
// g = c m + i; the words count hops, so no word is ever reset and calls
// reuse the mapped buffers freely:
//
//   arrived   written by the left neighbour: g + 2 once the basis of this
//             rank's hop g + 1 has landed in slot (i + 1) % 2;
//   consumed  written by the right neighbour: h + 1 once it has finished
//             its global hop h (every read of that hop's slot done).
//
// The TPU kernel's double buffer has no credit: its DMA wait covers only
// this rank's own send and receive, so a left neighbour that runs ahead
// could overwrite a slot that is still being read.  Here a push into the
// right neighbour's slot for its hop g + 1 waits until consumed >= g, that
// is until the right neighbour has finished hop g - 1, the last one to read
// that slot (or a later one).  Hop 0 reads V itself, so slot 0 first
// serves hop 2.
//
// Ordering across processes: the payload is stored by every block, the
// grid meets at grid.sync(), and then one thread issues
// __threadfence_system() and a st.release.sys of the sequence word; the
// waiting thread spins on ld.acquire.sys and the grid meets again before
// any block reads the slot, which is read with ld.global.cg (L2, never a
// stale L1 line).  Every wait is bounded by the %globaltimer: a wait that
// times out writes its code to status[0], every block leaves the kernel at
// the next grid.sync(), no further word is signalled (so the neighbours
// time out in turn), and the wrapper raises.
//
// What bounds it on an H100: FP32 operations, as B6: per rank 2 m d r^2
// (Grams) + 2 m d r^2 (apply) + 8 d r^2 (tail) plus m 24 4 r^3 of
// Newton-Schulz, 0.10 ms at 67 TFLOP/s at (8, 8192, 128); the hops write
// (m - 1) d r 4 bytes (29 MB, 9 us at 3.35 TB/s).  This first version
// is simple: every phase is one cooperative launch's pass with grid.sync()
// between phases, the push is a grid-stride copy beside the Gram, and
// each hop's r x r Newton-Schulz runs on one block while the rest wait
// (the TPU kernel also runs the hops' polar steps one after another).
// On one card without MPS the ranks' kernels time-slice: a rank that waits
// spins until the card switches to the neighbour's context.
#include <cooperative_groups.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>

#include "common.cuh"
#include "ns_polar.cuh"
#include "round_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace rt::round;
using u64 = unsigned long long;

// Layout of a rank's exchange buffer: the two sequence words on their own
// 128-byte lines, then the slots, each starting on a 256-byte boundary.
constexpr size_t kArrivedOff = 0;
constexpr size_t kConsumedOff = 128;
constexpr size_t kSlotOff = 256;

// status[0] codes (0: no error).
constexpr int kTimedOutArrival = 1;
constexpr int kTimedOutCredit = 2;

__host__ __device__ inline size_t slot_floats(int d, int r) {
  const size_t bytes = static_cast<size_t>(d) * r * sizeof(float);
  return ((bytes + 255) / 256) * 256 / sizeof(float);
}

struct RemoteArgs {
  const float* v;    // (d, r) this rank's basis
  const float* ref;  // (d, r)
  float* out;        // (d, r)
  float* part;       // (max(splits1, splits2), r, r) partial Grams
  float* z;          // (r, r) this hop's polar factor
  float* vbar;       // (d, r) running sum, then V-bar
  float* q1;         // (d, r)
  float* w;          // (2, r, r): W1, W2
  char* mine;        // this rank's exchange buffer
  char* right;       // the right neighbour's, mapped (null when m == 1)
  char* left;        // the left neighbour's, mapped (null when m == 1)
  int* status;       // [0]: error code
  u64 seq0;          // global index of this call's hop 0: call * m
  u64 timeout_ns;
  int m, d, r;
  int rows1, splits1;  // d-split of the hop Gram
  int rows2, splits2;  // d-split of S1 / S2
  int ns_iters;
  float pivot_c, shift_c;
};

__device__ __forceinline__ u64 ld_acquire_sys(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(u64* p, u64 v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ u64 global_ns() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin until *p >= want; false if timeout_ns of wall time pass first.
__device__ bool wait_at_least(const u64* p, u64 want, u64 timeout_ns) {
  const u64 t0 = global_ns();
  while (ld_acquire_sys(p) < want) {
    if (global_ns() - t0 > timeout_ns) return false;
    __nanosleep(200);
  }
  return true;
}

__global__ void __launch_bounds__(kThreads)
    fused_ring_remote_kernel(const RemoteArgs a) {
  extern __shared__ float smem[];
  __shared__ float warp_sums[kThreads / 32];
  cg::grid_group grid = cg::this_grid();
  const int m = a.m;
  const int d = a.d;
  const int r = a.r;
  const int tiles = (r + kBM - 1) / kBM;
  const int dtiles = (d + kBM - 1) / kBM;
  const size_t dr = static_cast<size_t>(d) * r;
  const size_t slot = slot_floats(d, r);
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  float* my_slots = reinterpret_cast<float*>(a.mine + kSlotOff);
  const u64* arrived = reinterpret_cast<const u64*>(a.mine + kArrivedOff);
  const u64* consumed = reinterpret_cast<const u64*>(a.mine + kConsumedOff);
  volatile int* status = a.status;

  for (int i = 0; i < m; ++i) {
    const u64 g = a.seq0 + i;
    const bool push = i < m - 1;
    // Hop i's basis has landed (hop 0 reads V), and the right neighbour
    // has released the slot this hop's push fills.
    if (lead) {
      if (i > 0 && !wait_at_least(arrived, g + 1, a.timeout_ns)) {
        *status = kTimedOutArrival;
      } else if (push && !wait_at_least(consumed, g, a.timeout_ns)) {
        *status = kTimedOutCredit;
      }
    }
    grid.sync();
    if (*status) return;  // every block reads the same word: no sync left
    const float* x = i == 0 ? a.v : my_slots + (i % 2) * slot;
    auto ldx = [&](int k, int j) { return __ldcg(x + static_cast<size_t>(k) * r + j); };

    // Push x into the right neighbour's slot (i + 1) % 2; Gram partials
    // G[s] = x[split s]^T ref[split s].
    if (push) {
      float* dst = reinterpret_cast<float*>(a.right + kSlotOff) +
                   ((i + 1) % 2) * slot;
      for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
           e < dr; e += static_cast<size_t>(gridDim.x) * blockDim.x) {
        __stcg(dst + e, __ldcg(x + e));
      }
    }
    for (int u = blockIdx.x; u < tiles * tiles * a.splits1; u += gridDim.x) {
      const int s = u / (tiles * tiles);
      const int t = u % (tiles * tiles);
      const int k_begin = s * a.rows1;
      const int k_end = min(d, k_begin + a.rows1);
      atb_tile(ldx,
               [&](int k, int j) { return a.ref[static_cast<size_t>(k) * r + j]; },
               k_begin, k_end, r, r, (t / tiles) * kBM, (t % tiles) * kBM,
               a.part + static_cast<size_t>(s) * r * r, smem);
    }
    grid.sync();

    // The push is complete: tell the right neighbour.  Z = NS-polar(G).
    if (blockIdx.x == 0) {
      if (push && threadIdx.x == 0) {
        __threadfence_system();
        st_release_sys(reinterpret_cast<u64*>(a.right + kArrivedOff), g + 2);
      }
      rt::ns_polar_block(a.part, a.z, a.splits1, r, a.ns_iters, smem,
                         warp_sums);
    }
    grid.sync();

    // V-bar += x Z; the last hop divides the sum by m.
    for (int u = blockIdx.x; u < dtiles * tiles; u += gridDim.x) {
      apply_tile([&](int, int k, int j) { return ldx(k, j); }, a.z, 1, d, r,
                 (u / tiles) * kBM, (u % tiles) * kBM,
                 i == m - 1 ? static_cast<float>(m) : 1.f, i > 0, a.vbar,
                 smem);
    }
    grid.sync();
    // Every read of x is done: release this hop's slot to the left
    // neighbour (hop g finished).
    if (lead && m > 1) {
      st_release_sys(reinterpret_cast<u64*>(a.left + kConsumedOff), g + 1);
    }
  }

  cholqr2_tail(grid, a.vbar, a.q1, a.w, a.part, a.out, d, r, a.rows2,
               a.splits2, a.pivot_c, a.shift_c, smem);
}

}  // namespace

extern "C" {

// Bytes of one rank's exchange buffer at (d, r).
size_t rt_remote_exchange_bytes(int d, int r) {
  return kSlotOff + 2 * slot_floats(d, r) * sizeof(float);
}

// Allocate and zero this rank's exchange buffer on ``device`` (cudaMalloc,
// its own allocation) and export it: *ptr receives the device pointer,
// handle (64 bytes) the cudaIpcMemHandle_t.
int rt_remote_alloc(int device, size_t bytes, void** ptr, void* handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMalloc(ptr, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemset(*ptr, 0, bytes);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess) {
    err = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), *ptr);
  }
  if (err != cudaSuccess) {
    cudaFree(*ptr);
    *ptr = nullptr;
  }
  return static_cast<int>(err);
}

// Map another process's exported buffer into this one (*ptr).
int rt_remote_open(int device, const void* handle, void** ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return static_cast<int>(
      cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

// Unmap a buffer mapped by rt_remote_open.
int rt_remote_close(int device, void* ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}

// Free this rank's own buffer (after every neighbour has unmapped it).
int rt_remote_free(int device, void* ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaFree(ptr));
}

// One B7 round.  v, ref, out, vbar, q1: (d, r) f32; part:
// (max(splits1, splits2), r, r); z: (r, r); w: (2, r, r); status: int[1],
// zero on entry.  mine: this rank's exchange buffer; right / left: the
// neighbours' mapped buffers (null when m == 1).  seq0 = call index * m.
// grid_out (may be null) receives the grid.
int rt_fused_ring_remote(int device, const void* v, const void* ref,
                         void* out, void* part, void* z, void* vbar, void* q1,
                         void* w, void* mine, void* right, void* left,
                         void* status, u64 seq0, u64 timeout_ns, int m, int d,
                         int r, int rows1, int splits1, int rows2, int splits2,
                         int ns_iters, float pivot_c, float shift_c,
                         int* grid_out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  RemoteArgs a{static_cast<const float*>(v), static_cast<const float*>(ref),
               static_cast<float*>(out), static_cast<float*>(part),
               static_cast<float*>(z), static_cast<float*>(vbar),
               static_cast<float*>(q1), static_cast<float*>(w),
               static_cast<char*>(mine), static_cast<char*>(right),
               static_cast<char*>(left), static_cast<int*>(status), seq0,
               timeout_ns, m, d, r, rows1, splits1, rows2, splits2, ns_iters,
               pivot_c, shift_c};
  const size_t smem = round_smem_bytes(r);
  err = cudaFuncSetAttribute(fused_ring_remote_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_ring_remote_kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Every block must be resident at once for grid.sync(): the co-resident
  // count, capped where more blocks would find no work.
  const int tiles = (r + kBM - 1) / kBM;
  const int most_units =
      std::max({tiles * tiles * splits1, ((d + kBM - 1) / kBM) * tiles,
                tiles * tiles * splits2, 1});
  const int blocks = std::min(per_sm * sms, most_units);
  if (grid_out) *grid_out = blocks;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fused_ring_remote_kernel), dim3(blocks),
      dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
