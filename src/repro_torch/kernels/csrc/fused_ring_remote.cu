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
// A round is m cooperative launches on this rank's stream, one a hop, and
// the waits sit between them as stream memory operations on this rank's
// own exchange words (cuStreamWaitValue64, reached through the runtime's
// cudaGetDriverEntryPoint, so the library needs no -lcuda): before hop
// i > 0, arrived >= g + 1; before a hop that pushes, consumed >= g.  While
// a rank waits, none of its blocks is on the SMs.  On one card the ranks'
// contexts time-slice: a kernel that spun in a wait would hold the card
// until its slice ran out, where a stream blocked in a wait leaves it to
// the neighbour's context.  A hop kernel never waits on another process:
// its only barriers are its own grid's, which a cooperative launch keeps
// resident.
//
// Ordering across processes: the payload is stored by every block, the
// grid meets at grid.sync(), and then one thread issues
// __threadfence_system() and a st.release.sys of the sequence word into
// the neighbour's mapped buffer; the neighbour's stream waits on the word
// before its next launch, which reads the slot with cp.async.cg /
// ld.global.cg (L2, never a stale L1 line).  A stream wait has no timeout
// of its own: the wrapper watches the round's hops from the host and,
// when one has waited REMOTE_WAIT_S, releases its own stream
// (rt_remote_release: the status word, then both words past any awaited
// value, on a stream of its own); every later hop kernel of the round
// reads the status word on entry and returns, so no further word is
// signalled and the neighbours time out in turn.
//
// What bounds it on an H100: FP32 operations, as B6: per rank 2 m d r^2
// (Grams) + 2 m d r^2 (apply) + 8 d r^2 (tail) plus m 24 4 r^3 of
// Newton-Schulz, 0.10 ms at 67 TFLOP/s at (8, 8192, 128); the hops write
// (m - 1) d r 4 bytes (29 MB, 9 us at 3.35 TB/s).  A hop is three phases
// with grid.sync() between them: the push (a grid-stride copy) beside the
// Gram partials, the polar step on a group of blocks (ns_polar_grouped,
// the group meeting at a counter in global memory while the rest of the
// grid waits at the next grid.sync), and V-bar += x Z.  The last hop
// then runs the CholeskyQR2 tail.  The Gram, apply and tail are B5/B6's
// (round_tiles.cuh); the wrapper plans the grid, the splits and the group
// (_hop_plan).
#include <cooperative_groups.h>
#include <cuda.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <initializer_list>

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

// status[0] codes (0: no error), and the value a release writes into
// both words: past any hop index.
constexpr int kTimedOutArrival = 1;
constexpr int kTimedOutCredit = 2;
constexpr u64 kReleased = 1ull << 62;

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
  float* ws;         // round_ws_floats(r) past kNsSmemMaxR (the tail), else null
  float* nsn;        // (group) the polar group's sums of squares
  unsigned* ctr;     // the polar group's barrier counter
  char* mine;        // this rank's exchange buffer
  char* right;       // the right neighbour's, mapped (null when m == 1)
  char* left;        // the left neighbour's, mapped (null when m == 1)
  const int* status; // [0]: nonzero once the wrapper released the round
  u64 seq0;          // global index of this call's hop 0: call * m
  int m, d, r;
  int rows1, splits1;  // d-split of the hop Gram
  int rows2, splits2;  // d-split of S1 / S2
  int ns_iters;
  int group;           // blocks of the polar step
  float pivot_c, shift_c;
};

__device__ __forceinline__ void st_release_sys(u64* p, u64 v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// Hop i of the round.  VEC: r % 4 == 0 and 16-byte aligned operands
// (16-byte copies).
template <bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
    remote_hop_kernel(const RemoteArgs a, int i) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kThreads / 32];
  cg::grid_group grid = cg::this_grid();
  // The status word changes only while the stream waits, never during a
  // launch, so every block reads the same value.
  if (*reinterpret_cast<const volatile int*>(a.status)) return;
  const int m = a.m;
  const int d = a.d;
  const int r = a.r;
  const size_t dr = static_cast<size_t>(d) * r;
  const size_t slot = slot_floats(d, r);
  const u64 g = a.seq0 + i;
  const bool push = i < m - 1;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  const float* x = i == 0 ? a.v : reinterpret_cast<float*>(a.mine + kSlotOff) + (i % 2) * slot;

  // Push x into the right neighbour's slot (i + 1) % 2; Gram partials
  // G[s] = x[split s]^T ref[split s].
  if (lead) *a.ctr = 0;
  if (push) {
    float* dst = reinterpret_cast<float*>(a.right + kSlotOff) + ((i + 1) % 2) * slot;
    for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         e < dr; e += static_cast<size_t>(gridDim.x) * blockDim.x) {
      __stcg(dst + e, __ldcg(x + e));
    }
  }
  gram_units<VEC>(x, 0, nullptr, a.ref, 1, d, r, a.rows1, a.splits1, a.part,
                  smem);
  grid.sync();

  // The push is complete: tell the right neighbour.  Z = NS-polar(G) on
  // blocks 0 .. group - 1; the first partial slot is its second iterate
  // buffer once the Gram is summed.
  if (push && lead) {
    __threadfence_system();
    st_release_sys(reinterpret_cast<u64*>(a.right + kArrivedOff), g + 2);
  }
  if (static_cast<int>(blockIdx.x) < a.group) {
    rt::ns_polar_grouped(a.part, a.splits1, a.z, a.part, a.nsn, a.ctr, a.group,
                         blockIdx.x, r, a.ns_iters, smem, red);
  }
  grid.sync();

  // V-bar += x Z; the last hop divides the sum by m.
  apply_units<VEC>(x, 0, nullptr, a.z, 1, d, r,
                   i == m - 1 ? static_cast<float>(m) : 1.f, i > 0, a.vbar,
                   smem);
  grid.sync();
  // Every read of x is done: release this hop's slot to the left
  // neighbour (hop g finished).
  if (lead && m > 1) {
    st_release_sys(reinterpret_cast<u64*>(a.left + kConsumedOff), g + 1);
  }
  // After the last hop, z is the tail's S.
  if (i == m - 1) {
    cholqr2_tail<VEC>(grid, a.vbar, a.q1, a.w, a.part, a.z, a.out, d, r,
                      a.rows2, a.splits2, a.pivot_c, a.shift_c, smem, a.ws);
  }
}

// Dynamic shared memory of the hop kernel: the round's phases and the
// grouped polar step.
size_t hop_smem_bytes(int r) {
  return std::max(round_smem_bytes(r), rt::ns_grouped_smem_bytes(r));
}

// Both instances of the hop kernel with their shared-memory limit set;
// *per_sm the blocks an SM holds of the smaller.
int hop_kernels(int r, int* per_sm) {
  const size_t smem = hop_smem_bytes(r);
  if (!rt::ns_grouped_smem_bytes(r)) return static_cast<int>(cudaErrorInvalidValue);
  *per_sm = 1 << 30;
  for (auto kernel : {remote_hop_kernel<true>, remote_hop_kernel<false>}) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    *per_sm = std::min(*per_sm, n);
  }
  return 0;
}

// The CUDA API's stream memory operations, looked up through the CUDA
// runtime (cudaGetDriverEntryPoint*) so that the library needs no -lcuda.
using WaitValue64 = CUresult (*)(CUstream, CUdeviceptr, cuuint64_t, unsigned);
using WriteValue64 = CUresult (*)(CUstream, CUdeviceptr, cuuint64_t, unsigned);
using WriteValue32 = CUresult (*)(CUstream, CUdeviceptr, cuuint32_t, unsigned);

void* driver_entry(const char* name) {
  void* ptr = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t err =
      cudaGetDriverEntryPointByVersion(name, &ptr, 12000, cudaEnableDefault, &found);
#else
  const cudaError_t err = cudaGetDriverEntryPoint(name, &ptr, cudaEnableDefault, &found);
#endif
  return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? ptr : nullptr;
}

// Hold stream s until the 64-bit word at p (this rank's own buffer) is at
// least want.
int wait_word(cudaStream_t s, const void* p, u64 want) {
  static const auto fn = reinterpret_cast<WaitValue64>(driver_entry("cuStreamWaitValue64"));
  if (!fn) return static_cast<int>(cudaErrorSymbolNotFound);
  return static_cast<int>(fn(reinterpret_cast<CUstream>(s),
                             reinterpret_cast<CUdeviceptr>(p), want,
                             CU_STREAM_WAIT_VALUE_GEQ));
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

// *blocks: the co-resident blocks of the hop kernel at edge r, the most
// its cooperative launch may have.
int rt_fused_ring_remote_coresident(int device, int r, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  int code = hop_kernels(r, &per_sm);
  if (code) return code;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = per_sm * sms;
  return 0;
}

// The waits before a hop, on stream: arrived >= arrived_want (skipped at
// 0) and consumed >= consumed_want (skipped at 0), both words of this
// rank's own buffer mine.
int rt_remote_wait(int device, void* mine, u64 arrived_want, u64 consumed_want,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const char* buf = static_cast<const char*>(mine);
  int code = 0;
  if (arrived_want) code = wait_word(s, buf + kArrivedOff, arrived_want);
  if (!code && consumed_want) code = wait_word(s, buf + kConsumedOff, consumed_want);
  return code;
}

// Hop `hop` of a B7 round, one cooperative launch of `grid` blocks (the
// last hop runs the tail too).  v, ref, out, vbar, q1: (d, r) f32; part:
// (max(splits1, splits2), r, r); z: (r, r); w: (2, r, r); ws:
// round_ws_floats(r) f32 when r > kNsSmemMaxR, else unused (may be null);
// nsn: (group) f32; ctr: one 32-bit word; status: int[1], zero unless the
// wrapper released the round.  mine: this rank's exchange buffer; right /
// left: the neighbours' mapped buffers (null when m == 1).  seq0 = call
// index * m.
int rt_remote_hop(int device, const void* v, const void* ref, void* out,
                  void* part, void* z, void* vbar, void* q1, void* w, void* ws,
                  void* nsn, void* ctr, void* mine, void* right, void* left,
                  const void* status, u64 seq0, int m, int d, int r, int rows1,
                  int splits1, int rows2, int splits2, int ns_iters, int grid,
                  int group, int hop, float pivot_c, float shift_c, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  int code = hop_kernels(r, &per_sm);
  if (code) return code;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (grid < 1 || grid > per_sm * sms || group < 1 || group > grid || hop < 0 ||
      hop >= m || (r > rt::kNsSmemMaxR && !ws)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RemoteArgs a{static_cast<const float*>(v), static_cast<const float*>(ref),
               static_cast<float*>(out), static_cast<float*>(part),
               static_cast<float*>(z), static_cast<float*>(vbar),
               static_cast<float*>(q1), static_cast<float*>(w),
               static_cast<float*>(ws), static_cast<float*>(nsn),
               static_cast<unsigned*>(ctr), static_cast<char*>(mine),
               static_cast<char*>(right), static_cast<char*>(left),
               static_cast<const int*>(status), seq0, m, d, r, rows1, splits1,
               rows2, splits2, ns_iters, group, pivot_c, shift_c};
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = r % 4 == 0 && aligned(v) && aligned(ref) && aligned(vbar) &&
                   aligned(part) && aligned(out) && aligned(q1);
  auto kernel = vec ? remote_hop_kernel<true> : remote_hop_kernel<false>;
  void* args[] = {&a, &hop};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(grid), dim3(kThreads), args,
                                    hop_smem_bytes(r),
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Release a round whose wait ran out, from a stream of its own: *code_out
// becomes kTimedOutArrival if this rank's arrived word is below
// arrived_want, else kTimedOutCredit; that code goes into status, then
// both words of mine past any value a wait of the round awaits, so the
// round's stream drains (its hop kernels return on entry).  Synchronous.
int rt_remote_release(int device, void* mine, void* status, u64 arrived_want,
                      int* code_out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  static const auto write64 =
      reinterpret_cast<WriteValue64>(driver_entry("cuStreamWriteValue64"));
  static const auto write32 =
      reinterpret_cast<WriteValue32>(driver_entry("cuStreamWriteValue32"));
  if (!write64 || !write32) return static_cast<int>(cudaErrorSymbolNotFound);
  cudaStream_t side;
  err = cudaStreamCreateWithFlags(&side, cudaStreamNonBlocking);
  if (err != cudaSuccess) return static_cast<int>(err);
  char* buf = static_cast<char*>(mine);
  u64 arrived = 0;
  err = cudaMemcpyAsync(&arrived, buf + kArrivedOff, sizeof(arrived),
                        cudaMemcpyDeviceToHost, side);
  if (err == cudaSuccess) err = cudaStreamSynchronize(side);
  int code = static_cast<int>(err);
  *code_out = arrived < arrived_want ? kTimedOutArrival : kTimedOutCredit;
  const CUstream cs = reinterpret_cast<CUstream>(side);
  if (!code) {
    code = static_cast<int>(write32(cs, reinterpret_cast<CUdeviceptr>(status),
                                    static_cast<cuuint32_t>(*code_out), 0));
  }
  for (size_t off : {kArrivedOff, kConsumedOff}) {
    if (!code) {
      code = static_cast<int>(write64(cs, reinterpret_cast<CUdeviceptr>(buf + off),
                                      kReleased, 0));
    }
  }
  if (!code) code = static_cast<int>(cudaStreamSynchronize(side));
  cudaStreamDestroy(side);
  return code;
}

}  // extern "C"
