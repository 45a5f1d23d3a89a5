// B1: Gram matrix X^T X of a sample stack, the local-covariance hot spot.
//
// Replaces the Pallas TPU kernel src/repro/kernels/covariance.py::gram
// (pallas_call at :82, body _gram_kernel :34): (n, d) f32/bf16 -> (d, d)
// f32, f32 accumulation whatever the input type, ``symmetric`` computes
// the upper-triangle tiles only and mirrors them.
//
// What bounds it on an H100: operations.  One shard at the production
// width (n = 65536, d = 8192) is 2 n d^2 = 8.8 TFLOP over 2.1 GB of input,
// about 4000 FLOP per byte, far above the FP32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20 FLOP/byte).  The reference accumulates plain f32
// products, so the tensor cores (TF32/bf16) are not used; the ceiling is
// the CUDA cores' 67 TFLOP/s.
//
// Design: a classic shared-memory SGEMM.  Each block owns one 128x128
// output tile and loops over all n rows inside the block, 8 rows at a
// time, each thread holding an 8x8 register tile (64 FMAs per 16 shared
// loads); both operand slices are rows of X, so every load is coalesced
// and X is read in place (no transpose, no padded copy: ragged n and d are
// masked in the loads and stores).  blockIdx.z runs over the leading
// (shard) axis, so one launch serves an (m, n, d) stack.  Not yet done:
// wgmma/TMA pipelines (FP32 has no tensor-core path anyway) and deeper
// copy/compute overlap than the one-slice register prefetch.
#include "common.cuh"

namespace {

constexpr int kBM = 128;  // output tile edge
constexpr int kTM = 8;    // per-thread register tile edge
constexpr int kBK = 8;    // rows per shared-memory slice
constexpr int kThreads = (kBM / kTM) * (kBM / kTM);

template <typename T>
int launch_gram(int device, const void* x, void* out, int m, int n, int d,
                int symmetric, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (d + kBM - 1) / kBM;
  const dim3 grid(static_cast<unsigned>(tiles) * tiles, 1, m);
  const long long zs = static_cast<long long>(n) * d;
  rt::atb_kernel<T, kBM, kTM, kBK>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), zs, static_cast<const T*>(x), zs,
          static_cast<float*>(out), n, n, d, d, symmetric);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: (m, n, d) row-major, out: (m, d, d) f32.
int rt_gram_f32(int device, const void* x, void* out, int m, int n, int d,
                int symmetric, void* stream) {
  return launch_gram<float>(device, x, out, m, n, d, symmetric, stream);
}

int rt_gram_bf16(int device, const void* x, void* out, int m, int n, int d,
                 int symmetric, void* stream) {
  return launch_gram<__nv_bfloat16>(device, x, out, m, n, d, symmetric,
                                    stream);
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
