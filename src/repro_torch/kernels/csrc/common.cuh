// Shared pieces of the port's hand-written Hopper (sm_90a) kernels: the
// wire types' decode to f32.  The tile products of the Procrustes kernels
// are in tile_products.cuh.
//
// Every kernel but B8's bf16 path accumulates plain FP32 products on the
// CUDA cores: no TF32 or bf16 tensor-core path, because the JAX reference
// accumulates f32 products and the port is held against it.  The C entry points take
// raw device pointers and a cudaStream_t, launch on that stream, never
// synchronise, allocate nothing, and return the cudaGetLastError() code
// of their launches (0 on success) for the Python wrapper to raise on.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace rt {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(signed char v) {
  return static_cast<float>(v);
}

}  // namespace rt
