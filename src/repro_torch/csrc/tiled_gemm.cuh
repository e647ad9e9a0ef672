// Conversions between the port's kernels' element types and fp32.
//
// Inputs are float or __nv_bfloat16; every kernel accumulates in fp32
// registers and rounds once to the output type with from_f32, as the TPU
// kernels' fp32 VMEM accumulators do.  (The header keeps the name of the
// SIMT tiled product it once held; split_matmul.cu's tensor-core product
// replaced that.)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

}  // namespace repro_torch
