// Shared helpers of the port's kernels (every .cu and .cuh here). CD is
// the compute dtype of the products: float or __nv_bfloat16. Every product accumulates in f32; a value is
// rounded to CD exactly where the JAX package casts it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

template <typename T>
__device__ __forceinline__ float to_f32(T v);

template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);

template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to CD and widened back: the operand an f32-accumulated
// product sees after a cast to CD.
template <typename T>
__device__ __forceinline__ float round_cd(float v) {
  return to_f32<T>(from_f32<T>(v));
}

// ReLU that keeps NaN, as torch.relu and jnp.maximum(x, 0) do.
__device__ __forceinline__ float relu_nan(float v) {
  return v < 0.f ? 0.f : v;
}
