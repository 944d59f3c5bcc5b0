// Shared helpers of the FedDD Hopper kernels (plain C interface, loaded
// with ctypes by repro_torch/kernels/_lib.py).
//
// Every kernel views one client-stacked parameter leaf as (N, A, C, B):
// N clients, C channels (the leaf's channel axis), A the leaf axes before
// the channel axis and B those after it.  The FL parameters store
// channels last ((in, out) dense, HWIO conv), so on the main path B == 1
// and neighbouring threads walk neighbouring channels: loads coalesce.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace feddd {

// dtype codes shared with the Python wrappers
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

inline unsigned int blocks_for(int64_t work, int threads) {
  return static_cast<unsigned int>((work + threads - 1) / threads);
}

}  // namespace feddd
