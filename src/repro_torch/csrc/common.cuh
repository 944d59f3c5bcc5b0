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
#include <cstring>

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

// V consecutive elements of one row, moved as one 4-, 8-, 16- or 32-byte
// access (the wrappers check that V divides the row and that every
// pointer is aligned to V elements).
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load_vec(const T* __restrict__ p) {
  return *reinterpret_cast<const Vec<T, V>*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void load_f32(const T* __restrict__ p,
                                         float (&out)[V]) {
  const Vec<T, V> x = load_vec<T, V>(p);
#pragma unroll
  for (int j = 0; j < V; ++j) out[j] = to_f32(x.v[j]);
}

template <typename T, int V>
__device__ __forceinline__ void store_f32(T* __restrict__ p,
                                          const float (&in)[V]) {
  Vec<T, V> x;
#pragma unroll
  for (int j = 0; j < V; ++j) x.v[j] = from_f32<T>(in[j]);
  *reinterpret_cast<Vec<T, V>*>(p) = x;
}

// The same accesses with a cache policy: `cs` streams (evict-first loads
// and stores, for data touched once), `ldg` reads through the read-only
// path (for data other threads read again).  Vec<T, V> moves as the
// integer type of its size.
template <int BYTES>
struct Bits;
template <>
struct Bits<2> {
  using type = unsigned short;
};
template <>
struct Bits<4> {
  using type = unsigned int;
};
template <>
struct Bits<8> {
  using type = uint2;
};
template <>
struct Bits<16> {
  using type = uint4;
};

template <typename T, int V>
using BitsOf = typename Bits<sizeof(T) * V>::type;

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> from_bits(BitsOf<T, V> r) {
  Vec<T, V> x;
  memcpy(&x, &r, sizeof(x));
  return x;
}

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load_vec_cs(const T* p) {
  return from_bits<T, V>(__ldcs(reinterpret_cast<const BitsOf<T, V>*>(p)));
}

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load_vec_ldg(const T* p) {
  return from_bits<T, V>(__ldg(reinterpret_cast<const BitsOf<T, V>*>(p)));
}

template <typename T, int V>
__device__ __forceinline__ void store_f32_cs(T* p, const float (&in)[V]) {
  Vec<T, V> x;
#pragma unroll
  for (int j = 0; j < V; ++j) x.v[j] = from_f32<T>(in[j]);
  BitsOf<T, V> r;
  memcpy(&r, &x, sizeof(r));
  __stcs(reinterpret_cast<BitsOf<T, V>*>(p), r);
}

inline unsigned int blocks_for(int64_t work, int threads) {
  return static_cast<unsigned int>((work + threads - 1) / threads);
}

}  // namespace feddd
