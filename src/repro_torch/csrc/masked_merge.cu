// FedDD Eq. (5) client update on Hopper.
//
// Replaces the Pallas TPU kernel masked_merge_2d (body _merge_kernel) in
// src/repro/kernels/masked_merge/masked_merge.py.  The JAX engine computes
// Eq. (5) inline (src/repro/core/aggregation.py client_update_sparse); the
// port runs every client's update through this kernel.
//
//   out[n, e] = G[e] * M[n, ch(e)] + L[n, e] * (1 - M[n, ch(e)])
//
// computed in fp32 and stored in L's dtype (fp32 or bf16).  With a binary
// mask this is an exact select of G or L.  The mask is channel-shaped,
// (N, C_m) with C_m in {C, 1}, in L's dtype.
//
// Bound: bytes.  One read of the client-stacked L (N, A, C, B), one of the
// global G (A, C, B) — reused by all N clients, so from L2 after the first
// — the small mask, and one write of the output.
// Design: a 2-D grid, blockIdx.y the client, so no thread divides by the
// leaf size; a warp reads and writes 32 consecutive elements (coalesced).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void masked_merge_kernel(const T* __restrict__ g,
                                    const T* __restrict__ l,
                                    const T* __restrict__ mask,
                                    T* __restrict__ out, int64_t size,
                                    int64_t c, int64_t b, int64_t mask_c) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= size) return;
  const int64_t k = blockIdx.y;
  const int64_t ch = mask_c == 1 ? 0 : (b == 1 ? e % c : (e / b) % c);
  const float m = feddd::to_f32(mask[k * mask_c + ch]);
  const int64_t i = k * size + e;
  const float gv = feddd::to_f32(g[e]);
  const float lv = feddd::to_f32(l[i]);
  out[i] = feddd::from_f32<T>(gv * m + lv * (1.f - m));
}

}  // namespace

// g: (A, C, B); l, out: (N, A, C, B); mask: (N, mask_c) with mask_c in
// {C, 1}; all contiguous, dtype code `dtype`.
extern "C" int feddd_masked_merge(const void* g, const void* l,
                                  const void* mask, void* out, int64_t n,
                                  int64_t a, int64_t c, int64_t b,
                                  int64_t mask_c, int dtype, void* stream) {
  const int64_t size = a * c * b;
  if (n <= 0 || n > 65535 || size <= 0 || (mask_c != c && mask_c != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(feddd::blocks_for(size, kThreads), static_cast<unsigned int>(n));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == feddd::kFloat32) {
    masked_merge_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(l),
        static_cast<const float*>(mask), static_cast<float*>(out), size, c, b,
        mask_c);
  } else if (dtype == feddd::kBFloat16) {
    masked_merge_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g),
        static_cast<const __nv_bfloat16*>(l),
        static_cast<const __nv_bfloat16*>(mask),
        static_cast<__nv_bfloat16*>(out), size, c, b, mask_c);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
