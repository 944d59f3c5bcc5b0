// FedDD Eq. (4) masked weighted aggregation partials on Hopper.
//
// Replaces the Pallas TPU kernel masked_weighted_sum_2d (body _agg_kernel)
// in src/repro/kernels/sparse_agg/sparse_agg.py, and the broadcast of the
// channel mask to the full (N, C, F) stack that its wrapper
// (src/repro/kernels/sparse_agg/ops.py) builds.
//
//   num[e] = sum_n (W[n, e] * M[n, ch(e)]) * w_n
//   den[e] = sum_n  M[n, ch(e)] * w_n
//
// fp32 sums over the client axis for fp32 and bf16 values; the mask has
// the values' dtype and is channel-shaped, (N, C_m) with C_m == C, or
// C_m == 1 for the all-ones masks of full uploads (read with stride 0).
//
// Bound: bytes.  One read of the (N, A, C, B) values, the (N, C_m) mask
// and N weights, two fp32 writes of the leaf; two flops per value.
// Design: one thread per output element, looping over the N clients, so
// the client reduction needs no second pass and no atomics and its order
// is fixed (deterministic).  A warp reads 32 consecutive elements of one
// client's leaf (coalesced); the mask and weights are a few KB, read
// through L1.  The broadcast (N, A, C, B) mask of the TPU wrapper is never
// built: that saves a full leaf-sized read per client.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void sparse_agg_kernel(const T* __restrict__ vals,
                                  const T* __restrict__ mask,
                                  const float* __restrict__ weights,
                                  float* __restrict__ num,
                                  float* __restrict__ den, int64_t n,
                                  int64_t size, int64_t c, int64_t b,
                                  int64_t mask_c) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= size) return;
  const int64_t ch = mask_c == 1 ? 0 : (b == 1 ? e % c : (e / b) % c);
  float s_num = 0.f;
  float s_den = 0.f;
  for (int64_t k = 0; k < n; ++k) {
    const float m = feddd::to_f32(mask[k * mask_c + ch]);
    const float w = weights[k];
    s_num += feddd::to_f32(vals[k * size + e]) * m * w;
    s_den += m * w;
  }
  num[e] = s_num;
  den[e] = s_den;
}

}  // namespace

// vals: (N, A, C, B) contiguous; mask: (N, mask_c) with mask_c in {C, 1},
// same dtype; weights: (N,) fp32; num, den: (A, C, B) fp32.
extern "C" int feddd_sparse_agg(const void* vals, const void* mask,
                                const void* weights, void* num, void* den,
                                int64_t n, int64_t a, int64_t c, int64_t b,
                                int64_t mask_c, int dtype, void* stream) {
  const int64_t size = a * c * b;
  if (n <= 0 || size <= 0 || (mask_c != c && mask_c != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(feddd::blocks_for(size, kThreads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(weights);
  float* nu = static_cast<float*>(num);
  float* de = static_cast<float*>(den);
  if (dtype == feddd::kFloat32) {
    sparse_agg_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(vals), static_cast<const float*>(mask), w,
        nu, de, n, size, c, b, mask_c);
  } else if (dtype == feddd::kBFloat16) {
    sparse_agg_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(vals),
        static_cast<const __nv_bfloat16*>(mask), w, nu, de, n, size, c, b,
        mask_c);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
