// FedDD Eq. (20)/(21) channel importance on Hopper.
//
// Replaces the Pallas TPU kernel channel_importance_sumsq (body
// _importance_kernel) in src/repro/kernels/importance/importance.py, and
// the moveaxis/reshape, sqrt and coverage division its wrappers in
// src/repro/kernels/importance/ops.py run around it.
//
//   score[n, c] = sqrt( sum_{a,b} |(wn - wo) * wn / wo_eps|^2 ) / max(cov[c], eps)
//
// wo_eps keeps wo's sign with its magnitude clamped to >= 1e-8; the sum runs
// in fp32 for fp32 and bf16 inputs.
//
// Bound: bytes.  Two reads of every leaf element and one (N, C) fp32
// write; about 6 flops per element, far below the card's fp32 rate.
// Design: the leaf is read in place as (N, A, C, B) — no moveaxis copy.
// A block owns 32 channels of one client: threadIdx.x runs along C, so a
// warp's loads are 32 consecutive elements of one row (coalesced when the
// channel axis is last, B == 1, as on the main path), and threadIdx.y
// splits the A*B fan-in rows 32 ways so a leaf with few channels (the
// MLP's: N*C = 1000 for fc0) still puts 32 warps per 32 channels in
// flight — the loop is latency-bound, not bandwidth-bound, at those sizes.
// The 32 partial sums combine in shared memory; sqrt and the coverage
// division are fused into the store.
#include "common.cuh"

namespace {

constexpr int kThreadsX = 32;  // channels per block
constexpr int kThreadsY = 32;  // fan-in row slices per block
constexpr float kEps = 1e-8f;

template <typename T>
__global__ void importance_kernel(const T* __restrict__ w_old,
                                  const T* __restrict__ w_new,
                                  const float* __restrict__ coverage,
                                  float* __restrict__ out, int64_t a,
                                  int64_t c, int64_t b) {
  const int64_t n = blockIdx.y;
  const int64_t ch = static_cast<int64_t>(blockIdx.x) * kThreadsX + threadIdx.x;
  const int64_t rows = a * b;
  float acc = 0.f;
  if (ch < c) {
    const int64_t base = n * a * c * b;
#pragma unroll 4
    for (int64_t r = threadIdx.y; r < rows; r += kThreadsY) {
      int64_t off;
      if (b == 1) {
        off = base + r * c + ch;
      } else {
        const int64_t ia = r / b;
        off = base + (ia * c + ch) * b + (r - ia * b);
      }
      const float wo = feddd::to_f32(w_old[off]);
      const float wn = feddd::to_f32(w_new[off]);
      const float dw = wn - wo;
      const float denom = fabsf(wo) < kEps ? (wo < 0.f ? -kEps : kEps) : wo;
      const float imp = fabsf(dw * wn / denom);
      acc += imp * imp;
    }
  }
  __shared__ float partial[kThreadsY][kThreadsX];
  partial[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && ch < c) {
    float s = 0.f;
#pragma unroll
    for (int y = 0; y < kThreadsY; ++y) s += partial[y][threadIdx.x];
    float score = sqrtf(s);
    if (coverage != nullptr) score = score / fmaxf(coverage[ch], kEps);
    out[n * c + ch] = score;
  }
}

}  // namespace

// w_old, w_new: (N, A, C, B) contiguous, dtype code `dtype`;
// coverage: (C,) fp32 or null; out: (N, C) fp32.
extern "C" int feddd_importance(const void* w_old, const void* w_new,
                                const void* coverage, void* out, int64_t n,
                                int64_t a, int64_t c, int64_t b, int dtype,
                                void* stream) {
  if (n <= 0 || c <= 0 || n > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid(feddd::blocks_for(c, kThreadsX), static_cast<unsigned int>(n));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* cov = static_cast<const float*>(coverage);
  float* o = static_cast<float*>(out);
  if (dtype == feddd::kFloat32) {
    importance_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(w_old), static_cast<const float*>(w_new),
        cov, o, a, c, b);
  } else if (dtype == feddd::kBFloat16) {
    importance_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(w_old),
        static_cast<const __nv_bfloat16*>(w_new), cov, o, a, c, b);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
