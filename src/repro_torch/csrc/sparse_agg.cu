// FedDD Eq. (4) masked weighted aggregation on Hopper.
//
// Replaces the Pallas TPU kernel masked_weighted_sum_2d (body _agg_kernel)
// in src/repro/kernels/sparse_agg/sparse_agg.py, the broadcast of the
// channel mask to the full (N, C, F) stack that its wrapper
// (src/repro/kernels/sparse_agg/ops.py) builds, and, in its mean mode, the
// division and previous-global fill of finish_masked_mean
// (src/repro/core/aggregation.py).
//
//   num[e] = sum_n W[n, e] * (M[n, ch(e)] * w_n)
//   den[e] = sum_n  M[n, ch(e)] * w_n
//   with `select`, a term whose mask is 0 adds nothing to num (a NaN or
//   Inf on a masked-out entry does not reach it), as the JAX package's
//   compiled engine step computes Eq. (4) where XLA rewrites
//   W * convert(mask) into a select; without it NaN * 0 stays NaN, as in
//   the literal Eq. (4)
//   mean mode: out[e] = den[e] > eps ? num[e] / max(den[e], eps) : gprev[e]
//              (num / max(den, eps) where gprev is null), in out's dtype
//
// fp32 sums over the client axis for fp32 and bf16 values; the mask has
// the values' dtype and is channel-shaped, (N, C_m) with C_m == C, or
// C_m == 1 for the all-ones masks of full uploads, or elementwise,
// C_m == A * C * B and ch(e) == e: the Pallas kernel's own (N, C, F) mask,
// which a ragged fleet's zero-padded canvas needs (a narrow client's mask
// is zero across the padded INPUT channels of a conv, which no channel
// mask describes).
//
// Bound: bytes.  One read of the (N, A, C, B) values, the (N, C_m) mask
// and N weights; two fp32 leaf writes (partials) or one leaf write in the
// output dtype (mean mode); two flops per value.  An elementwise mask is
// read like the values: twice the bytes of the channel route.
// Design: a thread owns V <= 4 consecutive elements of the leaf (one
// 16-byte fp32 or 8-byte bf16 access at V = 4; V divides the contiguous C
// where B == 1, else B) and walks the clients 16 at a time (8 in bf16): it
// issues their value loads, their V mask values (one channel where B > 1)
// and their weights back to back, predicated past N, with no dependence
// between them, and only then accumulates them in client order.  At the
// FedDD shapes (N = 10, fp32) that is one round trip to memory per thread.  The mask and the
// weights are a few KB, read through L1.  (Staging M * w in shared memory
// once per block, as the TPU kernel's blocking suggests, measured slower
// on the H100: the block barrier serialises the staging round trip with
// the value loads.)  The client reduction stays in one thread in a fixed
// order: deterministic, no atomics, no second pass.  An elementwise mask is
// read as the values are, V consecutive elements per access; the
// arithmetic is the channel route's, so a channel mask broadcast to the
// values' shape gives the same bits.  The mean mode runs the
// same accumulation and finishes in registers with a true IEEE division,
// so num and den never reach device memory, and it equals
// finish_masked_mean over the partials mode's output bit for bit.  The
// broadcast (N, A, C, B) mask of the TPU wrapper is never built.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;   // per block
constexpr float kEps = 1e-12f;

enum Mode { kPartials = 0, kMean = 1 };

template <typename T, typename TO, int V, int MODE, bool SELECT>
__global__ void __launch_bounds__(kThreads)
    sparse_agg_kernel(const T* __restrict__ vals, const T* __restrict__ mask,
                      const float* __restrict__ weights,
                      const TO* __restrict__ gprev, void* __restrict__ out,
                      float* __restrict__ den_out, int64_t n, int64_t size,
                      int64_t c, int64_t b, int64_t mask_c) {
  // clients in flight per thread: 16 in fp32, 8 in bf16 (16 bf16 clients
  // measured slower on the H100)
  constexpr int kUnroll = sizeof(T) == 4 ? 16 : 8;
  const int64_t e =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * V;
  if (e >= size) return;
  // the mask column of the thread's first element; with a channel-last
  // or an elementwise mask its V elements have V consecutive columns,
  // else one
  const bool elementwise = mask_c == size;
  const bool mask_vec = elementwise || (b == 1 && mask_c != 1);
  const int64_t ch = elementwise ? e
                     : mask_c == 1 ? 0
                                   : (b == 1 ? e % c : (e / b) % c);

  float num[V], den[V];
#pragma unroll
  for (int j = 0; j < V; ++j) num[j] = den[j] = 0.f;
  for (int64_t k0 = 0; k0 < n; k0 += kUnroll) {
    feddd::Vec<T, V> x[kUnroll], m[kUnroll];
    float w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k0 + u < n) {
        const int64_t k = k0 + u;
        x[u] = feddd::load_vec<T, V>(vals + k * size + e);
        if (mask_vec)
          m[u] = feddd::load_vec<T, V>(mask + k * mask_c + ch);
        else
          m[u].v[0] = mask[k * mask_c + ch];
        w[u] = weights[k];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k0 + u < n) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const T mj = mask_vec ? m[u].v[j] : m[u].v[0];
          const float mf = feddd::to_f32(mj);
          const float mw = mf * w[u];
          if (!SELECT || mf != 0.f)
            num[j] = fmaf(feddd::to_f32(x[u].v[j]), mw, num[j]);
          den[j] += mw;
        }
      }
    }
  }
  if constexpr (MODE == kPartials) {
    feddd::store_f32<float, V>(static_cast<float*>(out) + e, num);
    feddd::store_f32<float, V>(den_out + e, den);
  } else {
    float q[V];
    bool fill = false;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      // clamp(den, min=eps) keeps a NaN, as torch.clamp does
      q[j] = __fdiv_rn(num[j], den[j] < kEps ? kEps : den[j]);
      fill |= !(den[j] > kEps);
    }
    if (gprev != nullptr && fill) {   // a position no client uploaded
      float g[V];
      feddd::load_f32<TO, V>(gprev + e, g);
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (!(den[j] > kEps)) q[j] = g[j];
    }
    feddd::store_f32<TO, V>(static_cast<TO*>(out) + e, q);
  }
}

template <typename T, typename TO, int V, int MODE, bool SELECT>
cudaError_t launch(const void* vals, const void* mask, const float* weights,
                   const void* gprev, void* out, float* den, int64_t n,
                   int64_t a, int64_t c, int64_t b, int64_t mask_c,
                   cudaStream_t s) {
  const int64_t size = a * c * b;
  const int64_t blocks = (size / V + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  sparse_agg_kernel<T, TO, V, MODE, SELECT>
      <<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
          static_cast<const T*>(vals), static_cast<const T*>(mask), weights,
          static_cast<const TO*>(gprev), out, den, n, size, c, b, mask_c);
  return cudaSuccess;
}

template <typename T, typename TO, int MODE, bool SELECT>
cudaError_t launch_vec(int vec, const void* vals, const void* mask,
                       const float* weights, const void* gprev, void* out,
                       float* den, int64_t n, int64_t a, int64_t c, int64_t b,
                       int64_t mask_c, cudaStream_t s) {
  switch (vec) {
    case 1:
      return launch<T, TO, 1, MODE, SELECT>(vals, mask, weights, gprev, out,
                                            den, n, a, c, b, mask_c, s);
    case 2:
      return launch<T, TO, 2, MODE, SELECT>(vals, mask, weights, gprev, out,
                                            den, n, a, c, b, mask_c, s);
    case 4:
      return launch<T, TO, 4, MODE, SELECT>(vals, mask, weights, gprev, out,
                                            den, n, a, c, b, mask_c, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T, bool SELECT>
cudaError_t launch_mode(int mode, int out_dtype, int vec, const void* vals,
                        const void* mask, const float* weights,
                        const void* gprev, void* out, float* den, int64_t n,
                        int64_t a, int64_t c, int64_t b, int64_t mask_c,
                        cudaStream_t s) {
  if (mode == kPartials)
    return launch_vec<T, float, kPartials, SELECT>(
        vec, vals, mask, weights, nullptr, out, den, n, a, c, b, mask_c, s);
  if (mode != kMean) return cudaErrorInvalidValue;
  if (out_dtype == feddd::kFloat32)
    return launch_vec<T, float, kMean, SELECT>(
        vec, vals, mask, weights, gprev, out, nullptr, n, a, c, b, mask_c, s);
  if (out_dtype == feddd::kBFloat16)
    return launch_vec<T, __nv_bfloat16, kMean, SELECT>(
        vec, vals, mask, weights, gprev, out, nullptr, n, a, c, b, mask_c, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_select(int select, int mode, int out_dtype, int vec,
                          const void* vals, const void* mask,
                          const float* weights, const void* gprev, void* out,
                          float* den, int64_t n, int64_t a, int64_t c,
                          int64_t b, int64_t mask_c, cudaStream_t s) {
  if (select)
    return launch_mode<T, true>(mode, out_dtype, vec, vals, mask, weights,
                                gprev, out, den, n, a, c, b, mask_c, s);
  return launch_mode<T, false>(mode, out_dtype, vec, vals, mask, weights,
                               gprev, out, den, n, a, c, b, mask_c, s);
}

}  // namespace

// vals: (N, A, C, B) contiguous, dtype code `dtype`; mask: (N, mask_c) with
// mask_c in {C, 1, A * C * B} (channel, all-ones, elementwise), same dtype;
// weights: (N,) fp32.  `vec` elements per access, 1, 2 or 4 (divides C
// where B == 1, else B; the pointers aligned to it; an elementwise mask
// comes with B == 1).
// mode 0 (partials): out = num and den, (A, C, B) fp32; gprev unused.
// mode 1 (mean): out (A, C, B) in `out_dtype`; gprev (A, C, B) in
// `out_dtype` or null; den unused.
// select != 0: a term whose mask is 0 adds nothing to num (both modes).
extern "C" int feddd_sparse_agg(const void* vals, const void* mask,
                                const void* weights, const void* gprev,
                                void* out, void* den, int64_t n, int64_t a,
                                int64_t c, int64_t b, int64_t mask_c,
                                int vec, int mode, int select, int dtype,
                                int out_dtype, void* stream) {
  const int64_t inner = b == 1 ? c : b;
  const int64_t size = a * c * b;
  const bool elementwise = mask_c == size && size != c && size != 1;
  if (n <= 0 || size <= 0 ||
      (mask_c != c && mask_c != 1 && !(elementwise && b == 1)) || vec < 1 ||
      inner % vec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(weights);
  float* d = static_cast<float*>(den);
  cudaError_t err;
  if (dtype == feddd::kFloat32) {
    err = launch_select<float>(select, mode, out_dtype, vec, vals, mask, w,
                               gprev, out, d, n, a, c, b, mask_c, s);
  } else if (dtype == feddd::kBFloat16) {
    err = launch_select<__nv_bfloat16>(select, mode, out_dtype, vec, vals,
                                       mask, w, gprev, out, d, n, a, c, b,
                                       mask_c, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
