// Causal / sliding-window GQA flash attention on Hopper, on the CUDA cores:
// the exact-fp32 route.
//
// Replaces the Pallas TPU kernel flash_attention (body _flash_kernel) in
// src/repro/kernels/flash_attention/flash_attention.py, and the transpose
// copies its wrapper makes around the call, for fp32 inputs at every head
// dim and for bf16 inputs at head dims 16, 32, 48 and 96.  bf16 at head dims
// 64-256 (every full-width config's) goes to flash_attention_sm90.cu, the
// tensor-core kernel; kernels/flash_attention/ops.py routes.
//
//   out[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, kvh] * scale) v[b, j, kvh]
//
// kvh = h / (H / Hkv) (GQA), scale = 1/sqrt(hd).  Query i attends key j iff
// j < Skv and (not causal or j <= i) and (window == 0 or j > i - window).
// q is scaled in fp32 before the dot; scores, the running max m, the running
// sum l and the accumulator are fp32; masked scores are NEG_INF (finite), the
// output is acc / max(l, 1e-30) in q's dtype — the TPU kernel's arithmetic.
//
// Bound: operations.  4 * hd flops per unmasked (query, key) pair against
// (Sq + 2 Skv) * H * hd inputs: at S = 32768, hd = 128 that is thousands of
// flops per byte.
// Design (fp32 products, so exact to fp32 rounding; no tensor cores):
// - one CTA of 256 threads per (batch * head, 64-query tile); a loop over
//   64-key tiles takes the place of the TPU grid's sequential KV axis, with
//   m, l and the 64 x hd accumulator in registers across it;
// - q/k/v are read in place in their (B, S, H, hd) layout through strides,
//   so the TPU wrapper's (B*H, S, hd) transpose copies are never made;
// - the KV loop runs only over the tiles that hold a key some query of the
//   tile may attend (the causal/window band): for a causal 32k prefill that
//   halves the work, for a 1024-wide window it cuts it ~30x.  A skipped tile
//   holds only masked keys, which the TPU kernel washes out through
//   corr = exp(NEG_INF - m) = 0, so the result is the same;
// - Q (pre-scaled), K and V tiles are staged in shared memory as fp32 with
//   rows padded to hd + 4 floats (float4 reads, no bank conflicts), the
//   probabilities P in a 64 x 68 tile; both products run as fp32 FMA on the
//   CUDA cores: each thread owns 4 query rows x 4 keys of S and 4 query rows
//   x hd/16 columns of the output, and row max / sum are shuffles across the
//   16 threads that share a row.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;         // queries per CTA
constexpr int kBK = 64;         // keys per KV tile
constexpr int kThreads = 256;   // 16 x 16 threads
constexpr int kLDP = kBK + 4;   // row stride of the P tile (floats)
constexpr float kNegInf = -2.3819763e38f;

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(kBQ + 2 * kBK) * (HD + 4) + kBQ * kLDP);
}

// Rows [r0, r0 + 64) of one head of x (row stride `ss`, element stride 1)
// into a 64 x (HD + 4) fp32 tile, times `mul`; rows >= n are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int64_t ss, int64_t r0, int64_t n,
                                          float mul) {
  constexpr int kPer = kBK * HD / kThreads;
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int i = threadIdx.x + t * kThreads;
    const int r = i / HD;
    const int d = i - r * HD;
    const int64_t row = r0 + r;
    dst[r * (HD + 4) + d] =
        row < n ? feddd::to_f32(src[row * ss + d]) * mul : 0.f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int h, int hkv,
                 int64_t sq, int64_t skv, int64_t qsb, int64_t qss,
                 int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
                 int64_t vsb, int64_t vss, int64_t vsh, int causal,
                 int64_t window, float scale) {
  constexpr int LD = HD + 4;
  constexpr int NC = HD / 16;   // output columns per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [kBQ][LD]
  float* ks = qs + kBQ * LD;                     // [kBK][LD]
  float* vs = ks + kBK * LD;                     // [kBK][LD]
  float* ps = vs + kBK * LD;                     // [kBQ][kLDP]

  const int tx = threadIdx.x % 16;   // key / output-column group
  const int ty = threadIdx.x / 16;   // query rows ty*4 .. ty*4+3
  const int bh = blockIdx.y;
  const int b = bh / h;
  const int hh = bh - b * h;
  const int kvh = hh / (h / hkv);
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kBQ;

  const T* qb = q + b * qsb + hh * qsh;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;

  // KV tiles holding a key that some query of [q0, q_last] attends.
  const int64_t q_last = (q0 + kBQ < sq ? q0 + kBQ : sq) - 1;
  int64_t j_lo = 0;
  int64_t j_hi = (skv + kBK - 1) / kBK - 1;
  if (causal && q_last / kBK < j_hi) j_hi = q_last / kBK;
  if (window > 0 && q0 - window + 1 > 0) j_lo = (q0 - window + 1) / kBK;

  load_tile<T, HD>(qs, qb, qss, q0, sq, scale);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int64_t j = j_lo; j <= j_hi; ++j) {
    const int64_t k0 = j * kBK;
    __syncthreads();   // the previous tile's K, V and P are consumed
    load_tile<T, HD>(ks, kb, kss, k0, skv, 1.f);
    load_tile<T, HD>(vs, vb, vss, k0, skv, 1.f);
    __syncthreads();

    // S = (q * scale) . k^T for rows ty*4+i, keys tx + 16*jj
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&qs[(ty * 4 + i) * LD + d]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        kv[jj] = *reinterpret_cast<const float4*>(&ks[(tx + 16 * jj) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float a = s[i][jj];
          a = fmaf(qv[i].x, kv[jj].x, a);
          a = fmaf(qv[i].y, kv[jj].y, a);
          a = fmaf(qv[i].z, kv[jj].z, a);
          a = fmaf(qv[i].w, kv[jj].w, a);
          s[i][jj] = a;
        }
    }

    // mask, online softmax, P to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t row = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int64_t col = k0 + tx + 16 * jj;
        bool ok = row < sq && col < skv;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && col > row - window;
        if (!ok) s[i][jj] = kNegInf;
        mx = fmaxf(mx, s[i][jj]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[i][jj] - m_new);
        sum += p;
        ps[(ty * 4 + i) * kLDP + tx + 16 * jj] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc += P . V for rows ty*4+i, columns tx + 16*c
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&ps[(ty * 4 + i) * kLDP + kk]);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float v0 = vs[(kk + 0) * LD + tx + 16 * c];
        const float v1 = vs[(kk + 1) * LD + tx + 16 * c];
        const float v2 = vs[(kk + 2) * LD + tx + 16 * c];
        const float v3 = vs[(kk + 3) * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float a = acc[i][c];
          a = fmaf(pv[i].x, v0, a);
          a = fmaf(pv[i].y, v1, a);
          a = fmaf(pv[i].z, v2, a);
          a = fmaf(pv[i].w, v3, a);
          acc[i][c] = a;
        }
      }
    }
  }

  // out is (B, Sq, H, HD) contiguous
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* o = out + ((b * sq + row) * h + hh) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      o[tx + 16 * c] = feddd::from_f32<T>(acc[i][c] * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int64_t b,
           int64_t sq, int64_t skv, int h, int hkv, const int64_t* st,
           int causal, int64_t window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kern = flash_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(feddd::blocks_for(sq, kBQ), static_cast<unsigned int>(b * h));
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD)));
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), h, hkv, sq, skv, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                void* out, int64_t b, int64_t sq, int64_t skv, int h, int hkv,
                const int64_t* st, int causal, int64_t window,
                cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, out, b, sq, skv, h, hkv, st, causal, window, s);
    case 32: return launch<T, 32>(q, k, v, out, b, sq, skv, h, hkv, st, causal, window, s);
    case 48: return launch<T, 48>(q, k, v, out, b, sq, skv, h, hkv, st, causal, window, s);
    case 96: return launch<T, 96>(q, k, v, out, b, sq, skv, h, hkv, st, causal, window, s);
    default: break;
  }
  // bf16 at the head dims below takes the tensor-core kernel
  if constexpr (sizeof(T) == 4) {
    switch (hd) {
      case 64: return launch<T, 64>(q, k, v, out, b, sq, skv, h, hkv, st, causal, window, s);
      case 128: return launch<T, 128>(q, k, v, out, b, sq, skv, h, hkv, st, causal, window, s);
      case 192: return launch<T, 192>(q, k, v, out, b, sq, skv, h, hkv, st, causal, window, s);
      case 256: return launch<T, 256>(q, k, v, out, b, sq, skv, h, hkv, st, causal, window, s);
      default: break;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q: (B, Sq, H, hd), k/v: (B, Skv, Hkv, hd), any strides over (B, S, H) and
// unit stride over hd, given in elements; out: (B, Sq, H, hd) contiguous.
// hd in {16, 32, 48, 64, 96, 128, 192, 256} for fp32, {16, 32, 48, 96} for
// bf16; H divisible by Hkv.
extern "C" int feddd_flash_attention(
    const void* q, const void* k, const void* v, void* out, int64_t b,
    int64_t sq, int64_t skv, int64_t h, int64_t hkv, int64_t hd, int64_t qsb,
    int64_t qss, int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
    int64_t vsb, int64_t vss, int64_t vsh, int causal, int64_t window,
    int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || h <= 0 || hkv <= 0 || h % hkv != 0 ||
      b * h > 65535 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hi = static_cast<int>(h), hkvi = static_cast<int>(hkv);
  const int hdi = static_cast<int>(hd);
  if (dtype == feddd::kFloat32)
    return dispatch_hd<float>(hdi, q, k, v, out, b, sq, skv, hi, hkvi, st,
                              causal, window, s);
  if (dtype == feddd::kBFloat16)
    return dispatch_hd<__nv_bfloat16>(hdi, q, k, v, out, b, sq, skv, hi, hkvi,
                                      st, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
