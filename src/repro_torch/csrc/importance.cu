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
// A block owns a tile of 32 channels of one client.  Where the channel
// axis is last (B == 1, every FL leaf) a thread loads V consecutive
// channels of a row as one 16-byte (or 8-, 4-byte) access: 32 / V threads
// cover a row of the tile, a warp reads V rows of it at once (fp32: 4 rows
// of 128 bytes), and the block's 256 / (32 / V) row slices split the
// fan-in rows among them; a thread issues the loads of 4 rows back to back
// before it sums them in row order.  The division is __fdividef (2 ulp;
// |denom| >= 1e-8 keeps it in range): an IEEE division costs ~20
// instructions per element, which at bf16 is as long as the bytes take.  At the FedDD shapes N * ceil(C / 32)
// is far below the 132 SMs (fc0: 40 blocks), so the fan-in is also split
// ACROSS blocks: the S <= 8 blocks that share one (client, tile) form a
// thread-block cluster, each reduces a contiguous slice of the rows into
// shared memory, and after cluster.sync() rank 0 sums the S partials
// through distributed shared memory in rank order, then applies sqrt and
// the coverage division.  One launch, no scratch, no atomics, and a fixed
// summation order: the same inputs give the same bits on every launch.
// S comes from the wrapper's work plan (kernels/importance/ops.py), which
// targets 2-4 blocks per SM but splits no further than leaves each thread
// a full step of 4 rows; at S = 1 the launch is a plain one, without a
// cluster.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;   // per block
constexpr int kTile = 32;       // channels per block
constexpr int kMaxSplits = 8;   // blocks per cluster (the portable limit)
constexpr int kUnroll = 4;      // rows in flight per thread
constexpr float kEps = 1e-8f;

template <typename T, int V>
__device__ __forceinline__ void accumulate(float (&acc)[V],
                                           const feddd::Vec<T, V>& wo_v,
                                           const feddd::Vec<T, V>& wn_v) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float wo = feddd::to_f32(wo_v.v[j]);
    const float wn = feddd::to_f32(wn_v.v[j]);
    const float dw = wn - wo;
    const float denom = fabsf(wo) < kEps ? (wo < 0.f ? -kEps : kEps) : wo;
    const float imp = fabsf(__fdividef(dw * wn, denom));
    acc[j] += imp * imp;
  }
}

// CLUSTER: the launch splits the fan-in over a cluster of `splits` blocks;
// otherwise one block reduces all rows of its tile (splits == 1).
template <typename T, int V, bool CLUSTER>
__global__ void __launch_bounds__(kThreads)
    importance_kernel(const T* __restrict__ w_old,
                      const T* __restrict__ w_new,
                      const float* __restrict__ coverage,
                      float* __restrict__ out, int64_t a, int64_t c,
                      int64_t b, int splits) {
  constexpr int kLanes = kTile / V;            // threads along C
  constexpr int kSlices = kThreads / kLanes;   // row slices per block
  __shared__ float partial[kSlices][kTile];
  __shared__ float block_sum[kTile];

  int split = 0;
  if constexpr (CLUSTER)
    split = static_cast<int>(cg::this_cluster().block_rank());
  const int lane = threadIdx.x % kLanes;
  const int slice = threadIdx.x / kLanes;
  const int64_t n = blockIdx.z;
  const int64_t tile0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const int64_t c0 = tile0 + lane * V;
  const int64_t rows = a * b;
  // this block's rows: [rows * s / S, rows * (s + 1) / S)
  const int64_t r_end = rows * (split + 1) / splits;

  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
  if (c0 < c) {
    const T* po = w_old + n * rows * c;
    const T* pn = w_new + n * rows * c;
    auto offset = [&](int64_t r) -> int64_t {
      if (b == 1) return r * c + c0;
      const int64_t ia = r / b;
      return (ia * c + c0) * b + (r - ia * b);
    };
    // kUnroll rows per step, their loads issued back to back (predicated
    // at the end), then summed in row order
    for (int64_t r = rows * split / splits + slice; r < r_end;
         r += kUnroll * kSlices) {
      feddd::Vec<T, V> o[kUnroll], w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u * kSlices < r_end) {
          const int64_t off = offset(r + u * kSlices);
          o[u] = feddd::load_vec<T, V>(po + off);
          w[u] = feddd::load_vec<T, V>(pn + off);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (r + u * kSlices < r_end) accumulate<T, V>(acc, o[u], w[u]);
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) partial[slice][lane * V + j] = acc[j];
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x < kTile) {
#pragma unroll 8
    for (int y = 0; y < kSlices; ++y) s += partial[y][threadIdx.x];
    if constexpr (CLUSTER) block_sum[threadIdx.x] = s;
  }
  if constexpr (CLUSTER) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();   // every split's block_sum is written and visible
    if (split == 0 && threadIdx.x < kTile) {
      s = 0.f;
      for (int k = 0; k < splits; ++k)
        s += cluster.map_shared_rank(block_sum, k)[threadIdx.x];
    }
  }
  const int64_t ch = tile0 + threadIdx.x;
  if (split == 0 && threadIdx.x < kTile && ch < c) {
    float score = sqrtf(s);
    if (coverage != nullptr) score = score / fmaxf(coverage[ch], kEps);
    out[n * c + ch] = score;
  }
  // no block leaves while rank 0 may read its shared memory
  if constexpr (CLUSTER) cg::this_cluster().sync();
}

template <typename T, int V>
cudaError_t launch(const void* w_old, const void* w_new,
                   const float* coverage, float* out, int64_t n, int64_t a,
                   int64_t c, int64_t b, int splits, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned int>(splits),
                  feddd::blocks_for(c, kTile), static_cast<unsigned int>(n));
  const T* wo = static_cast<const T*>(w_old);
  const T* wn = static_cast<const T*>(w_new);
  if (splits == 1) {
    importance_kernel<T, V, false><<<grid, kThreads, 0, stream>>>(
        wo, wn, coverage, out, a, c, b, splits);
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(splits);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, importance_kernel<T, V, true>, wo, wn,
                            coverage, out, a, c, b, splits);
}

template <typename T>
cudaError_t launch_vec(int vec, const void* w_old, const void* w_new,
                       const float* coverage, float* out, int64_t n,
                       int64_t a, int64_t c, int64_t b, int splits,
                       cudaStream_t s) {
  switch (vec) {
    case 1:
      return launch<T, 1>(w_old, w_new, coverage, out, n, a, c, b, splits, s);
    case 2:
      return launch<T, 2>(w_old, w_new, coverage, out, n, a, c, b, splits, s);
    case 4:
      return launch<T, 4>(w_old, w_new, coverage, out, n, a, c, b, splits, s);
    case 8:
      if constexpr (sizeof(T) == 2)
        return launch<T, 8>(w_old, w_new, coverage, out, n, a, c, b, splits,
                            s);
      break;
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// w_old, w_new: (N, A, C, B) contiguous, dtype code `dtype`;
// coverage: (C,) fp32 or null; out: (N, C) fp32.  `vec` channels per
// access (1 unless B == 1; divides C; the pointers aligned to it) and
// `splits` fan-in splits per (client, tile), 1..8, from the work plan.
extern "C" int feddd_importance(const void* w_old, const void* w_new,
                                const void* coverage, void* out, int64_t n,
                                int64_t a, int64_t c, int64_t b, int vec,
                                int splits, int dtype, void* stream) {
  if (n <= 0 || c <= 0 || n > 65535 || feddd::blocks_for(c, kTile) > 65535 ||
      splits < 1 || splits > kMaxSplits || vec < 1 || c % vec != 0 ||
      (vec > 1 && b != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* cov = static_cast<const float*>(coverage);
  float* o = static_cast<float*>(out);
  cudaError_t err;
  if (dtype == feddd::kFloat32) {
    err = launch_vec<float>(vec, w_old, w_new, cov, o, n, a, c, b, splits, s);
  } else if (dtype == feddd::kBFloat16) {
    err = launch_vec<__nv_bfloat16>(vec, w_old, w_new, cov, o, n, a, c, b,
                                    splits, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
