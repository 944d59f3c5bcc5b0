// Client-batched SAME convolutions on Hopper, for vmapped local SGD:
// the forward pass, the input gradient (dgrad) and the weight gradient
// (wgrad) of N clients' convolutions, each client with its own weights,
// one launch a pass for the whole fleet.
//
// Replaces no Pallas kernel: the JAX package leaves its convolutions to
// XLA.  It was added because torch.func.vmap of a client's training step
// turns each F.conv2d into one N-group cuDNN convolution, which cuDNN runs
// group by group with layout transposes around each group: some 2,100
// launches of a CNN2 step at N = 100 and ~12x the least time of the
// work (kernels/conv/ops.py routes the vmapped call here).
//
// Layouts: activations (N, B, C, H, W) read by strides (the images arrive
// as an NHWC view), weights W(n, ky, kx, c, o) read by strides (HWIO on
// the main path, OIHW as viewed), outputs written contiguous.  Float32 in,
// float32 FFMA (no TF32), float32 out; odd square kernels k, zero padding
// p = (k - 1) / 2, stride 1.  Every sum runs in a fixed order: a run
// repeats bit for bit.
//
// Forward: per client an implicit GEMM out[m, o] = sum_r A[m, r] W[r, o]
// with m = (b, y, x), r = (ky, kx, c): M = B H W, N = O, K = k k C.
// Bound: the FFMA rate (67 TFLOP/s) for the wide layers; the narrow ones
// (C = 3, O = 16) sit near the bytes bound.  Design: a block takes one
// client and a BM x BN tile of (m, o), BN the smallest of 16/32/64 that
// holds O (more tiles above 64), BM = 4096 / BN, so 256 threads hold 4 x 4
// outputs each (a warp 32 x 16: one 128-byte wavefront of shared memory
// per operand and step of the reduction, eight FFMAs per shared load).
// The reduction runs in steps of 8 rows, double-buffered through
// registers; each thread loads one pixel's column of A (the pixel found
// once, the (ky, kx, c) of each row from an 8-entry table the block
// writes once a step), so neighbouring threads read neighbouring pixels.
// The output is stored as float4 runs of four pixels.
//
// dgrad: the same kernel over the output gradient with the weights
// flipped in both taps and transposed (the wrapper passes negative tap
// strides from the last tap): no copy of the weights.
//
// wgrad: per client gW[r, o] = sum_m A[m, r] G[m, o], a reduction over
// B H W pixels (51,200 / 12,800 / 3,200 a client at CNN2's three convs)
// into a small k k C x O tile.  Bound: FFMA rate for the wide layers,
// bytes for the first.  Design: a block takes one client, a TR x TC tile
// (TR 32 or 64 rows, TC 16/32/64 channels) and one split of the pixels;
// its 8 warps form groups that each cover the tile and reduce their own
// runs of 8 pixels (the A and G chunks double-buffered through
// registers), then sum in the block in group order.  The splits (enough
// blocks to fill the card: ops.wgrad_plan) write partials that a second
// launch sums in split order: no float atomics.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kDepth = 8;       // reduction rows of a forward step
constexpr int kChunk = 8;       // pixels a wgrad group reduces a step
constexpr int kFar = 1 << 20;   // a row offset no image reaches
constexpr int64_t kMaxReduceBlocks = 1 << 16;   // the sum strides past them

struct Act {                    // (N, B, C, H, W) by strides
  const float* p;
  int64_t sn;                   // between clients (0: shared)
  int sb, sc, sh, sw;           // within a client: under 2^31
};

struct FpropArgs {
  Act x;
  const float* w;               // W(0, 0, 0, 0, 0)
  int64_t w_sn;
  int w_so, w_sc, w_sh, w_sw;   // output channel, input channel, ky, kx
  float* out;                   // (N, B, O, H, W)
  int b, c, h, w_, o, k, pad, kdim;   // kdim = k k C
};

struct WgradArgs {
  Act x, g;
  float* out;                   // (N, splits, k k C, O)
  int b, c, h, w_, o, k, pad, kdim;
  int splits, per_split;
};

__device__ __forceinline__ bool inside(int y, int x, int h, int w) {
  return static_cast<unsigned>(y) < static_cast<unsigned>(h) &&
         static_cast<unsigned>(x) < static_cast<unsigned>(w);
}

// acc[i][j] += a[i] * b[j] over one row of the reduction.
__device__ __forceinline__ void fma_4x4(float (&acc)[4][4], const float4 a,
                                        const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads)
    conv_fprop_kernel(const __grid_constant__ FpropArgs a) {
  constexpr int kWarpsM = BM / 32;
  static_assert(kWarpsM * (BN / 16) == kThreads / 32, "4 x 4 a thread");
  constexpr int kAStep = kThreads / BM;   // rows between a thread's A loads
  constexpr int kAPer = kDepth / kAStep;
  constexpr int kBPer = (kDepth * BN + kThreads - 1) / kThreads;

  __shared__ __align__(16) float As[2][kDepth][BM];
  __shared__ __align__(16) float Bs[2][kDepth][BN];
  __shared__ int4 tab[2][kDepth];   // per row: A offset, W offset, dy, dx

  const int tid = threadIdx.x;
  const int hw = a.h * a.w_;
  const int pixels = a.b * hw;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const float* __restrict__ x = a.x.p + blockIdx.z * a.x.sn;
  const float* __restrict__ w = a.w + blockIdx.z * a.w_sn;

  // the pixel whose A column this thread loads (kFar: past the last)
  const int lm = tid % BM, lk = tid / BM;
  int ly = kFar, lx = 0, lbase = 0;
  if (m0 + lm < pixels) {
    const int ib = (m0 + lm) / hw, pix = (m0 + lm) - ib * hw;
    ly = pix / a.w_;
    lx = pix - ly * a.w_;
    lbase = ib * a.x.sb + ly * a.x.sh + lx * a.x.sw;
  }

  auto fill_table = [&](int step, int buf) {
    if (tid < kDepth) {
      const int r = step * kDepth + tid;
      int4 e = make_int4(0, 0, kFar, 0);
      if (r < a.kdim) {
        const int ci = r % a.c, tap = r / a.c;
        const int ky = tap / a.k, kx = tap - ky * a.k;
        e = make_int4(
            ci * a.x.sc + (ky - a.pad) * a.x.sh + (kx - a.pad) * a.x.sw,
            ci * a.w_sc + ky * a.w_sh + kx * a.w_sw, ky - a.pad, kx - a.pad);
      }
      tab[buf][tid] = e;
    }
  };

  float ra[kAPer], rb[kBPer];
  auto load = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kAPer; ++i) {
      const int4 e = tab[buf][lk + i * kAStep];
      ra[i] = inside(ly + e.z, lx + e.w, a.h, a.w_) ? __ldg(x + lbase + e.x)
                                                    : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int idx = tid + i * kThreads;
      const int4 e = tab[buf][(idx / BN) % kDepth];
      const int n = n0 + idx % BN;
      rb[i] = (idx < kDepth * BN && e.z != kFar && n < a.o)
                  ? __ldg(w + e.y + n * a.w_so)
                  : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kAPer; ++i) As[buf][lk + i * kAStep][lm] = ra[i];
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < kDepth * BN) Bs[buf][idx / BN][idx % BN] = rb[i];
    }
  };

  const int warp = tid / 32, lane = tid % 32;
  const int row0 = (warp % kWarpsM) * 32 + (lane % 8) * 4;
  const int col0 = (warp / kWarpsM) * 16 + (lane / 8) * 4;
  float acc[4][4] = {};

  const int steps = (a.kdim + kDepth - 1) / kDepth;
  fill_table(0, 0);
  __syncthreads();
  load(0);
  store(0);
  if (steps > 1) fill_table(1, 1);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    if (s + 1 < steps) load(cur ^ 1);
#pragma unroll
    for (int r = 0; r < kDepth; ++r)
      fma_4x4(acc, *reinterpret_cast<const float4*>(&As[cur][r][row0]),
              *reinterpret_cast<const float4*>(&Bs[cur][r][col0]));
    if (s + 1 < steps) store(cur ^ 1);
    if (s + 2 < steps) fill_table(s + 2, cur);
    __syncthreads();
  }

  float* __restrict__ out =
      a.out + static_cast<int64_t>(blockIdx.z) * pixels * a.o;
  const int m = m0 + row0;
  if (hw % 4 == 0) {            // four pixels of one image, 16-byte aligned
    if (m < pixels) {
      const int ib = m / hw;
      float* o = out + ib * a.o * hw + (m - ib * hw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + col0 + j;
        if (n < a.o)
          *reinterpret_cast<float4*>(o + n * hw) =
              make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (m + i >= pixels) break;
      const int ib = (m + i) / hw;
      float* o = out + ib * a.o * hw + (m + i - ib * hw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + col0 + j;
        if (n < a.o) o[n * hw] = acc[i][j];
      }
    }
  }
}

template <int TR, int TC>
__global__ void __launch_bounds__(kThreads)
    conv_wgrad_kernel(const __grid_constant__ WgradArgs a) {
  constexpr int kWarpsR = TR / 32, kGroupWarps = kWarpsR * (TC / 16);
  constexpr int kGroups = kThreads / 32 / kGroupWarps;
  constexpr int kGT = 32 * kGroupWarps;      // threads of a group
  constexpr int kRowStep = kGT / kChunk;     // rows between a thread's loads
  constexpr int kAPer = TR / kRowStep, kGPer = TC / kRowStep;
  constexpr int kAS = TR + 4, kGS = TC + 4;  // padded rows: no conflicts
  constexpr int kASize = kGroups * 2 * kChunk * kAS;
  constexpr int kGSize = kGroups * 2 * kChunk * kGS;
  constexpr int kRedSize = (kGroups - 1) * TR * TC;
  static_assert(kAPer >= 1 && kGPer >= 1, "loads a thread");
  static_assert(kRedSize <= kASize + kGSize, "the group sums fit");

  __shared__ __align__(16) float smem[kASize + kGSize];
  float* const As = smem;                    // [group][buf][pixel][row]
  float* const Gs = smem + kASize;           // [group][buf][pixel][col]

  const int tid = threadIdx.x;
  const int grp = tid / kGT, gt = tid % kGT;
  const int tiles_r = (a.kdim + TR - 1) / TR;
  const int r0 = (blockIdx.x % tiles_r) * TR, c0 = (blockIdx.x / tiles_r) * TC;
  const float* __restrict__ x = a.x.p + blockIdx.z * a.x.sn;
  const float* __restrict__ g = a.g.p + blockIdx.z * a.g.sn;

  // the rows (A) and channels (G) this thread loads, fixed for the block
  const int lp = gt % kChunk, lr = gt / kChunk;
  int koff[kAPer], kdy[kAPer], kdx[kAPer], goff[kGPer];
#pragma unroll
  for (int i = 0; i < kAPer; ++i) {
    const int r = r0 + lr + i * kRowStep;
    koff[i] = 0;
    kdy[i] = kFar;
    kdx[i] = 0;
    if (r < a.kdim) {
      const int ci = r % a.c, tap = r / a.c;
      const int ky = tap / a.k, kx = tap - ky * a.k;
      koff[i] = ci * a.x.sc + (ky - a.pad) * a.x.sh + (kx - a.pad) * a.x.sw;
      kdy[i] = ky - a.pad;
      kdx[i] = kx - a.pad;
    }
  }
#pragma unroll
  for (int i = 0; i < kGPer; ++i) {
    const int n = c0 + lr + i * kRowStep;
    goff[i] = n < a.o ? n * a.g.sc : -1;
  }

  // this thread's pixel, walked by kGroups * kChunk pixels a step
  const int hw = a.h * a.w_;
  const int pixels = a.b * hw;
  const int begin = blockIdx.y * a.per_split;
  const int end = min(pixels, begin + a.per_split);
  constexpr int kStride = kGroups * kChunk;
  const int sb = kStride / hw, sy = (kStride % hw) / a.w_,
            sx = kStride % a.w_;
  int m = begin + grp * kChunk + lp;
  int ib = m / hw, iy = (m - ib * hw) / a.w_, ix = m - ib * hw - iy * a.w_;
  auto advance = [&]() {
    m += kStride;
    ix += sx;
    if (ix >= a.w_) {
      ix -= a.w_;
      ++iy;
    }
    iy += sy;
    if (iy >= a.h) {
      iy -= a.h;
      ++ib;
    }
    ib += sb;
  };

  float ra[kAPer], rg[kGPer];
  auto load = [&]() {
    const bool live = m < end;
    const int xb = ib * a.x.sb + iy * a.x.sh + ix * a.x.sw;
    const int gb = ib * a.g.sb + iy * a.g.sh + ix * a.g.sw;
#pragma unroll
    for (int i = 0; i < kAPer; ++i)
      ra[i] = live && inside(iy + kdy[i], ix + kdx[i], a.h, a.w_)
                  ? __ldg(x + xb + koff[i])
                  : 0.f;
#pragma unroll
    for (int i = 0; i < kGPer; ++i)
      rg[i] = live && goff[i] >= 0 ? __ldg(g + gb + goff[i]) : 0.f;
  };
  auto store = [&](int buf) {
    float* as = As + ((grp * 2 + buf) * kChunk + lp) * kAS;
    float* gs = Gs + ((grp * 2 + buf) * kChunk + lp) * kGS;
#pragma unroll
    for (int i = 0; i < kAPer; ++i) as[lr + i * kRowStep] = ra[i];
#pragma unroll
    for (int i = 0; i < kGPer; ++i) gs[lr + i * kRowStep] = rg[i];
  };

  const int warp = gt / 32, lane = gt % 32;
  const int row0 = (warp % kWarpsR) * 32 + (lane % 8) * 4;
  const int col0 = (warp / kWarpsR) * 16 + (lane / 8) * 4;
  float acc[4][4] = {};

  const int steps = (end - begin + kStride - 1) / kStride;
  load();
  store(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    if (s + 1 < steps) {
      advance();
      load();
    }
    const float* as = As + (grp * 2 + cur) * kChunk * kAS + row0;
    const float* gs = Gs + (grp * 2 + cur) * kChunk * kGS + col0;
#pragma unroll
    for (int p = 0; p < kChunk; ++p)
      fma_4x4(acc, *reinterpret_cast<const float4*>(as + p * kAS),
              *reinterpret_cast<const float4*>(gs + p * kGS));
    if (s + 1 < steps) store(cur ^ 1);
    __syncthreads();
  }

  // the groups' sums, added to group 0's in group order
  if (kGroups > 1) {
    if (grp > 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          smem[((grp - 1) * TR + row0 + i) * TC + col0 + j] = acc[i][j];
    }
    __syncthreads();
    if (grp > 0) return;
    for (int q = 0; q < kGroups - 1; ++q) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] += smem[(q * TR + row0 + i) * TC + col0 + j];
    }
  }
  float* __restrict__ out =
      a.out + (static_cast<int64_t>(blockIdx.z) * a.splits + blockIdx.y) *
                  a.kdim * a.o;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + row0 + i;
    if (r >= a.kdim) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = c0 + col0 + j;
      if (n < a.o) out[r * a.o + n] = acc[i][j];
    }
  }
}

// out[n, e] = sum over s in order of part[n, s, e]
__global__ void __launch_bounds__(kThreads)
    conv_wgrad_reduce_kernel(const float* __restrict__ part,
                             float* __restrict__ out, int64_t total,
                             int splits, int64_t each) {
  for (int64_t e = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t client = e / each;
    const float* p = part + client * splits * each + (e - client * each);
    float s = p[0];
    for (int q = 1; q < splits; ++q) s += p[q * each];
    out[e] = s;
  }
}

template <typename Args>
int launch(void (*kernel)(Args), dim3 grid, const Args& a, void* stream) {
  void* params[] = {const_cast<Args*>(&a)};
  cudaError_t err = cudaLaunchKernel(kernel, grid, dim3(kThreads), params, 0,
                                     static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <int BM, int BN>
int fprop(const FpropArgs& a, int64_t clients, void* stream) {
  const int pixels = a.b * a.h * a.w_;
  return launch(conv_fprop_kernel<BM, BN>,
                dim3((pixels + BM - 1) / BM, (a.o + BN - 1) / BN,
                     static_cast<unsigned>(clients)),
                a, stream);
}

template <int TR, int TC>
int wgrad(const WgradArgs& a, int64_t clients, void* stream) {
  const int tiles = ((a.kdim + TR - 1) / TR) * ((a.o + TC - 1) / TC);
  return launch(conv_wgrad_kernel<TR, TC>,
                dim3(tiles, a.splits, static_cast<unsigned>(clients)), a,
                stream);
}

Act act(const float* p, const int64_t* s) {
  return Act{p, s[0], static_cast<int>(s[1]), static_cast<int>(s[2]),
             static_cast<int>(s[3]), static_cast<int>(s[4])};
}

}  // namespace

// desc: clients, B, C, H, W, O, k, pad, x strides (client, b, c, h, w),
// weight strides (client, o, c, ky, kx).
extern "C" int feddd_conv_fprop(const float* x, const float* w, float* out,
                                const int64_t* d, void* stream) {
  FpropArgs a;
  a.x = act(x, d + 8);
  a.w = w;
  a.w_sn = d[13];
  a.w_so = static_cast<int>(d[14]);
  a.w_sc = static_cast<int>(d[15]);
  a.w_sh = static_cast<int>(d[16]);
  a.w_sw = static_cast<int>(d[17]);
  a.out = out;
  a.b = static_cast<int>(d[1]);
  a.c = static_cast<int>(d[2]);
  a.h = static_cast<int>(d[3]);
  a.w_ = static_cast<int>(d[4]);
  a.o = static_cast<int>(d[5]);
  a.k = static_cast<int>(d[6]);
  a.pad = static_cast<int>(d[7]);
  a.kdim = a.k * a.k * a.c;
  if (a.o <= 16) return fprop<256, 16>(a, d[0], stream);
  if (a.o <= 32) return fprop<128, 32>(a, d[0], stream);
  return fprop<64, 64>(a, d[0], stream);
}

// desc: clients, B, C, H, W, O, k, pad, x strides, g strides (client, b,
// c, h, w), splits, pixels a split.
extern "C" int feddd_conv_wgrad(const float* x, const float* g, float* out,
                                const int64_t* d, void* stream) {
  WgradArgs a;
  a.x = act(x, d + 8);
  a.g = act(g, d + 13);
  a.out = out;
  a.b = static_cast<int>(d[1]);
  a.c = static_cast<int>(d[2]);
  a.h = static_cast<int>(d[3]);
  a.w_ = static_cast<int>(d[4]);
  a.o = static_cast<int>(d[5]);
  a.k = static_cast<int>(d[6]);
  a.pad = static_cast<int>(d[7]);
  a.kdim = a.k * a.k * a.c;
  a.splits = static_cast<int>(d[18]);
  a.per_split = static_cast<int>(d[19]);
  const bool narrow = a.kdim <= 32;
  if (a.o <= 16) return narrow ? wgrad<32, 16>(a, d[0], stream)
                               : wgrad<64, 16>(a, d[0], stream);
  if (a.o <= 32) return narrow ? wgrad<32, 32>(a, d[0], stream)
                               : wgrad<64, 32>(a, d[0], stream);
  return narrow ? wgrad<32, 64>(a, d[0], stream)
                : wgrad<64, 64>(a, d[0], stream);
}

extern "C" int feddd_conv_wgrad_reduce(const float* part, float* out,
                                       int64_t clients, int splits,
                                       int64_t each, void* stream) {
  const int64_t total = clients * each;
  const int64_t blocks = std::min<int64_t>((total + kThreads - 1) / kThreads,
                                           kMaxReduceBlocks);
  void* params[] = {const_cast<float**>(&part), &out,
                    const_cast<int64_t*>(&total), &splits, &each};
  cudaError_t err = cudaLaunchKernel(
      conv_wgrad_reduce_kernel,
      dim3(static_cast<unsigned>(blocks)),
      dim3(kThreads), params, 0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
