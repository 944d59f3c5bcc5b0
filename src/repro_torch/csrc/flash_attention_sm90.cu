// Causal / sliding-window GQA flash attention for Hopper: bf16 operands on
// the tensor cores (wgmma), tiles brought in by the TMA.
//
// Replaces the Pallas TPU kernel flash_attention (body _flash_kernel) in
// src/repro/kernels/flash_attention/flash_attention.py for bf16 inputs at
// head dims 64, 128, 192 and 256 (kernels/flash_attention/ops.py routes
// there; fp32 and the other head dims stay on flash_attention.cu).
//
//   out[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, kvh] / sqrt(hd)) v[b, j, kvh]
//
// kvh = h / (H / Hkv).  Query i attends key j iff j < Skv and (not causal or
// j <= i) and (window == 0 or j > i - window).  Masked scores are NEG_INF
// (finite), the running max m, sum l and the accumulator are fp32, the
// output is acc / max(l, 1e-30) in bf16 (as acc times the reciprocal, to
// ~1 fp32 ulp): the TPU kernel's arithmetic, with two roundings it does not
// make (below).
//
// Bound: operations.  4 * hd flops per unmasked (query, key) pair
// (ref.valid_pairs) against (Sq + 2 Skv) * H * hd bf16 inputs: at S = 32768,
// hd = 128 a causal layer is ~9 TFLOP over 0.8 GB, far above the card's
// ~300 flops per byte.  What the design does about it:
//
// 1. wgmma for both products, bf16 operands, fp32 accumulators.  One CTA
//    holds 128 queries of one (batch, head); each of two consumer
//    warpgroups owns 64 of them.  S = Q.K^T is wgmma.m64nBKk16 with Q and
//    K in shared memory (K-major).  O += P.V takes P in registers as the A
//    operand: the fp32 score accumulator's layout is the bf16 A fragment's,
//    so P is converted in place and never goes through shared memory.  V
//    is the B operand in its (key, hd) layout, read MN-major (trans-b).
// 2. TMA loads: one thread of a producer warpgroup loads the Q tile once
//    and the K/V tiles into a ring of 2 stages, with mbarrier completion
//    (full: bytes landed; empty: the 8 consumer warps are done with the
//    stage).  q/k/v are read in place through 4-d tensor maps over
//    (hd, H, S, B) built per call from the wrapper's strides; a bf16 row of
//    hd values is hd/64 boxes of 128 bytes, with the 128-byte swizzle the
//    wgmma descriptors name.  Rows past Sq or Skv arrive as zeros.  The
//    producer warpgroup drops to 24 registers (setmaxnreg), the consumers
//    rise to 240, so the 64 x hd fp32 output, the 64 x BK fp32 scores and
//    the bf16 P stay in registers.
// 3. Tiles: BK = 128 keys at hd <= 128, 64 at hd 192 and 256.  hd 128:
//    Q 32 KB + 2 stages x (K + V) 64 KB = 160 KB of shared memory.
// 4. The online softmax stays in fp32, in registers.  A thread holds two
//    rows of its warpgroup's 64 (lanes 4r..4r+3 share a row); row max and
//    row sum are reduced across those 4 lanes.  The scale moves from q to
//    the scores: x = (q.k) * log2(e) / sqrt(hd) in fp32, p = 2^(x - m).  It
//    differs from the TPU kernel's (q * scale).k by fp32 rounding.  l sums
//    the fp32 p; P.V uses p rounded to bf16 (relative error <= 2^-9 per
//    term, independent across keys, so the output moves by ~2^-9 |v| /
//    sqrt(keys): well inside the bf16 output's own half-ulp).
// 5. Mask work only where a tile may hold a masked pair: a tile inside the
//    band, below the diagonal and inside Skv, skips the compares.  As in
//    flash_attention.cu, the KV loop runs only over the tiles of the band of
//    the CTA's rows, and a warpgroup whose 64 rows attend no key of a tile
//    skips its products (it still releases the stage).  A causal launch
//    takes its query tiles heaviest first (the last tile first), so the
//    long CTAs do not form the tail.

#include <cuda.h>   // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kBQ = 128;               // queries per CTA
constexpr int kConsumers = 2;          // consumer warpgroups, 64 queries each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kStages = 2;             // K/V ring
constexpr int kRow = 128;              // bytes of one swizzled box row (64 bf16)
constexpr float kNegInf = -2.3819763e38f;

template <int HD>
struct Tiles {
  static constexpr int BK = HD <= 128 ? 128 : 64;      // keys per KV tile
  static constexpr int kQBytes = kBQ * HD * 2;
  static constexpr int kKVBytes = BK * HD * 2;         // one of K, V
  static constexpr int kBarOffset = kQBytes + kStages * 2 * kKVBytes;
  // barriers: q_full, full[kStages], empty[kStages]; + 1 KB to align the
  // base to the 1024-byte swizzle atom
  static constexpr int kSmem = kBarOffset + 8 * (1 + 2 * kStages) + 1024;
};
static_assert(Tiles<256>::kSmem <= 232448, "too much shared memory");

// ------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// Wait until the barrier has completed the phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// The producer's wait for a free stage.  It lasts microseconds; one that
// lasts ~2^35 cycles (~17 s) is a broken pipeline (consumers stuck on data
// that never lands stop freeing stages too), and traps — a launch error —
// rather than hang the card.  It fires only in a CTA with more KV tiles
// than stages: a CTA of at most kStages tiles never waits for a free stage,
// so if one of its loads never lands its consumers spin and the launch
// hangs.  Only the producer watches: the clock and the trap path in the
// consumers' waits spill the hd-256 accumulators.
__device__ __forceinline__ void mbar_wait_or_trap(uint32_t bar,
                                                  uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

// One box of a 4-d tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle.  K-major operands (Q,
// K): rows of 128 bytes, 8-row atoms 1024 bytes apart (SBO), LBO unused.
// MN-major V: LBO is the distance between 64-column boxes, SBO between
// 8-key atoms.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving register accesses across a wgmma fence or
// wait (the async unit reads and writes these registers).
template <int N>
__device__ __forceinline__ void pin(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 1/x to ~1 ulp in one MUFU op: the epilogue multiplies each of a row's
// outputs by it instead of dividing each.
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A in registers, B MN-major in
// shared memory (trans-b).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A in registers, B MN-major in
// shared memory (trans-b).
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O[64 x HD] += P[64 x 16] . V[16 keys x HD]; v_addr: the 16 keys' rows of
// the V stage's first box.
template <int HD, int BK>
__device__ __forceinline__ void pv_step(float* o, const uint32_t* a,
                                        uint32_t v_addr) {
  constexpr uint32_t kBox = BK * kRow;   // next 64 columns of hd (LBO)
  const uint64_t d0 = sw128_desc(v_addr, kBox, 8 * kRow);
  if constexpr (HD == 64) {
    wgmma_rs_n64(o, a, d0);
  } else {
    wgmma_rs_n128(o, a, d0);
    const uint64_t d1 = sw128_desc(v_addr + 2 * kBox, kBox, 8 * kRow);
    if constexpr (HD == 192) wgmma_rs_n64(o + 64, a, d1);
    if constexpr (HD == 256) wgmma_rs_n128(o + 64, a, d1);
  }
}

// -------------------------------------------------------------- the kernel

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      __nv_bfloat16* __restrict__ out, int h, int group,
                      int sq, int skv, int causal, int window,
                      float scale_log2) {
  using T = Tiles<HD>;
  constexpr int BK = T::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_smem = base;                      // box c: + c * kBQ * kRow
  const uint32_t kv_smem = base + T::kQBytes;        // stage s: K, then V
  const uint32_t q_full = base + T::kBarOffset;
  const uint32_t full0 = q_full + 8;                 // + 8 * stage
  const uint32_t empty0 = full0 + 8 * kStages;       // + 8 * stage

  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int bb = blockIdx.y / h;
  const int hh = blockIdx.y - bb * h;
  const int kvh = hh / group;
  const int q0 = tile * kBQ;

  // KV tiles holding a key that some query of [q0, q_last] attends
  const int q_last = min(q0 + kBQ, sq) - 1;
  int j_hi = (skv - 1) / BK;
  if (causal) j_hi = min(j_hi, q_last / BK);
  const int j_lo = (window > 0 && q0 - window + 1 > 0) ? (q0 - window + 1) / BK
                                                        : 0;
  const int ntiles = j_hi - j_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * kConsumers);   // one arrive per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kConsumers) {
    // ---------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(q_full, T::kQBytes);
#pragma unroll
      for (int c = 0; c < HD / 64; ++c)
        tma_load_4d(q_smem + c * kBQ * kRow, &tm_q, q_full, c * 64, hh, q0, bb);
      for (int n = 0; n < ntiles; ++n) {
        const int stage = n % kStages;
        const uint32_t k_smem = kv_smem + stage * 2 * T::kKVBytes;
        const uint32_t v_smem = k_smem + T::kKVBytes;
        const uint32_t full = full0 + 8 * stage;
        mbar_wait_or_trap(empty0 + 8 * stage, ((n / kStages) & 1) ^ 1);
        mbar_expect_tx(full, 2 * T::kKVBytes);
        const int k0 = (j_lo + n) * BK;
#pragma unroll
        for (int c = 0; c < HD / 64; ++c) {
          tma_load_4d(k_smem + c * BK * kRow, &tm_k, full, c * 64, kvh, k0, bb);
          tma_load_4d(v_smem + c * BK * kRow, &tm_v, full, c * 64, kvh, k0, bb);
        }
      }
    }
  } else {
    // ---------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int r0 = q0 + 64 * wg;                   // this warpgroup's rows
    const int ra = r0 + 16 * warp + lane / 4;      // this thread's: ra, ra + 8
    const int cq = 2 * (lane % 4);                 // columns cq, cq + 1 of 8
    const uint32_t q_wg = q_smem + 64 * wg * kRow;

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

    mbar_wait(q_full, 0);
    for (int n = 0; n < ntiles; ++n) {
      const int stage = n % kStages;
      const uint32_t k_smem = kv_smem + stage * 2 * T::kKVBytes;
      const uint32_t v_smem = k_smem + T::kKVBytes;
      const int k0 = (j_lo + n) * BK;
      mbar_wait(full0 + 8 * stage, (n / kStages) & 1);
      const bool idle = r0 >= sq || (causal && k0 > r0 + 63) ||
                        (window > 0 && k0 + BK - 1 <= r0 - window);
      if (!idle) {
        // S = Q . K^T
        float s[BK / 2];
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
        pin<BK / 2>(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;   // 16 columns = 32 bytes
          const uint64_t da = sw128_desc(q_wg + (kk / 4) * kBQ * kRow + off,
                                         16, 8 * kRow);
          const uint64_t db = sw128_desc(k_smem + (kk / 4) * BK * kRow + off,
                                         16, 8 * kRow);
          if constexpr (BK == 128) wgmma_ss_n128(s, da, db, kk > 0);
          else wgmma_ss_n64(s, da, db, kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        pin<BK / 2>(s);

        // scale, mask, online softmax
        const bool edge = k0 + BK > skv || (causal && k0 + BK - 1 > r0) ||
                          (window > 0 && k0 <= r0 + 63 - window);
        float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
        for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float xa = s[4 * i + e] * scale_log2;
            float xb = s[4 * i + 2 + e] * scale_log2;
            if (edge) {
              const int col = k0 + 8 * i + cq + e;
              const bool in = col < skv;
              if (!(in && (!causal || col <= ra) &&
                    (window == 0 || col > ra - window)))
                xa = kNegInf;
              if (!(in && (!causal || col <= ra + 8) &&
                    (window == 0 || col > ra + 8 - window)))
                xb = kNegInf;
            }
            s[4 * i + e] = xa;
            s[4 * i + 2 + e] = xb;
            mx_a = fmaxf(mx_a, xa);
            mx_b = fmaxf(mx_b, xb);
          }
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
          mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
        }
        const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
        const float c_a = ex2(m_a - mn_a), c_b = ex2(m_b - mn_b);
        m_a = mn_a;
        m_b = mn_b;
        float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
        for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            s[4 * i + e] = ex2(s[4 * i + e] - mn_a);
            s[4 * i + 2 + e] = ex2(s[4 * i + 2 + e] - mn_b);
            sum_a += s[4 * i + e];
            sum_b += s[4 * i + 2 + e];
          }
        }
        // l is summed per thread and reduced over the row's 4 lanes at the end
        l_a = l_a * c_a + sum_a;
        l_b = l_b * c_b + sum_b;
#pragma unroll
        for (int i = 0; i < HD / 8; ++i) {
          o[4 * i] *= c_a;
          o[4 * i + 1] *= c_a;
          o[4 * i + 2] *= c_b;
          o[4 * i + 3] *= c_b;
        }

        // O += P . V, P (bf16) from registers
        uint32_t p[BK / 4];
#pragma unroll
        for (int t = 0; t < BK / 16; ++t)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            p[4 * t + r] = pack_bf16(s[8 * t + 2 * r], s[8 * t + 2 * r + 1]);
        pin<BK / 4>(p);
        pin<HD / 2>(o);
        wgmma_fence();
#pragma unroll
        for (int t = 0; t < BK / 16; ++t)
          pv_step<HD, BK>(o, p + 4 * t, v_smem + t * 16 * kRow);
        wgmma_commit();
        wgmma_wait_all();
        pin<HD / 2>(o);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);
    }

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
    const float inv_a = rcp(fmaxf(l_a, 1e-30f));
    const float inv_b = rcp(fmaxf(l_b, 1e-30f));
    // out is (B, Sq, H, HD) contiguous
    if (ra < sq) {
      __nv_bfloat16* row = out + ((static_cast<int64_t>(bb) * sq + ra) * h + hh) * HD;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * i + cq) =
            __floats2bfloat162_rn(o[4 * i] * inv_a, o[4 * i + 1] * inv_a);
    }
    if (ra + 8 < sq) {
      __nv_bfloat16* row =
          out + ((static_cast<int64_t>(bb) * sq + ra + 8) * h + hh) * HD;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * i + cq) =
            __floats2bfloat162_rn(o[4 * i + 2] * inv_b, o[4 * i + 3] * inv_b);
    }
  }
}

// ------------------------------------------------------------------ host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library links against nothing but the runtime.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (B, S, heads, hd) bf16 view with element strides (sb, ss, sh, 1) as a
// 4-d map over (hd, heads, S, B), boxes of 64 x 1 x rows x 1.  A stride of a
// dimension of size 1 is never followed; it is replaced by a packed one.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int64_t b,
            int64_t s, int64_t heads, int64_t hd, int64_t sb, int64_t ss,
            int64_t sh, uint32_t rows) {
  if (heads == 1) sh = hd;
  if (s == 1) ss = sh * heads;
  if (b == 1) sb = ss * s;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int64_t b,
           int64_t sq, int64_t skv, int64_t h, int64_t hkv, const int64_t* st,
           int causal, int64_t window, cudaStream_t stream) {
  using T = Tiles<HD>;
  EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  if (!encode(fn, &tq, q, b, sq, h, HD, st[0], st[1], st[2], kBQ) ||
      !encode(fn, &tk, k, b, skv, hkv, HD, st[3], st[4], st[5], T::BK) ||
      !encode(fn, &tv, v, b, skv, hkv, HD, st[6], st[7], st[8], T::BK))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_sm90_kernel<HD>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>((sq + kBQ - 1) / kBQ),
                  static_cast<unsigned int>(b * h));
  const float scale_log2 = static_cast<float>(
      1.4426950408889634 / std::sqrt(static_cast<double>(HD)));
  kern<<<grid, kThreads, T::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), static_cast<int>(h),
      static_cast<int>(h / hkv), static_cast<int>(sq), static_cast<int>(skv),
      causal, static_cast<int>(window), scale_log2);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// the stride of a dimension of size > 1 must be a multiple of 8 elements
// (16 bytes, the TMA's rule)
bool stride_ok(int64_t size, int64_t stride) {
  return size == 1 || (stride > 0 && stride % 8 == 0);
}

}  // namespace

// q: (B, Sq, H, hd), k/v: (B, Skv, Hkv, hd) bf16 with strides over (B, S, H)
// in elements (multiples of 8 where the size is > 1) and unit stride over
// hd, base pointers 16-byte aligned; out: (B, Sq, H, hd) bf16 contiguous.
// hd in {64, 128, 192, 256}; H divisible by Hkv.
extern "C" int feddd_flash_attention_sm90(
    const void* q, const void* k, const void* v, void* out, int64_t b,
    int64_t sq, int64_t skv, int64_t h, int64_t hkv, int64_t hd, int64_t qsb,
    int64_t qss, int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
    int64_t vsb, int64_t vss, int64_t vsh, int causal, int64_t window,
    void* stream) {
  const int64_t lim = INT_MAX - 2 * kBQ;
  if (b <= 0 || sq <= 0 || skv <= 0 || h <= 0 || hkv <= 0 || h % hkv != 0 ||
      b * h > 65535 || sq > lim || skv > lim || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out) ||
      !stride_ok(b, qsb) || !stride_ok(sq, qss) || !stride_ok(h, qsh) ||
      !stride_ok(b, ksb) || !stride_ok(skv, kss) || !stride_ok(hkv, ksh) ||
      !stride_ok(b, vsb) || !stride_ok(skv, vss) || !stride_ok(hkv, vsh))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (window > sq) window = sq;   // no narrower than unlimited for any row
  const int64_t st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch<64>(q, k, v, out, b, sq, skv, h, hkv, st, causal, window, s);
    case 128: return launch<128>(q, k, v, out, b, sq, skv, h, hkv, st, causal, window, s);
    case 192: return launch<192>(q, k, v, out, b, sq, skv, h, hkv, st, causal, window, s);
    case 256: return launch<256>(q, k, v, out, b, sq, skv, h, hkv, st, causal, window, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
