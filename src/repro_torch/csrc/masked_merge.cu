// FedDD Eq. (5) client update on Hopper: every leaf of a client-stacked
// parameter pytree in one launch.
//
// Replaces the Pallas TPU kernel masked_merge_2d (body _merge_kernel) in
// src/repro/kernels/masked_merge/masked_merge.py.  The JAX engine computes
// Eq. (5) inline (src/repro/core/aggregation.py client_update_sparse); the
// port runs every client's update through this kernel.
//
//   out[n, e] = G[e] * M[n, ch(e)] + L[n, e] * (1 - M[n, ch(e)])
//
// computed in fp32 and stored in L's dtype (fp32 or bf16).  Each leaf is
// viewed as (N, A, C, B) (common.cuh); its mask is channel-shaped, (N, C_m)
// with C_m in {C, 1}, in L's dtype.
//
// Bound: bytes.  One read of the client-stacked L, one of the global G,
// the small mask, and one write of the output; three flops per element.
// Design:
// - One launch merges up to kMaxLeaves leaves of one dtype.  Their
//   descriptors travel by value in a __grid_constant__ parameter (no
//   host-to-device copy), in a table of 1, 8 or 32 rows, the smallest that
//   holds the group (a launch's time grows with its parameter's size).
//   Each leaf owns a run of tiles, in the order of the table; a block finds
//   its leaf by comparing its tile with every row's first tile (independent
//   loads of the parameter bank, uniform over the block).
// - A tile is kThreads vectors of the leaf's G times one chunk of at most
//   kClients clients; the chunks of one G vector are adjacent tiles, so G
//   is read from memory once and from L2 by the other chunks.  A thread
//   owns one vector (V consecutive elements: 16 bytes where the leaf
//   allows it, down to one element), reads it and finds its channel once,
//   issues the loads of L and of the mask of all its clients together, and
//   only then blends and stores them: one round trip to memory per block,
//   so blocks are short and the last wave is small.
// - V divides C where the channel axis is last (B == 1), else B, so the V
//   lanes of a vector have V consecutive channels of one mask row (read as
//   one vector) or share one channel.  Where C allows no wide vector the
//   leaf takes a narrow one (fc2's bias, 10 fp32: V = 2), in the same
//   kernel.  (Keeping V at 16 bytes and reading the mask in narrower
//   pieces, or lane by lane, measured slower on the H100: the extra mask
//   loads and registers cost more than the wider L accesses save.)
// - No 64-bit arithmetic per element and no division: a descriptor covers
//   fewer than 2^31 elements of each client leaf, and a vector's channel
//   and a block's tile come from magic-number divmods (constants from the
//   wrapper, as CUTLASS's FastDivmod).  A client leaf of 2^31 elements or
//   more takes one descriptor per client and per piece (the wrapper's
//   split_leaf: runs of whole rows, or of whole channels of a row), each
//   with its pointers moved to that client's piece and its mask to the
//   piece's first channel, so the kernel's code is the same for it.
// - L and the output stream past the caches (evict-first loads and
//   stores); G and the mask are read through the read-only path.
// - The blend is written with round-to-nearest intrinsics, so no FMA
//   contraction changes it: it equals the plain version for every mask
//   value, not only 0 and 1, and keeps its NaN propagation (NaN * 0 is
//   NaN); it is not a select that skips the unread operand.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;     // vectors of G per tile
constexpr int kClients = 4;       // clients per tile, their loads in flight
constexpr int kMaxLeaves = 32;    // descriptors per launch
constexpr int kFields = 18;       // int64 fields per leaf in the host table

struct LeafDesc {
  const void* g;       // (A, C, B)
  const void* l;       // (N, A, C, B)
  const void* mask;    // (N, C_m)
  void* out;           // (N, A, C, B)
  uint32_t n, size, vectors, c, b, mask_c;
  uint32_t vec;        // V, elements per access
  uint32_t tile_begin, chunk, chunks;    // first tile; clients per chunk
  // divmod constants of C, B and chunks (ops.divmod_constants)
  uint32_t c_mul, c_shr, b_mul, b_shr, k_mul, k_shr;
};

template <int L>
struct Group {
  LeafDesc leaf[L];
  int count;
};
static_assert(sizeof(Group<kMaxLeaves>) <= 4096,
              "the leaf table must stay a small kernel parameter");

// x / d for x < 2^31: __umulhi(x, mul) >> shr, with mul = ceil(2^p / d)
// and p = 31 + ceil(log2 d) (shr = p - 32); d == 1 is x itself.
__device__ __forceinline__ uint32_t fast_div(uint32_t x, uint32_t d,
                                             uint32_t mul, uint32_t shr) {
  return d == 1 ? x : __umulhi(x, mul) >> shr;
}

// Clients [k0, k1) of the vector at element e of one leaf; MASK_VEC: the
// lanes have consecutive channels (B == 1), else they share one.
template <typename T, int V, bool MASK_VEC>
__device__ __forceinline__ void merge_vector(const LeafDesc& d, uint32_t e,
                                             uint32_t k0, uint32_t k1) {
  const uint32_t mask_c = d.mask_c;
  uint32_t ch = 0;
  if (mask_c != 1) {
    const uint32_t row = d.b == 1 ? e : fast_div(e, d.b, d.b_mul, d.b_shr);
    ch = row - fast_div(row, d.c, d.c_mul, d.c_shr) * d.c;
  }
  float g[V];
  {
    const feddd::Vec<T, V> gv =
        feddd::load_vec_ldg<T, V>(static_cast<const T*>(d.g) + e);
#pragma unroll
    for (int j = 0; j < V; ++j) g[j] = feddd::to_f32(gv.v[j]);
  }
  const size_t stride = d.size;
  const T* lp = static_cast<const T*>(d.l) + e;
  T* op = static_cast<T*>(d.out) + e;
  const T* mp = static_cast<const T*>(d.mask) + ch;

  feddd::Vec<T, V> x[kClients];
  feddd::Vec<T, MASK_VEC ? V : 1> m[kClients];
#pragma unroll
  for (int u = 0; u < kClients; ++u) {
    if (k0 + u < k1) {
      const size_t k = k0 + u;
      x[u] = feddd::load_vec_cs<T, V>(lp + k * stride);
      m[u] = feddd::load_vec_ldg<T, MASK_VEC ? V : 1>(mp + k * mask_c);
    }
  }
#pragma unroll
  for (int u = 0; u < kClients; ++u) {
    if (k0 + u < k1) {
      float r[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float mj = feddd::to_f32(m[u].v[MASK_VEC ? j : 0]);
        const float lj = feddd::to_f32(x[u].v[j]);
        r[j] = __fadd_rn(__fmul_rn(g[j], mj),
                         __fmul_rn(lj, __fsub_rn(1.f, mj)));
      }
      feddd::store_f32_cs<T, V>(op + static_cast<size_t>(k0 + u) * stride,
                                r);
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ void merge_width(const LeafDesc& d, uint32_t e,
                                            uint32_t k0, uint32_t k1) {
  if constexpr (V > 1) {
    if (d.mask_c != 1 && d.b == 1) {
      merge_vector<T, V, true>(d, e, k0, k1);
      return;
    }
  }
  merge_vector<T, V, false>(d, e, k0, k1);
}

template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
    masked_merge_kernel(const __grid_constant__ Group<L> grp) {
  const uint32_t tile = blockIdx.x;
  int i = 0;   // the last leaf whose first tile is <= this one
#pragma unroll
  for (int j = 1; j < L; ++j)
    i += j < grp.count && grp.leaf[j].tile_begin <= tile;
  const LeafDesc& d = grp.leaf[i];
  const uint32_t local = tile - d.tile_begin;
  const uint32_t gchunk = fast_div(local, d.chunks, d.k_mul, d.k_shr);
  const uint32_t k0 = (local - gchunk * d.chunks) * d.chunk;
  const uint32_t v = gchunk * kThreads + threadIdx.x;
  if (v >= d.vectors) return;
  const uint32_t k1 = min(d.n, k0 + d.chunk);
  switch (d.vec) {
    case 1:
      merge_width<T, 1>(d, v, k0, k1);
      break;
    case 2:
      merge_width<T, 2>(d, 2 * v, k0, k1);
      break;
    case 4:
      merge_width<T, 4>(d, 4 * v, k0, k1);
      break;
    default:   // 8: bf16 only (16 bytes)
      if constexpr (sizeof(T) == 2) merge_width<T, 8>(d, 8 * v, k0, k1);
  }
}

bool aligned(const void* p, int64_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(bytes) == 0;
}

// One leaf of the host table -> its descriptor; false if the kernel does
// not take it.
bool fill_leaf(const int64_t* f, int64_t es, int64_t tile_begin,
               LeafDesc* d, int64_t* tiles) {
  const void* g = reinterpret_cast<const void*>(f[0]);
  const void* l = reinterpret_cast<const void*>(f[1]);
  const void* mask = reinterpret_cast<const void*>(f[2]);
  void* out = reinterpret_cast<void*>(f[3]);
  const int64_t n = f[4], a = f[5], c = f[6], b = f[7], mask_c = f[8];
  const int64_t vec = f[9], chunk = f[11];
  constexpr int64_t kLimit = int64_t{1} << 31;
  if (!g || !l || !mask || !out || n < 1 || n >= kLimit || a < 1 ||
      c < 1 || b < 1 || a >= kLimit || c >= kLimit || b >= kLimit)
    return false;
  const int64_t size = a * c * b;   // < 2^62: no overflow
  // a channel mask's row is the descriptor's channels, or, for one client's
  // piece of a row, longer
  if (size >= kLimit || f[10] != tile_begin ||
      (mask_c != 1 && mask_c != c && (n != 1 || mask_c < c)))
    return false;
  // V lanes: consecutive channels of one mask row (read as one vector), or
  // one shared channel
  const bool mask_vec = mask_c != 1 && b == 1;
  if ((vec != 1 && vec != 2 && vec != 4 && vec != 8) || vec * es > 16 ||
      size % vec != 0 || (b > 1 ? b : c) % vec != 0 ||
      !aligned(g, vec * es) || !aligned(l, vec * es) ||
      !aligned(out, vec * es) || (mask_vec && !aligned(mask, vec * es)) ||
      chunk < 1 || chunk > kClients)
    return false;
  for (const int i : {13, 15, 17})   // shifts of the divmod constants
    if (f[i] < 0 || f[i] > 31) return false;
  const int64_t vectors = size / vec;
  const int64_t chunks = (n + chunk - 1) / chunk;
  d->g = g;
  d->l = l;
  d->mask = mask;
  d->out = out;
  d->n = static_cast<uint32_t>(n);
  d->size = static_cast<uint32_t>(size);
  d->vectors = static_cast<uint32_t>(vectors);
  d->c = static_cast<uint32_t>(c);
  d->b = static_cast<uint32_t>(b);
  d->mask_c = static_cast<uint32_t>(mask_c);
  d->vec = static_cast<uint32_t>(vec);
  d->tile_begin = static_cast<uint32_t>(tile_begin);
  d->chunk = static_cast<uint32_t>(chunk);
  d->chunks = static_cast<uint32_t>(chunks);
  d->c_mul = static_cast<uint32_t>(f[12]);
  d->c_shr = static_cast<uint32_t>(f[13]);
  d->b_mul = static_cast<uint32_t>(f[14]);
  d->b_shr = static_cast<uint32_t>(f[15]);
  d->k_mul = static_cast<uint32_t>(f[16]);
  d->k_shr = static_cast<uint32_t>(f[17]);
  *tiles = (vectors + kThreads - 1) / kThreads * chunks;
  return true;
}

template <int L>
int launch(const int64_t* table, int leaves, int dtype, int64_t es,
           cudaStream_t s) {
  Group<L> grp = {};
  int64_t tiles = 0;
  for (int i = 0; i < leaves; ++i) {
    int64_t t = 0;
    if (!fill_leaf(table + i * kFields, es, tiles, &grp.leaf[i], &t))
      return static_cast<int>(cudaErrorInvalidValue);
    tiles += t;
    if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  }
  grp.count = leaves;
  const unsigned int grid = static_cast<unsigned int>(tiles);
  if (dtype == feddd::kFloat32)
    masked_merge_kernel<float, L><<<grid, kThreads, 0, s>>>(grp);
  else
    masked_merge_kernel<__nv_bfloat16, L><<<grid, kThreads, 0, s>>>(grp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table: `leaves` rows of kFields int64 (the wrapper's ops.plan):
//   g, l, mask, out (pointers), n, a, c, b, mask_c, vec, tile_begin, chunk,
//   c_mul, c_shr, b_mul, b_shr, k_mul, k_shr
// (the divmod constants of C, B and ceil(N / chunk), ops.divmod_constants)
// every leaf contiguous in dtype code `dtype`; g (A, C, B), l and out
// (N, A, C, B), mask (N, mask_c).  Rows give the tiles in order:
// tile_begin is the sum of the earlier rows' ceil(A*C*B / vec / kThreads)
// * ceil(N / chunk).
extern "C" int feddd_masked_merge_group(const int64_t* table, int leaves,
                                        int dtype, void* stream) {
  const int64_t es = dtype == feddd::kFloat32    ? 4
                     : dtype == feddd::kBFloat16 ? 2
                                                 : 0;
  if (table == nullptr || es == 0 || leaves < 1 || leaves > kMaxLeaves)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (leaves == 1) return launch<1>(table, leaves, dtype, es, s);
  if (leaves <= 8) return launch<8>(table, leaves, dtype, es, s);
  return launch<kMaxLeaves>(table, leaves, dtype, es, s);
}
