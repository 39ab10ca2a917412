// Hash grouping (distinct / group-by / count, sum, min, max) for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/hash_group.py::group_aggregate
// (`_block_kernel`, `tree_merge`) and the XLA glue around it (bucket hash,
// first-claim ownership, overflow mask), plus the grouping prologue of
// repro/core/pipeline.py::_group_body (predicate, n_valid mask, key
// conversion, drop-key substitution). Contract: repro.kernels.ref.
// group_aggregate, field for field, for each request of a (B, N) stack:
//   * bucket = top log2(n_buckets) bits of uint32(key) * 0x9E3779B1;
//   * the lowest-index row of a bucket claims it (its key is the bucket's
//     key); rows of that bucket with another key overflow;
//   * per bucket: count, sum, min and max over the rows it owns. Rows of
//     the bucket it does not own carry 0, +FLT_MAX and -FLT_MAX into them,
//     as in the reference's segmented scan; empty buckets report
//     KEY_SENTINEL, 0, 0, +FLT_MAX, -FLT_MAX;
//   * f32 arithmetic as XLA runs the reference on the CPU: add, min and
//     max read subnormal operands as zero; NaN propagates through min and
//     max; every result over a stack of two or more rows is canonical
//     (-0.0 and subnormals come out as +0.0); a stack of one row is
//     returned as its raw words. Built without fast-math, so no flush is
//     implied beyond these explicit ones.
// The TPU kernel aggregates through one-hot matmuls, so one inf in a block
// turns every other bucket's sums into NaN (0 * inf); this kernel never
// multiplies a value.
//
// Its bound on the card is bytes: each row's key and values are read once
// and a byte of overflow mask written; the bucket tables are small. The
// direct path reaches 28% of that bound at B=4 x 2^25 rows, V=2, 1024
// buckets (PERF.md): what holds it back is its per-row work in the SM
// (a hash, __match_any_sync, the lane tree's shuffles, shared-memory
// atomics for min and max), not its bytes; no profiler has split it
// further. Two paths, chosen by the wrapper from n_buckets alone (hash_group.py,
// direct_chunk): the direct path wherever a block's bucket tables for at
// least one value column fit in shared memory (n_buckets * 52 bytes
// within 227 KB: up to 4096 buckets), the sort path past that (8192
// buckets and more). Each pass is over a (blocks, B) grid, on the caller's
// stream.
//
//   hg_prep      (both paths' prologue) one thread per row: predicate
//                (shared with select_project through predicate.cuh), row
//                < n_valid[b], key = rint to int32 with saturation
//                (cvt.rni: NaN -> 0), dropped rows -> drop_key with zero
//                values; value columns gathered. The plan and the value
//                columns are read from device memory, so any table width
//                and any number of value columns run.
//
// The direct path (no sort: every row read in its own order, coalesced):
//   hg_first     the claim: each block finds each bucket's first row of
//                its range by shared-memory atomicMin, then one global
//                atomicMin a (block, bucket) it saw into first (B, nb),
//                pre-filled with INT_MAX. An integer min has no order, so
//                the claim is deterministic; a bucket's key is
//                keys[first];
//   hg_direct    the aggregation, once for each chunk of value columns
//                that the shared memory holds (nb * (12 + 40 Vc) bytes:
//                1024 buckets take 5 columns a chunk, 4096 one). Blocks
//                over fixed row ranges of a request (ceil(N / 8192) of
//                them, at most 256: fixed by N alone, so a request's sums
//                come out the same bits alone or stacked, on any card),
//                with the claimed keys and the block's bucket tables in
//                shared memory. Each warp takes tiles of 32-row groups
//                (lane = row), writes each row's overflow byte (first
//                chunk), and finds the lanes of each owned bucket
//                (__match_any_sync). Their count and sums are reduced by a
//                fixed tree over the lanes' order (as many steps as log2
//                of the warp's largest group: a hot bucket, such as skewed
//                keys or the drop-key bucket of a selective predicate,
//                costs 5 steps a 32 rows, never 32); the group's lowest
//                lane adds the result into the block's count (an integer
//                atomic) and into the warp's own sums. Min and max need no
//                order: each owned value as an order-preserving integer
//                key (NaN the extreme key) goes into the block's by
//                integer atomicMin / atomicMax. The warps' sums fold in
//                warp order at the block's end, into the block's partials,
//                min and max taking +-FLT_MAX where the block saw a row
//                its bucket does not own;
//   hg_merge     one warp per (request, bucket, value column of the
//                chunk): lane l folds the partials of blocks l, l + 32,
//                ... in block order, the lanes fold in a fixed tree;
//                canonical results. No float atomics anywhere: two
//                launches are bitwise equal.
//
// The sort path (the bucket tables outgrow shared memory):
//   hg_bucket    one thread per row: the bucket id;
//   (the wrapper sorts bucket ids stably along each request: torch.sort)
//   hg_claim     one thread per sorted position: the first row of each
//                bucket segment writes claimed[b, s] and start[b, s], the
//                last writes end[b, s] (one writer each, no atomics);
//   (the wrapper counts each bucket's pieces of at most 4096 sorted
//   positions and takes their prefix sum: torch.cumsum over (B, nb))
//   hg_piece     one block per piece and per chunk of at most 16 value
//                columns (the wrapper runs the chunks one after the other
//                over the one bucket sort): the block's threads walk the
//                piece in a fixed stride, each row read through the sorted
//                order (a scattered address), then reduce across the block
//                with warp shuffles and a fixed-order fold over warps,
//                into the piece's partial (count, sum, min, max);
//   hg_fold      one thread per (bucket, request): folds the bucket's
//                piece partials in piece order and makes the results
//                canonical. No atomics: two launches are bitwise equal,
//                and a hot bucket spreads over as many blocks as any
//                other 4096 rows;
//   hg_overflow  one thread per row: overflow = key != claimed[bucket].
// The sort and the gather through the sorted order move several times the
// bytes of the bound (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

#include "predicate.cuh"

namespace {

using predicate::row_passes;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVals = 16;      // value columns a block carries a pass
constexpr int kPieceRows = 4096;   // sorted positions a piece block reduces
constexpr float kBig = 3.4028234663852886e38f;  // FLT_MAX
constexpr uint32_t kFib = 0x9E3779B1u;
constexpr unsigned kFull = 0xFFFFFFFFu;
// the direct path
constexpr int kIntMax = 0x7FFFFFFF;          // first[]: no row yet
constexpr int kSentinel = (int)0x80000000;   // KEY_SENTINEL
constexpr int kMinBlockRows = 8192;          // rows a direct block at least
constexpr int kMaxParts = 256;               // direct blocks a request
constexpr int kClaimBlocksPerSm = 8;
constexpr size_t kSmemLimit = 232448;        // a block's shared memory
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float daz(float x) {
  return (__float_as_uint(x) & 0x7F800000u) == 0u ? 0.0f : x;
}

__device__ __forceinline__ float add_daz(float a, float b) {
  return daz(a) + daz(b);
}

// NaN-propagating min / max; the sign of a zero result does not matter
// (results are made canonical), nor which NaN comes out
__device__ __forceinline__ float nan_min(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return b < a ? b : a;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return b > a ? b : a;
}

__device__ __forceinline__ int bucket_of(int key, int log2_nb) {
  const uint32_t h = (uint32_t)key * kFib;
  return log2_nb == 0 ? 0 : (int)(h >> (32 - log2_nb));
}

// plan: the compacted predicate (3 * n_pred words, predicate.cuh), then
// the V value columns
__global__ void __launch_bounds__(kThreads)
hg_prep_kernel(const uint32_t* __restrict__ table,
               const int* __restrict__ plan, int n_pred, int C, int V,
               int kcol, const int* __restrict__ n_valid, int drop_key,
               int* __restrict__ keys, uint32_t* __restrict__ vals,
               long long N) {
  const int b = blockIdx.y;
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= N) return;
  const long long nv = min((long long)n_valid[b], N);
  const long long at = (long long)b * N + r;
  const uint32_t* row = table + at * C;
  const bool m = r < nv && row_passes(row, plan, n_pred);
  keys[at] = m ? __float2int_rn(__uint_as_float(row[kcol])) : drop_key;
  const int* vcols = plan + 3 * n_pred;
  uint32_t* out = vals + at * V;
  for (int j = 0; j < V; ++j) out[j] = m ? row[__ldg(vcols + j)] : 0u;
}

__global__ void __launch_bounds__(kThreads)
hg_bucket_kernel(const int* __restrict__ keys, int* __restrict__ bucket,
                 long long N, int log2_nb) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= N) return;
  const long long at = (long long)blockIdx.y * N + r;
  bucket[at] = bucket_of(keys[at], log2_nb);
}

__global__ void __launch_bounds__(kThreads)
hg_claim_kernel(const int* __restrict__ sorted_bucket,
                const long long* __restrict__ order,
                const int* __restrict__ keys, int* __restrict__ claimed,
                int* __restrict__ start, int* __restrict__ end, long long N,
                int nb) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= N) return;
  const int b = blockIdx.y;
  const int* sb = sorted_bucket + (long long)b * N;
  const int s = sb[i];
  const long long slot = (long long)b * nb + s;
  if (i == 0 || sb[i - 1] != s) {
    start[slot] = (int)i;
    claimed[slot] = keys[(long long)b * N + order[(long long)b * N + i]];
  }
  if (i == N - 1 || sb[i + 1] != s) end[slot] = (int)(i + 1);
}

// one block per piece: at most kPieceRows consecutive sorted positions of
// one bucket's segment, over value columns [j0, j0 + Vc) of V (Vc <=
// kMaxVals); the partials are (B, P, Vc). piece_incl[b, s] is the inclusive prefix sum of
// the buckets' piece counts, so bucket s owns pieces
// [piece_incl[s-1], piece_incl[s]) and its j-th piece starts at
// start[s] + j * kPieceRows.
__global__ void __launch_bounds__(kThreads)
hg_piece_kernel(const long long* __restrict__ order,
                const int* __restrict__ keys, const float* __restrict__ vals,
                const int* __restrict__ claimed,
                const int* __restrict__ start, const int* __restrict__ end,
                const int* __restrict__ piece_incl,
                int* __restrict__ pcount, float* __restrict__ psum,
                float* __restrict__ pmin, float* __restrict__ pmax,
                long long N, int V, int j0, int Vc, int nb, int P) {
  __shared__ int s_cnt[kWarps];
  __shared__ float s_sum[kMaxVals][kWarps];
  __shared__ float s_min[kMaxVals][kWarps];
  __shared__ float s_max[kMaxVals][kWarps];
  const int b = blockIdx.y;
  const int p = blockIdx.x;
  const int* incl = piece_incl + (long long)b * nb;
  if (p >= incl[nb - 1]) return;            // past this request's pieces
  int lo_s = 0, hi_s = nb - 1;              // first bucket with incl > p
  while (lo_s < hi_s) {
    const int mid = (lo_s + hi_s) >> 1;
    if (incl[mid] > p) hi_s = mid; else lo_s = mid + 1;
  }
  const long long slot = (long long)b * nb + lo_s;
  const int first = lo_s == 0 ? 0 : incl[lo_s - 1];
  const long long lo = start[slot] + (long long)(p - first) * kPieceRows;
  const long long hi = min(lo + kPieceRows, (long long)end[slot]);
  const int owner = claimed[slot];
  const long long* ob = order + (long long)b * N;
  const int* kb = keys + (long long)b * N;
  const float* vb = vals + (long long)b * N * V + j0;

  int cnt = 0;
  float a_sum[kMaxVals], a_min[kMaxVals], a_max[kMaxVals];
#pragma unroll
  for (int j = 0; j < kMaxVals; ++j) {
    a_sum[j] = 0.0f;
    a_min[j] = __int_as_float(0x7F800000);   // +inf: min's identity
    a_max[j] = __int_as_float(0xFF800000);   // -inf: max's identity
  }
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    const long long row = ob[i];
    const bool own = kb[row] == owner;
    cnt += own ? 1 : 0;
    const float* v = vb + row * V;
#pragma unroll
    for (int j = 0; j < kMaxVals; ++j) {
      if (j < Vc) {
        const float x = v[j];
        a_sum[j] = add_daz(a_sum[j], own ? x : 0.0f);
        a_min[j] = nan_min(a_min[j], own ? x : kBig);
        a_max[j] = nan_max(a_max[j], own ? x : -kBig);
      }
    }
  }

  // fixed-order reduction: shuffle tree within each warp, then warps 0..7
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_down_sync(0xFFFFFFFFu, cnt, off);
#pragma unroll
    for (int j = 0; j < kMaxVals; ++j) {
      if (j < Vc) {
        a_sum[j] = add_daz(a_sum[j],
                           __shfl_down_sync(0xFFFFFFFFu, a_sum[j], off));
        a_min[j] = nan_min(a_min[j],
                           __shfl_down_sync(0xFFFFFFFFu, a_min[j], off));
        a_max[j] = nan_max(a_max[j],
                           __shfl_down_sync(0xFFFFFFFFu, a_max[j], off));
      }
    }
  }
  if (lane == 0) {
    s_cnt[warp] = cnt;
#pragma unroll
    for (int j = 0; j < kMaxVals; ++j) {
      if (j < Vc) {
        s_sum[j][warp] = a_sum[j];
        s_min[j][warp] = a_min[j];
        s_max[j][warp] = a_max[j];
      }
    }
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  const long long at = (long long)b * P + p;
  int total = 0;
  for (int w = 0; w < kWarps; ++w) total += s_cnt[w];
  pcount[at] = total;
  for (int j = 0; j < Vc; ++j) {
    float sm = s_sum[j][0], mn = s_min[j][0], mx = s_max[j][0];
    for (int w = 1; w < kWarps; ++w) {
      sm = add_daz(sm, s_sum[j][w]);
      mn = nan_min(mn, s_min[j][w]);
      mx = nan_max(mx, s_max[j][w]);
    }
    psum[at * Vc + j] = sm;
    pmin[at * Vc + j] = mn;
    pmax[at * Vc + j] = mx;
  }
}

// one thread per (bucket, request): folds the bucket's piece partials in
// piece order and writes its row of the outputs, value columns
// [j0, j0 + Vc) of V
__global__ void __launch_bounds__(kThreads)
hg_fold_kernel(const float* __restrict__ vals,
               const int* __restrict__ piece_incl,
               const int* __restrict__ pcount, const float* __restrict__ psum,
               const float* __restrict__ pmin, const float* __restrict__ pmax,
               int* __restrict__ count, float* __restrict__ sum,
               float* __restrict__ mn, float* __restrict__ mx, long long N,
               int V, int j0, int Vc, int nb, int P) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= nb) return;
  const int b = blockIdx.y;
  const long long slot = (long long)b * nb + s;
  const int* incl = piece_incl + (long long)b * nb;
  const int p0 = s == 0 ? 0 : incl[s - 1];
  const int p1 = incl[s];
  float* osum = sum + slot * V + j0;
  float* omin = mn + slot * V + j0;
  float* omax = mx + slot * V + j0;
  if (p1 <= p0) {                       // empty bucket
    count[slot] = 0;
    for (int j = 0; j < Vc; ++j) {
      osum[j] = 0.0f;
      omin[j] = kBig;
      omax[j] = -kBig;
    }
    return;
  }
  if (N == 1) {                         // one row: its raw words
    count[slot] = 1;
    const float* v = vals + (long long)b * V + j0;
    for (int j = 0; j < Vc; ++j) osum[j] = omin[j] = omax[j] = v[j];
    return;
  }
  const long long base = (long long)b * P;
  int total = 0;
  for (int p = p0; p < p1; ++p) total += pcount[base + p];
  count[slot] = total;
  for (int j = 0; j < Vc; ++j) {
    const long long at = (base + p0) * Vc + j;
    float sm = psum[at], lo = pmin[at], hi = pmax[at];
    for (int p = p0 + 1; p < p1; ++p) {
      const long long q = (base + p) * Vc + j;
      sm = add_daz(sm, psum[q]);
      lo = nan_min(lo, pmin[q]);
      hi = nan_max(hi, pmax[q]);
    }
    osum[j] = daz(sm);                  // canonical: -0.0, subnormal -> +0.0
    omin[j] = daz(lo);
    omax[j] = daz(hi);
  }
}

__global__ void __launch_bounds__(kThreads)
hg_overflow_kernel(const int* __restrict__ keys,
                   const int* __restrict__ claimed,
                   uint8_t* __restrict__ overflow, long long N, int nb,
                   int log2_nb) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= N) return;
  const int b = blockIdx.y;
  const long long at = (long long)b * N + r;
  const int key = keys[at];
  overflow[at] = key != claimed[(long long)b * nb + bucket_of(key, log2_nb)];
}

// ------------------------------------------------------------- direct path
// Shared memory of a direct block over a chunk of Vc value columns: per
// bucket the claimed key, count and not-owned flag, then per value column
// a min key, a max key and one sum for each of the block's warps.
size_t direct_smem(int nb, int Vc) {
  return (size_t)nb * (12 + 4 * (size_t)Vc * (2 + kWarps));
}

// order-preserving uint32 keys of floats for integer atomicMin / atomicMax;
// NaN is the extreme key (0 for min, all ones for max), so it wins either
__device__ __forceinline__ uint32_t ord_key(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float ord_float(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}
__device__ __forceinline__ uint32_t min_key(float x) {
  return x != x ? 0u : ord_key(x);
}
__device__ __forceinline__ uint32_t max_key(float x) {
  return x != x ? 0xFFFFFFFFu : ord_key(x);
}
// the float a min key stands for (+inf: no owned row; NaN: any NaN)
__device__ __forceinline__ float min_of(uint32_t k) {
  return k == 0u ? __uint_as_float(0x7FC00000u)
                 : k == 0xFFFFFFFFu ? __uint_as_float(0x7F800000u)
                                    : ord_float(k);
}
__device__ __forceinline__ float max_of(uint32_t k) {
  return k == 0xFFFFFFFFu ? __uint_as_float(0x7FC00000u)
                          : k == 0u ? __uint_as_float(0xFF800000u)
                                    : ord_float(k);
}

// the claim: rows [blockIdx.x * rows, + rows) of request blockIdx.y; first
// (B, nb) pre-filled with kIntMax
__global__ void __launch_bounds__(kThreads)
hg_first_kernel(const int* __restrict__ keys, int* __restrict__ first,
                long long N, int nb, int log2_nb, long long rows) {
  extern __shared__ int s_first[];
  for (int s = threadIdx.x; s < nb; s += kThreads) s_first[s] = kIntMax;
  __syncthreads();
  const int b = blockIdx.y;
  const long long r0 = (long long)blockIdx.x * rows;
  const long long r1 = min(N, r0 + rows);
  const int* kb = keys + (long long)b * N;
  for (long long r = r0 + threadIdx.x; r < r1; r += 4 * kThreads) {
    int key[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long ru = r + u * kThreads;
      key[u] = ru < r1 ? kb[ru] : 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long ru = r + u * kThreads;
      const int s = bucket_of(key[u], log2_nb);
      if (ru < r1 && ru < s_first[s]) atomicMin(&s_first[s], (int)ru);
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; s < nb; s += kThreads) {
    const int f = s_first[s];
    if (f != kIntMax) atomicMin(&first[(long long)b * nb + s], f);
  }
}

// The aggregation of value columns [j0, j0 + Vc) of V (Vc <= VC) over rows
// [blockIdx.x * rows, + rows) of request blockIdx.y, into the block's
// partials at (b, blockIdx.x): pcount (B, P, nb), psum/pmin/pmax (B, P,
// nb, Vc). The first chunk (j0 = 0) writes the overflow mask and pcount.
template <int VC>
__global__ void __launch_bounds__(kThreads)
hg_direct_kernel(const int* __restrict__ keys, const float* __restrict__ vals,
                 const int* __restrict__ first,
                 uint8_t* __restrict__ overflow, int* __restrict__ pcount,
                 float* __restrict__ psum, float* __restrict__ pmin,
                 float* __restrict__ pmax, long long N, int V, int j0,
                 int Vc, int nb, int log2_nb, long long rows) {
  extern __shared__ __align__(16) int hsmem[];
  int* s_claim = hsmem;                                   // nb
  int* s_cnt = s_claim + nb;                              // nb
  int* s_flag = s_cnt + nb;                               // nb
  uint32_t* s_min = reinterpret_cast<uint32_t*>(s_flag + nb);   // nb x Vc
  uint32_t* s_max = s_min + nb * Vc;                      // nb x Vc
  float* s_sum = reinterpret_cast<float*>(s_max + nb * Vc);   // warps x nb x Vc
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int* kb = keys + (long long)b * N;
  const float* vb = vals + (long long)b * N * V + j0;
  uint8_t* ob = j0 == 0 ? overflow + (long long)b * N : nullptr;
  for (int s = threadIdx.x; s < nb; s += kThreads) {
    const int f = first[(long long)b * nb + s];
    s_claim[s] = f == kIntMax ? kSentinel : kb[f];
    s_cnt[s] = 0;
    s_flag[s] = 0;
  }
  for (int i = threadIdx.x; i < nb * Vc; i += kThreads) {
    s_min[i] = 0xFFFFFFFFu;
    s_max[i] = 0u;
  }
  for (int i = threadIdx.x; i < kWarps * nb * Vc; i += kThreads)
    s_sum[i] = 0.f;
  __syncthreads();

  const long long r0 = (long long)blockIdx.x * rows;
  const long long r1 = min(N, r0 + rows);
  float* w_sum = s_sum + warp * nb * Vc;
  const unsigned below = (1u << lane) - 1u;       // lanes under this one
  const unsigned above = ~((2u << lane) - 1u);    // lanes over this one
  // 32-row groups a tile: their loads in flight together, their trees
  // interleaved (independent shuffles hide each other's latency)
  constexpr int G = VC <= 2 ? 4 : VC <= 4 ? 2 : 1;
  constexpr int kTile = 32 * G;
  const long long stride = (long long)kWarps * kTile;
  // the tile at t into (key, sm); rows past the block's read nothing
  auto load = [&](long long t, int (&key)[G], float (&sm)[G][VC]) {
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const long long r = t + u * 32 + lane;
      const bool in = r < r1;
      key[u] = in ? kb[r] : 0;
#pragma unroll
      for (int j = 0; j < VC; ++j)
        sm[u][j] = in && j < Vc ? vb[r * V + j] : 0.f;
    }
  };
  int key[G], next_key[G];
  float sm[G][VC], next_sm[G][VC];
  load(r0 + (long long)warp * kTile, key, sm);
  for (long long t0 = r0 + (long long)warp * kTile; t0 < r1; t0 += stride) {
    // the next tile's loads in flight while this one is worked
    load(t0 + stride, next_key, next_sm);
    int s[G], c[G];
    unsigned peers[G];
    int most = 1;
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const long long r = t0 + u * 32 + lane;
      const bool in = r < r1;
      s[u] = bucket_of(key[u], log2_nb);
      const bool own = in && key[u] == s_claim[s[u]];
      c[u] = own ? 1 : 0;
      if (in && !own) s_flag[s[u]] = 1;
      if (in && ob) ob[r] = own ? 0 : 1;
      // min and max need no order: each owned row's integer key, an
      // atomic only where it improves the block's
#pragma unroll
      for (int j = 0; j < VC; ++j) {
        if (own && j < Vc) {
          const int at = s[u] * Vc + j;
          const uint32_t kn = min_key(sm[u][j]), kx = max_key(sm[u][j]);
          if (kn < s_min[at]) atomicMin(&s_min[at], kn);
          if (kx > s_max[at]) atomicMax(&s_max[at], kx);
        }
      }
      // the lanes of each owned bucket; others alone in a group of one
      peers[u] = __match_any_sync(kFull, own ? s[u] : -1 - lane);
      most = max(most, own ? __popc(peers[u]) : 1);
    }
    most = __reduce_max_sync(kFull, most);
    // count and sums by a fixed tree over the lanes' order: each step, the
    // active peers at even positions take their next active peer's
    // partial; as many steps as the warp's largest group needs
    unsigned act[G];
#pragma unroll
    for (int u = 0; u < G; ++u) act[u] = peers[u];
    for (int span = 1; span < most; span <<= 1) {
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const bool on = (act[u] >> lane) & 1u;
        const bool even = !(__popc(act[u] & below) & 1);
        const unsigned up = act[u] & above;
        const int src = up ? __ffs(up) - 1 : lane;
        const bool take = on && even && up;
        const int c2 = __shfl_sync(kFull, c[u], src);
        if (take) c[u] += c2;
#pragma unroll
        for (int j = 0; j < VC; ++j) {
          if (j < Vc) {
            const float s2 = __shfl_sync(kFull, sm[u][j], src);
            if (take) sm[u][j] = add_daz(sm[u][j], s2);
          }
        }
        act[u] = peers[u] & __ballot_sync(kFull, on && even);
      }
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      if (c[u] > 0 && (peers[u] & below) == 0u) {   // a group's lowest lane
        atomicAdd(&s_cnt[s[u]], c[u]);
#pragma unroll
        for (int j = 0; j < VC; ++j) {
          if (j < Vc) {
            const int at = s[u] * Vc + j;
            w_sum[at] = add_daz(w_sum[at], sm[u][j]);
          }
        }
      }
      __syncwarp();   // the warp's sums in place for its next group
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      key[u] = next_key[u];
#pragma unroll
      for (int j = 0; j < VC; ++j) sm[u][j] = next_sm[u][j];
    }
  }
  __syncthreads();
  const long long part = ((long long)b * gridDim.x + blockIdx.x) * nb;
  if (j0 == 0)
    for (int s = threadIdx.x; s < nb; s += kThreads)
      pcount[part + s] = s_cnt[s];
  for (int i = threadIdx.x; i < nb * Vc; i += kThreads) {
    float sm = s_sum[i];
    for (int w = 1; w < kWarps; ++w) sm = add_daz(sm, s_sum[w * nb * Vc + i]);
    float mn = min_of(s_min[i]), mx = max_of(s_max[i]);
    if (s_flag[i / Vc]) {               // a row the bucket does not own
      mn = nan_min(mn, kBig);
      mx = nan_max(mx, -kBig);
    }
    psum[part * Vc + i] = sm;
    pmin[part * Vc + i] = mn;
    pmax[part * Vc + i] = mx;
  }
}

// one warp per (request, bucket, value column j of the chunk): lane l
// folds the partials of blocks l, l + 32, ... in order, then the lanes
// fold in a fixed tree; canonical. Writes column j0 + j of sum/mn/mx (B,
// nb, V), and bucket_keys and count with the first chunk. An empty bucket
// (no first row) reads KEY_SENTINEL / 0 / 0 / +FLT_MAX / -FLT_MAX, a stack
// of one row its raw words
__global__ void __launch_bounds__(kThreads)
hg_merge_kernel(const int* __restrict__ keys, const float* __restrict__ vals,
                const int* __restrict__ first, const int* __restrict__ pcount,
                const float* __restrict__ psum, const float* __restrict__ pmin,
                const float* __restrict__ pmax, int* __restrict__ bucket_keys,
                int* __restrict__ count, float* __restrict__ sum,
                float* __restrict__ mn, float* __restrict__ mx, long long N,
                int V, int j0, int Vc, int nb, int P) {
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= nb * Vc) return;
  const int b = blockIdx.y;
  const int s = i / Vc, j = i - s * Vc;
  const bool head = j0 == 0 && j == 0;    // writes the bucket's key, count
  const long long slot = (long long)b * nb + s;
  const long long at = slot * V + j0 + j;
  const int f = first[slot];
  if (f == kIntMax) {                   // empty bucket
    if (lane == 0) {
      if (head) {
        bucket_keys[slot] = kSentinel;
        count[slot] = 0;
      }
      sum[at] = 0.0f;
      mn[at] = kBig;
      mx[at] = -kBig;
    }
    return;
  }
  if (N == 1) {                         // one row: its raw words
    if (lane == 0) {
      if (head) {
        bucket_keys[slot] = keys[(long long)b * N + f];
        count[slot] = 1;
      }
      sum[at] = mn[at] = mx[at] = vals[(long long)b * V + j0 + j];
    }
    return;
  }
  const long long base = (long long)b * P * nb;
  int total = 0;
  float a = 0.f, lo = __uint_as_float(0x7F800000u),
        hi = __uint_as_float(0xFF800000u);   // +inf, -inf: identities
  for (int p = lane; p < P; p += 32) {
    const long long q = (base + (long long)p * nb) * Vc + i;
    if (head) total += pcount[base + (long long)p * nb + s];
    a = add_daz(a, psum[q]);
    lo = nan_min(lo, pmin[q]);
    hi = nan_max(hi, pmax[q]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    total += __shfl_down_sync(kFull, total, off);
    a = add_daz(a, __shfl_down_sync(kFull, a, off));
    lo = nan_min(lo, __shfl_down_sync(kFull, lo, off));
    hi = nan_max(hi, __shfl_down_sync(kFull, hi, off));
  }
  if (lane != 0) return;
  if (head) {
    bucket_keys[slot] = keys[(long long)b * N + f];
    count[slot] = total;
  }
  sum[at] = daz(a);                     // canonical: -0.0, subnormal -> +0.0
  mn[at] = daz(lo);
  mx[at] = daz(hi);
}

// a direct kernel may take more than 48 KB of shared memory: allowed once
// per device and instance
std::once_flag g_once[kMaxDevices][5];
cudaError_t g_err[kMaxDevices][5];

template <typename F>
cudaError_t by_vals(int Vc, F&& f) {
  if (Vc <= 1) return f(hg_direct_kernel<1>, 0);
  if (Vc <= 2) return f(hg_direct_kernel<2>, 1);
  if (Vc <= 4) return f(hg_direct_kernel<4>, 2);
  if (Vc <= 8) return f(hg_direct_kernel<8>, 3);
  return f(hg_direct_kernel<kMaxVals>, 4);
}

template <typename K>
cudaError_t allow_direct(K kernel, int variant) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(g_once[dev][variant], [&] {
    g_err[dev][variant] = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemLimit);
  });
  return g_err[dev][variant];
}

// the direct path's blocks a request: fixed by N alone, never by the
// stack or the card, as they fix the order of its f32 sums
long long direct_parts(long long N) {
  return std::max(1LL, std::min<long long>(
                           kMaxParts, (N + kMinBlockRows - 1) / kMinBlockRows));
}

// the claim's blocks a request: enough to fill the card's SMs
// kClaimBlocksPerSm times, none under kMinBlockRows rows (an integer min:
// any split gives the same result)
long long claim_parts(long long N, int B) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
             != cudaSuccess)
    sms = 1;
  const long long want = ((long long)sms * kClaimBlocksPerSm + B - 1) / B;
  return std::max(1LL, std::min(want, (N + kMinBlockRows - 1) / kMinBlockRows));
}

int log2_of(int nb) {
  int l = 0;
  while ((1 << l) < nb) ++l;
  return l;
}

dim3 row_grid(long long N, int B) {
  return dim3((unsigned)((N + kThreads - 1) / kThreads), (unsigned)B);
}

}  // namespace

extern "C" {

int hg_max_vals() { return kMaxVals; }
const char* hg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// table (B, N, C) f32, plan (3 * n_pred + V words: the compacted
// predicate, then the value columns), n_valid (B,), keys (B, N) i32,
// vals (B, N, V) f32: device pointers. Returns cudaGetLastError().
int hg_prep(const void* table, const void* plan, int n_pred, int C,
            int kcol, int V, const void* n_valid, int drop_key, void* keys,
            void* vals, long long N, int B, void* stream) {
  if (C < 1 || n_pred < 0 || n_pred > C || V < 1 || B < 1 || N < 1
      || kcol < 0 || kcol >= C)
    return cudaErrorInvalidValue;
  hg_prep_kernel<<<row_grid(N, B), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)table, (const int*)plan, n_pred, C, V, kcol,
      (const int*)n_valid, drop_key, (int*)keys, (uint32_t*)vals, N);
  return (int)cudaGetLastError();
}

int hg_bucket(const void* keys, void* bucket, long long N, int B, int nb,
              void* stream) {
  if (B < 1 || N < 1 || nb < 1 || (nb & (nb - 1))) return cudaErrorInvalidValue;
  hg_bucket_kernel<<<row_grid(N, B), kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)keys, (int*)bucket, N, log2_of(nb));
  return (int)cudaGetLastError();
}

// sorted_bucket (B, N) i32 and order (B, N) i64 from a stable sort of the
// bucket ids along each request; claimed, start and end (B, nb) i32,
// pre-filled with KEY_SENTINEL, 0 and 0.
int hg_claim(const void* sorted_bucket, const void* order, const void* keys,
             void* claimed, void* start, void* end, long long N, int B,
             int nb, void* stream) {
  if (B < 1 || N < 1 || nb < 1) return cudaErrorInvalidValue;
  hg_claim_kernel<<<row_grid(N, B), kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)sorted_bucket, (const long long*)order, (const int*)keys,
      (int*)claimed, (int*)start, (int*)end, N, nb);
  return (int)cudaGetLastError();
}

int hg_piece_rows() { return kPieceRows; }

// piece_incl (B, nb) i32: inclusive prefix sum over buckets of
// ceil((end - start) / kPieceRows); partials pcount (B, P) i32 and
// psum/pmin/pmax (B, P, Vc) f32 with P >= ceil(N / kPieceRows) + nb.
// Aggregates value columns [j0, j0 + Vc) of vals (B, N, V) into the same
// columns of sum/mn/mx (B, nb, V); count (B, nb) is written by every chunk.
int hg_aggregate(const void* order, const void* keys, const void* vals,
                 const void* claimed, const void* start, const void* end,
                 const void* piece_incl, void* pcount, void* psum,
                 void* pmin, void* pmax, void* count, void* sum, void* mn,
                 void* mx, long long N, int V, int j0, int Vc, int B, int nb,
                 int P, void* stream) {
  if (B < 1 || N < 1 || nb < 1 || V < 1 || Vc < 1 || Vc > kMaxVals
      || j0 < 0 || j0 + Vc > V
      || (long long)P < (N + kPieceRows - 1) / kPieceRows + nb)
    return cudaErrorInvalidValue;
  hg_piece_kernel<<<dim3((unsigned)P, (unsigned)B), kThreads, 0,
                    (cudaStream_t)stream>>>(
      (const long long*)order, (const int*)keys, (const float*)vals,
      (const int*)claimed, (const int*)start, (const int*)end,
      (const int*)piece_incl, (int*)pcount, (float*)psum, (float*)pmin,
      (float*)pmax, N, V, j0, Vc, nb, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hg_fold_kernel<<<dim3((unsigned)((nb + kThreads - 1) / kThreads),
                        (unsigned)B), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)vals, (const int*)piece_incl, (const int*)pcount,
      (const float*)psum, (const float*)pmin, (const float*)pmax,
      (int*)count, (float*)sum, (float*)mn, (float*)mx, N, V, j0, Vc, nb, P);
  return (int)cudaGetLastError();
}

// the direct path's blocks a request for N rows: the P of hg_direct
long long hg_direct_parts(long long N) { return direct_parts(N); }

// the most value columns a direct pass takes at nb buckets, 0 where the
// bucket tables of one column do not fit (the sort path's n_buckets);
// hash_group.py's direct_chunk computes the same on the host
int hg_direct_chunk(int nb) {
  int vc = kMaxVals;
  while (vc > 0 && direct_smem(nb, vc) > kSmemLimit) --vc;
  return vc;
}

// keys (B, N) i32, vals (B, N, V) f32; first (B, nb) i32 pre-filled with
// INT_MAX; overflow (B, N) u8; partials pcount (B, P, nb) i32 and
// psum/pmin/pmax (B, P, nb, Vc) f32, P = hg_direct_parts(N); outputs
// bucket_keys and count (B, nb) i32, sum/mn/mx (B, nb, V) f32. The claim,
// then the aggregation and the merge of each chunk of Vc value columns,
// on `stream`. Returns cudaGetLastError().
int hg_direct(const void* keys, const void* vals, void* first, void* overflow,
              void* pcount, void* psum, void* pmin, void* pmax,
              void* bucket_keys, void* count, void* sum, void* mn, void* mx,
              long long N, int V, int Vc, int B, int nb, long long P,
              void* stream) {
  if (B < 1 || N < 1 || nb < 1 || (nb & (nb - 1)) || V < 1 || Vc < 1
      || Vc > kMaxVals || direct_smem(nb, Vc) > kSmemLimit
      || P != direct_parts(N))
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int l2 = log2_of(nb);
  const long long pc = claim_parts(N, B);
  hg_first_kernel<<<dim3((unsigned)pc, (unsigned)B), kThreads,
                    nb * sizeof(int), st>>>(
      (const int*)keys, (int*)first, N, nb, l2, (N + pc - 1) / pc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long rows = (N + P - 1) / P;
  for (int j0 = 0; j0 < V; j0 += Vc) {
    const int vc = std::min(Vc, V - j0);
    err = by_vals(vc, [&](auto kernel, int variant) {
      cudaError_t e = allow_direct(kernel, variant);
      if (e != cudaSuccess) return e;
      kernel<<<dim3((unsigned)P, (unsigned)B), kThreads,
               direct_smem(nb, vc), st>>>(
          (const int*)keys, (const float*)vals, (const int*)first,
          (uint8_t*)overflow, (int*)pcount, (float*)psum, (float*)pmin,
          (float*)pmax, N, V, j0, vc, nb, l2, rows);
      return cudaGetLastError();
    });
    if (err != cudaSuccess) return (int)err;
    hg_merge_kernel<<<dim3((unsigned)((nb * vc + kWarps - 1) / kWarps),
                           (unsigned)B), kThreads, 0, st>>>(
        (const int*)keys, (const float*)vals, (const int*)first,
        (const int*)pcount, (const float*)psum, (const float*)pmin,
        (const float*)pmax, (int*)bucket_keys, (int*)count, (float*)sum,
        (float*)mn, (float*)mx, N, V, j0, vc, nb, (int)P);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return cudaSuccess;
}

int hg_overflow(const void* keys, const void* claimed, void* overflow,
                long long N, int B, int nb, void* stream) {
  if (B < 1 || N < 1 || nb < 1 || (nb & (nb - 1))) return cudaErrorInvalidValue;
  hg_overflow_kernel<<<row_grid(N, B), kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)keys, (const int*)claimed, (uint8_t*)overflow, N, nb,
      log2_of(nb));
  return (int)cudaGetLastError();
}

}  // extern "C"
