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
// Passes, each over a (blocks, B) grid, on the caller's stream:
//   hg_prep      one thread per row: predicate (shared with select_project
//                through predicate.cuh), row < n_valid[b], key = rint to
//                int32 with saturation (cvt.rni: NaN -> 0), dropped rows
//                -> drop_key with zero values; value columns gathered.
//                The plan and the value columns are read from device
//                memory, so any table width and any number of value
//                columns run;
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
//                piece in
//                a fixed stride, then reduce across the block with warp
//                shuffles and a fixed-order fold over warps, into the
//                piece's partial (count, sum, min, max);
//   hg_fold      one thread per (bucket, request): folds the bucket's
//                piece partials in piece order and makes the results
//                canonical. No atomics anywhere: two launches are bitwise
//                equal, and a hot bucket spreads over as many blocks as
//                any other 4096 rows (skewed keys, the drop-key bucket);
//   hg_overflow  one thread per row: overflow = key != claimed[bucket].
//
// Bound on the card: bytes. Each row's key and values are read once and a
// byte of overflow mask written; the bucket tables are small. The sort and
// the pieces' gather by row id (the sorted order is a permutation of the
// rows, so each row's key and values are read from a scattered address)
// cost more than that bound: see PERF.md.
#include <cuda_runtime.h>
#include <stdint.h>

#include "predicate.cuh"

namespace {

using predicate::row_passes;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVals = 16;      // value columns a piece block carries
constexpr int kPieceRows = 4096;   // sorted positions a piece block reduces
constexpr float kBig = 3.4028234663852886e38f;  // FLT_MAX
constexpr uint32_t kFib = 0x9E3779B1u;

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

int hg_overflow(const void* keys, const void* claimed, void* overflow,
                long long N, int B, int nb, void* stream) {
  if (B < 1 || N < 1 || nb < 1 || (nb & (nb - 1))) return cudaErrorInvalidValue;
  hg_overflow_kernel<<<row_grid(N, B), kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)keys, (const int*)claimed, (uint8_t*)overflow, N, nb,
      log2_of(nb));
  return (int)cudaGetLastError();
}

}  // extern "C"
