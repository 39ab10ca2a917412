// Small-table inner join probe for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/hash_join.py::hash_join
// (`_kernel`) and the probe-key conversion of repro/core/pipeline.py's
// join branch (`jnp.rint(work[:, probe_col]).astype(int32)`). Contract:
// repro.kernels.ops.hash_join_xla for each request of a stack, with
// valid = row < n_valid[b]:
//   * the probe key of a row is column kcol of its (w words) row: an f32
//     word converted as rint to int32 with saturation (cvt.rni: halves to
//     even, NaN -> 0, out of range -> INT32_MIN / INT32_MAX), or an int32
//     word taken as it is;
//   * a row hits iff its key is one of the K build keys (unique, sorted
//     ascending by the wrapper); a hit writes the matched build row's V
//     words bitwise and 1.0f, a miss or a row past n_valid[b] writes V
//     zeros and 0.0f;
//   * each output row is the widened row the pipeline's select_project
//     reads: the probe row's w words, copied bitwise, then the V + 1
//     words, then zeros up to the output's width (the pipeline writes
//     partitioned dispatch's id column there afterwards). Writing the
//     probe row too saves the pipeline a separate copy of the stack.
// The TPU kernel matches through a one-hot (rows x K) matmul, so an inf
// build value turns every other row of its block into NaN (0 * inf); this
// kernel looks keys up by binary search and moves words with integer loads
// and stores only.
//
// A (row blocks, B) grid of 256 threads, 2048 rows a block, taken 256 at
// a time (a thread per row); the build is one table for the whole stack.
// Each thread builds its output row in a shared-memory tile of 256 rows,
// which the block then writes as one contiguous run (a thread writing
// its own few-word row straight to device memory would leave every store
// instruction scattered over partial sectors); rows wider than 32 words
// are written straight. When the K keys fit beside the tile in the
// 48 KiB of dynamic shared memory a block takes without opting in, each
// block first copies them there, once for its 2048 rows
// (hj_probe<true>); otherwise the same kernel searches them in device
// memory, where the top levels of the search stay in L1
// (hj_probe<false>). K is not capped. The probe may be a view with any
// stride between requests (the page gather's), so it is never copied
// first.
//
// Bound on the card: bytes. The function reads each probe row and the
// build once and writes w + V + 1 words a row; the search is log2(K)
// compares a row.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 8;
constexpr int kRowsPerBlock = kThreads * kRowsPerThread;
constexpr int kSmemBytes = 48 * 1024;   // dynamic shared memory, no opt-in
constexpr int kMaxStagedWords = 32;     // widest output row built in the tile

// first index in keys[0, K) whose key is >= key
__device__ __forceinline__ int lower_bound(const int* keys, int K, int key) {
  int lo = 0, hi = K;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// probe: request b's row r at probe + b * probe_bstride + r * w. out:
// rows of out_w words, request after request: the probe row's w words,
// the V + 1 join words and zeros. staged: build the rows in the shared
// tile (out_w <= kMaxStagedWords) and write them as one run.
template <bool kSharedKeys>
__global__ void __launch_bounds__(kThreads)
hj_probe_kernel(const uint32_t* __restrict__ probe, long long probe_bstride,
                int w, int kcol, int key_f32,
                const int* __restrict__ bkeys,
                const uint32_t* __restrict__ bvals, int K, int V,
                const int* __restrict__ n_valid, uint32_t* __restrict__ out,
                int out_w, long long N, int staged) {
  extern __shared__ uint32_t smem[];
  const int* s_keys = reinterpret_cast<const int*>(smem);
  uint32_t* tile = smem + (kSharedKeys ? K : 0);
  if constexpr (kSharedKeys) {
    for (int i = threadIdx.x; i < K; i += kThreads) smem[i] = bkeys[i];
    __syncthreads();
  }
  const int b = blockIdx.y;
  const long long nv = min((long long)n_valid[b], N);
  const uint32_t* pb = probe + (long long)b * probe_bstride;
  for (int s = 0; s < kRowsPerThread; ++s) {
    const long long r0 = (long long)blockIdx.x * kRowsPerBlock
                         + (long long)s * kThreads;
    if (r0 >= N) break;                     // the same in every thread
    const int rows_here = (int)min((long long)kThreads, N - r0);
    const long long r = r0 + threadIdx.x;
    if (threadIdx.x < rows_here) {
      const uint32_t* row = pb + r * w;
      uint32_t* o = staged ? tile + threadIdx.x * out_w
                           : out + ((long long)b * N + r) * out_w;
      for (int j = 0; j < w; ++j) o[j] = row[j];
      int hit = -1;  // the matched build row, or -1
      if (r < nv) {
        const uint32_t word = row[kcol];
        const int key = key_f32 ? __float2int_rn(__uint_as_float(word))
                                : (int)word;
        if constexpr (kSharedKeys) {
          const int i = lower_bound(s_keys, K, key);
          hit = (i < K && s_keys[i] == key) ? i : -1;
        } else {
          const int i = lower_bound(bkeys, K, key);
          hit = (i < K && __ldg(bkeys + i) == key) ? i : -1;
        }
      }
      uint32_t* oj = o + w;
      if (hit >= 0) {
        const uint32_t* src = bvals + (long long)hit * V;
        for (int j = 0; j < V; ++j) oj[j] = __ldg(src + j);
        oj[V] = 0x3F800000u;  // 1.0f
      } else {
        for (int j = 0; j <= V; ++j) oj[j] = 0u;
      }
      for (int j = w + V + 1; j < out_w; ++j) o[j] = 0u;
    }
    if (staged) {                           // the same in every thread
      __syncthreads();
      uint32_t* dst = out + ((long long)b * N + r0) * out_w;
      const int n_words = rows_here * out_w;
      for (int j = threadIdx.x; j < n_words; j += kThreads) dst[j] = tile[j];
      __syncthreads();                      // the tile is rebuilt next
    }
  }
}

}  // namespace

extern "C" {

const char* hj_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// probe (B, N, w) words with probe_bstride words between requests, bkeys
// (K,) i32 sorted ascending and unique, bvals (K, V) f32 in the same
// order, n_valid (B,) i32, out (B, N, out_w) f32: device pointers.
// key_f32: 1 for f32 key words, 0 for int32 keys. Returns
// cudaGetLastError().
int hj_probe(const void* probe, long long probe_bstride, int w, int kcol,
             int key_f32, const void* bkeys, const void* bvals,
             int K, int V, const void* n_valid, void* out, int out_w,
             long long N, int B, void* stream) {
  if (w < 1 || kcol < 0 || kcol >= w || K < 1 || V < 0 || w + V + 1 > out_w
      || N < 1 || B < 1)
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((N + kRowsPerBlock - 1) / kRowsPerBlock),
                  (unsigned)B);
  const int staged = out_w <= kMaxStagedWords;
  const size_t tile = staged ? (size_t)kThreads * out_w * sizeof(uint32_t)
                             : 0;
  const size_t keys = (size_t)K * sizeof(int);
  if (keys + tile <= (size_t)kSmemBytes) {
    hj_probe_kernel<true><<<grid, kThreads, keys + tile,
                            (cudaStream_t)stream>>>(
        (const uint32_t*)probe, probe_bstride, w, kcol, key_f32,
        (const int*)bkeys, (const uint32_t*)bvals, K, V, (const int*)n_valid,
        (uint32_t*)out, out_w, N, staged);
  } else {
    hj_probe_kernel<false><<<grid, kThreads, tile, (cudaStream_t)stream>>>(
        (const uint32_t*)probe, probe_bstride, w, kcol, key_f32,
        (const int*)bkeys, (const uint32_t*)bvals, K, V, (const int*)n_valid,
        (uint32_t*)out, out_w, N, staged);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
