// Tiered page gather for Hopper (sm_90a): the cold-page decode of memory
// tiering, fused into the request's read of the pool.
//
// Replaces no Pallas kernel: it stands for the XLA-fused gathers of
// repro/kernels/tier.py (`_decode_flat` at :51, `gather_rows_tiered` :102,
// `gather_columns_tiered` :115). XLA fuses the decode's ~20 elementwise
// steps into the jitted gather; in torch each step would be a full-size
// tensor, so the card runs this one kernel instead. Contract: the plain
// version `tier_gather_plain` in kernels/tier.py, bitwise.
//
// For each request b of the stack and each output word (row r, column
// cols[i]) at logical word g = r * C + cols[i] of the table: page p =
// g / page_words, word kk = g % page_words, column plane c = g % C (that
// is cols[i]), and the page's descriptor row (phys, mode, width, base,
// dictoff, bitoff) of request b. MODE_RAW reads the word itself from page
// phys; a packed plane extracts its `width`-bit value at bit bitoff + j *
// width of frame phys (j: the word's rank in its plane) from a two-word
// straddle read, then adds the plane's base (MODE_DELTA, wrapping) or
// looks it up in the frame's dictionary (MODE_DICT). Words are moved as
// uint32: no float arithmetic touches them, so NaN payloads and subnormals
// survive.
//
// What the reference defines that C does not, kept as the reference has
// it: a shift by 32 or more (`hi << (32 - sh)` at sh == 0, `0xFFFFFFFF >>
// (32 - w)` at w outside 1..32) gives 0 in XLA, and is guarded here; the
// clamps of the straddle index to [0, page_words - 2] and of the
// dictionary index to [0, page_words - 1] are the reference's, with its
// int32 wrap of the bit offset and of the dictionary index. The rank j is
// the reference's (kk - (c - phase) % C) // C with Python's non-negative
// `%`, phase = (p * page_words) % C: pages start mid-row when C does not
// divide page_words. Over the rows of one page that is r - first(c), with
// first(c) = ceil((p * page_words - c) / C) the first row whose column-c
// word lies in page p (both count the column-c words of the page before
// row r), so the kernel takes the difference and C's signed `%` never
// enters. The packed candidate is computed for every lane, as the
// reference computes it; the raw word and the dictionary word are read
// only where the mode selects them (the value the reference selects is
// the same, and a cold lane does not stream its frame's raw words).
//
// One block per (page, request): it stages the page's descriptor row for
// up to kChunk output columns in shared memory, with each column's
// first(c), then walks the page's output words (the rows that touch the
// page, times the columns) with neighbouring threads on neighbouring
// output words, each decoding the words whose logical word lies in its
// page (a row that straddles two pages is written by both blocks, each
// its own words). So no per-word division and no per-word descriptor
// load from device memory. Indices and addresses are 64-bit.
//
// Bound on the card: bytes. The output words are written once and the
// packed planes and dictionaries (or a raw page's words) read once, over
// 3.35 TB/s of HBM.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 512;        // output columns staged at a time
constexpr int kModeRaw = 0;
constexpr int kModeDict = 2;

__global__ void __launch_bounds__(kThreads)
tier_gather_kernel(const uint32_t* __restrict__ buf, long long buf_pages,
                   long long pw, const int* __restrict__ phys,
                   const int* __restrict__ mode,
                   const int* __restrict__ width,
                   const uint32_t* __restrict__ base,
                   const int* __restrict__ dictoff,
                   const int* __restrict__ bitoff, long long P, long long C,
                   const int* __restrict__ cols, int k, long long n_rows,
                   uint32_t* __restrict__ out) {
  __shared__ int s_col[kChunk], s_mode[kChunk], s_width[kChunk];
  __shared__ int s_dictoff[kChunk], s_bitoff[kChunk];
  __shared__ uint32_t s_base[kChunk];
  __shared__ long long s_first[kChunk];
  const long long p = blockIdx.x;
  const long long b = blockIdx.y;
  const long long words = n_rows * C;
  const long long pstart = p * pw;
  const long long pend = pstart + pw < words ? pstart + pw : words;
  if (pstart >= pend) return;
  const long long r_lo = pstart / C;
  const long long r_hi = (pend - 1) / C;
  const long long R = r_hi - r_lo + 1;
  const long long drow = b * P + p;
  long long frame = __ldg(phys + drow);
  // a descriptor names a page of the buffer; clamp so a corrupt one
  // cannot read outside it
  frame = frame < 0 ? 0 : (frame >= buf_pages ? buf_pages - 1 : frame);
  const uint32_t* page = buf + frame * pw;
  uint32_t* out_b = out + b * n_rows * (long long)k;

  for (int i0 = 0; i0 < k; i0 += kChunk) {
    const int kc = k - i0 < kChunk ? k - i0 : kChunk;
    __syncthreads();
    for (int t = threadIdx.x; t < kc; t += kThreads) {
      const int col = cols == nullptr ? i0 + t : __ldg(cols + i0 + t);
      const long long d = drow * C + col;
      s_col[t] = col;
      s_mode[t] = __ldg(mode + d);
      s_width[t] = __ldg(width + d);
      s_base[t] = __ldg(base + d);
      s_dictoff[t] = __ldg(dictoff + d);
      s_bitoff[t] = __ldg(bitoff + d);
      s_first[t] = (pstart - col + C - 1) / C;   // ceil((pstart - col) / C)
    }
    __syncthreads();
    const long long total = R * kc;
    const long long step_r = kThreads / kc;
    const int step_i = kThreads % kc;
    long long rl = threadIdx.x / kc;
    int ii = threadIdx.x % kc;
    for (long long t = threadIdx.x; t < total; t += kThreads) {
      const long long r = r_lo + rl;
      const long long g = r * C + s_col[ii];
      if (g >= pstart && g < pend) {
        const long long kk = g - pstart;
        const int m = s_mode[ii];
        const int w = s_width[ii];
        // packed candidate, with the reference's int32 wrap and clamp
        const uint32_t j = (uint32_t)(r - s_first[ii]);
        const int bit = (int)((uint32_t)s_bitoff[ii] + j * (uint32_t)w);
        long long wi = bit >> 5;
        wi = wi < 0 ? 0 : (wi > pw - 2 ? pw - 2 : wi);
        const uint32_t sh = (uint32_t)bit & 31u;
        const uint32_t lo = __ldg(page + wi);
        const uint32_t hi = __ldg(page + wi + 1);
        uint32_t packed = (lo >> sh) | (sh == 0 ? 0u : hi << (32u - sh));
        packed &= (w >= 1 && w <= 32) ? (0xFFFFFFFFu >> (32 - w)) : 0u;
        uint32_t v;
        if (m == kModeRaw) {
          v = __ldg(page + kk);
        } else if (m == kModeDict) {
          long long di = (int)((uint32_t)s_dictoff[ii] + packed);
          di = di < 0 ? 0 : (di > pw - 1 ? pw - 1 : di);
          v = __ldg(page + di);
        } else {
          v = packed + s_base[ii];                 // wrap-around delta
        }
        out_b[r * k + i0 + ii] = v;
      }
      ii += step_i;
      rl += step_r;
      if (ii >= kc) {
        ii -= kc;
        rl += 1;
      }
    }
  }
}

}  // namespace

extern "C" {

const char* tg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// buf: (buf_pages, page_words) uint32 words; phys (B, P) and mode, width,
// base, dictoff, bitoff (B, P, C) int32 (base: uint32 bit patterns);
// cols: k int32 column ids in [0, C), or null for every column (k == C);
// out: (B, n_rows, k) uint32. Returns cudaGetLastError() after the launch.
int tier_gather(const void* buf, long long buf_pages, int page_words,
                const void* phys, const void* mode, const void* width,
                const void* base, const void* dictoff, const void* bitoff,
                long long P, int C, const void* cols, int k, long long n_rows,
                int B, void* out, void* stream) {
  if (buf_pages < 1 || page_words < 2 || P < 1 || C < 1 || k < 1 ||
      n_rows < 1 || B < 1 || B > 65535 || P > 0x7FFFFFFFLL)
    return cudaErrorInvalidValue;
  if (cols == nullptr && k != C) return cudaErrorInvalidValue;
  if (n_rows * (long long)C > P * (long long)page_words)
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)P, (unsigned)B);
  tier_gather_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)buf, buf_pages, page_words, (const int*)phys,
      (const int*)mode, (const int*)width, (const uint32_t*)base,
      (const int*)dictoff, (const int*)bitoff, P, C, (const int*)cols, k,
      n_rows, (uint32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
