// Regular-expression matching, one DFA run per string, for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/dfa_match.py::dfa_match
// (`_kernel`) and its wrapper repro/kernels/ops.py::regex_match.
// Contract: repro.kernels.ref.dfa_match for each request of a stack, with
// valid = row < n_valid[b]:
//   * request b's row r is the w bytes at strings + (b * N + r) * w; it
//     consumes its first clamp(lengths[b * N + r], 0, w) bytes from state
//     0 through the (S, 256) transition table;
//   * mask[b * N + r] = 1 iff r < n_valid[b] and the state after the last
//     consumed byte accepts.
// The TPU kernel evaluates every transition as two one-hot f32 matmuls
// over all S states and 256 chars, because the TPU has no cheap gather.
// Here a transition is one byte load from the table in shared memory.
//
// Design. A (blocks, B) grid of 256 threads. Each block first copies the
// table into shared memory, a byte per entry (S <= 256 states), and the
// accept vector beside it, then walks tiles of R rows of its request, R =
// 256 for rows up to 252 bytes wide (fewer for wider rows, so a tile
// stays within 64 KiB). The grid holds about one resident wave of
// blocks, so the table is loaded once per block and not once per tile.
// For each tile:
//   * staging: the tile's rows are one contiguous run of bytes in device
//     memory; the block reads it with coalesced 16-byte loads (the run's
//     unaligned head and tail byte by byte, as rows of any width start at
//     any byte) and writes it into shared memory with a row stride of an
//     odd number of 4-byte words;
//   * walk: thread t takes row t and reads its bytes 4 at a time; with an
//     odd word stride the 32 threads of a warp read 32 different banks.
//     Each byte is one dependent table lookup.
// Rows at or past n_valid[b] are neither staged nor walked; their mask
// byte is 0. Table entries outside [0, S) are read as state 0, so that the
// walk never leaves its table (the wrapper's host check rejects them).
//
// Bound on the card: bytes (the strings, lengths and mask, each once); the
// lookups (one per consumed byte, at up to 32 a cycle per SM from shared
// memory) take less at the main path's shapes.
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kAlpha = 256;
constexpr int kMaxStates = 256;            // a state fits in one byte
constexpr int kTileBytes = 64 * 1024;      // staged rows of a tile, at most
constexpr int kMaxSmem = kMaxStates * kAlpha + kMaxStates + kTileBytes;
constexpr int kMaxDevices = 64;

std::once_flag g_once[kMaxDevices];
cudaError_t g_err[kMaxDevices];
int g_sms[kMaxDevices];

// the tile's row stride in 4-byte words: the row's words, made odd
__host__ __device__ inline int stride_words(int w) {
  const int sw = (w + 3) / 4;
  return sw | 1;
}

__host__ __device__ inline int tile_rows(int w) {
  const int r = kTileBytes / (4 * stride_words(w));
  return r < kThreads ? r : kThreads;
}

// byte o of the tile's contiguous run -> its place in the strided tile
__device__ __forceinline__ void put_byte(uint8_t* tile, int stride, int w,
                                         int o, uint8_t v) {
  const int row = o / w;
  tile[row * stride + (o - row * w)] = v;
}

// 16 bytes starting at byte o of the run; words when every 4-byte word of
// the run lies inside one row at a 4-byte aligned column
__device__ __forceinline__ void put16(uint8_t* tile, int stride, int w,
                                      int o, uint4 v, bool words) {
  int row = o / w;
  int col = o - row * w;
  const uint32_t part[4] = {v.x, v.y, v.z, v.w};
  if (words) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      *reinterpret_cast<uint32_t*>(tile + row * stride + col) = part[k];
      col += 4;
      if (col == w) { col = 0; ++row; }
    }
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      tile[row * stride + col] = (uint8_t)(part[k >> 2] >> (8 * (k & 3)));
      if (++col == w) { col = 0; ++row; }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
dfa_match_kernel(const uint8_t* __restrict__ strings,
                 const int* __restrict__ lengths,
                 const int* __restrict__ n_valid,
                 const int* __restrict__ table,
                 const uint8_t* __restrict__ accept, int S,
                 uint8_t* __restrict__ mask, long long N, int w) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* s_table = smem;                              // S * 256 bytes
  uint8_t* s_accept = smem + S * kAlpha;                // S bytes
  uint8_t* tile = s_accept + ((S + 15) & ~15);          // R rows x stride
  const int sw = stride_words(w);
  const int stride = 4 * sw;
  const int R = tile_rows(w);

  for (int i = threadIdx.x; i < S * kAlpha; i += kThreads) {
    const int t = table[i];
    s_table[i] = (uint8_t)((unsigned)t < (unsigned)S ? t : 0);
  }
  for (int i = threadIdx.x; i < S; i += kThreads) s_accept[i] = accept[i] != 0;

  const int b = blockIdx.y;
  const long long nv = max(0LL, min((long long)n_valid[b], N));
  const long long base = (long long)b * N;
  const long long n_tiles = (N + R - 1) / R;
  for (long long tl = blockIdx.x; tl < n_tiles; tl += gridDim.x) {
    const long long r0 = tl * R;
    const int rows = (int)min((long long)R, N - r0);
    const int walk = (int)max(0LL, min((long long)rows, nv - r0));
    __syncthreads();   // the table is in place; the last tile is walked
    if (walk > 0) {    // the same in every thread
      const uint8_t* src = strings + (base + r0) * w;
      const int len = walk * w;
      const int head = min(len, (int)((16 - ((uintptr_t)src & 15)) & 15));
      const int n16 = (len - head) >> 4;
      const int tail = head + (n16 << 4);
      const bool words = (w & 3) == 0 && (head & 3) == 0;
      const uint4* src16 = reinterpret_cast<const uint4*>(src + head);
      for (int i = threadIdx.x; i < n16; i += kThreads)
        put16(tile, stride, w, head + 16 * i, __ldcs(src16 + i), words);
      for (int i = threadIdx.x; i < head; i += kThreads)
        put_byte(tile, stride, w, i, src[i]);
      for (int i = tail + threadIdx.x; i < len; i += kThreads)
        put_byte(tile, stride, w, i, src[i]);
      __syncthreads();
    }
    if (threadIdx.x < rows) {
      uint8_t hit = 0;
      if (threadIdx.x < walk) {
        const int ln = __ldcs(lengths + base + r0 + threadIdx.x);
        const int m = ln < 0 ? 0 : (ln > w ? w : ln);
        const uint32_t* row =
            reinterpret_cast<const uint32_t*>(tile) + threadIdx.x * sw;
        int state = 0;
        int j = 0;
        for (; j + 4 <= m; j += 4) {
          const uint32_t c = row[j >> 2];
          state = s_table[(state << 8) | (c & 0xFF)];
          state = s_table[(state << 8) | ((c >> 8) & 0xFF)];
          state = s_table[(state << 8) | ((c >> 16) & 0xFF)];
          state = s_table[(state << 8) | (c >> 24)];
        }
        if (j < m) {
          uint32_t c = row[j >> 2];
          for (; j < m; ++j, c >>= 8)
            state = s_table[(state << 8) | (c & 0xFF)];
        }
        hit = s_accept[state];
      }
      __stcs(mask + base + r0 + threadIdx.x, hit);
    }
  }
}

}  // namespace

extern "C" {

int dfa_max_states() { return kMaxStates; }
// widest row a tile holds (one row of kTileBytes)
int dfa_max_width() { return kTileBytes - 4; }
const char* dfa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// strings (B, N, w) u8, lengths (B, N) i32, n_valid (B,) i32, table (S,
// 256) i32, accept (S,) u8 and mask (B, N) u8: device pointers, all
// contiguous (strings may be empty when w = 0: no byte is read). Returns
// cudaGetLastError().
int dfa_match(const void* strings, const void* lengths, const void* n_valid,
              const void* table, const void* accept, int S, void* mask,
              long long N, int w, int B, void* stream) {
  if (S < 1 || S > kMaxStates || w < 0 || w > kTileBytes - 4 || N < 1
      || B < 1 || B > 65535)
    return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  // the largest table and tile are allowed once per device, on first use
  std::call_once(g_once[dev], [dev] {
    g_err[dev] = cudaFuncSetAttribute(
        dfa_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (g_err[dev] == cudaSuccess)
      g_err[dev] = cudaDeviceGetAttribute(
          &g_sms[dev], cudaDevAttrMultiProcessorCount, dev);
  });
  if (g_err[dev] != cudaSuccess) return (int)g_err[dev];
  const int R = tile_rows(w);
  const size_t smem = (size_t)S * kAlpha + ((S + 15) & ~15)
                      + (size_t)R * 4 * stride_words(w);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, dfa_match_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // about one resident wave over the whole stack
  const long long n_tiles = (N + R - 1) / R;
  long long gx = ((long long)per_sm * g_sms[dev] + B - 1) / B;
  if (gx > n_tiles) gx = n_tiles;
  const dim3 grid((unsigned)gx, (unsigned)B);
  dfa_match_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)strings, (const int*)lengths, (const int*)n_valid,
      (const int*)table, (const uint8_t*)accept, S, (uint8_t*)mask, N, w);
  return (int)cudaGetLastError();
}

}  // extern "C"
