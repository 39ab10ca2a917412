// Counter-mode Threefry-2x32 stream cipher for Hopper (sm_90a), over word
// streams and over byte streams.
//
// Replaces the Pallas kernel repro/kernels/ctr_crypt.py::ctr_crypt
// (`_kernel`). Contract: repro.kernels.ref.ctr_crypt. Word i of a stream is
// XORed with lane (p & 1) of threefry2x32(key, p >> 1, nonce), where the
// position p is i (each request of the B stack starts its own stream at 0)
// or idx[i] when an explicit position tensor is given. The explicit form
// serves partitioned dispatch (row_ids), which the TPU path runs through
// the reference cipher because its kernel only takes a contiguous stream.
// The cipher is its own inverse.
//
// Words: one thread per word pair, grid-stride over the whole (B, L)
// stack. Without idx the pair (2t, 2t+1) shares counter block t, so one
// Threefry call yields both keystream words; with idx each word runs its
// own call. Bound on the card: bytes. Each word is read and written once
// (8 bytes), against about 37 32-bit integer operations per word (72 a
// counter block of two words, and the XOR), which the integer pipes retire
// faster than HBM delivers the words. The design keeps the whole schedule
// in registers (fully unrolled rounds, key schedule computed once per
// thread) and lets neighbouring threads touch neighbouring words.
//
// Bytes (`ctr_crypt_bytes`): a string table's pre-decrypt, the reference
// pipeline's cipher over its bytes widened to uint32 words, cut back to
// the low byte (repro/core/pipeline.py::_body). Byte i becomes
// b[i] ^ (ks(p) & 0xFF). Without row ids p is the byte's index in its
// request; with (B, n) row ids over rows of w bytes, the byte at (row, col)
// takes p = (uint32)row_id * w + col, wrapping mod 2^32. The kernel reads
// the bytes and the row ids and computes every position itself: no
// widened copy, no position tensor. It writes a new buffer.
//
// Bound on the card: integer operations, not bytes. A counter block costs
// 72 instructions and serves two bytes, so about 37 operations a byte
// (with the XOR) against 2 bytes moved: at the regex round's 2^30 bytes
// about 1.2 ms of integer work at the SM's issue rate (128 lanes a clock;
// nvcc spreads the adds over the FMA pipe as IMAD) against 0.64 ms of HBM
// traffic. So the design spends no instruction twice. Each thread owns a chunk of 16
// positions that starts on an even position, so the chunk's 8 counter
// blocks are its own and each runs once (the calls of a chunk whose bytes
// all lie outside the row are skipped). The 16 keystream low bytes are
// packed into four words and XORed into one 16-byte vector load and store
// where the chunk is whole and aligned, byte by byte elsewhere. Without
// row ids the chunks tile the request's flat stream (chunk t is bytes
// [16t, 16t + 16)): no divide. With row ids a row starting on an odd
// position (odd w) begins with a chunk of 15 bytes, so that every later
// chunk of the row starts on an even position; the thread's (row, chunk)
// comes from one 32-bit divide by the chunks a row.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void threefry2x32(const uint32_t ks[3],
                                             uint32_t c0, uint32_t c1,
                                             uint32_t* o0, uint32_t* o1) {
  const int rots[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  uint32_t x0 = c0 + ks[0];
  uint32_t x1 = c1 + ks[1];
#pragma unroll
  for (int block = 0; block < 5; ++block) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl(x1, rots[(4 * block + r) % 8]);
      x1 ^= x0;
    }
    x0 += ks[(block + 1) % 3];
    x1 += ks[(block + 2) % 3] + (uint32_t)(block + 1);
  }
  *o0 = x0;
  *o1 = x1;
}

__global__ void __launch_bounds__(kThreads)
ctr_crypt_kernel(const uint32_t* __restrict__ data,
                 const uint32_t* __restrict__ idx, uint32_t* __restrict__ out,
                 long long L, long long pairs_per_row, long long n_pairs,
                 uint32_t k0, uint32_t k1, uint32_t nonce) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
       p < n_pairs; p += stride) {
    const long long b = p / pairs_per_row;
    const long long t = p - b * pairs_per_row;
    const long long i = b * L + 2 * t;
    const bool has_second = 2 * t + 1 < L;
    if (idx == nullptr) {
      uint32_t s0, s1;
      threefry2x32(ks, (uint32_t)t, nonce, &s0, &s1);
      out[i] = data[i] ^ s0;
      if (has_second) out[i + 1] = data[i + 1] ^ s1;
    } else {
      for (int j = 0; j < (has_second ? 2 : 1); ++j) {
        const uint32_t pos = idx[i + j];
        uint32_t s0, s1;
        threefry2x32(ks, pos >> 1, nonce, &s0, &s1);
        out[i + j] = data[i + j] ^ ((pos & 1u) ? s1 : s0);
      }
    }
  }
}

// The 16 bytes of a chunk whose position 0 is P0 (even, mod 2^32): byte j
// of the chunk, j in [jlo, jhi), is s[j] and becomes d[j] ^ the low byte of
// lane (j & 1) of block ((P0 >> 1) + j / 2) mod 2^31. Bytes outside
// [jlo, jhi) are not touched; a block none of whose bytes is inside is not
// computed.
__device__ __forceinline__ void crypt_chunk(const uint32_t ks[3],
                                            uint32_t nonce, uint32_t p0,
                                            const uint8_t* __restrict__ s,
                                            uint8_t* __restrict__ d,
                                            int jlo, int jhi) {
  uint32_t kw[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (2 * k + 1 >= jlo && 2 * k < jhi) {
      uint32_t s0, s1;
      threefry2x32(ks, ((p0 >> 1) + k) & 0x7FFFFFFFu, nonce, &s0, &s1);
      kw[k >> 1] |= ((s0 & 0xFFu) | ((s1 & 0xFFu) << 8)) << (16 * (k & 1));
    }
  }
  if (jlo == 0 && jhi == 16 &&
      ((reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(d)) &
       15) == 0) {
    uint4 v = *reinterpret_cast<const uint4*>(s);
    v.x ^= kw[0];
    v.y ^= kw[1];
    v.z ^= kw[2];
    v.w ^= kw[3];
    *reinterpret_cast<uint4*>(d) = v;
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (j >= jlo && j < jhi) {
        d[j] = s[j] ^ (uint8_t)(kw[j >> 2] >> (8 * (j & 3)));
      }
    }
  }
}

// blockIdx.y is the request; x strides over its chunks. data/out: B * L
// bytes; row_ids: null, or B * (L / w) ids.
__global__ void __launch_bounds__(kThreads)
ctr_bytes_kernel(const uint8_t* __restrict__ data,
                 const int32_t* __restrict__ row_ids,
                 uint8_t* __restrict__ out, long long L, int w,
                 uint32_t k0, uint32_t k1, uint32_t nonce) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  const long long b = blockIdx.y;
  const uint8_t* src = data + b * L;
  uint8_t* dst = out + b * L;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (row_ids == nullptr) {
    const long long chunks = (L + 15) / 16;
    for (long long t = first; t < chunks; t += stride) {
      const long long f0 = 16 * t;
      crypt_chunk(ks, nonce, (uint32_t)f0, src + f0, dst + f0, 0,
                  (int)min(16LL, L - f0));
    }
    return;
  }
  // a row's first chunk holds 16 - odd bytes (odd: the row starts on an
  // odd position), so cpr chunks cover a row of either parity
  const uint32_t cpr = (uint32_t)(w + (w & 1) + 15) / 16;
  const long long n = L / w;
  const int32_t* ids = row_ids + b * n;
  for (long long t = first; t < n * cpr; t += stride) {
    const uint32_t row = (uint32_t)t / cpr;
    const int k = (int)((uint32_t)t - row * cpr);
    const uint32_t prow = (uint32_t)ids[row] * (uint32_t)w;
    const int c0 = 16 * k - (int)(prow & 1u);   // the column at j = 0
    const int jlo = max(0, -c0), jhi = min(16, w - c0);
    if (jlo >= jhi) continue;
    // chunk byte j is column c0 + j of the row (j >= jlo keeps it >= 0)
    const long long at = (long long)row * w + c0;
    crypt_chunk(ks, nonce, prow + (uint32_t)c0, src + at, dst + at, jlo,
                jhi);
  }
}

}  // namespace

extern "C" {

const char* ctr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// data, idx (or null), out: device pointers to B*L uint32 words.
// Returns cudaGetLastError() after the launch.
int ctr_crypt(const void* data, const void* idx, void* out, long long L, int B,
              unsigned k0, unsigned k1, unsigned nonce, void* stream) {
  if (L < 1 || B < 1) return cudaErrorInvalidValue;
  const long long pairs_per_row = (L + 1) / 2;
  const long long n_pairs = pairs_per_row * B;
  long long blocks = (n_pairs + kThreads - 1) / kThreads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  ctr_crypt_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)data, (const uint32_t*)idx, (uint32_t*)out, L,
      pairs_per_row, n_pairs, k0, k1, nonce);
  return (int)cudaGetLastError();
}

// data, out: device pointers to B*L bytes; row_ids: null, or B*(L/w) int32
// row ids of rows of w bytes (w >= 1 dividing L). Returns
// cudaGetLastError() after the launch.
int ctr_crypt_bytes(const void* data, const void* row_ids, void* out,
                    long long L, int w, int B, unsigned k0, unsigned k1,
                    unsigned nonce, void* stream) {
  if (L < 1 || B < 1 || B > 65535) return cudaErrorInvalidValue;
  long long units = (L + 15) / 16;
  if (row_ids != nullptr) {
    if (w < 1 || L % w != 0) return cudaErrorInvalidValue;
    units = L / w * ((w + (w & 1) + 15) / 16);
    if (units >= (1LL << 32)) return cudaErrorInvalidValue;  // 32-bit divide
  }
  long long blocks = (units + kThreads - 1) / kThreads;
  const long long cap = (132LL * 64 + B - 1) / B;  // grid-stride beyond this
  if (blocks > cap) blocks = cap;
  const dim3 grid((unsigned)blocks, (unsigned)B);
  ctr_bytes_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)row_ids, (uint8_t*)out, L, w, k0,
      k1, nonce);
  return (int)cudaGetLastError();
}

}  // extern "C"
