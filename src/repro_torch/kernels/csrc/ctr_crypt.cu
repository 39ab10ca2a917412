// Counter-mode Threefry-2x32 stream cipher for Hopper (sm_90a).
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
// One thread per word pair, grid-stride over the whole (B, L) stack. Without
// idx the pair (2t, 2t+1) shares counter block t, so one Threefry call
// yields both keystream words; with idx each word runs its own call.
//
// Bound on the card: bytes. Each word is read and written once (8 bytes),
// against about 60 32-bit integer operations per word (20 rounds of
// add/rotate/xor per two words), which the integer pipes retire faster than
// HBM delivers the words. The design keeps the whole schedule in registers
// (fully unrolled rounds, key schedule computed once per thread) and lets
// neighbouring threads touch neighbouring words.
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

}  // extern "C"
