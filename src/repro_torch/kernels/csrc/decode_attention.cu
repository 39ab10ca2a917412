// Far-KV decode attention partials (flash-decoding) for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/decode_attention.py::
// decode_attention (`_kernel`) and its wrapper repro/kernels/ops.py::
// decode_attention. Contract: repro.kernels.ref.decode_attention for each
// (p, b) of a stack of KV shards, with m = -1e30 where no row is valid:
//   * q (PB, Hq, D) f32; k and v (PB, S, Hkv, D), f32 or bf16, contiguous
//     (far_kv's layout, with the pool and batch axes flattened to PB);
//     lengths (PB) i32, clamped to [0, S];
//   * query head j = h * G + g (G = Hq / Hkv) attends KV head h over the
//     rows r < lengths[pb]; s = scale * <q_j, k_r> in f32;
//   * o[pb, j] = sum_r exp(s_r - m) v_r (unnormalised), m = max_r s_r,
//     l = sum_r exp(s_r - m), all in f32; for an empty (pb, j): o = 0,
//     m = -1e30, l = 0.
// The TPU kernel pads G to 8 and D to 128 for its matrix unit and walks the
// S blocks in order, carrying (o, m, l) in its output blocks. Here no
// padding is needed, and blocks run in no order, so the rows are split.
//
// Design (flash-decoding, split over KV). Grid (PB, Hkv * n_gc, n_split);
// a block of 256 threads takes one KV head, up to 32 of its query rows
// (n_gc = ceil(G / 32) chunks of them) and one contiguous split of the
// rows. It holds its query rows and their running o in shared memory in
// f32 and walks its split below the length in tiles of T rows (T = 64 for
// D <= 128, else 32):
//   * stage: the tile's K and V rows, read once with 16-byte loads where
//     the row's bytes allow, converted to f32 into shared memory (K with a
//     row stride of D + 4 words, so that a quarter warp reading 8 rows 16
//     bytes at a time hits 32 banks; odd where loads are scalar);
//   * scores: one thread a (query row, tile row) pair, an f32 FMA dot;
//   * softmax: one warp a query row: tile max, m_new = max(m, tile max),
//     alpha = exp(m - m_new), p = exp(s - m_new), l = l * alpha + sum p;
//   * P.V: one thread an (query row, d) entry, o = o * alpha + sum p v.
// Rows at or past the length are neither read nor counted. Each split
// writes its (o, m, l); with more than one split a second kernel folds the
// splits of each (pb, j) in split order (no float atomics: deterministic).
//
// Bound on the card: bytes. The function reads each valid K and V row once
// (2 * Hkv * D elements a row) and does 4 * Hq * D flops a row, under one
// flop a byte for a bf16 cache; the f32 FMA pipes (no TF32, no bf16 mma)
// are far from the limit. The number of splits is chosen so that the grid
// covers the card several times over.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDim = 256;
constexpr int kMaxGroup = 32;      // query rows a block holds
constexpr int kBatch = 8;          // 16-byte loads in flight a thread
constexpr float kNegInf = -1.0e30f;
constexpr int kMaxDevices = 64;
constexpr int kVariants = 4;       // {f32, bf16} x {16-byte, scalar} loads

std::once_flag g_once[kMaxDevices][kVariants];
cudaError_t g_err[kMaxDevices][kVariants];

__host__ __device__ inline int tile_rows(int D) { return D <= 128 ? 64 : 32; }
// K's row stride in shared memory: D + 4 words for 16-byte accesses (8
// rows of a quarter warp fall in 32 banks), else odd (32 rows, 32 banks)
__host__ __device__ inline int k_stride(int D, bool vec) {
  return vec ? D + 4 : (D | 1);
}

size_t smem_bytes(int gc, int D) {
  const int T = tile_rows(D);
  return sizeof(float) * ((size_t)2 * gc * D          // q rows, running o
                          + (size_t)T * (D + 4)        // K tile
                          + (size_t)T * D              // V tile
                          + (size_t)gc * T             // scores, then p
                          + 3 * (size_t)gc);           // m, l, alpha
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xFFFFFFFFu, x, o);
  return x;
}

// VEC elements of type T as one load: 16 bytes, or one element
template <typename T, int VEC>
struct Chunk {
  static_assert(VEC * sizeof(T) == 16, "16-byte chunks");
  uint4 raw;
  __device__ __forceinline__ void load(const T* p) {
    raw = __ldcs(reinterpret_cast<const uint4*>(p));
  }
  // dst: 16-byte aligned shared memory
  __device__ __forceinline__ void store(float* dst) const {
    float4* d4 = reinterpret_cast<float4*>(dst);
    if constexpr (sizeof(T) == 4) {
      d4[0] = make_float4(__uint_as_float(raw.x), __uint_as_float(raw.y),
                          __uint_as_float(raw.z), __uint_as_float(raw.w));
    } else {   // bf16 -> f32 is exact: the bits move up 16 places
      d4[0] = make_float4(__uint_as_float(raw.x << 16),
                          __uint_as_float(raw.x & 0xFFFF0000u),
                          __uint_as_float(raw.y << 16),
                          __uint_as_float(raw.y & 0xFFFF0000u));
      d4[1] = make_float4(__uint_as_float(raw.z << 16),
                          __uint_as_float(raw.z & 0xFFFF0000u),
                          __uint_as_float(raw.w << 16),
                          __uint_as_float(raw.w & 0xFFFF0000u));
    }
  }
};

template <typename T>
struct Chunk<T, 1> {
  float val;
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (sizeof(T) == 4)
      val = __ldcs(reinterpret_cast<const float*>(p));
    else
      val = __uint_as_float(
          (uint32_t)__ldcs(reinterpret_cast<const unsigned short*>(p)) << 16);
  }
  __device__ __forceinline__ void store(float* dst) const { dst[0] = val; }
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
da_partial_kernel(const float* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ lengths,
                  float* __restrict__ o_out, float* __restrict__ m_out,
                  float* __restrict__ l_out, int S, int Hkv, int G, int D,
                  int n_gc, int chunk, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool kVec = VEC > 1;      // then D % 4 == 0
  const int T_ = tile_rows(D);
  const int ks = k_stride(D, kVec);
  const long long pb = blockIdx.x;
  const int h = blockIdx.y / n_gc;
  const int g0 = (blockIdx.y - h * n_gc) * kMaxGroup;
  const int gc = min(kMaxGroup, G - g0);
  const int split = blockIdx.z;
  const int n_split = gridDim.z;
  const int tid = threadIdx.x;

  float* s_q = smem;                  // gc x D
  float* s_o = s_q + gc * D;          // gc x D
  float* s_k = s_o + gc * D;          // T x ks
  float* s_v = s_k + T_ * ks;         // T x D
  float* s_p = s_v + T_ * D;          // gc x T
  float* s_m = s_p + gc * T_;         // gc
  float* s_l = s_m + gc;              // gc
  float* s_a = s_l + gc;              // gc

  const float* qb = q + ((size_t)pb * Hkv * G + (size_t)h * G + g0) * D;
  for (int i = tid; i < gc * D; i += kThreads) {
    s_q[i] = qb[i];
    s_o[i] = 0.f;
  }
  for (int i = tid; i < gc; i += kThreads) {
    s_m[i] = kNegInf;
    s_l[i] = 0.f;
  }
  const int len = max(0, min(lengths[pb], S));
  const int r0 = split * chunk;
  const int r1 = min(len, r0 + chunk);
  const size_t row_stride = (size_t)Hkv * D;
  const T* kb = k + ((size_t)pb * S * Hkv + h) * D;
  const T* vb = v + ((size_t)pb * S * Hkv + h) * D;
  const int vpr = D / VEC;            // chunks a row
  const int warp = tid >> 5, lane = tid & 31;

  for (int t0 = r0; t0 < r1; t0 += T_) {
    const int nt = min(T_, r1 - t0);
    __syncthreads();   // q, o, m, l in place; the last tile consumed
    // stage K (the first n chunks) and V (the next n) as f32
    const int n = nt * vpr;
    for (int base = tid; base < 2 * n; base += kThreads * kBatch) {
      Chunk<T, VEC> c[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = base + j * kThreads;
        if (i < 2 * n) {
          const bool is_v = i >= n;
          const int ii = is_v ? i - n : i;
          const int row = ii / vpr;
          c[j].load((is_v ? vb : kb) + (size_t)(t0 + row) * row_stride
                    + (size_t)(ii - row * vpr) * VEC);
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = base + j * kThreads;
        if (i < 2 * n) {
          const bool is_v = i >= n;
          const int ii = is_v ? i - n : i;
          const int row = ii / vpr;
          const int col = (ii - row * vpr) * VEC;
          c[j].store(is_v ? s_v + row * D + col : s_k + row * ks + col);
        }
      }
    }
    __syncthreads();
    // scores: thread i takes query row i / T and tile row i % T
    for (int i = tid; i < gc * T_; i += kThreads) {
      const int g = i / T_;
      const int t = i - g * T_;
      if (t < nt) {
        const float* kr = s_k + t * ks;
        const float* qr = s_q + g * D;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        int d = 0;
        if constexpr (kVec) {
          const float4* k4 = reinterpret_cast<const float4*>(kr);
          const float4* q4 = reinterpret_cast<const float4*>(qr);
          for (; d < D / 4; ++d) {
            const float4 a = q4[d], b = k4[d];
            a0 = fmaf(a.x, b.x, a0);
            a1 = fmaf(a.y, b.y, a1);
            a2 = fmaf(a.z, b.z, a2);
            a3 = fmaf(a.w, b.w, a3);
          }
        } else {
          for (; d + 4 <= D; d += 4) {
            a0 = fmaf(qr[d], kr[d], a0);
            a1 = fmaf(qr[d + 1], kr[d + 1], a1);
            a2 = fmaf(qr[d + 2], kr[d + 2], a2);
            a3 = fmaf(qr[d + 3], kr[d + 3], a3);
          }
          for (; d < D; ++d) a0 = fmaf(qr[d], kr[d], a0);
        }
        s_p[i] = ((a0 + a1) + (a2 + a3)) * scale;
      }
    }
    __syncthreads();
    // running max and sum: a warp a query row
    for (int g = warp; g < gc; g += kWarps) {
      float* row = s_p + g * T_;
      float mx = kNegInf;
      for (int t = lane; t < nt; t += 32) mx = fmaxf(mx, row[t]);
      mx = warp_max(mx);
      const float m_old = s_m[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < nt; t += 32) {
        const float p = expf(row[t] - m_new);
        row[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        s_a[g] = a;
        s_l[g] = s_l[g] * a + sum;
        s_m[g] = m_new;
      }
    }
    __syncthreads();
    // o = o * alpha + p . V: thread i keeps entry i of every tile
    for (int i = tid; i < gc * D; i += kThreads) {
      const int g = i / D;
      const int d = i - g * D;
      const float* pr = s_p + g * T_;
      float acc = s_o[i] * s_a[g];
      for (int t = 0; t < nt; ++t) acc = fmaf(pr[t], s_v[t * D + d], acc);
      s_o[i] = acc;
    }
  }
  __syncthreads();
  const size_t slot = (((size_t)pb * Hkv + h) * n_split + split) * G + g0;
  for (int i = tid; i < gc * D; i += kThreads) o_out[slot * D + i] = s_o[i];
  for (int i = tid; i < gc; i += kThreads) {
    m_out[slot + i] = s_m[i];
    l_out[slot + i] = s_l[i];
  }
}

// one block a (pb, query head): fold the splits in split order
__global__ void da_combine_kernel(const float* __restrict__ o_s,
                                  const float* __restrict__ m_s,
                                  const float* __restrict__ l_s,
                                  float* __restrict__ o, float* __restrict__ m,
                                  float* __restrict__ l, int G, int D,
                                  int n_split) {
  const size_t row = blockIdx.x;            // pb * Hq + h * G + g
  const size_t pbh = row / G;
  const int g = (int)(row - pbh * G);
  const size_t base = pbh * n_split * G + g;
  float mx = kNegInf;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, m_s[base + (size_t)s * G]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const size_t slot = base + (size_t)s * G;
      acc += o_s[slot * D + d] * expf(m_s[slot] - mx);
    }
    o[row * D + d] = acc;
  }
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const size_t slot = base + (size_t)s * G;
      acc += l_s[slot] * expf(m_s[slot] - mx);
    }
    m[row] = mx;
    l[row] = acc;
  }
}

template <typename T, int VEC>
cudaError_t launch(int variant, const void* q, const void* k, const void* v,
                   const void* lengths, void* o, void* m, void* l,
                   long long PB, int S, int Hkv, int G, int D, int n_split,
                   float scale, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  // the largest block's shared memory is allowed once per device
  std::call_once(g_once[dev][variant], [dev, variant] {
    g_err[dev][variant] = cudaFuncSetAttribute(
        da_partial_kernel<T, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(kMaxGroup, kMaxDim));
  });
  if (g_err[dev][variant] != cudaSuccess) return g_err[dev][variant];
  const int n_gc = (G + kMaxGroup - 1) / kMaxGroup;
  const int rows = tile_rows(D);
  const long long tiles = (S + rows - 1) / rows;
  const long long per = (tiles + n_split - 1) / n_split;
  const int chunk = (int)(per * rows);
  const dim3 grid((unsigned)PB, (unsigned)(Hkv * n_gc), (unsigned)n_split);
  da_partial_kernel<T, VEC><<<grid, kThreads, smem_bytes(min(G, kMaxGroup), D),
                              stream>>>(
      (const float*)q, (const T*)k, (const T*)v, (const int*)lengths,
      (float*)o, (float*)m, (float*)l, S, Hkv, G, D, n_gc, chunk, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int da_tile_rows(int D) { return tile_rows(D); }
int da_group_chunk() { return kMaxGroup; }
const char* da_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (PB, Hkv * G, D) f32; k, v (PB, S, Hkv, D) f32 (bf16 = 0) or bf16
// (bf16 = 1); lengths (PB) i32; o (PB, Hkv, n_split, G, D), m and l (PB,
// Hkv, n_split, G) f32: device pointers, all contiguous. With n_split = 1
// these are the shard's partials, (PB, Hq, D) and (PB, Hq). Returns
// cudaGetLastError().
int da_partial(const void* q, const void* k, const void* v,
               const void* lengths, void* o, void* m, void* l, long long PB,
               int S, int Hkv, int G, int D, int n_split, float scale,
               int bf16, void* stream) {
  const int n_gc = (G + kMaxGroup - 1) / kMaxGroup;
  if (PB < 1 || PB > 2147483647LL || S < 0 || Hkv < 1 || G < 1 || D < 1
      || D > kMaxDim || n_split < 1 || n_split > 65535
      || (long long)Hkv * n_gc > 65535)
    return cudaErrorInvalidValue;
  const size_t elt = bf16 ? 2 : 4;
  const bool vec = (D * elt) % 16 == 0 && ((uintptr_t)k & 15) == 0
                   && ((uintptr_t)v & 15) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (bf16)
    err = vec ? launch<__nv_bfloat16, 8>(0, q, k, v, lengths, o, m, l, PB, S,
                                         Hkv, G, D, n_split, scale, st)
              : launch<__nv_bfloat16, 1>(1, q, k, v, lengths, o, m, l, PB, S,
                                         Hkv, G, D, n_split, scale, st);
  else
    err = vec ? launch<float, 4>(2, q, k, v, lengths, o, m, l, PB, S, Hkv, G,
                                 D, n_split, scale, st)
              : launch<float, 1>(3, q, k, v, lengths, o, m, l, PB, S, Hkv, G,
                                 D, n_split, scale, st);
  return (int)err;
}

// o_s, m_s, l_s: da_partial's outputs for n_split > 1 splits; o (PB, Hq,
// D), m and l (PB, Hq) f32, Hq = Hkv * G. Returns cudaGetLastError().
int da_combine(const void* o_s, const void* m_s, const void* l_s, void* o,
               void* m, void* l, long long PB, int Hkv, int G, int D,
               int n_split, void* stream) {
  const long long rows = PB * Hkv * G;
  if (rows < 1 || rows > 2147483647LL || D < 1 || D > kMaxDim || n_split < 1)
    return cudaErrorInvalidValue;
  const int threads = ((D + 31) / 32) * 32;
  da_combine_kernel<<<(unsigned)rows, threads, 0, (cudaStream_t)stream>>>(
      (const float*)o_s, (const float*)m_s, (const float*)l_s, (float*)o,
      (float*)m, (float*)l, G, D, n_split);
  return (int)cudaGetLastError();
}

}  // extern "C"
