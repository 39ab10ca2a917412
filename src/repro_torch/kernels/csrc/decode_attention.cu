// Far-KV decode attention partials (flash-decoding) for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/decode_attention.py::
// decode_attention (`_kernel`) and its wrapper repro/kernels/ops.py::
// decode_attention. Contract: repro.kernels.ref.decode_attention for each
// (p, b) of a stack of KV shards, with m = -1e30 where no row is valid:
//   * q (P, B, Hq, D) f32 or bf16, each (p, b)'s (Hq, D) contiguous, any
//     stride over P and B (0 for a query replicated over the shards); k
//     and v (PB, S, Hkv, D), f32 or bf16, contiguous (far_kv's layout,
//     with the pool and batch axes flattened to PB); lengths (PB) i32,
//     clamped to [0, S];
//   * query head j = h * G + g (G = Hq / Hkv) attends KV head h over the
//     rows r < lengths[pb]; s = scale * <q_j, k_r> in f32;
//   * o[pb, j] = sum_r exp(s_r - m) v_r (unnormalised), m = max_r s_r,
//     l = sum_r exp(s_r - m), all in f32; for an empty (pb, j): o = 0,
//     m = -1e30, l = 0; where some s_r is +inf or NaN, m = 0 and p =
//     exp(s_r), as the reference's `msafe` takes it.
// The TPU kernel pads G to 8 and D to 128 for its matrix unit and walks the
// S blocks in order, carrying (o, m, l) in its output blocks. Here no
// padding is needed, and blocks run in no order, so the rows are split.
//
// What bounds it on the card: bytes. The function reads each valid K and V
// row once (2 * Hkv * D elements a row) and does 4 * Hq * D f32 flops a
// row, under one flop a byte for a bf16 cache. The kernel PR 19 wrote
// reached 35% of that bound: (1) its phases never overlapped, a tile's
// loads in flight only while the block staged it (f32 tiles, 71 KB a
// block, 3 blocks an SM); (2) its shared-memory traffic (~3,800 wavefronts
// a 64-row tile, K read once a query row) took longer than the bound; (3)
// its wrapper copied q to f32 every call, and its splits assumed 8 blocks
// an SM. This design answers each:
//
// Flash-decoding, split over KV. Grid (PB * Hkv * n_gc, n_split), the KV
// heads of a (pb) next to each other; a block takes one KV head, up to 8 of
// its query rows (n_gc = ceil(G / 8) chunks of them) and one contiguous
// split of the rows. Rows of 16-byte multiples go to a streaming kernel:
//   * (1) loads kept in flight: each of the block's 4 warps walks its own
//     stages (stage j of the split to warp j % 4) through a ring of 2 slots
//     in shared memory, filled with 16-byte `cp.async.cg` copies in the
//     cache's own type, so that a stage loads while the one before it is
//     computed; a stage is at most 4 KB of K and 4 KB of V, so 3 blocks
//     (12 warps, 64-72 KB each) fit on an SM, ~190 KB of ring in all. No
//     __syncthreads inside the loop: a warp waits on its own copies
//     (`cp.async.wait_group`, `__syncwarp`). q is read in place, f32 or
//     bf16, with any stride over (P, B);
//   * (2) shared memory read once an element. bf16 caches at D = 64 or 128
//     with G <= 4 (the far-KV path's) take the tensor cores (`mma.sync`
//     m16n8k16): K and V stages of 16 rows, XOR-swizzled so `ldmatrix`
//     reads 8 rows at once without bank conflicts; q and p are split
//     exactly into three bf16 parts (below), so the arithmetic is f32's;
//     the softmax stays in the product's registers; K's slot refills as
//     soon as the scores have read it, V's after P.V; q waits in a ring
//     slot until it is in registers. Other 16-byte rows
//     (f32 caches, other D or G) take f32 FMAs: in the scores, lpr lanes
//     share a row and read each K chunk once for all query rows, q
//     broadcast; in P.V a lane owns a 16-byte chunk of the row for all
//     query rows, p broadcast (~200 wavefronts a 16-row bf16 stage). Where
//     both could run, the tensor-core kernel is the faster at every far-KV
//     shape: chip_smoke times the FMA kernel in its place, from a build
//     with -DDA_FMA_ONLY;
//   * the softmax per warp: a stage's max, m_new, alpha = exp(m - m_new),
//     p = exp(s - m_new), the running o in registers rescaled; l summed
//     once at the end.
// The warps' (o, m, l) are folded in warp order at the end of the block,
// the splits in split order by a second kernel (no float atomics: two
// launches are bitwise equal). Rows at or past the length are neither read
// nor counted. (3) The wrapper splits the rows so that the grid fills the
// card's resident blocks (the occupancy, `da_blocks_per_sm`) about twice.
// Rows of other sizes (scalar loads, e.g. D = 20 bf16) go to a staging
// kernel: a tile of K and V as f32 in shared memory, then scores, softmax
// and P.V one after another.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

namespace {

constexpr int kMaxDim = 256;
constexpr int kGroup = 8;          // query rows a block holds
constexpr float kNegInf = -1.0e30f;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xFFFFFFFFu;
// the streaming kernel
constexpr int kWarps = 4;          // warps a block, each over its own stages
constexpr int kStages = 2;         // ring slots a warp
constexpr int kStageBytes = 4096;  // K bytes a stage at most (V as much)
// the staging kernel (scalar loads)
constexpr int kThreads = 256;
constexpr int kBatch = 8;          // loads in flight a thread
// variants: the streaming kernel's {f32, bf16} x {1, 2, 4, 8} query rows,
// the staging kernel's {f32, bf16}, the tensor-core kernel's {64, 128} x
// {1, 2, 4}
constexpr int kVariants = 16;

std::once_flag g_once[kMaxDevices][kVariants];
cudaError_t g_err[kMaxDevices][kVariants];

// ---------------------------------------------------------------- streaming
// The f32 FMA kernel. A stage's shape for rows of D elements of elt bytes
// (a multiple of 16).
struct Geom {
  int C;    // 16-byte chunks a row
  int lpr;  // lanes a row in the scores (a power of 2)
  int rs;   // rows a stage: 32 / lpr
  int ks;   // K's row stride in shared memory, in chunks
  __host__ __device__ Geom(int D, int elt) {
    C = D * elt / 16;
    lpr = 1;
    while (lpr < 32 && (32 / lpr) * D * elt > kStageBytes) lpr *= 2;
    rs = 32 / lpr;
    // ks = lpr (mod 8): a quarter warp's 8 lanes, 8 / lpr rows of lpr
    // chunks each, fall in distinct 16-byte bank groups
    ks = C;
    if (lpr < 8)
      while (ks % 8 != lpr) ++ks;
  }
  __host__ __device__ int stage_bytes() const { return rs * (ks + C) * 16; }
  // a warp's ring, which then holds its (GC, D) f32 partial o
  __host__ __device__ int ring_bytes(int GC, int D) const {
    const int ring = kStages * stage_bytes();
    return ring > GC * D * 4 ? ring : GC * D * 4;
  }
};

size_t stream_smem(int D, int elt, int GC) {
  const Geom ge(D, elt);
  return sizeof(float) * ((size_t)GC * D            // q rows
                          + (size_t)kWarps * 32 * GC  // p of a stage
                          + 2 * (size_t)kWarps * GC)  // warps' m, l
         + (size_t)kWarps * ge.ring_bytes(GC, D);
}

// a 16-byte chunk of the cache as f32
template <typename T>
struct Unpack;
template <>
struct Unpack<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void run(const uint4& w, float* f) {
    f[0] = __uint_as_float(w.x);
    f[1] = __uint_as_float(w.y);
    f[2] = __uint_as_float(w.z);
    f[3] = __uint_as_float(w.w);
  }
};
template <>
struct Unpack<__nv_bfloat16> {   // exact: the bits move up 16 places
  static constexpr int N = 8;
  __device__ __forceinline__ static void run(const uint4& w, float* f) {
    f[0] = __uint_as_float(w.x << 16);
    f[1] = __uint_as_float(w.x & 0xFFFF0000u);
    f[2] = __uint_as_float(w.y << 16);
    f[3] = __uint_as_float(w.y & 0xFFFF0000u);
    f[4] = __uint_as_float(w.z << 16);
    f[5] = __uint_as_float(w.z & 0xFFFF0000u);
    f[6] = __uint_as_float(w.w << 16);
    f[7] = __uint_as_float(w.w & 0xFFFF0000u);
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The running softmax and non-finite scores. fmaxf drops NaN, and exp(inf
// - inf) is NaN, so a (pb, query row) that meets a +inf or NaN score takes
// 0 as its base from then on (the reference's msafe: m = 0, p = exp(s)).
// Its running m then holds +inf as a mark, which no finite max reaches;
// the folds of warps and splits rebase every partial of a marked row to 0
// and write m = 0. The common path pays a select a score and a compare a
// stage.
__device__ __forceinline__ float mark() { return __int_as_float(0x7F800000); }
__device__ __forceinline__ bool marked(float m) { return m == mark(); }
// the base a running m (or a partial's m) stands for
__device__ __forceinline__ float base_of(float m) {
  return marked(m) ? 0.f : m;
}
// a score as the running max reads it: NaN counts as +inf
__device__ __forceinline__ float max_key(float s) {
  return s != s ? mark() : s;
}
// one stage of the running softmax: m the running max (or the mark), mx
// the stage's largest max_key(score). Returns the stage's base (p = exp(s
// - base)); alpha rescales the o and l kept so far.
__device__ __forceinline__ float step_base(float& m, float mx, float& alpha) {
  const bool flag = marked(m) || marked(mx);
  const float base = flag ? 0.f : fmaxf(m, mx);
  alpha = expf(base_of(m) - base);
  m = flag ? mark() : base;
  return base;
}
// m as the kernel writes it: a split's partial keeps the mark for the
// combine; the shard's result (one split) reads 0 there
__device__ __forceinline__ float m_written(float m, int n_split) {
  return n_split == 1 && marked(m) ? 0.f : m;
}

__device__ __forceinline__ float q_elem(const void* q, int q_bf16, size_t i) {
  return q_bf16 ? __uint_as_float(
                      (uint32_t)(reinterpret_cast<const unsigned short*>(q)[i])
                      << 16)
                : reinterpret_cast<const float*>(q)[i];
}

// q rows g0 .. g0 + gc of KV head h of (pb) into s_q (GC x D f32, zero past
// gc); every thread of the block takes part
__device__ __forceinline__ void load_q(float* s_q, const void* q,
                                       long long q_sp, long long q_sb,
                                       int q_bf16, long long pb, int B, int h,
                                       int G, int g0, int gc, int GC, int D,
                                       int threads) {
  const long long p = pb / B, b = pb - p * B;
  const size_t off = (size_t)(p * q_sp + b * q_sb) + ((size_t)h * G + g0) * D;
  // 8 loads a thread in flight at once
  for (int base = threadIdx.x; base < GC * D; base += 8 * threads) {
    float x[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int i = base + t * threads;
      x[t] = i < gc * D ? q_elem(q, q_bf16, off + i) : 0.f;
    }
#pragma unroll
    for (int t = 0; t < 8; ++t)
      if (base + t * threads < GC * D) s_q[base + t * threads] = x[t];
  }
}

// The block's partial from its warps' (o at the head of each ring, m, l),
// folded in warp order; written at `slot` of (o, m, l)
template <int GC>
__device__ __forceinline__ void fold_warps(const unsigned char* rings,
                                           int ring_bytes, const float* s_m,
                                           const float* s_l, int gc, int D,
                                           float* o_out, float* m_out,
                                           float* l_out, size_t slot) {
  for (int i = threadIdx.x; i < gc * D; i += kWarps * 32) {
    const int g = i / D;
    float mx = kNegInf;   // the mark, where any warp has it
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w * GC + g]);
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      acc += reinterpret_cast<const float*>(rings + w * ring_bytes)[i] *
             expf(base_of(s_m[w * GC + g]) - base_of(mx));
    o_out[slot * D + i] = acc;
  }
  for (int g = threadIdx.x; g < gc; g += kWarps * 32) {
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w * GC + g]);
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      acc += s_l[w * GC + g] * expf(base_of(s_m[w * GC + g]) - base_of(mx));
    m_out[slot + g] = m_written(mx, gridDim.y);
    l_out[slot + g] = acc;
  }
}

// 3 blocks an SM (2 at 8 query rows, whose shared memory allows no more)
template <typename T, int GC>
__global__ void __launch_bounds__(kWarps * 32, GC >= 8 ? 2 : 3)
da_stream_kernel(const void* __restrict__ q, long long q_sp, long long q_sb,
                 int q_bf16, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ lengths,
                 float* __restrict__ o_out, float* __restrict__ m_out,
                 float* __restrict__ l_out, int B, int S, int Hkv, int G,
                 int D, int n_gc, int chunk, float scale) {
  using U = Unpack<T>;
  constexpr int N = U::N;                     // elements a chunk
  constexpr int NCH = sizeof(T) == 4 ? 2 : 1;  // o chunks a lane (C <= 32 NCH)
  constexpr int NA = GC >= 4 ? 1 : 4 / GC;     // accumulators a score
  extern __shared__ __align__(16) unsigned char smem[];
  const Geom ge(D, sizeof(T));
  const int C = ge.C, lpr = ge.lpr, rs = ge.rs, ks = ge.ks;
  const int stage_bytes = ge.stage_bytes();
  const int ring_bytes = ge.ring_bytes(GC, D);
  const long long pb = blockIdx.x / (Hkv * n_gc);
  const int hy = (int)(blockIdx.x - pb * Hkv * n_gc);
  const int h = hy / n_gc;
  const int g0 = (hy - h * n_gc) * GC;
  const int gc = min(GC, G - g0);
  const int split = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float* s_q = reinterpret_cast<float*>(smem);   // GC x D
  float* s_p = s_q + GC * D;                      // kWarps x 32 x GC
  float* s_m = s_p + kWarps * 32 * GC;            // kWarps x GC
  float* s_l = s_m + kWarps * GC;                 // kWarps x GC
  unsigned char* rings = reinterpret_cast<unsigned char*>(s_l + kWarps * GC);
  unsigned char* ring = rings + warp * ring_bytes;
  float* w_p = s_p + warp * 32 * GC;

  load_q(s_q, q, q_sp, q_sb, q_bf16, pb, B, h, G, g0, gc, GC, D, kWarps * 32);
  const int len = max(0, min(lengths[pb], S));
  const long long r0l = (long long)split * chunk;
  const int r0 = (int)min(r0l, (long long)len);
  const int r1 = (int)min((long long)len, r0l + chunk);
  const int nst = (r1 - r0 + rs - 1) / rs;        // stages of the block
  const size_t row_stride = (size_t)Hkv * D;
  const T* kb = k + ((size_t)pb * S * Hkv + h) * D;
  const T* vb = v + ((size_t)pb * S * Hkv + h) * D;

  // stage j of the block into ring slot `slot` (an empty group past nst)
  auto issue = [&](int j, int slot) {
    if (j < nst) {
      const int t0 = r0 + j * rs;
      const int nv = min(rs, r1 - t0);
      uint4* sk = reinterpret_cast<uint4*>(ring + slot * stage_bytes);
      uint4* sv = sk + rs * ks;
      // chunk i = r * C + c of the stage, i = lane, lane + 32, ...
      const int dr = 32 / C, dc = 32 - dr * C;
      int r = lane / C, c = lane - r * C;
      while (r < nv) {
        const size_t off = (size_t)(t0 + r) * row_stride + (size_t)c * N;
        cp_async16(sk + r * ks + c, kb + off);
        cp_async16(sv + r * C + c, vb + off);
        r += dr;
        c += dc;
        if (c >= C) {
          c -= C;
          ++r;
        }
      }
    }
    cp_commit();
  };

  // scores: lane = (row, part); P.V: lane = (row group rg, chunk cv)
  const int lg = __ffs(lpr) - 1;
  const int row = lane >> lg, part = lane & (lpr - 1);
  const int pr = C >= 32 ? 1 : 32 / C;
  const int rg = C >= 32 ? 0 : lane / C;
  const int cv = lane - rg * (C >= 32 ? 0 : C);
  const bool pv_on = rg < pr;

  float m[GC], lsum[GC], o[GC][NCH * N];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = kNegInf;
    lsum[g] = 0.f;
#pragma unroll
    for (int x = 0; x < NCH * N; ++x) o[g][x] = 0.f;
  }

  __syncthreads();   // q in place
  const int mine = nst > warp ? (nst - warp + kWarps - 1) / kWarps : 0;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(warp + i * kWarps, i);
  for (int i = 0; i < mine; ++i) {
    issue(warp + (i + kStages - 1) * kWarps, (i + kStages - 1) % kStages);
    cp_wait<kStages - 1>();   // this lane's copies of stage i have landed
    __syncwarp();             // and every lane's
    const uint4* sk =
        reinterpret_cast<const uint4*>(ring + (i % kStages) * stage_bytes);
    const uint4* sv = sk + rs * ks;
    const int t0 = r0 + (warp + i * kWarps) * rs;
    const int nv = min(rs, r1 - t0);

    // scores of this lane's row, its chunks part, part + lpr, ...
    float acc[GC][NA];
#pragma unroll
    for (int g = 0; g < GC; ++g)
#pragma unroll
      for (int a = 0; a < NA; ++a) acc[g][a] = 0.f;
    const uint4* kr = sk + row * ks;
#pragma unroll 2
    for (int c = part; c < C; c += lpr) {
      float kf[N];
      U::run(kr[c], kf);
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        const float4* q4 = reinterpret_cast<const float4*>(s_q + g * D + c * N);
#pragma unroll
        for (int e = 0; e < N / 4; ++e) {
          const float4 qq = q4[e];
          acc[g][0 % NA] = fmaf(qq.x, kf[4 * e], acc[g][0 % NA]);
          acc[g][1 % NA] = fmaf(qq.y, kf[4 * e + 1], acc[g][1 % NA]);
          acc[g][2 % NA] = fmaf(qq.z, kf[4 * e + 2], acc[g][2 % NA]);
          acc[g][3 % NA] = fmaf(qq.w, kf[4 * e + 3], acc[g][3 % NA]);
        }
      }
    }
    // softmax over the stage, the running max and rescale
    float alpha[GC];
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float s = acc[g][0];
#pragma unroll
      for (int a = 1; a < NA; ++a) s += acc[g][a];
      for (int off = lpr >> 1; off > 0; off >>= 1)
        s += __shfl_xor_sync(kFull, s, off);
      s = row < nv ? s * scale : __int_as_float(0xFF800000);   // -inf
      float mx = max_key(s);
      for (int off = lpr; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float base = step_base(m[g], mx, alpha[g]);
      const float p = expf(s - base);           // 0 past the length
      lsum[g] = lsum[g] * alpha[g] + (part == 0 ? p : 0.f);
      if (part == 0) w_p[row * GC + g] = p;
    }
#pragma unroll
    for (int g = 0; g < GC; ++g)
#pragma unroll
      for (int x = 0; x < NCH * N; ++x) o[g][x] *= alpha[g];
    __syncwarp();   // p in place
    // o += p . V: this lane's chunk(s) of rows rg, rg + pr, ...
    if (pv_on) {
      for (int rr = rg; rr < nv; rr += pr) {
        float pp[GC];
        if constexpr (GC % 4 == 0) {
#pragma unroll
          for (int g = 0; g < GC; g += 4) {
            const float4 t =
                *reinterpret_cast<const float4*>(w_p + rr * GC + g);
            pp[g] = t.x;
            pp[g + 1] = t.y;
            pp[g + 2] = t.z;
            pp[g + 3] = t.w;
          }
        } else {
#pragma unroll
          for (int g = 0; g < GC; ++g) pp[g] = w_p[rr * GC + g];
        }
#pragma unroll
        for (int n = 0; n < NCH; ++n) {
          const int c = cv + 32 * n;
          if (n == 0 || c < C) {
            float vf[N];
            U::run(sv[rr * C + c], vf);
#pragma unroll
            for (int g = 0; g < GC; ++g)
#pragma unroll
              for (int e = 0; e < N; ++e)
                o[g][n * N + e] = fmaf(pp[g], vf[e], o[g][n * N + e]);
          }
        }
      }
    }
    __syncwarp();   // the stage and p consumed
  }
  cp_wait<0>();

  // fold the row groups into rg = 0 in order, sum l over the lanes
  for (int j = 1; j < pr; ++j) {
#pragma unroll
    for (int g = 0; g < GC; ++g)
#pragma unroll
      for (int x = 0; x < NCH * N; ++x) {
        const float t = __shfl_sync(kFull, o[g][x], (lane + j * C) & 31);
        if (rg == 0) o[g][x] += t;
      }
  }
#pragma unroll
  for (int g = 0; g < GC; ++g)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      lsum[g] += __shfl_xor_sync(kFull, lsum[g], off);
  // the warp's partial into its ring, then the warps folded in order
  float* w_o = reinterpret_cast<float*>(ring);
  if (pv_on && rg == 0) {
#pragma unroll
    for (int n = 0; n < NCH; ++n) {
      const int c = cv + 32 * n;
      if (n == 0 || c < C) {
#pragma unroll
        for (int g = 0; g < GC; ++g)
#pragma unroll
          for (int e = 0; e < N; e += 4)
            *reinterpret_cast<float4*>(w_o + g * D + c * N + e) =
                make_float4(o[g][n * N + e], o[g][n * N + e + 1],
                            o[g][n * N + e + 2], o[g][n * N + e + 3]);
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      s_m[warp * GC + g] = m[g];
      s_l[warp * GC + g] = lsum[g];
    }
  }
  __syncthreads();
  fold_warps<GC>(rings, ring_bytes, s_m, s_l, gc, D, o_out, m_out, l_out,
                 (((size_t)pb * Hkv + h) * gridDim.y + split) * G + g0);
}

// ------------------------------------------------------------- tensor cores
// bf16 caches at D = 64 or 128 with up to 4 query rows a KV head: the
// streaming kernel's ring and fold, its two products on the tensor cores.
// q and p are f32; each is split exactly into three bf16 parts (hi =
// bf16(x), mid = bf16(x - hi), lo = x - hi - mid, which bf16 holds
// exactly), stacked as rows s * GC + g of a 16-row tile, so that one
// m16n8k16 product covers all three. A product of a part and a bf16 K or V
// element is exact in f32 and the sums are f32: the arithmetic is that of
// f32 over the stored values, in another order. Where part 0's sum is not
// finite (an infinite K or V element, an infinite or NaN p), that sum is
// taken alone: its infinities carry the reference's signs, and a zero
// part of the others times an infinity would be NaN (part_sum). A
// nonzero x of at most 2^-134, which bf16 rounds to 0, splits into
// (s, -s, 0) with s = +-2^-133 of x's sign: the parts still sum to the 0
// that it split into before, but part 0 times an infinite K or V element
// is an infinity of the reference's sign, where three zero parts would
// give NaN.
constexpr int kMmaRows = 16;   // rows a stage

bool mma_takes(int D, int G, int bf16) {
#ifdef DA_FMA_ONLY   // a build that times the FMA kernel in this one's place
  return false;
#endif
  return bf16 && (D == 64 || D == 128) && G <= 4;
}

size_t mma_smem(int D, int GC) {
  const int stage = kMmaRows * D * 2 * 2;   // K and V rows, bf16
  const int ring = kStages * stage > 16 * D * 4 ? kStages * stage
                                                 : 16 * D * 4;
  // q's parts (16 x D bf16) wait in the last slot of warp 0's ring
  return (size_t)kWarps * ring
         + 2 * sizeof(float) * kWarps * GC;    // warps' m, l
}

__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two bf16 as an mma operand register (a at the lower column)
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 a, __nv_bfloat16 b) {
  return (uint32_t)__bfloat16_as_ushort(a)
         | ((uint32_t)__bfloat16_as_ushort(b) << 16);
}
// the three bf16 parts of x, each exact, their sum x (0 where |x| <=
// 2^-134, part 0 then nonzero of x's sign)
__device__ __forceinline__ void split3(float x, __nv_bfloat16* part) {
  part[0] = __float2bfloat16_rn(x);
  const float r = x - __bfloat162float(part[0]);
  part[1] = __float2bfloat16_rn(r);
  part[2] = __float2bfloat16_rn(r - __bfloat162float(part[1]));
  if (x != 0.f && __bfloat162float(part[0]) == 0.f) {
    part[0] = __ushort_as_bfloat16(
        (unsigned short)((__float_as_uint(x) >> 16 & 0x8000u) | 1u));
    part[1] = __ushort_as_bfloat16(__bfloat16_as_ushort(part[0]) ^ 0x8000u);
    part[2] = __float2bfloat16_rn(0.f);
  }
}

// the three parts' sum, part 0 alone where it is not finite
__device__ __forceinline__ float part_sum(float p0, float p1, float p2) {
  return (__float_as_uint(p0) & 0x7F800000u) == 0x7F800000u ? p0
                                                             : (p0 + p1) + p2;
}

// K, V and the stacked q as rows of C 16-byte chunks, chunk c of row r at
// r * C + (c ^ (r & 7)): 8 rows read at one chunk hit 8 bank groups
template <int C>
__device__ __forceinline__ int swz(int r, int c) {
  return r * C + (c ^ (r & 7));
}

template <int GC, int D>
__global__ void __launch_bounds__(kWarps * 32, 3)
da_mma_kernel(const void* __restrict__ q, long long q_sp, long long q_sb,
              int q_bf16, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const int* __restrict__ lengths, float* __restrict__ o_out,
              float* __restrict__ m_out, float* __restrict__ l_out, int B,
              int S, int Hkv, int G, int n_gc, int chunk, float scale) {
  constexpr int C = D / 8;                   // 16-byte chunks a row
  constexpr int KT = D / 16;                 // k-tiles of the scores
  constexpr int DT = D / 8;                  // n-tiles (of d) of P.V
  constexpr int kStage = kMmaRows * C * 16 * 2;
  constexpr int kRing = kStages * kStage > 16 * D * 4 ? kStages * kStage
                                                       : 16 * D * 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const long long pb = blockIdx.x / (Hkv * n_gc);
  const int hy = (int)(blockIdx.x - pb * Hkv * n_gc);
  const int h = hy / n_gc;
  const int g0 = (hy - h * n_gc) * GC;
  const int gc = min(GC, G - g0);
  const int split = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;

  unsigned char* rings = smem;                    // kWarps x kRing
  unsigned char* ring = rings + warp * kRing;
  float* s_m = reinterpret_cast<float*>(rings + kWarps * kRing);  // x GC
  float* s_l = s_m + kWarps * GC;                                 // x GC
  // q's parts (16 x C chunks) in warp 0's last slot until they are in
  // registers; that slot's first stage loads after
  uint4* s_qs = reinterpret_cast<uint4*>(rings + (kStages - 1) * kStage);

  const int len = max(0, min(lengths[pb], S));
  const long long r0l = (long long)split * chunk;
  const int r0 = (int)min(r0l, (long long)len);
  const int r1 = (int)min((long long)len, r0l + chunk);
  const int nst = (r1 - r0 + kMmaRows - 1) / kMmaRows;
  const size_t row_stride = (size_t)Hkv * D;
  const __nv_bfloat16* kb = k + ((size_t)pb * S * Hkv + h) * D;
  const __nv_bfloat16* vb = v + ((size_t)pb * S * Hkv + h) * D;

  // K (is_v = 0) or V (is_v = 1) of stage j into ring slot `slot`, one commit
  // group: rows below the length, V's zero past it (p is 0 there, and 0
  // times a stale NaN is not 0). K and V are separate groups so that a
  // slot's K refills as soon as the scores have read it.
  auto issue = [&](int j, int slot, int is_v) {
    if (j < nst) {
      const int t0 = r0 + j * kMmaRows;
      const int nv = min(kMmaRows, r1 - t0);
      uint4* dst = reinterpret_cast<uint4*>(ring + slot * kStage)
                   + is_v * kMmaRows * C;
      const __nv_bfloat16* src = is_v ? vb : kb;
#pragma unroll
      for (int i = lane; i < kMmaRows * C; i += 32) {
        const int r = i / C, c = i % C;
        const bool in = r < nv;
        const size_t off = (size_t)(t0 + (in ? r : 0)) * row_stride + c * 8;
        if (in || is_v) cp_async16_zfill(dst + swz<C>(r, c), src + off,
                                         in ? 16 : 0);
      }
    }
    cp_commit();
  };

  // the first stages load while q does
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    issue(warp + i * kWarps, i, 0);
    issue(warp + i * kWarps, i, 1);
  }
  // q's parts as rows s * GC + g, zero past gc and past 3 * GC; a thread's
  // loads all in flight at once
  {
    constexpr int QT = (GC * D + kWarps * 32 - 1) / (kWarps * 32);
    const long long p = pb / B, b = pb - p * B;
    const size_t off =
        (size_t)(p * q_sp + b * q_sb) + ((size_t)h * G + g0) * D;
    __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(s_qs);
    float x[QT];
#pragma unroll
    for (int t = 0; t < QT; ++t) {
      const int i = threadIdx.x + t * kWarps * 32;
      x[t] = i < gc * D ? q_elem(q, q_bf16, off + i) : 0.f;
    }
#pragma unroll
    for (int t = 0; t < QT; ++t) {
      const int i = threadIdx.x + t * kWarps * 32;
      if (i < GC * D) {
        const int g = i / D, d = i % D;
        __nv_bfloat16 part[3];
        split3(x[t], part);
#pragma unroll
        for (int s = 0; s < 3; ++s)
          qs[swz<C>(s * GC + g, d / 8) * 8 + d % 8] = part[s];
      }
    }
    for (int i = threadIdx.x; i < (16 - 3 * GC) * D; i += kWarps * 32) {
      const int row = 3 * GC + i / D, d = i % D;
      qs[swz<C>(row, d / 8) * 8 + d % 8] = __float2bfloat16_rn(0.f);
    }
  }
  __syncthreads();
  // q's A fragments, the same for every stage
  uint32_t qa[KT][4];
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
    ldsm_x4(qa[kt], s_qs + swz<C>((lane & 7) + 8 * ((lane >> 3) & 1),
                                  2 * kt + (lane >> 4)));
  __syncthreads();   // q read: the last slots load
  issue(warp + (kStages - 1) * kWarps, kStages - 1, 0);
  issue(warp + (kStages - 1) * kWarps, kStages - 1, 1);

  // the lane's query row g = gid % GC: its running max and (over its rows)
  // sum, and o's rows gid and gid + 8
  float m = kNegInf, lsum = 0.f, o[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t)
#pragma unroll
    for (int x = 0; x < 4; ++x) o[t][x] = 0.f;

  const int mine = nst > warp ? (nst - warp + kWarps - 1) / kWarps : 0;
  // groups in flight: K and V of stages i .. i + kStages - 1, then
  // K(i + kStages) after the scores of stage i and V(i + kStages) after its
  // P.V; either wait leaves the 2 kStages - 1 latest groups in flight
  constexpr int kFly = 2 * kStages - 1;
  for (int i = 0; i < mine; ++i) {
    cp_wait<kFly>();   // this lane's K of stage i has landed
    __syncwarp();   // and every lane's
    const uint4* sk =
        reinterpret_cast<const uint4*>(ring + (i % kStages) * kStage);
    const uint4* sv = sk + kMmaRows * C;
    const int t0 = r0 + (warp + i * kWarps) * kMmaRows;
    const int nv = min(kMmaRows, r1 - t0);

    // scores: rows (s, g) x the stage's 16 rows, as two n-tiles of 8, each
    // in two chains (even and odd k-tiles)
    float sc[2][2][4] = {};
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t kf[4];
      ldsm_x4(kf, sk + swz<C>((lane & 7) + 8 * (lane >> 4),
                              2 * kt + ((lane >> 3) & 1)));
      mma16816(sc[0][kt & 1], qa[kt], kf[0], kf[1]);
      mma16816(sc[1][kt & 1], qa[kt], kf[2], kf[3]);
    }
    __syncwarp();   // K read: its slot takes stage i + 2
    issue(warp + (i + kStages) * kWarps, i % kStages, 0);
    // the lane's query row g = gid % GC at stage rows nt * 8 + 2 tig + e:
    // the parts' rows (s * GC + g) summed on the lanes of part 0, then
    // handed to every lane of g, which holds p's A fragment of those rows
    float x[4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float hi = sc[nt][0][e] + sc[nt][1][e];              // row gid
        const float below = sc[nt][0][2 + e] + sc[nt][1][2 + e];   // gid + 8
        const float mid = __shfl_sync(kFull, hi, (lane + 4 * GC) & 31);
        const float lo =
            GC == 4 ? below : __shfl_sync(kFull, hi, (lane + 8 * GC) & 31);
        const float sum =
            __shfl_sync(kFull, part_sum(hi, mid, lo), (gid % GC) * 4 + tig);
        x[nt * 2 + e] = nt * 8 + 2 * tig + e < nv
                            ? sum * scale : __int_as_float(0xFF800000);
      }
    float mx = fmaxf(fmaxf(max_key(x[0]), max_key(x[1])),
                     fmaxf(max_key(x[2]), max_key(x[3])));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    float alpha;
    const float base = step_base(m, mx, alpha);
    float psum = 0.f;
    __nv_bfloat16 part[4][3];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = expf(x[e] - base);   // 0 past the length
      psum += pe;
      split3(pe, part[e]);
    }
    lsum = lsum * alpha + psum;
    // p's A fragment: row gid holds part gid / GC, row gid + 8 part (gid +
    // 8) / GC, zero past the three parts
    uint32_t pa[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int sp = 0; sp < 3; ++sp) {
      const uint32_t lo01 = pack2(part[0][sp], part[1][sp]);
      const uint32_t hi01 = pack2(part[2][sp], part[3][sp]);
      if (gid / GC == sp) {
        pa[0] = lo01;
        pa[2] = hi01;
      }
      if ((gid + 8) / GC == sp) {
        pa[1] = lo01;
        pa[3] = hi01;
      }
    }
    // o's rows gid and gid + 8 both hold query row g
    if (__any_sync(kFull, alpha != 1.f)) {
#pragma unroll
      for (int t = 0; t < DT; ++t)
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4) o[t][c4] *= alpha;
    }
    cp_wait<kFly>();   // V of stage i
    __syncwarp();
    // o += p . V, two n-tiles of d a transposed load
#pragma unroll
    for (int t = 0; t < DT; t += 2) {
      uint32_t vf[4];
      ldsm_x4_t(vf, sv + swz<C>((lane & 7) + 8 * ((lane >> 3) & 1),
                                t + (lane >> 4)));
      mma16816(o[t], pa, vf[0], vf[1]);
      mma16816(o[t + 1], pa, vf[2], vf[3]);
    }
    __syncwarp();   // V and p consumed: V's slot takes stage i + 2
    issue(warp + (i + kStages) * kWarps, i % kStages, 1);
  }
  cp_wait<0>();
  __syncwarp();

  // o's rows (s, g) into the ring, then the parts summed into rows g < GC
  float* w_o = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int t = 0; t < DT; ++t) {
    *reinterpret_cast<float2*>(w_o + gid * D + t * 8 + 2 * tig) =
        make_float2(o[t][0], o[t][1]);
    *reinterpret_cast<float2*>(w_o + (gid + 8) * D + t * 8 + 2 * tig) =
        make_float2(o[t][2], o[t][3]);
  }
  __syncwarp();
  for (int i = lane; i < GC * D; i += 32)
    w_o[i] = part_sum(w_o[i], w_o[GC * D + i], w_o[2 * GC * D + i]);
  lsum += __shfl_xor_sync(kFull, lsum, 1);
  lsum += __shfl_xor_sync(kFull, lsum, 2);
  if (gid < GC && tig == 0) {
    s_m[warp * GC + gid] = m;
    s_l[warp * GC + gid] = lsum;
  }
  __syncthreads();
  fold_warps<GC>(rings, kRing, s_m, s_l, gc, D, o_out, m_out, l_out,
                 (((size_t)pb * Hkv + h) * gridDim.y + split) * G + g0);
}

// ------------------------------------------------------------------ staging
__host__ __device__ inline int tile_rows(int D) { return D <= 128 ? 64 : 32; }

size_t staging_smem(int D) {
  const int T = tile_rows(D);
  return sizeof(float) * ((size_t)2 * kGroup * D     // q rows, running o
                          + (size_t)T * (D | 1)       // K tile (odd stride)
                          + (size_t)T * D             // V tile
                          + (size_t)kGroup * T        // scores, then p
                          + 3 * (size_t)kGroup);      // m, l, alpha
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <typename T>
__device__ __forceinline__ float load_f32(const T* p) {
  if constexpr (sizeof(T) == 4)
    return __ldcs(reinterpret_cast<const float*>(p));
  else
    return __uint_as_float(
        (uint32_t)__ldcs(reinterpret_cast<const unsigned short*>(p)) << 16);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
da_staging_kernel(const void* __restrict__ q, long long q_sp, long long q_sb,
                  int q_bf16, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ lengths,
                  float* __restrict__ o_out, float* __restrict__ m_out,
                  float* __restrict__ l_out, int B, int S, int Hkv, int G,
                  int D, int n_gc, int chunk, float scale) {
  extern __shared__ __align__(16) float fsmem[];
  const int T_ = tile_rows(D);
  const int ks = D | 1;               // odd: 32 rows, 32 banks
  const long long pb = blockIdx.x / (Hkv * n_gc);
  const int hy = (int)(blockIdx.x - pb * Hkv * n_gc);
  const int h = hy / n_gc;
  const int g0 = (hy - h * n_gc) * kGroup;
  const int gc = min(kGroup, G - g0);
  const int split = blockIdx.y;
  const int tid = threadIdx.x;

  float* s_q = fsmem;                 // kGroup x D
  float* s_o = s_q + kGroup * D;      // gc x D
  float* s_k = s_o + kGroup * D;      // T x ks
  float* s_v = s_k + T_ * ks;         // T x D
  float* s_p = s_v + T_ * D;          // gc x T
  float* s_m = s_p + kGroup * T_;     // gc
  float* s_l = s_m + kGroup;          // gc
  float* s_a = s_l + kGroup;          // gc

  load_q(s_q, q, q_sp, q_sb, q_bf16, pb, B, h, G, g0, gc, kGroup, D,
         kThreads);
  for (int i = tid; i < gc * D; i += kThreads) s_o[i] = 0.f;
  for (int i = tid; i < gc; i += kThreads) {
    s_m[i] = kNegInf;
    s_l[i] = 0.f;
  }
  const int len = max(0, min(lengths[pb], S));
  const long long r0l = (long long)split * chunk;
  const int r0 = (int)min(r0l, (long long)len);
  const int r1 = (int)min((long long)len, r0l + chunk);
  const size_t row_stride = (size_t)Hkv * D;
  const T* kb = k + ((size_t)pb * S * Hkv + h) * D;
  const T* vb = v + ((size_t)pb * S * Hkv + h) * D;
  const int warp = tid >> 5, lane = tid & 31;

  for (int t0 = r0; t0 < r1; t0 += T_) {
    const int nt = min(T_, r1 - t0);
    __syncthreads();   // q, o, m, l in place; the last tile consumed
    // stage K (the first n elements) and V (the next n) as f32
    const int n = nt * D;
    for (int base = tid; base < 2 * n; base += kThreads * kBatch) {
      float c[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = base + j * kThreads;
        if (i < 2 * n) {
          const bool is_v = i >= n;
          const int ii = is_v ? i - n : i;
          const int r = ii / D;
          c[j] = load_f32((is_v ? vb : kb) + (size_t)(t0 + r) * row_stride
                          + (ii - r * D));
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = base + j * kThreads;
        if (i < 2 * n) {
          const bool is_v = i >= n;
          const int ii = is_v ? i - n : i;
          const int r = ii / D;
          (is_v ? s_v + r * D : s_k + r * ks)[ii - r * D] = c[j];
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
        for (; d + 4 <= D; d += 4) {
          a0 = fmaf(qr[d], kr[d], a0);
          a1 = fmaf(qr[d + 1], kr[d + 1], a1);
          a2 = fmaf(qr[d + 2], kr[d + 2], a2);
          a3 = fmaf(qr[d + 3], kr[d + 3], a3);
        }
        for (; d < D; ++d) a0 = fmaf(qr[d], kr[d], a0);
        s_p[i] = ((a0 + a1) + (a2 + a3)) * scale;
      }
    }
    __syncthreads();
    // running max and sum: a warp a query row
    for (int g = warp; g < gc; g += kThreads / 32) {
      float* prow = s_p + g * T_;
      float mx = kNegInf;
      for (int t = lane; t < nt; t += 32) mx = fmaxf(mx, max_key(prow[t]));
      mx = warp_max(mx);
      float m_run = s_m[g], a;
      const float base = step_base(m_run, mx, a);
      float sum = 0.f;
      for (int t = lane; t < nt; t += 32) {
        const float p = expf(prow[t] - base);
        prow[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        s_a[g] = a;
        s_l[g] = s_l[g] * a + sum;
        s_m[g] = m_run;
      }
    }
    __syncthreads();
    // o = o * alpha + p . V: thread i keeps entry i of every tile
    for (int i = tid; i < gc * D; i += kThreads) {
      const int g = i / D;
      const int d = i - g * D;
      const float* prow = s_p + g * T_;
      float acc = s_o[i] * s_a[g];
      for (int t = 0; t < nt; ++t) acc = fmaf(prow[t], s_v[t * D + d], acc);
      s_o[i] = acc;
    }
  }
  __syncthreads();
  const size_t slot = (((size_t)pb * Hkv + h) * gridDim.y + split) * G + g0;
  for (int i = tid; i < gc * D; i += kThreads) o_out[slot * D + i] = s_o[i];
  for (int i = tid; i < gc; i += kThreads) {
    m_out[slot + i] = m_written(s_m[i], gridDim.y);
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
  float mx = kNegInf;   // the mark, where any split has it: base 0
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, m_s[base + (size_t)s * G]);
  mx = base_of(mx);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const size_t slot = base + (size_t)s * G;
      acc += o_s[slot * D + d] * expf(base_of(m_s[slot]) - mx);
    }
    o[row * D + d] = acc;
  }
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const size_t slot = base + (size_t)s * G;
      acc += l_s[slot] * expf(base_of(m_s[slot]) - mx);
    }
    m[row] = mx;
    l[row] = acc;
  }
}

// ----------------------------------------------------------------- dispatch
template <typename T, int GC>
struct Tag {
  using type = T;
  static constexpr int gc = GC;
};

// f(Tag<T, GC>{}) for the streaming kernel's instance that takes G
// query rows a block of the streaming kernels holds for a group of G
int group_rows(int G) { return G >= 8 ? 8 : G > 2 ? 4 : G; }

// f(Tag<T, GC>{}) for the streaming kernel's instance that takes G
template <typename F>
cudaError_t by_group(int G, int bf16, F&& f) {
  const int gc = group_rows(G);
  if (bf16) {
    switch (gc) {
      case 1: return f(Tag<__nv_bfloat16, 1>{});
      case 2: return f(Tag<__nv_bfloat16, 2>{});
      case 4: return f(Tag<__nv_bfloat16, 4>{});
      default: return f(Tag<__nv_bfloat16, 8>{});
    }
  }
  switch (gc) {
    case 1: return f(Tag<float, 1>{});
    case 2: return f(Tag<float, 2>{});
    case 4: return f(Tag<float, 4>{});
    default: return f(Tag<float, 8>{});
  }
}

template <int GC, int D>
struct MmaTag {
  static constexpr int gc = GC;
  static constexpr int d = D;
};

// f(MmaTag<GC, D>{}) for the tensor-core kernel's instance (mma_takes)
template <typename F>
cudaError_t by_mma(int D, int G, F&& f) {
  const int gc = group_rows(G);
  if (D == 64) {
    switch (gc) {
      case 1: return f(MmaTag<1, 64>{});
      case 2: return f(MmaTag<2, 64>{});
      default: return f(MmaTag<4, 64>{});
    }
  }
  switch (gc) {
    case 1: return f(MmaTag<1, 128>{});
    case 2: return f(MmaTag<2, 128>{});
    default: return f(MmaTag<4, 128>{});
  }
}

// allow a kernel its largest shared memory, once per device and variant
template <typename K>
cudaError_t allow_smem(K kernel, int variant, size_t bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(g_once[dev][variant], [&] {
    g_err[dev][variant] = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  });
  return g_err[dev][variant];
}

int log2_of(int gc) { return gc == 1 ? 0 : gc == 2 ? 1 : gc == 4 ? 2 : 3; }

template <typename T, int GC>
cudaError_t allow_stream() {
  size_t most = 0;   // over every D the kernel takes
  for (int D = 16 / (int)sizeof(T); D <= kMaxDim; D += 16 / (int)sizeof(T))
    most = std::max(most, stream_smem(D, sizeof(T), GC));
  return allow_smem(da_stream_kernel<T, GC>,
                    (sizeof(T) == 2 ? 4 : 0) + log2_of(GC), most);
}

template <int GC, int D>
cudaError_t allow_mma() {
  return allow_smem(da_mma_kernel<GC, D>,
                    10 + (D == 128 ? 3 : 0) + log2_of(GC), mma_smem(D, GC));
}

template <typename T>
cudaError_t allow_staging() {
  return allow_smem(da_staging_kernel<T>, 8 + (sizeof(T) == 2),
                    staging_smem(kMaxDim));
}

bool streams(int D, int bf16) { return (D * (bf16 ? 2 : 4)) % 16 == 0; }

}  // namespace

extern "C" {

int da_group_chunk() { return kGroup; }
// rows a stage of the kernel that takes (D, G, cache type), 16-byte rows
// (the staging kernel, for other rows: a tile)
int da_stage_rows(int D, int G, int bf16) {
  if (mma_takes(D, G, bf16)) return kMmaRows;
  return streams(D, bf16) ? Geom(D, bf16 ? 2 : 4).rs : tile_rows(D);
}
// the unit of a split: a round of the block's warps over their stages
int da_split_rows(int D, int G, int bf16) {
  const int rows = da_stage_rows(D, G, bf16);
  return streams(D, bf16) ? kWarps * rows : rows;
}
const char* da_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory a block of the kernel that takes (D, G, cache type)
int da_smem_bytes(int D, int G, int bf16) {
  if (D < 1 || D > kMaxDim || G < 1) return -(int)cudaErrorInvalidValue;
  if (mma_takes(D, G, bf16)) return (int)mma_smem(D, group_rows(G));
  if (!streams(D, bf16)) return (int)staging_smem(D);
  return (int)stream_smem(D, bf16 ? 2 : 4, group_rows(G));
}

// Blocks of the kernel that takes (D, G, cache type) resident on one SM of
// the current device, or minus a CUDA error code.
int da_blocks_per_sm(int D, int G, int bf16) {
  if (D < 1 || D > kMaxDim || G < 1) return -(int)cudaErrorInvalidValue;
  int n = 0;
  cudaError_t err;
  if (mma_takes(D, G, bf16)) {
    err = by_mma(D, G, [&](auto tag) {
      constexpr int GC = decltype(tag)::gc, DD = decltype(tag)::d;
      cudaError_t e = allow_mma<GC, DD>();
      if (e != cudaSuccess) return e;
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, da_mma_kernel<GC, DD>, kWarps * 32, mma_smem(DD, GC));
    });
  } else if (streams(D, bf16)) {
    err = by_group(G, bf16, [&](auto tag) {
      using T = typename decltype(tag)::type;
      constexpr int GC = decltype(tag)::gc;
      cudaError_t e = allow_stream<T, GC>();
      if (e != cudaSuccess) return e;
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, da_stream_kernel<T, GC>, kWarps * 32,
          stream_smem(D, sizeof(T), GC));
    });
  } else if (bf16) {
    err = allow_staging<__nv_bfloat16>();
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, da_staging_kernel<__nv_bfloat16>, kThreads, staging_smem(D));
  } else {
    err = allow_staging<float>();
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, da_staging_kernel<float>, kThreads, staging_smem(D));
  }
  return err == cudaSuccess ? n : -(int)err;
}

// q (P, B, Hkv * G, D) f32 (q_bf16 = 0) or bf16 (q_bf16 = 1), element
// strides q_sp and q_sb over P and B, each (p, b)'s rows contiguous; k, v
// (PB, S, Hkv, D) f32 (bf16 = 0) or bf16 (bf16 = 1), PB = P * B;
// lengths (PB) i32; o (PB, Hkv, n_split, G, D), m and l (PB, Hkv, n_split,
// G) f32; split z takes rows [z * chunk, (z + 1) * chunk): device
// pointers, all contiguous but q. With n_split = 1 these are the shard's
// partials, (PB, Hq, D) and (PB, Hq). Returns cudaGetLastError().
int da_partial(const void* q, long long q_sp, long long q_sb, int q_bf16,
               const void* k, const void* v, const void* lengths, void* o,
               void* m, void* l, long long PB, int B, int S, int Hkv, int G,
               int D, int n_split, int chunk, float scale, int bf16,
               void* stream) {
  const int n_gc = (G + kGroup - 1) / kGroup;
  if (PB < 1 || B < 1 || PB % B != 0 || S < 0 || Hkv < 1 || G < 1 || D < 1
      || D > kMaxDim || n_split < 1 || n_split > 65535 || chunk < 1
      || (long long)chunk * n_split < S
      || PB * Hkv * n_gc > 2147483647LL || q_sp < 0 || q_sb < 0)
    return cudaErrorInvalidValue;
  const bool vec = streams(D, bf16) && ((uintptr_t)k & 15) == 0
                   && ((uintptr_t)v & 15) == 0;
  // the KV heads of a (pb) fastest: blocks that run together read whole
  // rows of the cache (Hkv heads, 2 KB at granite's shape), not 256 bytes
  // of each of many rows
  const dim3 grid((unsigned)(PB * Hkv * n_gc), (unsigned)n_split);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (vec && mma_takes(D, G, bf16)) {
    err = by_mma(D, G, [&](auto tag) {
      constexpr int GC = decltype(tag)::gc, DD = decltype(tag)::d;
      cudaError_t e = allow_mma<GC, DD>();
      if (e != cudaSuccess) return e;
      da_mma_kernel<GC, DD><<<grid, kWarps * 32, mma_smem(DD, GC), st>>>(
          q, q_sp, q_sb, q_bf16, (const __nv_bfloat16*)k,
          (const __nv_bfloat16*)v, (const int*)lengths, (float*)o, (float*)m,
          (float*)l, B, S, Hkv, G, n_gc, chunk, scale);
      return cudaGetLastError();
    });
  } else if (vec) {
    err = by_group(G, bf16, [&](auto tag) {
      using T = typename decltype(tag)::type;
      constexpr int GC = decltype(tag)::gc;
      cudaError_t e = allow_stream<T, GC>();
      if (e != cudaSuccess) return e;
      da_stream_kernel<T, GC><<<grid, kWarps * 32,
                                stream_smem(D, sizeof(T), GC), st>>>(
          q, q_sp, q_sb, q_bf16, (const T*)k, (const T*)v,
          (const int*)lengths, (float*)o, (float*)m, (float*)l, B, S, Hkv, G,
          D, n_gc, chunk, scale);
      return cudaGetLastError();
    });
  } else if (bf16) {
    err = allow_staging<__nv_bfloat16>();
    if (err != cudaSuccess) return (int)err;
    da_staging_kernel<__nv_bfloat16><<<grid, kThreads, staging_smem(D), st>>>(
        q, q_sp, q_sb, q_bf16, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (const int*)lengths, (float*)o, (float*)m,
        (float*)l, B, S, Hkv, G, D, n_gc, chunk, scale);
    err = cudaGetLastError();
  } else {
    err = allow_staging<float>();
    if (err != cudaSuccess) return (int)err;
    da_staging_kernel<float><<<grid, kThreads, staging_smem(D), st>>>(
        q, q_sp, q_sb, q_bf16, (const float*)k, (const float*)v,
        (const int*)lengths, (float*)o, (float*)m, (float*)l, B, S, Hkv, G, D,
        n_gc, chunk, scale);
    err = cudaGetLastError();
  }
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
