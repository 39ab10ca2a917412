// Fused selection + projection + packing for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/select_project.py::select_project
// (`_kernel`) and the block stitch of repro/kernels/ops.py::select_project.
// Contract: repro.kernels.ops.select_project_xla with valid = row < n_valid[b],
// over a stack of B requests:
//   * a row survives iff every predicate column passes and row < n_valid[b].
//     Compares are IEEE f32 (NaN fails every op but !=) with subnormal
//     operands read as zero, as the reference compares on the TPU and
//     under XLA on the CPU;
//   * projected words are copied bitwise, dropped columns are written as 0;
//   * survivors are stably compacted to the front of the request's output;
//   * every row past the request's survivor count is zero.
// The TPU kernel compacts with a permutation matmul and projects by
// multiplying, which turns 0 * inf into NaN; this kernel moves words with
// integer loads and stores only.
//
// Two passes over (row block, request) grids, 1024 rows per block at any
// table width:
//   sp_count: each block counts its survivors (block_counts[b, blk]);
//   (the wrapper takes an exclusive scan of the small counts array)
//   sp_pack:  each block ranks its survivors with warp ballots and a
//             shared-memory scan across warps (ranks stay in registers),
//             then, for each tile of at most 32 columns, stages the
//             projected words of its survivors compacted in shared memory
//             and writes them at the block's global offset, neighbouring
//             threads on neighbouring words (one contiguous run when the
//             table has at most 32 columns, runs of 32 words otherwise).
//             It also zero-fills its share of the tail: the rows it
//             dropped land, as zeros, at
//             total[b] + (rows dropped by earlier blocks), so the blocks
//             together write every output word exactly once.
// The predicate plan and the keep mask are read from device memory
// (predicate.cuh), and the staging tile is at most 1024 x 32 words
// (128 KiB), so no width needs more shared memory than that; both passes
// use the same 1024 rows per block whatever the width.
//
// Bound on the card: bytes. Each row is read once per pass (twice in all;
// the count pass reads only the predicate columns' sectors) and each
// output word written once; no arithmetic beyond a few compares per word.
// The design keeps the compaction out of device memory (ranks in
// registers and shared memory) and writes coalesced runs.
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "predicate.cuh"

namespace {

using predicate::row_passes;

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 1024;
constexpr int kSubTiles = kRowsPerBlock / kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kTileCols = 32;      // columns staged per pass of sp_pack
constexpr int kMaxSmem = kRowsPerBlock * kTileCols * (int)sizeof(uint32_t);

__global__ void __launch_bounds__(kThreads)
sp_count_kernel(const uint32_t* __restrict__ table,
                const int* __restrict__ plan, int n_pred,
                const int* __restrict__ n_valid, int* __restrict__ block_counts,
                long long N, int C, long long n_blocks) {
  const int b = blockIdx.y;
  const long long row0 = (long long)blockIdx.x * kRowsPerBlock;
  const long long nv = min((long long)n_valid[b], N);
  const uint32_t* tb = table + (long long)b * N * C;
  int count = 0;
#pragma unroll
  for (int s = 0; s < kSubTiles; ++s) {
    const long long r = row0 + s * kThreads + threadIdx.x;
    const bool keep = r < nv && row_passes(tb + r * C, plan, n_pred);
    count += __syncthreads_count(keep);
  }
  if (threadIdx.x == 0) block_counts[b * n_blocks + blockIdx.x] = count;
}

__global__ void __launch_bounds__(kThreads)
sp_pack_kernel(const uint32_t* __restrict__ table,
               const int* __restrict__ plan, int n_pred,
               const int* __restrict__ n_valid,
               const int* __restrict__ offsets, const int* __restrict__ totals,
               uint32_t* __restrict__ out, long long N, int C,
               long long n_blocks) {
  extern __shared__ uint32_t s_rows[];  // kRowsPerBlock * tile compacted words
  __shared__ int s_warp[kWarps];
  const uint32_t* keep_mask =
      reinterpret_cast<const uint32_t*>(plan) + 3 * n_pred;
  const int b = blockIdx.y;
  const long long row0 = (long long)blockIdx.x * kRowsPerBlock;
  const long long nv = min((long long)n_valid[b], N);
  const uint32_t* tb = table + (long long)b * N * C;
  uint32_t* ob = out + (long long)b * N * C;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  int rank[kSubTiles];  // each of this thread's rows: its survivor rank, or -1
  int kept = 0;         // survivors in earlier sub-tiles; equal in every thread
#pragma unroll
  for (int s = 0; s < kSubTiles; ++s) {
    const long long r = row0 + s * kThreads + threadIdx.x;
    const bool keep = r < nv && row_passes(tb + r * C, plan, n_pred);
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, keep);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int before = __popc(ballot & ((1u << lane) - 1u));
    int sub_total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int cw = s_warp[w];
      before += (w < warp) ? cw : 0;
      sub_total += cw;
    }
    rank[s] = keep ? kept + before : -1;
    kept += sub_total;
    __syncthreads();  // s_warp is rewritten by the next sub-tile
  }

  const long long off = offsets[b * n_blocks + blockIdx.x];
  uint32_t* dst = ob + off * C;
  for (int c0 = 0; c0 < C; c0 += kTileCols) {
    const int tw = min(kTileCols, C - c0);
#pragma unroll
    for (int s = 0; s < kSubTiles; ++s) {
      if (rank[s] >= 0) {
        const uint32_t* row = tb + (row0 + s * kThreads + threadIdx.x) * C + c0;
        uint32_t* stage = s_rows + rank[s] * tw;
        for (int c = 0; c < tw; ++c) stage[c] = row[c] & __ldg(keep_mask + c0 + c);
      }
    }
    __syncthreads();
    const int n_words = kept * tw;
    if (tw == C) {  // the whole row in one tile: one contiguous run
      for (int j = threadIdx.x; j < n_words; j += kThreads) dst[j] = s_rows[j];
    } else {
      for (int j = threadIdx.x; j < n_words; j += kThreads) {
        const int jr = j / tw;
        dst[(long long)jr * C + c0 + (j - jr * tw)] = s_rows[j];
      }
    }
    __syncthreads();  // the tile is rewritten by the next column tile
  }

  const long long rows_here = min((long long)kRowsPerBlock, N - row0);
  const long long zero_row = totals[b] + (row0 - off);
  const long long n_zero = (rows_here - kept) * C;
  uint32_t* zdst = ob + zero_row * C;
  for (long long j = threadIdx.x; j < n_zero; j += kThreads) zdst[j] = 0u;
}

constexpr int kMaxDevices = 64;
std::once_flag g_smem_once[kMaxDevices];
cudaError_t g_smem_err[kMaxDevices];

}  // namespace

extern "C" {

int sp_rows_per_block() { return kRowsPerBlock; }
const char* sp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// table, plan, n_valid, block_counts: device pointers. plan holds the
// compacted predicate (3 * n_pred words, predicate.cuh) and then the keep
// mask (C words, 0 or 0xFFFFFFFF). Returns cudaGetLastError().
int sp_count(const void* table, const void* plan, int n_pred,
             const void* n_valid, void* block_counts, long long N, int C,
             int B, void* stream) {
  if (C < 1 || n_pred < 0 || n_pred > C || B < 1 || N < 1)
    return cudaErrorInvalidValue;
  const long long n_blocks = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  dim3 grid((unsigned)n_blocks, (unsigned)B);
  sp_count_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)table, (const int*)plan, n_pred, (const int*)n_valid,
      (int*)block_counts, N, C, n_blocks);
  return (int)cudaGetLastError();
}

int sp_pack(const void* table, const void* plan, int n_pred,
            const void* n_valid, const void* offsets, const void* totals,
            void* out, long long N, int C, int B, void* stream) {
  if (C < 1 || n_pred < 0 || n_pred > C || B < 1 || N < 1)
    return cudaErrorInvalidValue;
  const long long n_blocks = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  const size_t smem =
      (size_t)kRowsPerBlock * (C < kTileCols ? C : kTileCols) * sizeof(uint32_t);
  // the widest staging tile is allowed once per device, on first use
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(g_smem_once[dev], [dev] {
    g_smem_err[dev] = cudaFuncSetAttribute(
        sp_pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  });
  if (g_smem_err[dev] != cudaSuccess) return (int)g_smem_err[dev];
  dim3 grid((unsigned)n_blocks, (unsigned)B);
  sp_pack_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)table, (const int*)plan, n_pred, (const int*)n_valid,
      (const int*)offsets, (const int*)totals, (uint32_t*)out, N, C,
      n_blocks);
  return (int)cudaGetLastError();
}

}  // extern "C"
