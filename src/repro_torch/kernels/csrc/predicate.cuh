// Predicate plan and row compare shared by select_project.cu and
// hash_group.cu (paper §5.3 predicate selection).
//
// A row passes iff every predicate column passes. Compares are IEEE f32
// (NaN fails every op but !=) with subnormal operands read as zero on
// both sides, as the reference compares on the TPU (no f32 subnormals)
// and under XLA on the CPU (flush-to-zero compares).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace predicate {

constexpr int kMaxCols = 32;

enum { OP_SKIP, OP_LT, OP_LE, OP_GT, OP_GE, OP_EQ, OP_NE };

// the static plan, passed to a kernel by value
struct Plan {
  int ops[kMaxCols];
  float vals[kMaxCols];
  int keep[kMaxCols];
};

// the plan as a block holds it in shared memory
struct SharedPlan {
  int ops[kMaxCols];
  float vals[kMaxCols];
  uint32_t keep[kMaxCols];
};

// subnormals (and -0.0) compare as 0.0; see the contract above
__device__ __forceinline__ float flush_subnormal(float x) {
  return (__float_as_uint(x) & 0x7F800000u) == 0u ? 0.0f : x;
}

// threads 0..C-1 copy the plan; the caller syncs the block after
__device__ __forceinline__ void load_plan(const Plan& plan, int C,
                                          SharedPlan* s) {
  if (threadIdx.x < C) {
    s->ops[threadIdx.x] = plan.ops[threadIdx.x];
    s->vals[threadIdx.x] = flush_subnormal(plan.vals[threadIdx.x]);
    s->keep[threadIdx.x] = plan.keep[threadIdx.x] ? 0xFFFFFFFFu : 0u;
  }
}

__device__ __forceinline__ bool row_passes(const uint32_t* row, int C,
                                           const SharedPlan& s) {
  bool ok = true;
  for (int c = 0; c < C; ++c) {
    const float x = flush_subnormal(__uint_as_float(row[c]));
    const float v = s.vals[c];
    switch (s.ops[c]) {
      case OP_LT: ok = ok && (x < v); break;
      case OP_LE: ok = ok && (x <= v); break;
      case OP_GT: ok = ok && (x > v); break;
      case OP_GE: ok = ok && (x >= v); break;
      case OP_EQ: ok = ok && (x == v); break;
      case OP_NE: ok = ok && (x != v); break;
      default: break;  // OP_SKIP and unknown codes pass, as in the reference
    }
  }
  return ok;
}

// keep may be null (no projection: every column kept)
inline Plan make_plan(const int* ops, const float* vals, const int* keep,
                      int C) {
  Plan p = {};
  for (int c = 0; c < C; ++c) {
    p.ops[c] = ops[c];
    p.vals[c] = vals[c];
    p.keep[c] = keep ? keep[c] : 1;
  }
  return p;
}

}  // namespace predicate
