// Predicate plan and row compare shared by select_project.cu and
// hash_group.cu (paper §5.3 predicate selection).
//
// A row passes iff every predicate column passes. Compares are IEEE f32
// (NaN fails every op but !=) with subnormal operands read as zero on
// both sides, as the reference compares on the TPU (no f32 subnormals)
// and under XLA on the CPU (flush-to-zero compares).
//
// The plan lives in device memory, so a table may have any number of
// columns: the wrapper compacts the predicate to the columns that carry a
// compare (OP_SKIP and unknown codes pass, so they drop out) and uploads
//   plan[0, n)    column index of each compare
//   plan[n, 2n)   its op code
//   plan[2n, 3n)  its operand, as f32 bits
// followed by whatever the kernel reads next (select_project's keep mask,
// hash_group's value columns). Every thread reads the same plan word at
// the same time, so the loads are broadcasts from L1.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace predicate {

enum { OP_SKIP, OP_LT, OP_LE, OP_GT, OP_GE, OP_EQ, OP_NE };

// subnormals (and -0.0) compare as 0.0; see the contract above
__device__ __forceinline__ float flush_subnormal(float x) {
  return (__float_as_uint(x) & 0x7F800000u) == 0u ? 0.0f : x;
}

__device__ __forceinline__ bool row_passes(const uint32_t* row,
                                           const int* __restrict__ plan,
                                           int n_pred) {
  bool ok = true;
  for (int i = 0; i < n_pred; ++i) {
    const float x = flush_subnormal(__uint_as_float(row[__ldg(plan + i)]));
    const float v = flush_subnormal(__int_as_float(__ldg(plan + 2 * n_pred + i)));
    switch (__ldg(plan + n_pred + i)) {
      case OP_LT: ok = ok && (x < v); break;
      case OP_LE: ok = ok && (x <= v); break;
      case OP_GT: ok = ok && (x > v); break;
      case OP_GE: ok = ok && (x >= v); break;
      case OP_EQ: ok = ok && (x == v); break;
      case OP_NE: ok = ok && (x != v); break;
      default: break;  // not produced by the wrapper's compaction
    }
  }
  return ok;
}

}  // namespace predicate
