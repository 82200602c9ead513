// The token fold's two int64 sort keys: the one packing that csrc/fnv.cu
// writes and csrc/segfold.cu reads.  Its plain torch twin is
// dampr_tpu_torch/ops/fnv.py::pack_sort_keys / unpack_sort_keys; a change
// here is made there too.
//
//   high = inv << 32 | u1
//   low  = u2, or u2 << LINE_BITS | line under per-line dedup (line < 2^31)
//
// with u1, u2 the unsigned FNV lanes and inv nonzero for an invalid
// record.  Sorting stably by low, then by high, orders records by
// (inv, h1, h2[, line]).

#pragma once

#include <stdint.h>

namespace sort_keys {

constexpr int LINE_BITS = 31;

__device__ __forceinline__ unsigned long long high(uint32_t u1,
                                                   uint32_t inv) {
  return ((unsigned long long)inv << 32) | u1;
}

__device__ __forceinline__ unsigned long long low(uint32_t u2, int32_t line,
                                                  bool dedup) {
  return dedup ? ((unsigned long long)u2 << LINE_BITS) |
                     (unsigned long long)(long long)line
               : (unsigned long long)u2;
}

__device__ __forceinline__ bool valid(unsigned long long high) {
  return (high >> 32) == 0;
}

__device__ __forceinline__ uint32_t u1(unsigned long long high) {
  return (uint32_t)high;
}

__device__ __forceinline__ uint32_t u2(unsigned long long low, bool dedup) {
  return (uint32_t)(dedup ? low >> LINE_BITS : low);
}

}  // namespace sort_keys
