// EPLB Collect's body for Hopper (sm_90a): the per-expert histogram of
// routed ids, as one block's device function. Two launches run it:
// collect.cu's standalone kernel, and route_pack.cu's count block (the
// serving path's MoE layer, which packs and counts the same top-k ids in
// one launch).
//
// counts[e] = #{i : ids[i] == e} for e in [0, n_experts); ids below 0
// (padding) and at n_experts or above match no expert and are ignored,
// as the reference's one-hot compare ignores them. The ids may be int32
// or int64 (the router's top-k indices), so the caller needs no cast.
//
// The block's threads zero a shared-memory histogram of n_experts
// counters, add each id with a shared-memory integer atomic (exact in
// any order), and write every counter out once: no output needs zeroing
// beforehand and nothing is written outside [0, n_experts).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define CO_MAX_E 12288  // 48 KB of shared counters

// hist: n_experts ints of the block's shared memory. Every thread of the
// block calls it (it synchronises the block).
template <typename I>
__device__ __forceinline__ void collect_block(const I* __restrict__ ids,
                                              int n, int n_experts,
                                              int* hist,
                                              int* __restrict__ counts) {
  for (int e = threadIdx.x; e < n_experts; e += blockDim.x) hist[e] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const I e = ids[i];
    if (e >= 0 && e < (I)n_experts) atomicAdd(&hist[(int)e], 1);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n_experts; e += blockDim.x) counts[e] = hist[e];
}
