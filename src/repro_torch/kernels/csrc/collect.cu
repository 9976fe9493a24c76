// EPLB Collect for Hopper (sm_90a): the per-expert histogram of routed ids.
//
// Replaces the TPU kernel src/repro/kernels/collect/kernel.py (collect,
// body _kernel): counts[e] = #{i : ids[i] == e} for e in [0, E); ids below
// 0 (padding) and at E or above match no expert and are ignored, as the
// reference's one-hot compare ignores them.
//
// Where it runs: this standalone launch is the counterpart of the
// reference's collect / expert_counts API, for a caller that has ids but
// no pack. The serving path's MoE layer does not launch it: route_pack.cu
// runs the same body (collect.cuh) in one more block of the route-pack
// launch, on the layer's logical top-k ids (§4.5 step 1).
//
// What bounds it on the H100: the launch. N = T * k ids (32 at DeepSeek-V3
// decode, 4096 for a 512-token prompt at top-8) and E <= 256 counters are
// a few KB.
//
// Design: one block of collect_block (collect.cuh): a shared-memory
// histogram with integer atomics, every counter written once.
#include "collect.cuh"

#define CO_THREADS 1024

template <typename I>
__global__ void __launch_bounds__(CO_THREADS)
collect_kernel(const I* __restrict__ ids, int n, int n_experts,
               int* __restrict__ counts) {
  extern __shared__ int hist[];
  collect_block<I>(ids, n, n_experts, hist, counts);
}

// id_bytes: 4 (int32 ids) or 8 (int64 ids). Returns a cudaError_t.
extern "C" int collect_launch(const void* ids, int id_bytes, int n,
                              int n_experts, int* counts,
                              cudaStream_t stream) {
  if (n < 0 || n_experts <= 0 || n_experts > CO_MAX_E)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n_experts * sizeof(int);
  if (id_bytes == 4)
    collect_kernel<int32_t><<<1, CO_THREADS, smem, stream>>>(
        reinterpret_cast<const int32_t*>(ids), n, n_experts, counts);
  else if (id_bytes == 8)
    collect_kernel<int64_t><<<1, CO_THREADS, smem, stream>>>(
        reinterpret_cast<const int64_t*>(ids), n, n_experts, counts);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
