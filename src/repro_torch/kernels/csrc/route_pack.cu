// Fused route-pack for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/route_pack/kernel.py
// (route_pack_kernel, body _kernel): for N = T*k routed assignments it
// computes each assignment's FIFO rank within its destination bucket,
// keep = rank < capacity && valid, optionally quantizes the payload row
// to INT8 per token, and scatters kept rows x[r / k] into
// [n_dest, C, d] buckets together with their scale and expert id.
//
// What bounds it on the H100: bytes. Every byte of the outputs is written
// once — at decode mostly the zeros of empty slots (DeepSeek-V3: 256 x 4
// x 7168 bf16, 14.7 MB, 4.4 us at 3.35 TB/s) — and the kept rows are read
// once.
//
// Design: one launch, one block per destination, plus one block for the
// rows that have none.
//  * Block e walks dest in order, 256 entries a tile, one per thread;
//    each warp's __ballot_sync of (dest == e) and the popcount of the
//    lanes below give every assignment with destination e its FIFO rank
//    (the same count as the reference's cumsum, with no atomics). The
//    block writes rank and keep for those assignments; masked rows
//    (valid == 0) still take a rank but are not kept.
//  * Slots of e: slot c < min(count, C) belongs to e's c-th assignment
//    and holds its row if that one is valid; every other slot holds
//    zeros, scale 0 and expert id -1. The block writes them all, one warp
//    a slot, with 16-byte accesses where d allows: a copy, or the per-row
//    INT8 quantization (scale = fmaxf(amax, 1e-8f) * (float)(1.0/127.0),
//    q = rintf(x / scale) with a true IEEE divide and round-half-to-even,
//    like jnp.round, clipped to +-127). So every output byte is written
//    exactly once, by this kernel: no fill or memset comes before it.
//  * The slot -> assignment map lives in shared memory for 256 slots at a
//    time; a capacity beyond that takes one more walk of dest per 256.
//  * Block n_dest writes rank 0 and keep 0 for padding rows (dest ==
//    n_dest) and ids outside [0, n_dest).
//  * Each block reads all N ids: N <= 2048 on the serving path, 8 KB
//    from L2 a block.
//  * EPLB Collect in the same launch (optional): given count ids, block
//    n_dest + 1 histograms them into counts[n_count] with collect.cuh's
//    body (the one collect.cu launches alone) and writes every counter
//    once. The MoE layer passes its logical top-k ids, which under an
//    EPLB placement differ from dest (physical slots): Collect counts
//    logical experts, as the reference does. The count block runs beside
//    the destination blocks (the grid fits the card at once), so the
//    layer's Collect costs no launch of its own; it changes nothing the
//    other blocks write. The ids' width (none, int32, int64) is a
//    template argument, so a pack without counts runs the kernel as it
//    was.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "collect.cuh"

#define RP_THREADS 256
#define RP_WARPS (RP_THREADS / 32)
#define RP_WINDOW 256  // slots mapped in shared memory per walk of dest
#define RP_MAX_COUNT 8192  // count block's shared counters: 32 KB

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Eight payload values at p (16-byte aligned) as floats.
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
// (a bfloat16 is the top half of its float: the widening is exact)
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ int8_t quant1(float v, float scale) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.f), 127.f);
  return (int8_t)q;
}

// One bucket slot, written by one warp: row `src` of the assignments'
// payload (x[src / k]), or zeros when src < 0.
template <typename T, bool QUANT, bool VEC>
__device__ __forceinline__ void write_slot(const T* __restrict__ x,
                                           const int* __restrict__ eid, int d,
                                           int k, int src, size_t slot,
                                           void* __restrict__ buckets,
                                           float* __restrict__ scales,
                                           int* __restrict__ eids) {
  const int lane = threadIdx.x & 31;
  if (eids != nullptr && lane == 0) eids[slot] = src < 0 ? -1 : eid[src];
  if (QUANT) {
    int8_t* out = reinterpret_cast<int8_t*>(buckets) + slot * d;
    if (src < 0) {
      if (lane == 0) scales[slot] = 0.f;
      if (VEC) {
        for (int i = lane; i < d / 8; i += 32)
          reinterpret_cast<uint2*>(out)[i] = make_uint2(0u, 0u);
      } else {
        for (int i = lane; i < d; i += 32) out[i] = 0;
      }
      return;
    }
    const T* row = x + (size_t)(src / k) * d;
    float amax = 0.f;
    if (VEC) {
      for (int i = lane; i < d / 8; i += 32) {
        float v[8];
        load8(row + 8 * i, v);
#pragma unroll
        for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[j]));
      }
    } else {
      for (int i = lane; i < d; i += 32)
        amax = fmaxf(amax, fabsf(to_f32(row[i])));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float scale = fmaxf(amax, 1e-8f) * (float)(1.0 / 127.0);
    if (lane == 0) scales[slot] = scale;
    if (VEC) {
      for (int i = lane; i < d / 8; i += 32) {
        float v[8];
        load8(row + 8 * i, v);
        uint32_t w[2] = {0u, 0u};
#pragma unroll
        for (int j = 0; j < 8; ++j)
          w[j >> 2] |= (uint32_t)(uint8_t)quant1(v[j], scale) << (8 * (j & 3));
        reinterpret_cast<uint2*>(out)[i] = make_uint2(w[0], w[1]);
      }
    } else {
      for (int i = lane; i < d; i += 32) out[i] = quant1(to_f32(row[i]), scale);
    }
  } else {
    T* out = reinterpret_cast<T*>(buckets) + slot * d;
    if (VEC) {
      const int n16 = d * (int)sizeof(T) / 16;
      uint4* o = reinterpret_cast<uint4*>(out);
      if (src < 0) {
        for (int i = lane; i < n16; i += 32) o[i] = make_uint4(0u, 0u, 0u, 0u);
      } else {
        const uint4* in =
            reinterpret_cast<const uint4*>(x + (size_t)(src / k) * d);
        for (int i = lane; i < n16; i += 32) o[i] = in[i];
      }
    } else if (src < 0) {
      for (int i = lane; i < d; i += 32) out[i] = zero_of<T>();
    } else {
      const T* row = x + (size_t)(src / k) * d;
      for (int i = lane; i < d; i += 32) out[i] = row[i];
    }
  }
}

// CB: bytes of a count id (4 or 8), or 0 for a pack without counts.
template <typename T, bool QUANT, bool VEC, int CB>
__global__ void __launch_bounds__(RP_THREADS)
    route_pack_kernel(const T* __restrict__ x, const int* __restrict__ dest,
                      const int* __restrict__ valid,
                      const int* __restrict__ eid, int d, int N, int k,
                      int n_dest, int capacity, void* __restrict__ buckets,
                      float* __restrict__ scales, int* __restrict__ eids,
                      int* __restrict__ rank,
                      unsigned char* __restrict__ keep,
                      const void* __restrict__ count_ids, int n_count,
                      int* __restrict__ counts) {
  __shared__ int warp_hits[RP_WARPS];
  __shared__ int src_of[RP_WINDOW];  // slot w0 + i -> assignment, -1 masked
  const int e = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  if (CB != 0 && e == n_dest + 1) {  // EPLB Collect of the count ids
    extern __shared__ int hist[];
    if (CB == 4)
      collect_block<int32_t>(reinterpret_cast<const int32_t*>(count_ids), N,
                             n_count, hist, counts);
    else
      collect_block<int64_t>(reinterpret_cast<const int64_t*>(count_ids), N,
                             n_count, hist, counts);
    return;
  }
  if (e == n_dest) {  // rows with no destination
    for (int r = tid; r < N; r += RP_THREADS) {
      const int dd = dest[r];
      if (dd < 0 || dd >= n_dest) {
        rank[r] = 0;
        keep[r] = 0;
      }
    }
    return;
  }
  const unsigned below = (1u << lane) - 1u;
  int count = 0;  // assignments with destination e (known after walk 0)
  for (int w0 = 0; w0 < capacity; w0 += RP_WINDOW) {
    // walk dest in order: FIFO ranks; the first walk writes rank and
    // keep, every walk maps the window's slots to their assignments
    if (w0 == 0 || w0 < count) {
      int base = 0;
      for (int t0 = 0; t0 < N; t0 += RP_THREADS) {
        const int r = t0 + tid;
        const bool hit = r < N && dest[r] == e;
        const unsigned bal = __ballot_sync(0xffffffffu, hit);
        if (lane == 0) warp_hits[warp] = __popc(bal);
        __syncthreads();
        int before = base, total = 0;
#pragma unroll
        for (int w = 0; w < RP_WARPS; ++w) {
          const int c = warp_hits[w];
          before += w < warp ? c : 0;
          total += c;
        }
        if (hit) {
          const int rk = before + __popc(bal & below);
          const bool ok = valid == nullptr || valid[r] != 0;
          if (w0 == 0) {
            rank[r] = rk;
            keep[r] = (rk < capacity && ok) ? 1 : 0;
          }
          if (rk >= w0 && rk < w0 + RP_WINDOW && rk < capacity)
            src_of[rk - w0] = ok ? r : -1;
        }
        base += total;
        __syncthreads();  // warp_hits is rewritten by the next tile
      }
      count = base;
    }
    __syncthreads();
    const int w1 = min(capacity, w0 + RP_WINDOW);
    for (int s = w0 + warp; s < w1; s += RP_WARPS)
      write_slot<T, QUANT, VEC>(x, eid, d, k, s < count ? src_of[s - w0] : -1,
                                (size_t)e * capacity + s, buckets, scales,
                                eids);
    __syncthreads();  // src_of is rewritten by the next window
  }
}

struct RpArgs {
  const void* x;
  const int *dest, *valid, *eid;
  int d, N, k, n_dest, capacity;
  void* buckets;
  float* scales;
  int *eids, *rank;
  unsigned char* keep;
  const void* count_ids;
  int n_count;
  int* counts;
  cudaStream_t stream;
};

template <typename T, bool QUANT, bool VEC, int CB>
static int launch(const RpArgs& a) {
  // one block per destination, one for rows with none, and the count block
  const int grid = a.n_dest + (CB != 0 ? 2 : 1);
  const size_t smem = CB != 0 ? (size_t)a.n_count * sizeof(int) : 0;
  route_pack_kernel<T, QUANT, VEC, CB><<<grid, RP_THREADS, smem, a.stream>>>(
      reinterpret_cast<const T*>(a.x), a.dest, a.valid, a.eid, a.d, a.N, a.k,
      a.n_dest, a.capacity, a.buckets, a.scales, a.eids, a.rank, a.keep,
      a.count_ids, a.n_count, a.counts);
  return (int)cudaGetLastError();
}

template <typename T, bool QUANT, bool VEC>
static int launch_cb(const RpArgs& a, int count_bytes) {
  if (count_bytes == 4) return launch<T, QUANT, VEC, 4>(a);
  if (count_bytes == 8) return launch<T, QUANT, VEC, 8>(a);
  return launch<T, QUANT, VEC, 0>(a);
}

template <typename T>
static int launch_t(const RpArgs& a, int quantize, int count_bytes) {
  // 16-byte payload loads and bucket stores: 8 values a group
  const bool vec = a.d % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(a.x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.buckets) % 16 == 0;
  if (quantize)
    return vec ? launch_cb<T, true, true>(a, count_bytes)
               : launch_cb<T, true, false>(a, count_bytes);
  return vec ? launch_cb<T, false, true>(a, count_bytes)
             : launch_cb<T, false, false>(a, count_bytes);
}

// dtype: 0 = float32 payload, 1 = bfloat16 payload. valid and eid may be
// null (all valid; no expert-id payload). count_bytes 0: no counts;
// else count_ids holds N ids of count_bytes (4: int32, 8: int64) each
// (null only when N is 0), and counts receives their histogram over
// [0, n_count). Every output is
// written by the kernel: the caller allocates them uninitialised. Returns
// a cudaError_t.
extern "C" int route_pack_launch(const void* x, int dtype, const int* dest,
                                 const int* valid, const int* eid, int d,
                                 int N, int k, int n_dest, int capacity,
                                 int quantize, void* buckets, float* scales,
                                 int* eids, int* rank, unsigned char* keep,
                                 const void* count_ids, int count_bytes,
                                 int n_count, int* counts,
                                 cudaStream_t stream) {
  if (n_dest <= 0 || k <= 0 || capacity <= 0 || d < 0 || N < 0)
    return (int)cudaErrorInvalidValue;
  if (count_bytes != 0 &&
      ((count_bytes != 4 && count_bytes != 8) || counts == nullptr ||
       n_count <= 0 || n_count > RP_MAX_COUNT))
    return (int)cudaErrorInvalidValue;
  const RpArgs a{x,       dest,   valid, eid,  d,    N,
                 k,       n_dest, capacity, buckets, scales, eids,
                 rank,    keep,   count_ids, n_count, counts, stream};
  if (dtype == 1) return launch_t<__nv_bfloat16>(a, quantize, count_bytes);
  if (dtype == 0) return launch_t<float>(a, quantize, count_bytes);
  return (int)cudaErrorInvalidValue;
}
