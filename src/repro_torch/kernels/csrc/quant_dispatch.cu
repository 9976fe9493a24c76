// Token-wise INT8 quantization for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/quant_dispatch/kernel.py
// (quant_dispatch, body _kernel): for every row of x [T, d] (bf16 or f32)
//   scale = max(amax, 1e-8) / 127,  q = clip(round(x / scale), -127, 127)
// giving int8 [T, d] and one f32 scale per row. The port's W8A8 linear
// quantizes its activations with it, and the INT8 KV cache its rows.
//
// What bounds it on the H100: bytes. One read of the input and one write
// of the int8 rows and the scales (at [512, 7168] bf16 about 11 MB, 3.3 us
// at 3.35 TB/s). At decode (T = 4) the rows are 14-144 KB: a launch that
// gives each row one block leaves 128 of 132 SMs idle.
//
// Design. A row is cut into 8-value units (16 bytes of bf16, 32 of f32).
// The launch plan (quant_dispatch/kernel.py::plan, from T, d and the SM
// count) names one of four paths:
//  * warp: rows of up to 128 units (KV rows of 128 and 512): a group of
//    G <= 32 lanes owns a row, 256 / G rows to a 256-thread block.
//  * block: one block of G threads owns a row.
//  * cluster: a cluster of CS = 2, 4 or 8 blocks owns a row, each block a
//    slice of `per` units (when the rows are too few to fill the card, or
//    too wide for one block's registers). Each block reduces the amax of
//    its slice; the blocks exchange their partial amax through
//    distributed shared memory between two cluster barriers, and each
//    then quantizes its own slice; block 0 of the cluster writes the scale.
//  * scalar: ragged d, an input not 16-byte aligned, or rows too wide for
//    eight blocks' registers: a warp (d <= 1024) or a block of 256 threads
//    per row, scalar loads, the row read twice (amax, then quantize).
// On the three vector paths each value is read from device memory once:
// thread t of a group holds units u0 + j*G + t (j < V) in registers,
// loaded with 16-byte loads (neighbouring threads on neighbouring units),
// reduces amax with warp shuffles (and shared memory across warps), and
// quantizes from registers, storing 8 int8 values a thread (a warp writes
// 256 bytes at a time). Units past the row's (or slice's) end are masked:
// they add 0 to the amax and store nothing.
//
// Bit-identical to the plain version: the max is exact in any order; both
// the scale and the quotient are true IEEE divides (__fdiv_rn, never a
// reciprocal multiply or __fdividef), rounding is half to even (rintf, as
// jnp.round and torch.round), then the clip. An all-zero row gives scale
// 1e-8/127 and zeros; on the vector paths it stores its zeros without the
// divide (whose slow path a zero dividend over that scale takes: the
// empty slots of a KV cache are such rows).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define QD_THREADS 256  // block of the scalar and warp paths

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ int8_t quant1(float v, float scale) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.f), 127.f);
  return (int8_t)q;
}

// Eight values of a row, as loaded: kept packed until quantized.
template <typename T>
struct Unit;
template <>
struct Unit<__nv_bfloat16> {
  uint4 w;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    w = __ldg(reinterpret_cast<const uint4*>(p));
  }
  // (a bfloat16 is the top half of its float: the widening is exact)
  __device__ __forceinline__ float at(int i) const {
    const uint32_t u = i < 2 ? w.x : i < 4 ? w.y : i < 6 ? w.z : w.w;
    return __uint_as_float((i & 1) ? (u & 0xffff0000u) : (u << 16));
  }
};
template <>
struct Unit<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ float at(int i) const {
    const float4& h = i < 4 ? a : b;
    const int k = i & 3;
    return k == 0 ? h.x : k == 1 ? h.y : k == 2 ? h.z : h.w;
  }
};

template <typename T>
__device__ __forceinline__ float unit_amax(const Unit<T>& u, float m) {
#pragma unroll
  for (int i = 0; i < 8; ++i) m = fmaxf(m, fabsf(u.at(i)));
  return m;
}

// The unit's eight int8 values, one 8-byte store. zero_row (amax 0, the
// same for the whole group): every value is +-0 or NaN, and 0 / scale is
// 0, so only NaN values take the divide — which would run its slow path
// on a zero dividend over the scale 1e-8/127 (empty cache slots).
template <typename T>
__device__ __forceinline__ void unit_store(int8_t* p, const Unit<T>& u,
                                           float scale, bool zero_row) {
  uint32_t w[2] = {0u, 0u};
  if (zero_row) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (u.at(i) != 0.f)
        w[i >> 2] |= (uint32_t)(uint8_t)quant1(u.at(i), scale) << (8 * (i & 3));
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      w[i >> 2] |= (uint32_t)(uint8_t)quant1(u.at(i), scale) << (8 * (i & 3));
  }
  *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}

// ---------------------------------------------------------------------------
// scalar path (TPR threads per row: 32, or QD_THREADS)
// ---------------------------------------------------------------------------
template <typename T, int TPR>
__global__ void __launch_bounds__(QD_THREADS)
quant_dispatch_scalar_kernel(const T* __restrict__ x, int n_rows, int d,
                             int8_t* __restrict__ q,
                             float* __restrict__ scales) {
  constexpr int RPB = QD_THREADS / TPR;          // rows per block
  __shared__ float red[QD_THREADS / 32];
  const int lane = threadIdx.x % TPR;
  const int row = blockIdx.x * RPB + threadIdx.x / TPR;
  const bool live = row < n_rows;                // uniform over the group
  const T* xr = x + (size_t)row * d;
  float amax = 0.f;
  if (live)
    for (int i = lane; i < d; i += TPR) amax = fmaxf(amax, fabsf(to_f32(xr[i])));
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (TPR > 32) {
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
    __syncthreads();
    amax = red[0];
#pragma unroll
    for (int w = 1; w < TPR / 32; ++w) amax = fmaxf(amax, red[w]);
  }
  if (!live) return;
  const float scale = __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
  int8_t* qr = q + (size_t)row * d;
  for (int i = lane; i < d; i += TPR) qr[i] = quant1(to_f32(xr[i]), scale);
  if (lane == 0) scales[row] = scale;
}

// ---------------------------------------------------------------------------
// warp path: a group of G lanes (a power of two <= 32) per row
// ---------------------------------------------------------------------------
template <typename T, int V>
__global__ void __launch_bounds__(QD_THREADS)
quant_dispatch_warp_kernel(const T* __restrict__ x, int n_rows, int d, int G,
                           int8_t* __restrict__ q,
                           float* __restrict__ scales) {
  const int units = d >> 3;
  const int t = threadIdx.x % G;
  const int row = blockIdx.x * (QD_THREADS / G) + threadIdx.x / G;
  const bool live = row < n_rows;                // uniform over the group
  const T* xr = x + (size_t)row * d;
  Unit<T> u[V];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = j * G + t;
    if (live && c < units) {
      u[j].load(xr + 8 * c);
      amax = unit_amax(u[j], amax);
    }
  }
  for (int o = G >> 1; o > 0; o >>= 1)           // within the group
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (!live) return;
  const float scale = __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
  int8_t* qr = q + (size_t)row * d;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = j * G + t;
    if (c < units) unit_store(qr + 8 * c, u[j], scale, amax == 0.f);
  }
  if (t == 0) scales[row] = scale;
}

// ---------------------------------------------------------------------------
// block and cluster paths: CS blocks per row (1: the block path), block r
// of a row owning units [r * per, min(units, (r + 1) * per))
// ---------------------------------------------------------------------------
template <int V>
struct MaxGroup {  // the block sizes the registers allow (V units a thread)
  static constexpr int value = V <= 2 ? 1024 : 512;
};

template <typename T, int V, int CS>
__global__ void __launch_bounds__(MaxGroup<V>::value)
quant_dispatch_block_kernel(const T* __restrict__ x, int d, int per,
                            int8_t* __restrict__ q,
                            float* __restrict__ scales) {
  __shared__ float red[32];
  __shared__ float part;                         // this block's amax
  const int units = d >> 3;
  const int G = blockDim.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int row = blockIdx.x / CS, r = blockIdx.x % CS;
  const int u0 = r * per, u1 = min(units, u0 + per);
  const T* xr = x + (size_t)row * d;
  Unit<T> u[V];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = u0 + j * G + t;
    if (c < u1) {
      u[j].load(xr + 8 * c);
      amax = unit_amax(u[j], amax);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (lane == 0) red[warp] = amax;
  __syncthreads();
  amax = red[0];
  for (int w = 1; w < G / 32; ++w) amax = fmaxf(amax, red[w]);
  if (CS > 1) {
    // the row's amax: every block's partial, read through distributed
    // shared memory once all are written
    cg::cluster_group cluster = cg::this_cluster();
    if (t == 0) part = amax;
    cluster.sync();
    if (warp == 0) {
      float m = 0.f;
      if (lane < CS) m = *cluster.map_shared_rank(&part, lane);
#pragma unroll
      for (int o = 4; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if (lane == 0) red[0] = m;
    }
    __syncthreads();
    amax = red[0];
    // the remote reads are done: arrive now, wait before exiting, so no
    // block's shared memory goes while another may still read it
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  }
  const float scale = __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
  int8_t* qr = q + (size_t)row * d;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = u0 + j * G + t;
    if (c < u1) unit_store(qr + 8 * c, u[j], scale, amax == 0.f);
  }
  if (r == 0 && t == 0) scales[row] = scale;
  if (CS > 1)
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
enum { QD_SCALAR = 0, QD_WARP = 1, QD_BLOCK = 2, QD_CLUSTER = 3 };

template <typename T, int V>
static int launch_warp(const T* x, int n_rows, int d, int G, int8_t* q,
                       float* s, cudaStream_t stream) {
  const int rpb = QD_THREADS / G;
  quant_dispatch_warp_kernel<T, V><<<(n_rows + rpb - 1) / rpb, QD_THREADS, 0,
                                     stream>>>(x, n_rows, d, G, q, s);
  return (int)cudaGetLastError();
}

template <typename T, int V, int CS>
static int launch_block(const T* x, int n_rows, int d, int G, int per,
                        int8_t* q, float* s, cudaStream_t stream) {
  if (G > MaxGroup<V>::value) return (int)cudaErrorInvalidValue;
  if (CS == 1) {
    quant_dispatch_block_kernel<T, V, 1><<<n_rows, G, 0, stream>>>(x, d, per,
                                                                   q, s);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n_rows * CS);
  cfg.blockDim = dim3(G);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, quant_dispatch_block_kernel<T, V, CS>, x, d, per, q, s);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <typename T, int V>
static int launch_cs(const T* x, int n_rows, int d, int G, int cs, int per,
                     int8_t* q, float* s, cudaStream_t stream) {
  switch (cs) {
    case 1: return launch_block<T, V, 1>(x, n_rows, d, G, per, q, s, stream);
    case 2: return launch_block<T, V, 2>(x, n_rows, d, G, per, q, s, stream);
    case 4: return launch_block<T, V, 4>(x, n_rows, d, G, per, q, s, stream);
    case 8: return launch_block<T, V, 8>(x, n_rows, d, G, per, q, s, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
static int launch(const void* xv, int n_rows, int d, int path, int G, int V,
                  int cs, int per, int8_t* q, float* s, cudaStream_t stream) {
  const T* x = reinterpret_cast<const T*>(xv);
  const int units = d / 8;
  if (path == QD_SCALAR) {
    if (G == QD_THREADS) {
      quant_dispatch_scalar_kernel<T, QD_THREADS><<<n_rows, QD_THREADS, 0,
                                                    stream>>>(x, n_rows, d,
                                                              q, s);
    } else if (G == 32) {
      constexpr int rpb = QD_THREADS / 32;
      quant_dispatch_scalar_kernel<T, 32><<<(n_rows + rpb - 1) / rpb,
                                            QD_THREADS, 0, stream>>>(
          x, n_rows, d, q, s);
    } else {
      return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
  }
  // the vector paths: whole units, a 16-byte aligned input, a plan that
  // covers the row
  if (d % 8 != 0 || reinterpret_cast<uintptr_t>(xv) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(q) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (path == QD_WARP) {
    if (G < 1 || G > 32 || (G & (G - 1)) != 0 || G * V < units)
      return (int)cudaErrorInvalidValue;
    switch (V) {
      case 1: return launch_warp<T, 1>(x, n_rows, d, G, q, s, stream);
      case 2: return launch_warp<T, 2>(x, n_rows, d, G, q, s, stream);
      case 4: return launch_warp<T, 4>(x, n_rows, d, G, q, s, stream);
    }
    return (int)cudaErrorInvalidValue;
  }
  if ((path == QD_BLOCK) != (cs == 1) || path < QD_BLOCK || path > QD_CLUSTER)
    return (int)cudaErrorInvalidValue;
  if (G < 32 || G % 32 != 0 || per <= 0 || (long long)per * cs < units ||
      G * V < per)
    return (int)cudaErrorInvalidValue;
  switch (V) {
    case 1: return launch_cs<T, 1>(x, n_rows, d, G, cs, per, q, s, stream);
    case 2: return launch_cs<T, 2>(x, n_rows, d, G, cs, per, q, s, stream);
    case 4: return launch_cs<T, 4>(x, n_rows, d, G, cs, per, q, s, stream);
    case 8: return launch_cs<T, 8>(x, n_rows, d, G, cs, per, q, s, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32 rows, 1 = bfloat16 rows. The plan's fields: path
// (0 scalar, 1 warp, 2 block, 3 cluster), group (threads per row on the
// scalar and warp paths, per block on the others), vec (units a thread
// holds; 0 on the scalar path), cluster (blocks per row) and per (units a
// block's slice holds). Returns a cudaError_t.
extern "C" int quant_dispatch_launch(const void* x, int dtype, int n_rows,
                                     int d, int path, int group, int vec,
                                     int cluster, int per, int8_t* q,
                                     float* scales, cudaStream_t stream) {
  if (n_rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, n_rows, d, path, group, vec, cluster,
                                 per, q, scales, stream);
  if (dtype == 0)
    return launch<float>(x, n_rows, d, path, group, vec, cluster, per, q,
                         scales, stream);
  return (int)cudaErrorInvalidValue;
}
