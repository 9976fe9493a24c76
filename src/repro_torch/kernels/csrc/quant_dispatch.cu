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
// at 3.35 TB/s); at the path's smaller shapes the launch dominates.
//
// Design.
//  * A group of threads owns a row: one warp for rows of up to 1024
//    values (8 rows per 256-thread block: cache rows of 128 or 512),
//    the whole block for wider rows (activations of 1536-18432). The
//    group reduces amax with warp shuffles (and shared memory across the
//    block's warps), then reads the row again — from L1/L2 — to write it.
//  * Bit-identical to the plain version: the max is exact in any order;
//    both the scale and the quotient are true IEEE divides (__fdiv_rn,
//    never a reciprocal multiply or __fdividef), rounding is half to even
//    (rintf, as jnp.round and torch.round), then the clip. An all-zero
//    row gives scale 1e-8/127 and zeros.
//  * Any d: the row is walked with a stride of the group's width, so a
//    ragged d needs no padding.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define QD_THREADS 256

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// TPR: threads per row (32: a warp per row; QD_THREADS: a block per row).
template <typename T, int TPR>
__global__ void __launch_bounds__(QD_THREADS)
quant_dispatch_kernel(const T* __restrict__ x, int n_rows, int d,
                      int8_t* __restrict__ q, float* __restrict__ scales) {
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
  for (int i = lane; i < d; i += TPR) {
    float v = rintf(__fdiv_rn(to_f32(xr[i]), scale));
    v = fminf(fmaxf(v, -127.f), 127.f);
    qr[i] = (int8_t)v;
  }
  if (lane == 0) scales[row] = scale;
}

template <typename T>
static int launch(const void* x, int n_rows, int d, int8_t* q, float* s,
                  cudaStream_t stream) {
  const T* xt = reinterpret_cast<const T*>(x);
  if (d > 1024) {
    quant_dispatch_kernel<T, QD_THREADS><<<n_rows, QD_THREADS, 0, stream>>>(
        xt, n_rows, d, q, s);
  } else {
    constexpr int rpb = QD_THREADS / 32;
    quant_dispatch_kernel<T, 32><<<(n_rows + rpb - 1) / rpb, QD_THREADS, 0,
                                   stream>>>(xt, n_rows, d, q, s);
  }
  return (int)cudaGetLastError();
}

// dtype: 0 = float32 rows, 1 = bfloat16 rows. Returns a cudaError_t.
extern "C" int quant_dispatch_launch(const void* x, int dtype, int n_rows,
                                     int d, int8_t* q, float* scales,
                                     cudaStream_t stream) {
  if (n_rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1) return launch<__nv_bfloat16>(x, n_rows, d, q, scales, stream);
  if (dtype == 0) return launch<float>(x, n_rows, d, q, scales, stream);
  return (int)cudaErrorInvalidValue;
}
