// Grouped expert FFN (SwiGLU) for Hopper (sm_90a), plain and
// owner-indexed.
//
// Replaces the TPU kernels src/repro/kernels/gmm/kernel.py: gmm (body
// _kernel) and placement_gmm (_placement_kernel). For every slot s with
// capacity bucket x [C, d] and expert e = phys_owner ? phys_owner[s] : s:
//     out[s] = sum_f (silu(x . Wg[e]) * (x . Wu[e]))[:, f] * Wd[e][f, :]
// with SiLU as g * sigmoid(g), products accumulated in float32, and the
// hidden cast to the payload type before the down-projection (as the
// TPU kernel does at kernel.py:45). Output is float32 [S, C, d].
//
// What bounds it on the H100: bytes. C is tiny (4 at DeepSeek-V3 decode
// and 32-token prefill), so each weight element is used for C FMAs —
// about 4 operations per 2-byte weight against the card's ~295 bf16
// operations per byte. Like the TPU kernel, this walks EVERY slot's
// weights whether or not its bucket holds a row: 3 * 256 * 7168 * 2048
// * 2 B = 22.5 GB per MoE layer call, 6.7 ms at 3.35 TB/s. At decode
// with T=4 tokens at most 32 of 256 buckets are non-empty, so the
// weights that matter are ~8x fewer; skipping empty buckets is a later
// redesign.
//
// Design (first version: right and simple, CUDA-core FMAs).
//  * Two hand-written passes. Pass 1 (grid: f-tiles x slots x row
//    tiles) streams Wg/Wu once per row tile and writes the hidden
//    h = silu(g) * u, cast to the payload type, to a [S, C, f] scratch.
//    Pass 2 (grid: d-tiles x slots x row tiles) streams Wd and writes
//    the float32 output. The scratch costs 2 * S * C * f * sizeof(T)
//    extra bytes (8.4 MB in bf16 at decode, 0.04% of the weight bytes)
//    and buys thousands of independent blocks for 132 SMs instead of
//    one block per slot.
//  * A block owns 128 output columns (64 threads x 2 adjacent columns,
//    so each weight row segment is one 256-byte coalesced read in bf16)
//    and splits the reduction dimension over 4 thread groups; the 4
//    partial sums are combined in a fixed order, so results are
//    bit-reproducible and the owner-indexed call is bit-identical to
//    the plain call on owner-gathered weights (only the weight base
//    pointer differs).
//  * The bucket rows of the tile sit in shared memory as float32, in
//    chunks of the reduction dimension; rows past C are zero and their
//    results are not stored (C may be as small as 4).
//  * wgmma/TMA pipelining and skipping empty buckets come later.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define GMM_THREADS 256
#define GMM_COLS 64           // thread columns per block (x2 values each)
#define GMM_SPLIT 4           // reduction split across thread groups
#define GMM_KCHUNK 256        // reduction elements staged per chunk
#define GMM_ROWS 4            // bucket rows per block; larger C takes
                              // ceil(C / GMM_ROWS) row tiles

template <typename T> struct Vec2;
template <> struct Vec2<float> {
  __device__ static float2 load(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  __device__ static void store(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
  __device__ static float f32(float v) { return v; }
};
template <> struct Vec2<__nv_bfloat16> {
  __device__ static float2 load(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  __device__ static void store(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
  __device__ static float f32(__nv_bfloat16 v) { return __bfloat162float(v); }
};

__device__ __forceinline__ int owner_of(const int* owner, int s, int E) {
  const int e = owner ? owner[s] : s;
  if (e < 0 || e >= E) __trap();
  return e;
}

// Stage rows [row0, row0+CT) x reduction range [k0, k0+kn) of a
// [C, K] matrix (slot-major base pointer) into shared float32.
template <typename T, int CT>
__device__ __forceinline__ void stage_rows(float (*xs)[GMM_KCHUNK],
                                           const T* base, int C, int K,
                                           int row0, int k0, int kn) {
  for (int i = threadIdx.x; i < CT * GMM_KCHUNK; i += GMM_THREADS) {
    const int r = i / GMM_KCHUNK, kk = i % GMM_KCHUNK;
    float v = 0.f;
    if (row0 + r < C && kk < kn)
      v = Vec2<T>::f32(base[(size_t)(row0 + r) * K + k0 + kk]);
    xs[r][kk] = v;
  }
}

// Pass 1: hidden[s, r, f] = cast_T(silu(x . Wg) * (x . Wu)).
template <typename T, int CT>
__global__ void __launch_bounds__(GMM_THREADS)
gate_up_kernel(const T* __restrict__ x, const T* __restrict__ wg,
               const T* __restrict__ wu, const int* __restrict__ owner,
               T* __restrict__ hidden, int C, int d, int f, int E) {
  __shared__ float xs[CT][GMM_KCHUNK];
  __shared__ float red[2][GMM_SPLIT][CT][2 * GMM_COLS];
  const int s = blockIdx.y, row0 = blockIdx.z * CT;
  const int e = owner_of(owner, s, E);
  const int tc = threadIdx.x % GMM_COLS, q = threadIdx.x / GMM_COLS;
  const int col = blockIdx.x * (2 * GMM_COLS) + 2 * tc;
  const bool live = col < f;
  const T* xb = x + (size_t)s * C * d;
  const T* gb = wg + (size_t)e * d * f + col;
  const T* ub = wu + (size_t)e * d * f + col;
  float g[CT][2], u[CT][2];
#pragma unroll
  for (int r = 0; r < CT; ++r) g[r][0] = g[r][1] = u[r][0] = u[r][1] = 0.f;
  for (int k0 = 0; k0 < d; k0 += GMM_KCHUNK) {
    const int kn = min(GMM_KCHUNK, d - k0);
    __syncthreads();
    stage_rows<T, CT>(xs, xb, C, d, row0, k0, kn);
    __syncthreads();
    if (live) {
      for (int kk = q; kk < kn; kk += GMM_SPLIT) {
        const float2 wgv = Vec2<T>::load(gb + (size_t)(k0 + kk) * f);
        const float2 wuv = Vec2<T>::load(ub + (size_t)(k0 + kk) * f);
#pragma unroll
        for (int r = 0; r < CT; ++r) {
          const float xv = xs[r][kk];
          g[r][0] = fmaf(xv, wgv.x, g[r][0]);
          g[r][1] = fmaf(xv, wgv.y, g[r][1]);
          u[r][0] = fmaf(xv, wuv.x, u[r][0]);
          u[r][1] = fmaf(xv, wuv.y, u[r][1]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < CT; ++r) {
    red[0][q][r][2 * tc] = g[r][0];
    red[0][q][r][2 * tc + 1] = g[r][1];
    red[1][q][r][2 * tc] = u[r][0];
    red[1][q][r][2 * tc + 1] = u[r][1];
  }
  __syncthreads();
  if (q == 0 && live) {
#pragma unroll
    for (int r = 0; r < CT; ++r) {
      if (row0 + r >= C) break;
      float h[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float gs = 0.f, us = 0.f;
#pragma unroll
        for (int p = 0; p < GMM_SPLIT; ++p) {
          gs += red[0][p][r][2 * tc + j];
          us += red[1][p][r][2 * tc + j];
        }
        const float sig = 1.f / (1.f + expf(-gs));
        h[j] = gs * sig * us;
      }
      Vec2<T>::store(hidden + ((size_t)s * C + row0 + r) * f + col,
                     h[0], h[1]);
    }
  }
}

// Pass 2: out[s, r, :] = hidden[s, r, :] . Wd[e]   (float32 output).
template <typename T, int CT>
__global__ void __launch_bounds__(GMM_THREADS)
down_kernel(const T* __restrict__ hidden, const T* __restrict__ wd,
            const int* __restrict__ owner, float* __restrict__ out,
            int C, int d, int f, int E) {
  __shared__ float hs[CT][GMM_KCHUNK];
  __shared__ float red[GMM_SPLIT][CT][2 * GMM_COLS];
  const int s = blockIdx.y, row0 = blockIdx.z * CT;
  const int e = owner_of(owner, s, E);
  const int tc = threadIdx.x % GMM_COLS, q = threadIdx.x / GMM_COLS;
  const int col = blockIdx.x * (2 * GMM_COLS) + 2 * tc;
  const bool live = col < d;
  const T* hb = hidden + (size_t)s * C * f;
  const T* db = wd + (size_t)e * f * d + col;
  float acc[CT][2];
#pragma unroll
  for (int r = 0; r < CT; ++r) acc[r][0] = acc[r][1] = 0.f;
  for (int k0 = 0; k0 < f; k0 += GMM_KCHUNK) {
    const int kn = min(GMM_KCHUNK, f - k0);
    __syncthreads();
    stage_rows<T, CT>(hs, hb, C, f, row0, k0, kn);
    __syncthreads();
    if (live) {
      for (int kk = q; kk < kn; kk += GMM_SPLIT) {
        const float2 w = Vec2<T>::load(db + (size_t)(k0 + kk) * d);
#pragma unroll
        for (int r = 0; r < CT; ++r) {
          const float hv = hs[r][kk];
          acc[r][0] = fmaf(hv, w.x, acc[r][0]);
          acc[r][1] = fmaf(hv, w.y, acc[r][1]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < CT; ++r) {
    red[q][r][2 * tc] = acc[r][0];
    red[q][r][2 * tc + 1] = acc[r][1];
  }
  __syncthreads();
  if (q == 0 && live) {
#pragma unroll
    for (int r = 0; r < CT; ++r) {
      if (row0 + r >= C) break;
      float o[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float v = 0.f;
#pragma unroll
        for (int p = 0; p < GMM_SPLIT; ++p) v += red[p][r][2 * tc + j];
        o[j] = v;
      }
      Vec2<float>::store(out + ((size_t)s * C + row0 + r) * d + col,
                         o[0], o[1]);
    }
  }
}

template <typename T, int CT>
static void launch(const void* x, const void* wg, const void* wu,
                   const void* wd, const int* owner, void* hidden,
                   float* out, int S, int C, int d, int f, int E,
                   cudaStream_t stream) {
  const int rt = (C + CT - 1) / CT;
  const dim3 g1((f + 2 * GMM_COLS - 1) / (2 * GMM_COLS), S, rt);
  gate_up_kernel<T, CT><<<g1, GMM_THREADS, 0, stream>>>(
      reinterpret_cast<const T*>(x), reinterpret_cast<const T*>(wg),
      reinterpret_cast<const T*>(wu), owner, reinterpret_cast<T*>(hidden),
      C, d, f, E);
  const dim3 g2((d + 2 * GMM_COLS - 1) / (2 * GMM_COLS), S, rt);
  down_kernel<T, CT><<<g2, GMM_THREADS, 0, stream>>>(
      reinterpret_cast<const T*>(hidden), reinterpret_cast<const T*>(wd),
      owner, out, C, d, f, E);
}

// dtype: 0 = float32, 1 = bfloat16 (buckets, weights and hidden share it).
// owner: null for the plain grouped FFN (slot s uses expert s).
extern "C" int gmm_launch(const void* x, const void* wg, const void* wu,
                          const void* wd, const int* owner, void* hidden,
                          float* out, int S, int C, int d, int f, int E,
                          int dtype, cudaStream_t stream) {
  if (S <= 0 || C <= 0 || (d & 1) || (f & 1) || E <= 0 || S > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    launch<__nv_bfloat16, GMM_ROWS>(x, wg, wu, wd, owner, hidden, out, S, C,
                                    d, f, E, stream);
  } else if (dtype == 0) {
    launch<float, GMM_ROWS>(x, wg, wu, wd, owner, hidden, out, S, C, d, f,
                            E, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
