// Flash-decoding GQA attention over a KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py
// (decode_attention, body _kernel). For each batch row b and query head
// h = kvh * G + g (G = H / KV query heads share KV head kvh):
//     s[l]   = (q[b, h] . k[b, l, kvh]) / sqrt(hd)      (float32)
//     valid  = slot l <= pos[b]                       (window == 0), or
//              the ring rule kv_pos = pos - ((pos - l) mod window),
//              0 <= kv_pos, kv_pos > pos - window, kv_pos <= pos
//     out    = sum_l cast_T(p[l]) v[b, l, kvh] / max(sum_l p[l], 1e-30)
// with p the exp-weights of an online softmax that skips fully masked
// tiles (the safe_m / corr guards of the TPU kernel). Output is float32
// [B, H, hd]. Slots past L (a ragged tail) and masked slots are never
// used, whatever they hold: masked slots are staged as zeros.
//
// What bounds it on the H100: bytes. Each K/V element read feeds 2*G
// FMAs, far below the card's ~295 operations per byte, so the least
// time is the K/V rows the call needs over 3.35 TB/s. With window == 0
// a row needs only slots <= pos, and the kernel reads no others. At the
// Llama-4 decode shape (B 4, KV 8, hd 128, L 1024) that is at most
// 16.8 MB, 5.0 us: below the cost of a launch, so on the serving path
// the kernel is launch-bound.
//
// Design (first version: right and simple, CUDA-core FMAs).
//  * The TPU grid (B, KV, L / bl) runs its L axis in order with the
//    softmax state in VMEM. Here L is split across blocks instead
//    (grid: splits x KV x B, so a 4-row batch still fills the SMs), each
//    block keeps its own (m, l, acc) over its slot range, and a second
//    launch combines the partials by log-sum-exp weights, the
//    combination the JAX package's seq-sharded decode uses across chips.
//  * A block holds the G query rows of its KV head in shared memory
//    (G may be any count, 5 for Llama-4), walks its range in tiles of
//    32 slots: K and V tiles staged as float32 in shared memory (rows
//    padded by one float so the score loop is free of bank conflicts),
//    one thread per (g, slot) score, one warp per query row for the
//    tile's max / exp / sum (one lane per slot), and each thread owns
//    G * hd / 128 output elements of the accumulator in registers.
//  * K and V are read with 16-byte vector loads (8 bf16 or 4 float32
//    values a thread), so a warp reads 512 contiguous bytes of a row.
//  * Strides of K and V are passed in (batch, slot, head), so a view of
//    a stacked cache is read in place; the innermost stride must be 1,
//    the other strides multiples of 16 bytes and the base 16-byte
//    aligned (the wrapper checks).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#define DA_THREADS 128
#define DA_TILE 32            // cache slots per tile: one per lane
#define DA_MAX_GD 1024        // G * hd per block
#define DA_ACC (DA_MAX_GD / DA_THREADS)

template <typename T> struct Val;
template <> struct Val<float> {
  static constexpr int VEC = 4;             // values per 16-byte load
  __device__ static float f32(float v) { return v; }
  __device__ static float round(float v) { return v; }
  __device__ static void unpack(const uint4& r, float* out) {
    out[0] = __uint_as_float(r.x);
    out[1] = __uint_as_float(r.y);
    out[2] = __uint_as_float(r.z);
    out[3] = __uint_as_float(r.w);
  }
};
template <> struct Val<__nv_bfloat16> {
  static constexpr int VEC = 8;
  __device__ static float f32(__nv_bfloat16 v) { return __bfloat162float(v); }
  // p cast to the value type before p . v, as the TPU kernel does
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static void unpack(const uint4& r, float* out) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ bool slot_valid(int slot, int pos, int window) {
  if (window > 0) {
    int delta = (pos - slot) % window;
    if (delta < 0) delta += window;
    const int kv_pos = pos - delta;
    return kv_pos >= 0 && kv_pos > pos - window && kv_pos <= pos;
  }
  return slot <= pos;
}

// One block: batch row b, KV head kvh, slots [lo, hi) of split `split`.
// Writes acc [G, hd] and (m, l) [G] of its range.
template <typename T>
__global__ void __launch_bounds__(DA_THREADS, 4)
partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ positions,
               float* __restrict__ part_acc, float* __restrict__ part_ml,
               int H, int G, int hd, int log2hd, int L, int split_len,
               int n_split, int window, float scale, long long ksb,
               long long ksl, long long ksh, long long vsb, long long vsl,
               long long vsh) {
  extern __shared__ float smem[];
  const int hdp = hd + 1, GD = G * hd;
  float* qs = smem;                         // [G][hd]
  float* ks = qs + GD;                      // [DA_TILE][hdp]
  float* vs = ks + DA_TILE * hdp;           // [DA_TILE][hdp]
  float* ps = vs + DA_TILE * hdp;           // [G][DA_TILE]
  float* m_s = ps + G * DA_TILE;            // [G]
  float* l_s = m_s + G;                     // [G]
  float* c_s = l_s + G;                     // [G]

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pos = positions[b];
  const int lo = split * split_len;
  int hi = min(L, lo + split_len);
  if (window == 0) hi = min(hi, pos + 1);   // masked slots are not read

  const T* qb = q + ((size_t)b * H + (size_t)kvh * G) * hd;
  for (int i = tid; i < GD; i += DA_THREADS) qs[i] = Val<T>::f32(qb[i]);
  for (int g = tid; g < G; g += DA_THREADS) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }
  float acc[DA_ACC];
#pragma unroll
  for (int i = 0; i < DA_ACC; ++i) acc[i] = 0.f;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;

  for (int t0 = lo; t0 < hi; t0 += DA_TILE) {
    __syncthreads();                 // the previous tile's readers are done
    constexpr int VEC = Val<T>::VEC;
    for (int i = tid * VEC; i < DA_TILE * hd; i += DA_THREADS * VEC) {
      const int j = i >> log2hd, d = i & (hd - 1), slot = t0 + j;
      float kk[VEC], vv[VEC];
      if (slot < hi && slot_valid(slot, pos, window)) {
        Val<T>::unpack(*reinterpret_cast<const uint4*>(kb + slot * ksl + d),
                       kk);
        Val<T>::unpack(*reinterpret_cast<const uint4*>(vb + slot * vsl + d),
                       vv);
      } else {
#pragma unroll
        for (int t = 0; t < VEC; ++t) kk[t] = vv[t] = 0.f;
      }
#pragma unroll
      for (int t = 0; t < VEC; ++t) {
        ks[j * hdp + d + t] = kk[t];
        vs[j * hdp + d + t] = vv[t];
      }
    }
    __syncthreads();
    // scores: one (g, slot) pair per thread; a warp shares g
    for (int p = tid; p < G * DA_TILE; p += DA_THREADS) {
      const int g = p / DA_TILE, j = p % DA_TILE, slot = t0 + j;
      float s = -INFINITY;
      if (slot < hi && slot_valid(slot, pos, window)) {
        const float* qg = qs + g * hd;
        const float* kj = ks + j * hdp;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qg[d], kj[d], dot);
        s = dot * scale;
      }
      ps[p] = s;
    }
    __syncthreads();
    // online softmax: one warp per query row, one lane per slot
    for (int g = warp; g < G; g += DA_THREADS / 32) {
      const float s = ps[g * DA_TILE + lane];
      float mb = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mb);
      const float safe_m = isfinite(m_new) ? m_new : 0.f;
      const float p = isfinite(s) ? expf(s - safe_m) : 0.f;
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      ps[g * DA_TILE + lane] = Val<T>::round(p);
      if (lane == 0) {
        const float corr = isfinite(m_old) ? expf(m_old - safe_m) : 0.f;
        c_s[g] = corr;
        l_s[g] = corr * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < DA_ACC; ++i) {
      const int e = tid + i * DA_THREADS;
      if (e < GD) {
        const int g = e >> log2hd, d = e & (hd - 1);
        const float* pg = ps + g * DA_TILE;
        float a = acc[i] * c_s[g];
        for (int j = 0; j < DA_TILE; ++j) a = fmaf(pg[j], vs[j * hdp + d], a);
        acc[i] = a;
      }
    }
  }
  __syncthreads();
  const size_t row0 = (size_t)b * H + (size_t)kvh * G;   // first head
#pragma unroll
  for (int i = 0; i < DA_ACC; ++i) {
    const int e = tid + i * DA_THREADS;
    if (e < GD) {
      const int g = e >> log2hd, d = e & (hd - 1);
      part_acc[((row0 + g) * n_split + split) * hd + d] = acc[i];
    }
  }
  for (int g = tid; g < G; g += DA_THREADS) {
    float* ml = part_ml + ((row0 + g) * n_split + split) * 2;
    ml[0] = m_s[g];
    ml[1] = l_s[g];
  }
}

// One block per (b, h): out = sum_j w_j acc_j / max(sum_j w_j l_j, 1e-30)
// with w_j = exp(m_j - max_j m_j) (0 for a range with no valid slot).
__global__ void __launch_bounds__(DA_THREADS)
combine_kernel(const float* __restrict__ part_acc,
               const float* __restrict__ part_ml, float* __restrict__ out,
               int n_split, int hd) {
  const size_t bh = blockIdx.x;
  const float* ml = part_ml + bh * n_split * 2;
  float M = -INFINITY;
  for (int j = 0; j < n_split; ++j) M = fmaxf(M, ml[2 * j]);
  const float safe = isfinite(M) ? M : 0.f;
  for (int d = threadIdx.x; d < hd; d += DA_THREADS) {
    float a = 0.f, l = 0.f;
    for (int j = 0; j < n_split; ++j) {
      const float m = ml[2 * j];
      const float w = isfinite(m) ? expf(m - safe) : 0.f;
      a = fmaf(w, part_acc[(bh * n_split + j) * hd + d], a);
      l = fmaf(w, ml[2 * j + 1], l);
    }
    out[bh * hd + d] = a / fmaxf(l, 1e-30f);
  }
}

template <typename T>
static void launch(const void* q, const void* k, const void* v,
                   const int* positions, float* part_acc, float* part_ml,
                   float* out, int B, int H, int KV, int hd, int log2hd,
                   int L, int split_len, int n_split, int window,
                   long long ksb, long long ksl, long long ksh,
                   long long vsb, long long vsl, long long vsh,
                   cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem = sizeof(float) *
      ((size_t)G * hd + 2 * DA_TILE * (hd + 1) + G * DA_TILE + 3 * G);
  const dim3 g1(n_split, KV, B);
  partial_kernel<T><<<g1, DA_THREADS, smem, stream>>>(
      reinterpret_cast<const T*>(q), reinterpret_cast<const T*>(k),
      reinterpret_cast<const T*>(v), positions, part_acc, part_ml, H, G, hd,
      log2hd, L, split_len, n_split, window, 1.0f / sqrtf((float)hd), ksb,
      ksl, ksh, vsb, vsl, vsh);
  combine_kernel<<<B * H, DA_THREADS, 0, stream>>>(part_acc, part_ml, out,
                                                   n_split, hd);
}

// q [B, H, hd] contiguous; k / v [B, L, KV, hd] with element strides
// (batch, slot, head) and innermost stride 1; positions [B] int32;
// part_acc [B, H, n_split, hd] and part_ml [B, H, n_split, 2] float32
// scratch; out [B, H, hd] float32. dtype: 0 = float32, 1 = bfloat16.
// hd must be 32, 64 or 128 (log2hd its log), G * hd <= 1024, split_len
// a multiple of 32 with n_split * split_len >= L.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const int* positions,
    float* part_acc, float* part_ml, float* out, int B, int H, int KV,
    int hd, int log2hd, int L, int split_len, int n_split, int window,
    long long ksb, long long ksl, long long ksh, long long vsb,
    long long vsl, long long vsh, int dtype, cudaStream_t stream) {
  if (B <= 0 || KV <= 0 || H % KV || L <= 0 || window < 0 ||
      hd < 32 || hd > 128 || (1 << log2hd) != hd ||
      (H / KV) * hd > DA_MAX_GD || split_len <= 0 || split_len % DA_TILE ||
      (long long)n_split * split_len < L ||
      (long long)(n_split - 1) * split_len >= L || B > 65535 || KV > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    launch<__nv_bfloat16>(q, k, v, positions, part_acc, part_ml, out, B, H,
                          KV, hd, log2hd, L, split_len, n_split, window, ksb,
                          ksl, ksh, vsb, vsl, vsh, stream);
  } else if (dtype == 0) {
    launch<float>(q, k, v, positions, part_acc, part_ml, out, B, H, KV, hd,
                  log2hd, L, split_len, n_split, window, ksb, ksl, ksh, vsb,
                  vsl, vsh, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
