// W8A8 INT8 matrix product for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/int8_matmul/kernel.py
// (int8_matmul, body _kernel): out[m, n] = ((float)acc[m, n] * xs[m]) * ws[n]
// with acc = sum_k x_q[m, k] * w_q[k, n] in int32; x_q int8 [M, K]
// (token-wise scales xs [M]), w_q int8 [K, N] (channel-wise scales ws [N]),
// out f32 [M, N].
//
// What bounds it on the H100: at decode (M 4) bytes — the weight is read
// once (K 7168, N 18432: 132 MB, 39 us at 3.35 TB/s); at M 512 the int8
// operations (135 GOP, 68 us at 1979 TOP/s dense).
//
// Design.
//  * Tensor cores through mma.sync.m16n8k32.row.col.s32.s8.s8.s32 (wgmma
//    and TMA are for a later version). A block of 8 warps computes a
//    64 x 128 tile of out; each warp 32 x 32 (2 x 4 mma tiles).
//  * The weight keeps the reference's [K, N] layout (N contiguous), but the
//    int8 mma takes B only K-contiguous, and ldmatrix .trans does not work
//    on 8-bit values. Tiles are staged verbatim with cp.async (no copy of
//    the weight is kept anywhere), and the transpose happens in registers:
//    the warp's 32 columns are permuted so that mma column g of n-tile j is
//    column 4g + j. A lane then needs, for k = 4t..4t+3, the 4 consecutive
//    columns 4g..4g+3 — four 32-bit shared-memory words, which four byte
//    permutes (a 4 x 4 byte transpose) turn into its B fragments of all
//    four n-tiles at once. The epilogue undoes the permutation.
//  * Shared memory is XOR-swizzled in 16-byte chunks so that both the
//    cp.async stores and the fragment loads are free of bank conflicts.
//    A 4-stage cp.async ring (48 KB) keeps three k-tiles in flight.
//  * Exact: the int32 sums are exact in any order while 127^2 K < 2^31
//    (the wrapper refuses larger K); the epilogue multiplies left to right
//    with round-to-nearest (__fmul_rn), as the reference does, so the
//    result is bit-identical to the plain version.
//  * Ragged shapes: rows past M, columns past N and depth past K are
//    zero-filled in shared memory (cp.async's source size, or masked byte
//    copies when K or N is not a multiple of 16 or a base is unaligned) and
//    masked on the store, so no padding is made by the wrapper.
#include <cuda_runtime.h>
#include <stdint.h>

#define IM_BM 64
#define IM_BN 128
#define IM_BK 64
#define IM_STAGES 4
#define IM_THREADS 256
#define IM_A_BYTES (IM_BM * IM_BK)
#define IM_B_BYTES (IM_BK * IM_BN)
#define IM_STAGE_BYTES (IM_A_BYTES + IM_B_BYTES)
#define IM_SMEM (IM_STAGES * IM_STAGE_BYTES)

// A tile: [BM rows][BK bytes] = 4 chunks of 16 B per row, chunk c of row r
// stored at chunk c ^ ((r >> 1) & 3).
__device__ __forceinline__ int a_off(int row, int kbyte) {
  return row * IM_BK + ((((kbyte >> 4) ^ (row >> 1)) & 3) << 4) + (kbyte & 15);
}
// B tile: [BK rows (k)][BN bytes (n)] = 8 chunks per row, chunk c of row k
// stored at chunk c ^ (((k >> 2) & 3) << 1).
__device__ __forceinline__ int b_off(int k, int nbyte) {
  return k * IM_BN + ((((nbyte >> 4) ^ (((k >> 2) & 3) << 1)) & 7) << 4) +
         (nbyte & 15);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 16 bytes of row `src` starting at `col`, `limit` bytes valid, zero-filled
// past it, into the 16-byte slot `dst`: the path for unaligned shapes.
__device__ __forceinline__ void copy16_masked(unsigned char* dst,
                                              const int8_t* src, int limit) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t v = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = 4 * i + j;
      const uint32_t byte = b < limit ? (uint32_t)(uint8_t)src[b] : 0u;
      v |= byte << (8 * j);
    }
    w[i] = v;
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

template <bool VEC>
__device__ __forceinline__ void load_tile(unsigned char* stage,
                                          const int8_t* __restrict__ xq,
                                          const int8_t* __restrict__ wq,
                                          int M, int N, int K, int m0, int n0,
                                          int k0) {
  const int tid = threadIdx.x;
  unsigned char* As = stage;
  unsigned char* Bs = stage + IM_A_BYTES;
  {  // A: 64 rows x 4 chunks, one chunk per thread
    const int row = tid >> 2, kb = (tid & 3) << 4;
    const int gm = m0 + row, gk = k0 + kb;
    int valid = (gm < M) ? K - gk : 0;
    valid = valid < 0 ? 0 : (valid > 16 ? 16 : valid);
    const int8_t* src = valid ? xq + (size_t)gm * K + gk : xq;
    if (VEC)
      cp_async16(As + a_off(row, kb), src, valid);
    else
      copy16_masked(As + a_off(row, kb), src, valid);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // B: 64 k-rows x 8 chunks, two per thread
    const int c = tid + i * IM_THREADS;
    const int k = c >> 3, nb = (c & 7) << 4;
    const int gk = k0 + k, gn = n0 + nb;
    int valid = (gk < K) ? N - gn : 0;
    valid = valid < 0 ? 0 : (valid > 16 ? 16 : valid);
    const int8_t* src = valid ? wq + (size_t)gk * N + gn : wq;
    if (VEC)
      cp_async16(Bs + b_off(k, nb), src, valid);
    else
      copy16_masked(Bs + b_off(k, nb), src, valid);
  }
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows r0..r3 hold 4 bytes (4 columns) each; returns in c[j] the 4 bytes
// of column j, row 0 in the low byte.
__device__ __forceinline__ void transpose4x4(const uint32_t* r, uint32_t* c) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

template <bool VEC>
__global__ void __launch_bounds__(IM_THREADS, 2)
int8_matmul_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                   const int8_t* __restrict__ wq, const float* __restrict__ ws,
                   float* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.y * IM_BM, n0 = blockIdx.x * IM_BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps
  const int g = lane >> 2, t = lane & 3;
  const int nk = (K + IM_BK - 1) / IM_BK;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
  for (int s = 0; s < IM_STAGES - 1; ++s) {
    if (s < nk)
      load_tile<VEC>(smem + s * IM_STAGE_BYTES, xq, wq, M, N, K, m0, n0,
                     s * IM_BK);
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<IM_STAGES - 2>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt-1
    const int nt = kt + IM_STAGES - 1;
    if (nt < nk)
      load_tile<VEC>(smem + (nt % IM_STAGES) * IM_STAGE_BYTES, xq, wq, M, N,
                     K, m0, n0, nt * IM_BK);
    cp_async_commit();

    const unsigned char* As = smem + (kt % IM_STAGES) * IM_STAGE_BYTES;
    const unsigned char* Bs = As + IM_A_BYTES;
#pragma unroll
    for (int ks = 0; ks < IM_BK / 32; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r0 = wm * 32 + mt * 16 + g;
        const int kb = ks * 32 + t * 4;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(As + a_off(r0, kb));
        a[mt][1] = *reinterpret_cast<const uint32_t*>(As + a_off(r0 + 8, kb));
        a[mt][2] = *reinterpret_cast<const uint32_t*>(As + a_off(r0, kb + 16));
        a[mt][3] =
            *reinterpret_cast<const uint32_t*>(As + a_off(r0 + 8, kb + 16));
      }
      uint32_t b[2][4];  // [k half][n-tile j]
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t rows[4];
        const int kbase = ks * 32 + h * 16 + t * 4;
        const int nb = wn * 32 + 4 * g;
#pragma unroll
        for (int r = 0; r < 4; ++r)
          rows[r] = *reinterpret_cast<const uint32_t*>(Bs + b_off(kbase + r, nb));
        transpose4x4(rows, b[h]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[mt][j], a[mt], b[0][j], b[1][j]);
    }
  }

  // Epilogue: mma column c of n-tile j is column wn*32 + 4c + j, so the
  // four n-tiles of one accumulator slot are four consecutive columns.
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int m = m0 + wm * 32 + mt * 16 + g + rr * 8;
      if (m >= M) continue;
      const float xsm = xs[m];
      float* orow = out + (size_t)m * N;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int n = n0 + wn * 32 + 4 * (2 * t + i);
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int nj = n + j < N ? n + j : N - 1;
          v[j] = __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][j][rr * 2 + i]),
                                     xsm),
                           ws[nj]);
        }
        if (VEC && n + 3 < N) {
          *reinterpret_cast<float4*>(orow + n) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (n + j < N) orow[n + j] = v[j];
        }
      }
    }
}

// vec: 1 when K and N are multiples of 16 and x_q, w_q and out are
// 16-byte aligned (cp.async and float4 stores), else 0. Returns a
// cudaError_t.
extern "C" int int8_matmul_launch(const int8_t* xq, const float* xs,
                                  const int8_t* wq, const float* ws,
                                  float* out, int M, int N, int K, int vec,
                                  cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + IM_BN - 1) / IM_BN, (M + IM_BM - 1) / IM_BM);
  if (vec)
    int8_matmul_kernel<true><<<grid, IM_THREADS, IM_SMEM, stream>>>(
        xq, xs, wq, ws, out, M, N, K);
  else
    int8_matmul_kernel<false><<<grid, IM_THREADS, IM_SMEM, stream>>>(
        xq, xs, wq, ws, out, M, N, K);
  return (int)cudaGetLastError();
}
