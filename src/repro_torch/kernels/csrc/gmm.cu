// Grouped expert FFN (SwiGLU) for Hopper (sm_90a), plain and
// owner-indexed.
//
// Replaces the TPU kernels src/repro/kernels/gmm/kernel.py: gmm (body
// _kernel) and placement_gmm (_placement_kernel). For every slot s with
// capacity bucket x [C, d] and expert e = phys_owner ? phys_owner[s] : s:
//     out[s] = (silu(x . Wg[e]) * (x . Wu[e])).astype(payload) . Wd[e]
// with SiLU as g * sigmoid(g), products accumulated in float32, and the
// hidden cast to the payload type before the down-projection (as the
// TPU kernel does at kernel.py:45). Output is float32 [S, C, d].
//
// What bounds it on the H100.
//  * At decode, bytes: C is 4, so each 2-byte weight element is used for
//    2C = 8 operations against the card's ~295 bf16 operations per
//    byte. Only the experts whose bucket holds a row matter: at most 32
//    of 256 on DeepSeek-V3 (T 4, top-8) and 4 of 128 on Llama-4 (top-1),
//    so the bound is live experts x 3 d f x 2 B at 3.35 TB/s.
//  * At a C = 8 prefill, still bytes, but 2C = 16 operations per weight
//    element at full bandwidth is ~54 TFLOP/s of mma work: close to what
//    the CUDA cores give (67 TFLOP/s f32), far below the tensor cores.
//
// Design.
//  * Skip on the device, no host sync. A prologue (rows_kernel) reads the
//    buckets once and writes rows[s] = 1 + the index of the last row
//    with a non-zero element (0 for an empty slot; -0.0 counts as zero,
//    NaN and inf as non-zero), and writes +0 to out[s, rows[s]:, :]. A
//    one-block plan_kernel turns rows into a compact list of live
//    (slot, row-tile) pairs in slot order. The two passes walk that
//    list with persistent blocks (the occupancy limit per SM, times the
//    SM count), item i = (pair, column tile), i = blockIdx.x + q *
//    gridDim.x. An all-zero row gives +0 in the plain version, so
//    computing only rows [0, rows[s]) and zeroing the rest is the same
//    function.
//  * One weight read per live expert. A row tile is 8 rows (C <= 8) or
//    16 (C > 8), so the paths' capacities (4, 5, 8) take one tile and
//    read each live expert's weights once; a larger C takes
//    ceil(C / 16) tiles and reads them once per live tile.
//  * bf16 on the tensor cores: mma.sync.m16n8k16 with f32 accumulation in
//    a swap-AB layout. The 16-row operand is a 16-column slice of the
//    weight, W^T, loaded with ldmatrix.trans from the [K, N] tile (N
//    contiguous, as the reference keeps it); the 8-column operand is 8
//    bucket (or hidden) rows, already K-contiguous. A block of 8 warps
//    owns 128 output columns (256 contiguous bytes of each weight row),
//    16 per warp.
//  * Bytes in flight: 16-byte cp.async.cg into a 4-stage shared-memory
//    ring 64 rows deep. Pass 1 stages 32 KB of gate and up weights per
//    stage (136 KB of shared memory, one block per SM, ~96 KB in
//    flight); pass 2 16 KB of down weights (three blocks per SM). The
//    (item, k-step) sequence of a block is one flat stream, so the next
//    item's first tiles load during the current item's last. Weight rows
//    are XOR-swizzled in 16-byte chunks (ldmatrix without bank
//    conflicts); staged bucket rows are padded by 16 bytes.
//  * What is left at decode: few live slots give few items (29 live
//    slots x 16 column tiles is 3.5 rounds of 132 SMs on DeepSeek-V3; one
//    live slot uses 16 SMs), and a block streams far below an SM's share
//    of the bandwidth. A K split fixed by the shapes would fill the card.
//  * float32 stays on CUDA-core FMAs in full f32 (no TF32): 256 threads
//    own 128 columns, the reduction split over 4 thread groups combined
//    in a fixed order; 8-row tiles; the same skip and item walk.
//  * Deterministic: every output element is reduced by one block in an
//    order fixed by (C, d, f, dtype) alone, never by S, the live count or
//    the owner table, with no split-K and no float atomics. So repeated
//    calls are bit-identical, and the owner-indexed call is bit-identical
//    to the plain call on owner-gathered weights (only the weight base
//    pointer differs).
//  * Two passes: pass 1 writes the hidden h = silu(g) * u, cast to the
//    payload type, to a [S, C, f] scratch (only live rows); pass 2 reads
//    it (rows past rows[s] are zero-filled when staged) and writes the
//    float32 output rows [0, rows[s]).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ int owner_of(const int* owner, int s, int E) {
  const int e = owner ? owner[s] : s;
  if (e < 0 || e >= E) __trap();
  return e;
}

// ---------------------------------------------------------------------------
// prologue: live rows per slot, dead rows of out zeroed
// ---------------------------------------------------------------------------
#define ROWS_THREADS 256

// x: the buckets as 32-bit words, W words per row (d / 2 for bf16, d for
// float32); mask drops the sign bit of each value (so -0.0 is zero).
// VEC: 4 words per load (rows a multiple of 16 bytes, base aligned) or 1.
template <int VEC>
__global__ void __launch_bounds__(ROWS_THREADS)
rows_kernel(const uint32_t* __restrict__ x, uint32_t mask,
            float* __restrict__ out, int* __restrict__ rows, int C, int W,
            int d) {
  __shared__ int red[ROWS_THREADS / 32];
  const int s = blockIdx.x;
  const uint32_t* xs = x + (size_t)s * C * W;
  int last = -1;
  const int n = C * W / VEC;
  for (int i = threadIdx.x; i < n; i += ROWS_THREADS) {
    uint32_t v;
    if (VEC == 4) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(xs) + i);
      v = q.x | q.y | q.z | q.w;
    } else {
      v = __ldg(xs + i);
    }
    if (v & mask) last = max(last, i * VEC / W);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = last;
  __syncthreads();
  if (threadIdx.x < 32) {
    last = threadIdx.x < ROWS_THREADS / 32 ? red[threadIdx.x] : -1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
    if (threadIdx.x == 0) red[0] = last;
  }
  __syncthreads();
  const int R = red[0] + 1;
  if (threadIdx.x == 0) rows[s] = R;
  float* o = out + ((size_t)s * C + R) * d;
  const size_t nz = (size_t)(C - R) * d;
  if ((d & 3) == 0) {
    for (size_t i = threadIdx.x; i < nz / 4; i += ROWS_THREADS)
      reinterpret_cast<float4*>(o)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (size_t i = threadIdx.x; i < nz; i += ROWS_THREADS) o[i] = 0.f;
  }
}

// work = rows [S] | pair count [1] | pairs [S * rt]. One block lists the
// live (slot, row tile) pairs, slot-major, as s * rt + j.
#define PLAN_THREADS 1024
__global__ void __launch_bounds__(PLAN_THREADS)
plan_kernel(int* __restrict__ work, int S, int rt, int RT) {
  __shared__ int warp_sum[PLAN_THREADS / 32];
  __shared__ int carry;
  const int* rows = work;
  int* pairs = work + S + 1;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < S; base += PLAN_THREADS) {
    const int s = base + threadIdx.x;
    const int n = s < S ? (rows[s] + RT - 1) / RT : 0;
    int incl = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) warp_sum[wid] = incl;
    __syncthreads();
    if (wid == 0) {
      int w = warp_sum[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += v;
      }
      warp_sum[lane] = w;          // inclusive over warps
    }
    __syncthreads();
    incl += (wid ? warp_sum[wid - 1] : 0);
    const int start = carry + incl - n;
    for (int j = 0; j < n; ++j) pairs[start + j] = s * rt + j;
    __syncthreads();
    if (threadIdx.x == PLAN_THREADS - 1) carry += incl;
    __syncthreads();
  }
  if (threadIdx.x == 0) work[S] = carry;
}

// One unit of work: a row tile of a live slot and a column tile.
struct Item {
  int s, r0, nr, e, n0;
};

__device__ __forceinline__ Item item_of(int i, const int* __restrict__ work,
                                        const int* __restrict__ owner, int S,
                                        int E, int rt, int RT, int nct,
                                        int BN) {
  const int p = work[S + 1 + i / nct];
  Item it;
  it.s = p / rt;
  it.r0 = (p % rt) * RT;
  it.nr = min(RT, work[it.s] - it.r0);
  it.e = owner_of(owner, it.s, E);
  it.n0 = (i % nct) * BN;
  return it;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, cp.async ring, persistent blocks
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
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
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Both passes: TC_BN output columns (8 warps, 16 columns each), TC_BK
// deep, a ring of TC_ST stages. Pass 1 stages 32 KB of gate and up
// weights (one block per SM), pass 2 16 KB of down weights (three blocks
// per SM).
#define TC_BK 64
#define TC_BN 128
#define TC_ST 4
#define TC_THREADS (2 * TC_BN)

// The tile of a pass: NW weight matrices, NT 8-row n-tiles. Shared-memory
// layout of one stage: NW weight tiles [TC_BK][TC_BN] (16-byte chunk c of
// row k at chunk c ^ (k & 7)), then 8 NT staged rows [TC_BK] of the
// bucket (pass 1) or the hidden (pass 2), each padded by 16 bytes.
template <int NW, int NT>
struct TcTile {
  static constexpr int ROW = TC_BN * 2;          // bytes of a weight row
  static constexpr int CH = TC_BN / 8;           // its 16-byte chunks
  static constexpr int W_BYTES = TC_BK * ROW;
  static constexpr int A_STRIDE = TC_BK * 2 + 16;
  static constexpr int RT = 8 * NT;
  static constexpr int STAGE = NW * W_BYTES + RT * A_STRIDE;
  static constexpr int SMEM = TC_ST * STAGE;
};

// NW = 2: pass 1 (src = buckets [S, C, K = d], w0/w1 = gate/up [E, d, f],
// dst = hidden bf16 [S, C, N = f]); NW = 1: pass 2 (src = hidden, w0 =
// down [E, f, d], dst = out f32 [S, C, N = d]).
template <int NW, int NT>
__global__ void __launch_bounds__(TC_THREADS)
tc_pass(const __nv_bfloat16* __restrict__ src,
        const __nv_bfloat16* __restrict__ w0,
        const __nv_bfloat16* __restrict__ w1, const int* __restrict__ owner,
        const int* __restrict__ work, void* __restrict__ dst, int S, int C,
        int K, int N, int E, int rt) {
  using L = TcTile<NW, NT>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nct = (N + TC_BN - 1) / TC_BN;
  const int n_items = work[S] * nct;
  const int nk = (K + TC_BK - 1) / TC_BK;
  const int nq = n_items > (int)blockIdx.x
                     ? (n_items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                     : 0;
  const int total = nq * nk;

  int ld_q = -1;
  Item ld;
  auto load_step = [&](int step) {
    const int q = step / nk, kt = step % nk;
    if (q != ld_q) {
      ld_q = q;
      ld = item_of(blockIdx.x + q * gridDim.x, work, owner, S, E, rt, L::RT,
                   nct, TC_BN);
    }
    unsigned char* st = smem + (step % TC_ST) * L::STAGE;
    const int k0 = kt * TC_BK;
#pragma unroll
    for (int c = tid; c < NW * TC_BK * L::CH; c += TC_THREADS) {
      const int m = c / (TC_BK * L::CH), k = (c / L::CH) % TC_BK;
      const int ch = c % L::CH;
      const int gk = k0 + k, gn = ld.n0 + ch * 8;
      const __nv_bfloat16* w = m ? w1 : w0;
      const bool ok = gk < K && gn < N;
      const __nv_bfloat16* p =
          ok ? w + ((size_t)ld.e * K + gk) * N + gn : w;
      cp_async16(st + m * L::W_BYTES + k * L::ROW + ((ch ^ (k & 7)) << 4),
                 p, ok ? 16 : 0);
    }
    constexpr int ACH = TC_BK / 8;                 // 16-byte chunks per row
#pragma unroll
    for (int c = tid; c < L::RT * ACH; c += TC_THREADS) {
      const int r = c / ACH, ch = c % ACH;
      const int gk = k0 + ch * 8;
      const bool ok = r < ld.nr && gk < K;
      const __nv_bfloat16* p =
          ok ? src + ((size_t)ld.s * C + ld.r0 + r) * K + gk : src;
      cp_async16(st + NW * L::W_BYTES + r * L::A_STRIDE + ch * 16, p,
                 ok ? 16 : 0);
    }
  };

  float acc[NW][NT][4];
#pragma unroll
  for (int m = 0; m < NW; ++m)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][t][j] = 0.f;

  // ldmatrix.trans: lane l addresses row (l & 7) of 8x8 matrix l >> 3;
  // matrices 0..3 = (k 0-7, cols 0-7), (k 0-7, cols 8-15), (k 8-15, cols
  // 0-7), (k 8-15, cols 8-15) of the warp's 16 columns: the A fragment of
  // W^T.
  const int lm = lane >> 3;
  const int ld_k = (lane & 7) + ((lm >> 1) << 3);
  const int ld_chunk = (warp * 16 + ((lm & 1) << 3)) >> 3;
  const int g = lane >> 2, t4 = lane & 3;

#pragma unroll 1
  for (int p = 0; p < TC_ST - 1; ++p) {
    if (p < total) load_step(p);
    cp_async_commit();
  }
#pragma unroll 1
  for (int step = 0; step < total; ++step) {
    cp_async_wait<TC_ST - 2>();
    __syncthreads();
    if (step + TC_ST - 1 < total) load_step(step + TC_ST - 1);
    cp_async_commit();

    const unsigned char* st = smem + (step % TC_ST) * L::STAGE;
    const unsigned char* as = st + NW * L::W_BYTES;
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      const int k = kk * 16 + ld_k;
      uint32_t a[NW][4];
#pragma unroll
      for (int m = 0; m < NW; ++m)
        ldmatrix_x4_trans(a[m], st + m * L::W_BYTES + k * L::ROW +
                                    ((ld_chunk ^ (k & 7)) << 4));
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const unsigned char* row =
            as + (t * 8 + g) * L::A_STRIDE + (kk * 16 + 2 * t4) * 2;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(row);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(row + 16);
#pragma unroll
        for (int m = 0; m < NW; ++m) mma_bf16(acc[m][t], a[m], b0, b1);
      }
    }

    if (step % nk == nk - 1) {        // the item's last k-step: epilogue
      const Item it = item_of(blockIdx.x + (step / nk) * gridDim.x, work,
                              owner, S, E, rt, L::RT, nct, TC_BN);
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = t * 8 + 2 * t4 + (j & 1);
          const int col = it.n0 + warp * 16 + g + ((j >> 1) << 3);
          if (r < it.nr && col < N) {
            const size_t o = ((size_t)it.s * C + it.r0 + r) * N + col;
            if (NW == 2) {
              const float gs = acc[0][t][j], us = acc[NW - 1][t][j];
              const float sig = 1.f / (1.f + expf(-gs));
              reinterpret_cast<__nv_bfloat16*>(dst)[o] =
                  __float2bfloat16(gs * sig * us);
            } else {
              reinterpret_cast<float*>(dst)[o] = acc[0][t][j];
            }
          }
#pragma unroll
          for (int m = 0; m < NW; ++m) acc[m][t][j] = 0.f;
        }
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// float32: CUDA-core FMAs, persistent blocks
// ---------------------------------------------------------------------------
#define F32_THREADS 256
#define F32_COLS 64           // thread columns per block (x2 values each)
#define F32_SPLIT 4           // reduction split across thread groups
#define F32_KCHUNK 256        // reduction elements staged per chunk
#define F32_ROWS 8            // bucket rows per tile

// Stage rows [r0, r0 + nr) x reduction range [k0, k0 + kn) of a [C, K]
// matrix (slot-major base pointer) into shared memory; rows past nr are
// zero.
__device__ __forceinline__ void stage_rows(float (*xs)[F32_KCHUNK],
                                           const float* base, int K, int r0,
                                           int nr, int k0, int kn) {
  for (int i = threadIdx.x; i < F32_ROWS * F32_KCHUNK; i += F32_THREADS) {
    const int r = i / F32_KCHUNK, kk = i % F32_KCHUNK;
    xs[r][kk] = (r < nr && kk < kn) ? base[(size_t)(r0 + r) * K + k0 + kk]
                                    : 0.f;
  }
}

// Pass 1: hidden[s, r, f] = silu(x . Wg) * (x . Wu).
__global__ void __launch_bounds__(F32_THREADS)
f32_gate_up(const float* __restrict__ x, const float* __restrict__ wg,
            const float* __restrict__ wu, const int* __restrict__ owner,
            const int* __restrict__ work, float* __restrict__ hidden, int S,
            int C, int d, int f, int E, int rt) {
  __shared__ float xs[F32_ROWS][F32_KCHUNK];
  __shared__ float red[2][F32_SPLIT][F32_ROWS][2 * F32_COLS];
  const int nct = (f + 2 * F32_COLS - 1) / (2 * F32_COLS);
  const int n_items = work[S] * nct;
  const int tc = threadIdx.x % F32_COLS, q = threadIdx.x / F32_COLS;
  for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
    const Item it = item_of(i, work, owner, S, E, rt, F32_ROWS, nct,
                            2 * F32_COLS);
    const int col = it.n0 + 2 * tc;
    const bool live = col < f;
    const float* xb = x + (size_t)it.s * C * d;
    const float* gb = wg + (size_t)it.e * d * f + col;
    const float* ub = wu + (size_t)it.e * d * f + col;
    float g[F32_ROWS][2], u[F32_ROWS][2];
#pragma unroll
    for (int r = 0; r < F32_ROWS; ++r)
      g[r][0] = g[r][1] = u[r][0] = u[r][1] = 0.f;
    for (int k0 = 0; k0 < d; k0 += F32_KCHUNK) {
      const int kn = min(F32_KCHUNK, d - k0);
      __syncthreads();
      stage_rows(xs, xb, d, it.r0, it.nr, k0, kn);
      __syncthreads();
      if (live) {
        for (int kk = q; kk < kn; kk += F32_SPLIT) {
          const float2 wgv =
              *reinterpret_cast<const float2*>(gb + (size_t)(k0 + kk) * f);
          const float2 wuv =
              *reinterpret_cast<const float2*>(ub + (size_t)(k0 + kk) * f);
#pragma unroll
          for (int r = 0; r < F32_ROWS; ++r) {
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
    for (int r = 0; r < F32_ROWS; ++r) {
      red[0][q][r][2 * tc] = g[r][0];
      red[0][q][r][2 * tc + 1] = g[r][1];
      red[1][q][r][2 * tc] = u[r][0];
      red[1][q][r][2 * tc + 1] = u[r][1];
    }
    __syncthreads();
    if (q == 0 && live) {
      for (int r = 0; r < it.nr; ++r) {
        float h[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float gs = 0.f, us = 0.f;
#pragma unroll
          for (int p = 0; p < F32_SPLIT; ++p) {
            gs += red[0][p][r][2 * tc + j];
            us += red[1][p][r][2 * tc + j];
          }
          const float sig = 1.f / (1.f + expf(-gs));
          h[j] = gs * sig * us;
        }
        *reinterpret_cast<float2*>(
            hidden + ((size_t)it.s * C + it.r0 + r) * f + col) =
            make_float2(h[0], h[1]);
      }
    }
  }
}

// Pass 2: out[s, r, :] = hidden[s, r, :] . Wd[e].
__global__ void __launch_bounds__(F32_THREADS)
f32_down(const float* __restrict__ hidden, const float* __restrict__ wd,
         const int* __restrict__ owner, const int* __restrict__ work,
         float* __restrict__ out, int S, int C, int d, int f, int E, int rt) {
  __shared__ float hs[F32_ROWS][F32_KCHUNK];
  __shared__ float red[F32_SPLIT][F32_ROWS][2 * F32_COLS];
  const int nct = (d + 2 * F32_COLS - 1) / (2 * F32_COLS);
  const int n_items = work[S] * nct;
  const int tc = threadIdx.x % F32_COLS, q = threadIdx.x / F32_COLS;
  for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
    const Item it = item_of(i, work, owner, S, E, rt, F32_ROWS, nct,
                            2 * F32_COLS);
    const int col = it.n0 + 2 * tc;
    const bool live = col < d;
    const float* hb = hidden + (size_t)it.s * C * f;
    const float* db = wd + (size_t)it.e * f * d + col;
    float acc[F32_ROWS][2];
#pragma unroll
    for (int r = 0; r < F32_ROWS; ++r) acc[r][0] = acc[r][1] = 0.f;
    for (int k0 = 0; k0 < f; k0 += F32_KCHUNK) {
      const int kn = min(F32_KCHUNK, f - k0);
      __syncthreads();
      stage_rows(hs, hb, f, it.r0, it.nr, k0, kn);
      __syncthreads();
      if (live) {
        for (int kk = q; kk < kn; kk += F32_SPLIT) {
          const float2 w =
              *reinterpret_cast<const float2*>(db + (size_t)(k0 + kk) * d);
#pragma unroll
          for (int r = 0; r < F32_ROWS; ++r) {
            const float hv = hs[r][kk];
            acc[r][0] = fmaf(hv, w.x, acc[r][0]);
            acc[r][1] = fmaf(hv, w.y, acc[r][1]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < F32_ROWS; ++r) {
      red[q][r][2 * tc] = acc[r][0];
      red[q][r][2 * tc + 1] = acc[r][1];
    }
    __syncthreads();
    if (q == 0 && live) {
      for (int r = 0; r < it.nr; ++r) {
        float o[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float v = 0.f;
#pragma unroll
          for (int p = 0; p < F32_SPLIT; ++p) v += red[p][r][2 * tc + j];
          o[j] = v;
        }
        *reinterpret_cast<float2*>(
            out + ((size_t)it.s * C + it.r0 + r) * d + col) =
            make_float2(o[0], o[1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
// Persistent grid: as many blocks of Kern as fit on every SM at once,
// worked out once per device (the occupancy query costs host time).
#define GMM_MAX_DEVICES 64
template <auto Kern>
static int persistent_grid(int threads, int smem, int* blocks) {
  static int cached[GMM_MAX_DEVICES];
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < GMM_MAX_DEVICES && cached[dev] > 0) {
    *blocks = cached[dev];
    return 0;
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(Kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kern,
                                                        threads, smem);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
  if (err != cudaSuccess) return (int)err;
  *blocks = sms * per_sm;
  if (dev < GMM_MAX_DEVICES) cached[dev] = *blocks;
  return 0;
}

template <int NW, int NT>
static int launch_tc(const void* src, const void* w0, const void* w1,
                     const int* owner, const int* work, void* dst, int S,
                     int C, int K, int N, int E, int rt,
                     cudaStream_t stream) {
  const int smem = TcTile<NW, NT>::SMEM;
  int blocks = 0;
  int err = persistent_grid<tc_pass<NW, NT>>(TC_THREADS, smem, &blocks);
  if (err) return err;
  tc_pass<NW, NT><<<blocks, TC_THREADS, smem, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(src),
      reinterpret_cast<const __nv_bfloat16*>(w0),
      reinterpret_cast<const __nv_bfloat16*>(w1), owner, work, dst, S, C, K,
      N, E, rt);
  return (int)cudaGetLastError();
}

template <int NT>
static int launch_bf16(const void* x, const void* wg, const void* wu,
                       const void* wd, const int* owner, void* hidden,
                       float* out, const int* work, int S, int C, int d,
                       int f, int E, int rt, cudaStream_t stream) {
  int err = launch_tc<2, NT>(x, wg, wu, owner, work, hidden, S, C, d, f, E,
                             rt, stream);
  if (err) return err;
  return launch_tc<1, NT>(hidden, wd, wd, owner, work, out, S, C, f, d, E, rt,
                          stream);
}

static int launch_f32(const void* x, const void* wg, const void* wu,
                      const void* wd, const int* owner, void* hidden,
                      float* out, const int* work, int S, int C, int d, int f,
                      int E, int rt, cudaStream_t stream) {
  int blocks = 0;
  int err = persistent_grid<f32_gate_up>(F32_THREADS, 0, &blocks);
  if (err) return err;
  f32_gate_up<<<blocks, F32_THREADS, 0, stream>>>(
      reinterpret_cast<const float*>(x), reinterpret_cast<const float*>(wg),
      reinterpret_cast<const float*>(wu), owner, work,
      reinterpret_cast<float*>(hidden), S, C, d, f, E, rt);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = persistent_grid<f32_down>(F32_THREADS, 0, &blocks))) return err;
  f32_down<<<blocks, F32_THREADS, 0, stream>>>(
      reinterpret_cast<const float*>(hidden),
      reinterpret_cast<const float*>(wd), owner, work, out, S, C, d, f, E,
      rt);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16 (buckets, weights and hidden share it).
// owner: null for the plain grouped FFN (slot s uses expert s).
// work: int32 scratch of S + 1 + S * C entries; on return work[0:S] holds
// rows[s], the live rows of each slot.
// bf16 needs d and f multiples of 8 and 16-byte aligned pointers; float32
// needs d and f even.
extern "C" int gmm_launch(const void* x, const void* wg, const void* wu,
                          const void* wd, const int* owner, void* hidden,
                          float* out, int* work, int S, int C, int d, int f,
                          int E, int dtype, cudaStream_t stream) {
  if (S <= 0 || C <= 0 || d <= 0 || f <= 0 || E <= 0 || (d & 1) || (f & 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && ((d & 7) || (f & 7))) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int RT = dtype == 1 ? (C <= 8 ? 8 : 16) : F32_ROWS;
  const int rt = (C + RT - 1) / RT;

  // prologue: rows per slot, dead rows of out zeroed, the live-pair list
  const int W = dtype == 1 ? d / 2 : d;
  const uint32_t mask = dtype == 1 ? 0x7fff7fffu : 0x7fffffffu;
  if ((W & 3) == 0 && ((uintptr_t)x & 15) == 0)
    rows_kernel<4><<<S, ROWS_THREADS, 0, stream>>>(
        reinterpret_cast<const uint32_t*>(x), mask, out, work, C, W, d);
  else
    rows_kernel<1><<<S, ROWS_THREADS, 0, stream>>>(
        reinterpret_cast<const uint32_t*>(x), mask, out, work, C, W, d);
  int err = (int)cudaGetLastError();
  if (err) return err;
  plan_kernel<<<1, PLAN_THREADS, 0, stream>>>(work, S, rt, RT);
  if ((err = (int)cudaGetLastError())) return err;

  if (dtype == 0)
    return launch_f32(x, wg, wu, wd, owner, hidden, out, work, S, C, d, f, E,
                      rt, stream);
  if (C <= 8)
    return launch_bf16<1>(x, wg, wu, wd, owner, hidden, out, work, S, C, d,
                          f, E, rt, stream);
  return launch_bf16<2>(x, wg, wu, wd, owner, hidden, out, work, S, C, d, f,
                        E, rt, stream);
}
