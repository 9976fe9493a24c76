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
// What bounds it on the H100: bytes, at every capacity the paths pack.
// Only the experts whose bucket holds a row matter, so the bound is live
// experts x 3 d f x 2 B at 3.35 TB/s. Each 2-byte weight element is used
// for 2 rows operations, against the card's ~295 bf16 operations per
// byte: rows 4 at decode (at most 32 of 256 experts live on DeepSeek-V3,
// T 4, top-8; 4 of 128 on Llama-4, top-1), 8 in the smoke's short
// prefill chunks, and under 128 in a 512-token chunk (DeepSeek-MoE-16B
// C 72, every expert live: 1.1 GB of weights, 0.35 ms).
//
// Design.
//  * Skip on the device, no host sync. A prologue (rows_kernel) reads the
//    buckets once and writes rows[s] = 1 + the index of the last row
//    with a non-zero element (0 for an empty slot; -0.0 counts as zero,
//    NaN and inf as non-zero), and writes +0 to out[s, rows[s]:, :]. A
//    one-block plan_kernel turns rows into a compact list of live
//    (slot, row-tile) pairs in slot order. The two passes walk that
//    list with persistent blocks (the occupancy limit per SM, times the
//    SM count). An all-zero row gives +0 in the plain version, so
//    computing only rows [0, rows[s]) and zeroing the rest is the same
//    function.
//  * bf16: one variant, wgmma on TMA-staged tiles (wg_pass), swap-AB: the
//    weight stripe is wgmma's M (64 output columns per consumer
//    warpgroup), read MN-major from the [K, N] tile as stored (no copy or
//    relayout); the bucket (or hidden) rows are its N, K-major as stored,
//    staged NB = 8, 16, 32, 64 or 128 rows at a time (C rounded up to a
//    compiled width). One producer warp issues TMA loads (128-byte
//    swizzle) of 64 K-rows of each weight and of the rows into a ring of
//    up to 200 KB (mbarriers); the consumers keep one stage's products in
//    flight while the next is issued. The weights' tensor map is 3-D,
//    [E, K, N], so depth past K reads zero and the owner moves only its
//    third coordinate; a row box past a slot's live rows reads the next
//    slot's rows (or zeros past the last), whose output columns are never
//    stored.
//  * C > 8 (prefill chunks): 128-row tiles, so that C <= 128 takes one
//    tile per live slot (C 144 two): every row tile stages its expert's
//    whole stripe, so small tiles would read each expert once per tile.
//    An item is (pair, 128 output columns): the block's two consumer
//    warpgroups take 64 each and share one producer warp, one ring and
//    the staged rows; each item carries the whole K reduction.
//  * C <= 8 (every decode step, short prefill chunks): one 8-row tile per
//    live slot (NB 8: a 1024-byte swizzle atom of rows, wgmma m64n8k16),
//    the same 128-column units (pair, column tile), and the K reduction
//    cut into ns fixed ranges (wg_split: a function of (N, K, NW), at
//    least WG_FILL = 132 (unit, range) pieces at one live slot, ranges of
//    two 64-deep steps or more). The walk fills the card at any live
//    count: whole units go round robin (unit b + q G to block b, as the
//    C > 8 items go, so the blocks stream neighbouring column tiles of the
//    same weight rows at once), and the fewer than G units left over are
//    cut into pieces of L consecutive ranges, dealt round robin too
//    (wg_piece_len picks L on the card from the live count that
//    plan_kernel writes, weighing the tail against a ticket a piece). A
//    block holding a unit from range 0 folds the range sums in registers;
//    the other pieces write theirs (float32, live rows only) to a scratch
//    and take a ticket on the unit, and the block completing it folds the
//    ns range sums in range order and runs the epilogue (SiLU of pass 1
//    on the full gate and up sums). No float atomics; the tickets are
//    zeroed by the prologue and set back to 0 by the merging block. One
//    live slot gives DeepSeek-MoE-16B 132 / 176 (unit, range) items in
//    its two passes (dealt as 132 / 96 pieces), where a 128-column tile
//    carrying the whole K gave 11 / 16.
//  * float32 stays on CUDA-core FMAs in full f32 (no TF32): 256 threads
//    own 128 columns, the reduction split over 4 thread groups combined
//    in a fixed order; 8-row tiles; the same skip and item walk.
//  * Deterministic: every output element is reduced in an order fixed by
//    (C, d, f, dtype) alone, never by S, the live count or the owner
//    table: 16-deep products summed in K order in f32 within a K range,
//    the range sums (C <= 8) added in range order whichever block holds
//    them and whichever merges (the walk only moves work between blocks).
//    So repeated calls are bit-identical, a slot's output does not depend
//    on which other slots are live, and the owner-indexed call is
//    bit-identical to the plain call on owner-gathered weights (only the
//    tensor map's expert coordinate, or the weight base pointer,
//    differs).
//  * Two passes: pass 1 writes the hidden h = silu(g) * u, cast to the
//    payload type, to a [S, C, f] scratch (only live rows); pass 2 reads
//    it and writes the float32 output rows [0, rows[s]). Rows past
//    rows[s] are staged and never stored.
#include <cuda_bf16.h>

#include "hopper.cuh"

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
// tick: nt tickets a slot, zeroed.
// VEC: 4 words per load (rows a multiple of 16 bytes, base aligned) or 1.
template <int VEC>
__global__ void __launch_bounds__(ROWS_THREADS)
rows_kernel(const uint32_t* __restrict__ x, uint32_t mask,
            float* __restrict__ out, int* __restrict__ rows,
            int* __restrict__ tick, int nt, int C, int W, int d) {
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
  for (int i = threadIdx.x; i < nt; i += ROWS_THREADS)
    tick[(size_t)s * nt + i] = 0;
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
// bf16: wgmma on TMA-staged tiles, persistent blocks
// ---------------------------------------------------------------------------
#define WG_RT 128      // bucket rows of a row tile, C > 8
#define WG_NARROW 8    // C <= WG_NARROW: one 8-row tile a slot, K ranges
#define WG_FILL 132    // C <= 8: pieces a pass has at one live slot, at
                       // least (the SMs of an H100), where K allows
#define WG_BN 128      // output columns of a unit (two consumer warpgroups)
#define WG_BK 64       // K rows of a stage: one 128-byte swizzle row of 64
                       // weight columns, or of 64 K-elements of a bucket row
#define WG_BOX (WG_BK * 64 * 2)   // one weight box: 64 K-rows x 64 columns
#define WG_THREADS 288            // warps 0-7: two consumer warpgroups,
                                  // 64 output columns each; 8: producer
#define WG_RING (200 * 1024)      // shared memory of the ring

// The walk of a C <= 8 pass deals whole units round robin, and cuts the
// U2 < G units left over after the whole rounds into pieces of L
// consecutive K ranges (of ns, each nk / ns 64-deep steps). The time of
// pieces of L ranges, in 16 KB of weights at an SM's share of the
// bandwidth: the most loaded block's ceil(U2 ceil(ns / L) / G) pieces,
// each its steps (NW weight matrices) plus a ticket (the partial sums, the
// ticket and a merge: about 128 KB).
__host__ __device__ __forceinline__ int wg_piece_cost(int U2, int ns, int nk,
                                                      int G, int NW, int L) {
  const int pieces = U2 * ((ns + L - 1) / L);
  return (pieces + G - 1) / G * (NW * ((L * nk + ns - 1) / ns) + 8);
}

// The K ranges of a C <= 8 pass with N output and K reduction columns and
// NW weight matrices, a function of (N, K, NW) alone: ranges of two steps
// or more (where K has them), at least WG_FILL (unit, range) pieces at
// one live slot; of those, the fewest ranges whose best piece length
// gives one live slot on WG_FILL SMs a time within 5% of the least.
static int wg_split(int N, int K, int NW) {
  const int nct = (N + WG_BN - 1) / WG_BN, nk = (K + WG_BK - 1) / WG_BK;
  const int top = nk / 2 > 1 ? nk / 2 : 1;
  auto best = [&](int ns) {
    int c = -1;
    for (int L = 1; L <= ns; ++L) {
      const int x = wg_piece_cost(nct, ns, nk, WG_FILL, NW, L);
      if (c < 0 || x < c) c = x;
    }
    return c;
  };
  int least = -1;
  for (int ns = 1; ns <= top; ++ns)
    if (nct * ns >= WG_FILL && (least < 0 || best(ns) < least))
      least = best(ns);
  if (least < 0) return top;
  for (int ns = 1;; ++ns)
    if (nct * ns >= WG_FILL && 20 * best(ns) <= 21 * least) return ns;
}

// The piece length the walk takes for U2 leftover units: the least
// wg_piece_cost on this grid, the longest among equals. It changes which
// block reduces a range, never the order of the sums. The lanes of a warp
// try 32 lengths at a time; every lane returns it.
__device__ __forceinline__ int wg_piece_len(int U2, int ns, int nk, int G,
                                            int NW) {
  if (U2 == 0) return ns;
  int best = 0, cost = 0x7fffffff;
  for (int L = ns - (int)(threadIdx.x & 31); L >= 1; L -= 32) {
    const int c = wg_piece_cost(U2, ns, nk, G, NW, L);
    if (c < cost) {
      cost = c;
      best = L;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int oc = __shfl_xor_sync(0xffffffffu, cost, o);
    const int ol = __shfl_xor_sync(0xffffffffu, best, o);
    if (oc < cost || (oc == cost && ol > best)) {
      cost = oc;
      best = ol;
    }
  }
  return best;
}

// wgmma.mma_async m64nNk16, f32 += bf16 x bf16, both from shared memory:
// A MN-major (transposed: the [K, N] weight tile as stored), B K-major
// (bucket or hidden rows as stored); d[N / 2] accumulators per thread.
template <int N>
struct WgmmaBf16;
template <>
struct WgmmaBf16<8> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <>
struct WgmmaBf16<16> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <>
struct WgmmaBf16<32> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <>
struct WgmmaBf16<64> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <>
struct WgmmaBf16<128> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

// The tile of a pass: NW weight matrices of WG_BN columns (two 64-column
// boxes each, one per consumer warpgroup), then NB staged rows of the
// bucket (pass 1) or the hidden (pass 2), every box in the 128-byte
// swizzle. The ring takes as many stages as fit WG_RING, at most 8.
template <int NW, int NB>
struct WgTile {
  static constexpr int W_BYTES = 2 * WG_BOX;
  static constexpr int STAGE = NW * W_BYTES + NB * WG_BK * 2;
  static constexpr int STAGES = WG_RING / STAGE < 8 ? WG_RING / STAGE : 8;
  static constexpr int SMEM = STAGES * STAGE + 1024 + 16 * STAGES;
};

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The epilogue of a unit: accumulator 4 i8 + 2 h + x is output column g +
// 8 h of the warp's 16, bucket row 8 i8 + 2 t4 + x of the tile. Pass 1
// (NW 2) stores silu(gate) * up as bf16, pass 2 the float32 sum.
template <int NW, int NB>
__device__ __forceinline__ void wg_store(const float (&acc)[NW][NB / 2],
                                         const Item& it, void* dst, int C,
                                         int N) {
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
  const size_t row0 = (size_t)it.s * C + it.r0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int col = it.n0 + wg * 64 + warp * 16 + g + 8 * h;
    if (col >= N) continue;
#pragma unroll
    for (int i8 = 0; i8 < NB / 8; ++i8)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int r = 8 * i8 + 2 * t4 + x, y = 4 * i8 + 2 * h + x;
        if (r >= it.nr) continue;
        const size_t o = (row0 + r) * N + col;
        if (NW == 2) {
          const float gs = acc[0][y], us = acc[NW - 1][y];
          const float sig = 1.f / (1.f + expf(-gs));
          reinterpret_cast<__nv_bfloat16*>(dst)[o] =
              __float2bfloat16(gs * sig * us);
        } else {
          reinterpret_cast<float*>(dst)[o] = acc[0][y];
        }
      }
  }
}

// NW = 2: pass 1 (smap = buckets [S * C, K = d], w0map/w1map = gate/up
// [E, d, f], dst = hidden bf16 [S, C, N = f]); NW = 1: pass 2 (smap =
// hidden, w0map = down [E, f, d], dst = out f32 [S, C, N = d]). NB: the
// staged rows, the wgmma's N, at least the capacity (or WG_RT). At NB 8
// (ns K ranges): part, float32 scratch of the pieces' partial sums,
// [pieces][NW][256 threads][4]; tick, a zeroed int per unit.
template <int NW, int NB>
__global__ void __launch_bounds__(WG_THREADS, 1)
wg_pass(const __grid_constant__ CUtensorMap smap,
        const __grid_constant__ CUtensorMap w0map,
        const __grid_constant__ CUtensorMap w1map,
        const int* __restrict__ owner, const int* __restrict__ work,
        void* __restrict__ dst, float* __restrict__ part,
        int* __restrict__ tick, int S, int C, int K, int N, int E, int rt,
        int ns) {
  using L = WgTile<NW, NB>;
  constexpr int R = NB / 2;  // accumulators per thread and weight matrix
  extern __shared__ uint8_t ring[];
  const uint32_t base = (smem_u32(ring) + 1023) & ~1023u;  // swizzle atoms
  const uint32_t full = base + L::STAGES * L::STAGE;
  const uint32_t empty = full + 8 * L::STAGES;
  const int nct = (N + WG_BN - 1) / WG_BN;
  const int nk = (K + WG_BK - 1) / WG_BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  } else if (threadIdx.x == 256) {  // the producer's maps, early
    asm volatile(
        "prefetch.tensormap [%0];\nprefetch.tensormap [%1];\n"
        "prefetch.tensormap [%2];\n" ::"l"(reinterpret_cast<uint64_t>(&smap)),
        "l"(reinterpret_cast<uint64_t>(&w0map)),
        "l"(reinterpret_cast<uint64_t>(&w1map))
        : "memory");
  }
  __syncthreads();

  // one stage of the ring: the producer's loads, the consumers' products
  auto load = [&](const Item& it, int kt, int step) {
    const int st = step % L::STAGES;
    if (step >= L::STAGES)
      mbar_wait(empty + 8 * st, (step / L::STAGES - 1) & 1);
    const uint32_t a = base + st * L::STAGE, bar = full + 8 * st;
    mbar_expect_tx(bar, L::STAGE);
#pragma unroll
    for (int m = 0; m < NW; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        tma_load_3d(a + m * L::W_BYTES + h * WG_BOX, m ? &w1map : &w0map,
                    bar, it.n0 + 64 * h, kt * WG_BK, it.e);
    tma_load(a + NW * L::W_BYTES, &smap, bar, kt * WG_BK, it.s * C + it.r0);
  };
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  auto product = [&](float (&acc)[NW][R], int step, bool release_prev) {
    const int st = step % L::STAGES;
    mbar_wait(full + 8 * st, (step / L::STAGES) & 1);
    const uint32_t a = base + st * L::STAGE;
    const uint64_t db = sw128_desc(a + NW * L::W_BYTES);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk)
#pragma unroll
      for (int m = 0; m < NW; ++m)
        WgmmaBf16<NB>::mma(
            acc[m], sw128_desc(a + m * L::W_BYTES + wg * WG_BOX) + 128 * kk,
            db + 2 * kk);
    wg_commit();
    // keep this stage's products in flight; the previous stage's are
    // done, so its tiles go back to the producer
    wg_wait_one();
    if (release_prev && lane == 0)
      mbar_arrive(empty + 8 * ((step - 1) % L::STAGES));
  };
  auto zero = [&](float (&acc)[NW][R]) {
#pragma unroll
    for (int m = 0; m < NW; ++m) {
#pragma unroll
      for (int x = 0; x < R; ++x) acc[m][x] = 0.f;
      fence_regs<R>(acc[m]);
    }
  };
  // the last stage's products done: its tiles go back, the accumulators
  // may be read (only the wgmma touch them inside a K loop: any other
  // instruction that did would serialize the wgmma pipeline)
  auto drain = [&](float (&acc)[NW][R], int step) {
    wg_wait_all();
    if (lane == 0) mbar_arrive(empty + 8 * ((step - 1) % L::STAGES));
#pragma unroll
    for (int m = 0; m < NW; ++m) fence_regs<R>(acc[m]);
  };

  if constexpr (NB != WG_NARROW) {
    // an item: (pair, column tile), the whole K reduction
    const int n_items = work[S] * nct;
    if (threadIdx.x >= 256) {  // producer: one thread keeps the ring full
      if (threadIdx.x == 256) {
        int step = 0;
        for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
          const Item it =
              item_of(i, work, owner, S, E, rt, WG_RT, nct, WG_BN);
          for (int kt = 0; kt < nk; ++kt, ++step) load(it, kt, step);
        }
      }
      return;
    }
    float acc[NW][R];
    int step = 0;
    for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
      zero(acc);
      for (int kt = 0; kt < nk; ++kt, ++step) product(acc, step, kt > 0);
      drain(acc, step);
      wg_store<NW, NB>(acc, item_of(i, work, owner, S, E, rt, WG_RT, nct,
                                    WG_BN),
                       dst, C, N);
    }
  } else {
    // Units (pair, column tile): the first rounds x G of them whole, unit
    // b + q G to block b in round q (as the C > 8 items go: the blocks
    // stream neighbouring column tiles at once). The U2 < G left over are
    // cut into pieces of L consecutive K ranges, piece p = k U2 + v being
    // ranges [k L, k L + L) of unit rounds G + v, piece b + q G to block b
    // (the blocks stream one K region of neighbouring column tiles at
    // once); a block walks its pieces first. L balances the pieces against
    // the ticket each costs (wg_piece_len). Every unit is reduced in the
    // same order, its ns ranges in range order: folded in registers as
    // far as one block holds them from range 0 (a whole unit: all of
    // them), the rest from the pieces' partial sums in the scratch, by the
    // block that completes the unit's ticket.
    const int G = gridDim.x, b = blockIdx.x;
    const long long U = (long long)work[S] * nct;
    const int rounds = (int)(U / G), U2 = (int)(U - (long long)rounds * G);
    const int L = wg_piece_len(U2, ns, nk, G, NW);
    const int npieces = U2 * ((ns + L - 1) / L);
    const int mine = npieces > b ? (npieces - 1 - b) / G + 1 : 0;
    auto task = [&](int q, int& u, int& r0, int& r1) {
      if (q < mine) {                        // piece p: ranges [r0, r1)
        const int p = b + q * G;
        u = rounds * G + p % U2;
        r0 = p / U2 * L;
        r1 = min(ns, r0 + L);
      } else {                               // a whole unit
        u = b + (q - mine) * G;
        r0 = 0;
        r1 = ns;
      }
    };
    const int ntask = mine + rounds;
    if (threadIdx.x >= 256) {  // producer
      if (threadIdx.x == 256) {
        int step = 0;
        for (int q = 0; q < ntask; ++q) {
          int u, r0, r1;
          task(q, u, r0, r1);
          const Item it =
              item_of(u, work, owner, S, E, rt, WG_NARROW, nct, WG_BN);
          for (int kt = r0 * nk / ns; kt < r1 * nk / ns; ++kt, ++step)
            load(it, kt, step);
        }
      }
      return;
    }
    __shared__ int ticket;
    const int t = threadIdx.x, t4 = t & 3;
    // the scratch slot of range r of leftover unit v
    float4* const part4 = reinterpret_cast<float4*>(part) + t;
    auto slot = [&](int r, int v, int m) {
      return part4 + ((size_t)(r * U2 + v) * NW + m) * 256;
    };
    float acc[NW][R], sum[NW][R];
    auto fold = [&](int m, float4 v, bool first) {
      sum[m][0] = first ? v.x : sum[m][0] + v.x;
      sum[m][1] = first ? v.y : sum[m][1] + v.y;
      sum[m][2] = first ? v.z : sum[m][2] + v.z;
      sum[m][3] = first ? v.w : sum[m][3] + v.w;
    };
    int step = 0;
    for (int q = 0; q < ntask; ++q) {
      int u, r0, r1;
      task(q, u, r0, r1);
      const Item it =
          item_of(u, work, owner, S, E, rt, WG_NARROW, nct, WG_BN);
      const bool live = 2 * t4 < it.nr;   // a thread's rows 2 t4, 2 t4 + 1
      const int v = u - rounds * G;
      for (int r = r0; r < r1; ++r) {
        zero(acc);
        const int kt0 = r * nk / ns, kt1 = (r + 1) * nk / ns;
        for (int kt = kt0; kt < kt1; ++kt, ++step)
          product(acc, step, kt > kt0);
        drain(acc, step);
        if (r0 == 0) {
#pragma unroll
          for (int m = 0; m < NW; ++m)
            fold(m, make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]),
                 r == 0);
        } else if (live) {
#pragma unroll
          for (int m = 0; m < NW; ++m)
            __stcg(slot(r, v, m),
                   make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]));
        }
      }
      if (r1 - r0 < ns) {
        // a piece: its sums to the scratch (from range 0: the fold, in the
        // slot of its last range), then the unit's ticket; the block that
        // completes it folds the unit's ranges in range order
        if (r0 == 0 && live) {
#pragma unroll
          for (int m = 0; m < NW; ++m)
            __stcg(slot(r1 - 1, v, m),
                   make_float4(sum[m][0], sum[m][1], sum[m][2], sum[m][3]));
        }
        __threadfence();
        bar_sync(1, 256);
        if (t == 0) ticket = atomicAdd(tick + u, r1 - r0) + r1 - r0;
        bar_sync(1, 256);
        if (ticket != ns) continue;
        __threadfence();
        if (live) {
#pragma unroll
          for (int m = 0; m < NW; ++m) fold(m, __ldcg(slot(L - 1, v, m)), true);
        }
        for (int r = L; r < ns; r += 8) {
          float4 x[NW][8];
#pragma unroll
          for (int c = 0; c < 8; ++c)
#pragma unroll
            for (int m = 0; m < NW; ++m)
              if (live && r + c < ns) x[m][c] = __ldcg(slot(r + c, v, m));
#pragma unroll
          for (int c = 0; c < 8; ++c)
#pragma unroll
            for (int m = 0; m < NW; ++m)
              if (live && r + c < ns) fold(m, x[m][c], false);
        }
        if (t == 0) tick[u] = 0;                    // ready for pass 2
      }
      wg_store<NW, NB>(sum, it, dst, C, N);
    }
  }
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

// A bf16 tensor map of `rank` (2 or 3) dims, dims[0] contiguous: boxes of
// 64 elements (128 bytes) along dims[0], box1 along dims[1] and 1 along
// dims[2], in the 128-byte swizzle; out-of-bounds elements read as zero.
static int bf16_map(CUtensorMap* map, const void* ptr, int rank,
                    const cuuint64_t* dims, int box1) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t strides[2] = {dims[0] * 2, dims[0] * dims[1] * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box1, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                         (cuuint32_t)rank, const_cast<void*>(ptr), dims,
                         strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// src [S * C, K] staged NB rows at a time; w0 / w1 [E, K, N] as a 3-D map,
// so that a box's K-rows past K read as zero (not the next expert's) and
// the owner only moves its third coordinate.
template <int NW, int NB>
static int launch_wg(const void* src, const void* w0, const void* w1,
                     const int* owner, const int* work, void* dst,
                     float* part, int* tick, int S, int C, int K, int N,
                     int E, int rt, cudaStream_t stream) {
  CUtensorMap smap, w0map, w1map;
  const cuuint64_t rows[2] = {(cuuint64_t)K, (cuuint64_t)S * C};
  const cuuint64_t ws[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  int err = bf16_map(&smap, src, 2, rows, NB);
  if (!err) err = bf16_map(&w0map, w0, 3, ws, WG_BK);
  if (!err) err = NW == 2 ? bf16_map(&w1map, w1, 3, ws, WG_BK) : 0;
  if (err) return err;
  if (NW == 1) w1map = w0map;
  constexpr int smem = WgTile<NW, NB>::SMEM;
  int blocks = 0;
  if ((err = persistent_grid<wg_pass<NW, NB>>(WG_THREADS, smem, &blocks)))
    return err;
  wg_pass<NW, NB><<<blocks, WG_THREADS, smem, stream>>>(
      smap, w0map, w1map, owner, work, dst, part, tick, S, C, K, N, E, rt,
      NB == WG_NARROW ? wg_split(N, K, NW) : 1);
  return (int)cudaGetLastError();
}

template <int NB>
static int launch_bf16_wg(const void* x, const void* wg, const void* wu,
                          const void* wd, const int* owner, void* hidden,
                          float* out, int* work, float* part, int* tick,
                          int S, int C, int d, int f, int E, int rt,
                          cudaStream_t stream) {
  int err = launch_wg<2, NB>(x, wg, wu, owner, work, hidden, part, tick, S,
                             C, d, f, E, rt, stream);
  if (err) return err;
  return launch_wg<1, NB>(hidden, wd, wd, owner, work, out, part, tick, S, C,
                          f, d, E, rt, stream);
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

// The int32 work buffer: rows [S] | live pair count [1] | pairs [S * C],
// then at C <= 8 in bf16 the tickets [S * tick_per_slot] (one per unit)
// and, from a 128-byte boundary, the float32 partial sums of the pieces
// ([(blocks - 1) ns][NW][1024] for the pass with more of them: fewer than
// one unit a block is split into pieces).
struct WorkLayout {
  long long tick, part, ints;
  int tick_per_slot;
};
static int work_layout(int S, int C, int d, int f, int dtype,
                       WorkLayout* w) {
  w->tick = S + 1 + (long long)S * C;
  w->tick_per_slot = 0;
  w->part = w->ints = w->tick;
  if (dtype != 1 || C > WG_NARROW) return 0;
  int g1 = 0, g2 = 0;
  int err = persistent_grid<wg_pass<2, WG_NARROW>>(
      WG_THREADS, WgTile<2, WG_NARROW>::SMEM, &g1);
  if (!err)
    err = persistent_grid<wg_pass<1, WG_NARROW>>(
        WG_THREADS, WgTile<1, WG_NARROW>::SMEM, &g2);
  if (err) return err;
  const long long nc1 = (f + WG_BN - 1) / WG_BN;
  const long long nc2 = (d + WG_BN - 1) / WG_BN;
  const int ns1 = wg_split(f, d, 2), ns2 = wg_split(d, f, 1);
  const long long p1 = ns1 > 1 ? (long long)(g1 - 1) * ns1 * 2 * 1024 : 0;
  const long long p2 = ns2 > 1 ? (long long)(g2 - 1) * ns2 * 1024 : 0;
  w->tick_per_slot = (int)(nc1 > nc2 ? nc1 : nc2);
  w->part = (w->tick + (long long)S * w->tick_per_slot + 31) / 32 * 32;
  w->ints = w->part + (p1 > p2 ? p1 : p2);
  return 0;
}

// int32 entries gmm_launch's work buffer takes for a call (-1 if the
// device cannot run the kernel).
extern "C" long long gmm_work_ints(int S, int C, int d, int f, int dtype) {
  WorkLayout w;
  return work_layout(S, C, d, f, dtype, &w) ? -1 : w.ints;
}

// dtype: 0 = float32, 1 = bfloat16 (buckets, weights and hidden share it).
// owner: null for the plain grouped FFN (slot s uses expert s).
// work: int32 scratch of gmm_work_ints(S, C, d, f, dtype) entries, 16-byte
// aligned; on return work[0:S] holds rows[s], the live rows of each slot.
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
  const int RT =
      dtype == 1 ? (C <= WG_NARROW ? WG_NARROW : WG_RT) : F32_ROWS;
  const int rt = (C + RT - 1) / RT;
  WorkLayout wl;
  int err = work_layout(S, C, d, f, dtype, &wl);
  if (err) return err;
  int* tick = work + wl.tick;
  float* part = reinterpret_cast<float*>(work + wl.part);

  // prologue: rows per slot, dead rows of out zeroed, tickets zeroed, the
  // live-pair list
  const int W = dtype == 1 ? d / 2 : d;
  const uint32_t mask = dtype == 1 ? 0x7fff7fffu : 0x7fffffffu;
  if ((W & 3) == 0 && ((uintptr_t)x & 15) == 0)
    rows_kernel<4><<<S, ROWS_THREADS, 0, stream>>>(
        reinterpret_cast<const uint32_t*>(x), mask, out, work, tick,
        wl.tick_per_slot, C, W, d);
  else
    rows_kernel<1><<<S, ROWS_THREADS, 0, stream>>>(
        reinterpret_cast<const uint32_t*>(x), mask, out, work, tick,
        wl.tick_per_slot, C, W, d);
  if ((err = (int)cudaGetLastError())) return err;
  plan_kernel<<<1, PLAN_THREADS, 0, stream>>>(work, S, rt, RT);
  if ((err = (int)cudaGetLastError())) return err;

  if (dtype == 0)
    return launch_f32(x, wg, wu, wd, owner, hidden, out, work, S, C, d, f, E,
                      rt, stream);
  // the staged rows: the capacity rounded up to a compiled wgmma width
  if (C <= 8)
    return launch_bf16_wg<8>(x, wg, wu, wd, owner, hidden, out, work, part,
                             tick, S, C, d, f, E, rt, stream);
  if (C <= 16)
    return launch_bf16_wg<16>(x, wg, wu, wd, owner, hidden, out, work, part,
                              tick, S, C, d, f, E, rt, stream);
  if (C <= 32)
    return launch_bf16_wg<32>(x, wg, wu, wd, owner, hidden, out, work, part,
                              tick, S, C, d, f, E, rt, stream);
  if (C <= 64)
    return launch_bf16_wg<64>(x, wg, wu, wd, owner, hidden, out, work, part,
                              tick, S, C, d, f, E, rt, stream);
  return launch_bf16_wg<128>(x, wg, wu, wd, owner, hidden, out, work, part,
                             tick, S, C, d, f, E, rt, stream);
}
