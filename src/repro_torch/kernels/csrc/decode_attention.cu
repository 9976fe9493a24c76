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
// with p the exp-weights of an online softmax whose max is guarded (the
// safe_m / corr rules of the TPU kernel: a fully masked range gives
// zeros). Output is float32 [B, H, hd]. The partial form (ml given)
// serves a shard of a sequence-sharded cache: out is left unnormalised
// and ml holds each row's (m, l), which the ranks combine by log-sum-exp
// weights outside the kernel.
//
// What bounds it on the H100: bytes. Each K/V element read feeds 2 * G
// multiply-adds, far below the card's ~295 bf16 operations per byte, so
// the least time is the K/V rows the call needs over 3.35 TB/s. With
// window == 0 a row needs only slots <= pos, and no other slot is read.
// Llama-4's decode shape (B 4, KV 8, hd 128, bf16) costs 4096 bytes of
// K + V per slot: 16.8 MB (5.0 us) at L 1024, 537 MB (160 us) at 32768.
// RecurrentGemma's local attention (B 4, H 10 on KV 1, hd 256, a ring of
// L 2048) costs 1024 bytes a slot: 8.4 MB (2.5 us) with every slot valid.
// At such sizes a block walks a few tiles, and what a block costs
// besides its bytes (issuing its copies, the pipeline's fill, the
// merges) sets the time.
//
// Design.
//  * Split L across blocks, combine in the same launch. Grid (n_split,
//    KV * n_grp, B); a block walks slots [lo, lo + split_len) of one
//    (b, kvh) for one group of at most gpb of its G query heads, in
//    tiles of 64 slots (32 for float32 at hd 256). A block is WQ warp
//    sets of 4 warps over one ring of K/V tiles; set s takes query heads
//    [s * SH, s * SH + SH) of the group, so the K/V of a range is read
//    from memory once for all of them. bf16 sets take 8 heads (one query
//    tile) where the group has at most 8, else max(8, 1024 / hd); at hd
//    256 two sets of 8, so RecurrentGemma's 10 heads are one group.
//  * Each block merges its 4 slot-warps' (m, l, acc) into one part.
//    n_split == 1: the block writes the output. n_split <= 8: the grid's
//    n_split blocks of a (b, kvh, group) are one thread-block cluster;
//    each pushes its part's element e into the shared memory of block
//    i = owner(e), the one that merges [i GD / n, (i + 1) GD / n), and
//    its (m, l) to every block; after one cluster barrier each block
//    merges its elements of the n parts in part order 0..n-1 (the
//    log-sum-exp weights of lse_weights). n_split > 8 (long caches):
//    each block writes its part to a workspace and takes a ticket from a
//    per-(b, kvh, group) counter; the block that arrives last merges the
//    n_split parts in part order, writes the output and sets the counter
//    back to 0 for the next call. Both merges take the same sums in the
//    same order, fixed by the shapes alone: repeated calls are
//    bit-identical, no atomic enters a sum, and a plan with the same
//    split gives the same bits either way.
//  * Bytes in flight: K and V tiles stay in their own type in shared
//    memory, brought in by 16-byte cp.async.cg copies through a ring of
//    stages (bf16: 3 stages of 32 KB at hd 128, two blocks per SM; at
//    hd 256 3 stages of 64 KB, one block of 8 warps per SM), every stage
//    filled before the first tile is used. A thread copies one 16-byte
//    chunk of every (NT / chunks)-th row of a tile, so its addresses step
//    by one stride and a slot's test is one compare with a limit worked
//    out once per block (the ring rule slot by slot only where the cache
//    is longer than the window); a tile whose slots are all used takes
//    the plain copy. The index arithmetic per 16-byte chunk that this
//    replaces (a division and a modulo each) set the walk's speed, not
//    the copies. A slot the block must not use (past L, past pos, or
//    masked by the ring rule) is zero-filled by the copy's src-size 0
//    form and never read from memory, so a NaN in a stale slot cannot
//    reach a product; its score is also set to -inf.
//  * bf16 on the tensor cores (mma.sync.m16n8k16, f32 accumulation),
//    swap-AB: warp w of a set takes slots [16 w, 16 w + 16) of each tile
//    and keeps its own online-softmax state. Scores S^T [16 slots x 8
//    queries] = K . Q^T, K from ldmatrix (K rows are the A operand as
//    stored), Q^T held in registers for the whole block (queries padded
//    to a multiple of 8; pad queries score -inf and are never written).
//    The k-steps go to two accumulators in turn (four at hd 256), and
//    the exp is the fast __expf. The max over slots is a lane shuffle
//    within the warp; each lane keeps its own share of l and the lanes'
//    shares are summed once, at the end of the walk. p is rounded to
//    bf16 (the TPU kernel's cast before p . v) and passed through a
//    small warp-private buffer into the B operand of O^T [hd x 8] += V^T
//    . P^T, with V^T from ldmatrix.trans. K/V rows are XOR-swizzled in
//    16-byte chunks, so ldmatrix reads without bank conflicts.
//  * float32 keeps CUDA-core FMAs in full f32 (no TF32), on the same
//    pipelined tiles (2 stages, rows padded by 16 bytes; at hd 256 tiles
//    of 32 slots, so two stages fit in 133 KB): one lane per (slot, part
//    of hd) for the scores (halves of hd, quarters at hd 256), lane g for
//    the softmax of query g, and SH * hd / 32 accumulators per lane.
//  * Strides of K and V are passed in (batch, slot, head), so a view of
//    a stacked cache is read in place; the innermost stride must be 1,
//    the other strides multiples of 16 bytes and the base 16-byte
//    aligned (the wrapper checks).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define DA_WARPS 4            // warps of a set, along a tile's slots
#define DA_SET_THREADS (32 * DA_WARPS)
#define DA_TILE 64            // cache slots per stage, and the unit of
                              // split_len (a multiple of every Ring::TILE)
#define DA_MAX_CLUSTER 8      // the portable cluster size

__device__ __forceinline__ bool slot_valid(int slot, int pos, int window) {
  if (window > 0) {
    int delta = (pos - slot) % window;
    if (delta < 0) delta += window;
    const int kv_pos = pos - delta;
    return kv_pos >= 0 && kv_pos > pos - window && kv_pos <= pos;
  }
  return slot <= pos;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
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

// Shared-memory layout of the K/V ring for element type T and head size
// HD: a stage holds TILE K rows, then TILE V rows (SPW slots per warp).
// bf16 rows are unpadded with 16-byte chunk c of row r at c ^ swz(r);
// float32 rows are padded by 16 bytes, and at HD 256 a tile is 32 slots
// (two 64-slot stages would need 266 KB).
template <typename T, int HD>
struct Ring {
  static constexpr bool BF16 = sizeof(T) == 2;
  static constexpr int TILE = (!BF16 && HD > 128) ? 32 : DA_TILE;
  static constexpr int SPW = TILE / DA_WARPS;           // slots per warp
  static constexpr int CH = HD * (int)sizeof(T) / 16;   // chunks per row
  static constexpr int ROW = HD * (int)sizeof(T) + (BF16 ? 0 : 16);
  static constexpr int TILE_BYTES = TILE * ROW;
  static constexpr int STAGE = 2 * TILE_BYTES;
  static constexpr int STAGES = BF16 ? 3 : 2;
  static constexpr int BYTES = STAGES * STAGE;
  static_assert(DA_TILE % TILE == 0, "split_len must hold whole tiles");
  __device__ static int chunk_at(int r, int c) {
    if (!BF16) return c;
    return CH >= 8 ? c ^ (r & 7) : c ^ ((r >> 1) & 3);
  }
  __device__ static int offset(int r, int c) {
    return r * ROW + (chunk_at(r, c) << 4);
  }
};

// What a block walks: slots [lo, hi) of (b, kvh). A slot is used where
// ok(): below lim, or by the ring rule slot by slot where the cache is
// longer than the window (exact).
struct Range {
  int lo, hi, pos, window, lim;
  bool exact;
  __device__ Range(int lo_, int hi_, int pos_, int window_, int L)
      : lo(lo_), hi(hi_), pos(pos_), window(window_) {
    if (window == 0) hi = min(hi, pos + 1);       // masked slots not read
    exact = window > 0 && L > window;
    // a ring of L <= window slots: every slot once the ring is full,
    // else the slots up to pos
    lim = window > 0 && pos >= window - 1 ? hi : min(hi, pos + 1);
  }
  __device__ bool ok(int slot) const {
    return exact ? slot < hi && slot_valid(slot, pos, window) : slot < lim;
  }
};

// Issue the copies of tile `t` into ring stage `st` (zero-filled where a
// slot is not used); NT threads share them. Thread x copies 16-byte chunk
// x % CH of rows x / CH + i * STEP of the tile (K and V alike), so its
// addresses step by a fixed stride, and a slot's test is one compare.
template <typename T, int HD, int NT>
__device__ __forceinline__ void load_tile(unsigned char* st, const T* kb,
                                          const T* vb, long long ksl,
                                          long long vsl, const Range& r,
                                          int t) {
  using R = Ring<T, HD>;
  constexpr int STEP = NT / R::CH;                 // rows a pass copies
  static_assert(NT % R::CH == 0 && R::TILE % STEP == 0, "whole passes");
  const int ch = threadIdx.x % R::CH, j0 = threadIdx.x / R::CH;
  const int t0 = r.lo + t * R::TILE;
  const T* kp = kb + ksl * (t0 + j0) + ch * (16 / (int)sizeof(T));
  const T* vp = vb + vsl * (t0 + j0) + ch * (16 / (int)sizeof(T));
  if (!r.exact && t0 + R::TILE <= r.lim) {         // every slot used
#pragma unroll
    for (int i = 0; i < R::TILE / STEP; ++i) {
      const int j = j0 + i * STEP;
      cp_async16(st + R::offset(j, ch), kp + i * STEP * ksl);
      cp_async16(st + R::TILE_BYTES + R::offset(j, ch), vp + i * STEP * vsl);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < R::TILE / STEP; ++i) {
    const int j = j0 + i * STEP;
    const bool ok = r.ok(t0 + j);
    cp_async16(st + R::offset(j, ch), ok ? kp + i * STEP * ksl : kb,
               ok ? 16 : 0);
    cp_async16(st + R::TILE_BYTES + R::offset(j, ch),
               ok ? vp + i * STEP * vsl : vb, ok ? 16 : 0);
  }
}

// Per-warp state handed to the block merge: acc [DA_WARPS][G][HD], then
// m and l [DA_WARPS][G], in the (already drained) ring; then the block's
// (M, lsum) [2][G], and the cluster merge's weights [DA_MAX_CLUSTER][G]
// and sums [G].
struct MergeBuf {
  float* acc;
  float* m;
  float* l;
  float* bml;
  float* w;
  float* lf;
  __device__ MergeBuf(unsigned char* smem, int GD, int G) {
    acc = reinterpret_cast<float*>(smem);
    m = acc + DA_WARPS * GD;
    l = m + DA_WARPS * G;
    bml = l + DA_WARPS * G;
    w = bml + 2 * G;
    lf = w + DA_MAX_CLUSTER * G;
  }
  __host__ __device__ static int bytes(int GD, int G) {
    return 4 * (DA_WARPS * GD + (2 * DA_WARPS + 3) * G + DA_MAX_CLUSTER * G);
  }
};

// ---------------------------------------------------------------------------
// bf16: tensor cores. A warp set's NG query tiles of 8 (SH heads), HD /
// 16 k-steps.
// ---------------------------------------------------------------------------
template <int HD, int SH>
struct Bf16Cfg {
  static constexpr int NG = SH / 8;                  // 1, 2 or 4
  static constexpr int KS = HD / 16;
  static constexpr int CHAINS = KS >= 16 ? 4 : 2;    // score accumulators
  static constexpr int PS_ROW = 24;                  // bf16 per P^T row
  static constexpr int PS_WARP = NG * 8 * PS_ROW * 2;  // bytes per warp
};

// The walk of warp set `set` (heads [g0, g0 + Gs) of the block's G; Gs
// may be 0 or less for the last group's second set, which then only
// helps with the copies). qb points at the set's first head.
template <int HD, int SH, int NT>
__device__ __forceinline__ void bf16_walk(
    unsigned char* smem, const __nv_bfloat16* qb, const __nv_bfloat16* kb,
    const __nv_bfloat16* vb, long long ksl, long long vsl, const Range& r,
    int G, int g0, int Gs, float scale) {
  using R = Ring<__nv_bfloat16, HD>;
  using C = Bf16Cfg<HD, SH>;
  constexpr int NG = C::NG, KS = C::KS, CH = C::CHAINS;
  static_assert(R::SPW == 16, "a warp's slots are one m16 tile");
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = (tid >> 5) % DA_WARPS;            // slot-warp of the set
  const int gq = lane >> 2, t4 = lane & 3;
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(
      smem + R::BYTES + (tid >> 5) * C::PS_WARP);

  // Q^T as B operands: query 8 ng + gq, hd 16 kk + 2 t4 (+1) and +8
  uint32_t qf[NG][KS][2];
#pragma unroll
  for (int ng = 0; ng < NG; ++ng) {
    const int g = 8 * ng + gq;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        qf[ng][kk][h] = g < Gs ? *reinterpret_cast<const uint32_t*>(
                                     qb + g * HD + 16 * kk + 8 * h + 2 * t4)
                               : 0u;
  }
  float acc[KS][NG][4];
  float m_run[NG][2], l_run[NG][2];
#pragma unroll
  for (int ng = 0; ng < NG; ++ng) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      m_run[ng][x] = -INFINITY;
      l_run[ng][x] = 0.f;
    }
#pragma unroll
    for (int mt = 0; mt < KS; ++mt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][ng][c] = 0.f;
  }

  // ldmatrix row addresses: lane l addresses row (l & 7) of matrix l >> 3
  const int li = lane >> 3, lr = lane & 7;
  const int k_row = 16 * warp + lr + ((li & 1) << 3), k_ch = li >> 1;
  const int v_row = 16 * warp + lr + ((li >> 1) << 3), v_ch = li & 1;
  const int n_tiles = r.hi > r.lo ? (r.hi - r.lo + R::TILE - 1) / R::TILE : 0;

#pragma unroll 1
  for (int p = 0; p < R::STAGES; ++p) {          // every stage filled
    if (p < n_tiles)
      load_tile<__nv_bfloat16, HD, NT>(smem + p * R::STAGE, kb, vb, ksl, vsl,
                                       r, p);
    cp_async_commit();
  }
#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    // tile t is group t: STAGES groups are committed before t = 0, one
    // more (tile t + STAGES - 1, or none) after each wait from t = 1
    if (t == 0)
      cp_async_wait<R::STAGES - 1>();
    else
      cp_async_wait<R::STAGES - 2>();
    __syncthreads();
    if (t > 0) {    // tile t - 1's stage is free for tile t + STAGES - 1
      if (t + R::STAGES - 1 < n_tiles)
        load_tile<__nv_bfloat16, HD, NT>(
            smem + ((t - 1) % R::STAGES) * R::STAGE, kb, vb, ksl, vsl, r,
            t + R::STAGES - 1);
      cp_async_commit();
    }

    const unsigned char* ks = smem + (t % R::STAGES) * R::STAGE;
    const unsigned char* vs = ks + R::TILE_BYTES;
    const int s0 = r.lo + t * R::TILE + 16 * warp;   // the warp's slots
    if (s0 >= r.hi || Gs <= 0) continue;             // nothing to do
    // scores S^T [16 slots x 8 queries] per query tile, k-step kk in
    // accumulator kk % CH (a CH-th of the dependent chain): s[0] + s[1],
    // and (s[0] + s[1]) + (s[2] + s[3]) at hd 256
    float s[CH][NG][4];
#pragma unroll
    for (int x = 0; x < CH; ++x)
#pragma unroll
      for (int ng = 0; ng < NG; ++ng)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[x][ng][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, ks + R::offset(k_row, 2 * kk + k_ch));
#pragma unroll
      for (int ng = 0; ng < NG; ++ng)
        mma_bf16(s[kk % CH][ng], a, qf[ng][kk][0], qf[ng][kk][1]);
    }
#pragma unroll
    for (int ng = 0; ng < NG; ++ng)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[0][ng][c] += s[1][ng][c];
        if constexpr (CH == 4) s[0][ng][c] += s[2][ng][c] + s[3][ng][c];
      }
    bool ok[2];
#pragma unroll
    for (int y = 0; y < 2; ++y) ok[y] = r.ok(s0 + gq + 8 * y);
    // online softmax per query column g = 8 ng + 2 t4 + x; the max is
    // shared by the column's lanes, l is kept per lane (its own slots)
    // and summed over the lanes once, after the walk
    float corr[NG][2];
#pragma unroll
    for (int ng = 0; ng < NG; ++ng) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const bool real = 8 * ng + 2 * t4 + x < Gs;
        float sc[2], mb = -INFINITY;
#pragma unroll
        for (int y = 0; y < 2; ++y) {
          const float dot = s[0][ng][2 * y + x];
          sc[y] = ok[y] && real ? dot * scale : -INFINITY;
          mb = fmaxf(mb, sc[y]);
        }
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
          mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, o));
        const float m_old = m_run[ng][x];
        const float m_new = fmaxf(m_old, mb);
        const float safe_m = isfinite(m_new) ? m_new : 0.f;
        float sum = 0.f;
#pragma unroll
        for (int y = 0; y < 2; ++y) {
          const float p = isfinite(sc[y]) ? __expf(sc[y] - safe_m) : 0.f;
          sum += p;
          s[0][ng][2 * y + x] = p;
        }
        const float c = isfinite(m_old) ? __expf(m_old - safe_m) : 0.f;
        corr[ng][x] = c;
        l_run[ng][x] = c * l_run[ng][x] + sum;
        m_run[ng][x] = m_new;
      }
    }
    // P^T as the B operand: p (bf16) through the warp's buffer
    // ps[ng][g][slot], rows padded to PS_ROW
    __syncwarp();
#pragma unroll
    for (int ng = 0; ng < NG; ++ng)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        ps[(ng * 8 + 2 * t4 + (c & 1)) * C::PS_ROW + gq + 8 * (c >> 1)] =
            __float2bfloat16_rn(s[0][ng][c]);
    __syncwarp();
    uint32_t pb[NG][2];
#pragma unroll
    for (int ng = 0; ng < NG; ++ng)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        pb[ng][h] = *reinterpret_cast<const uint32_t*>(
            ps + (ng * 8 + gq) * C::PS_ROW + 2 * t4 + 8 * h);
    // O^T [hd x 8] = corr * O^T + V^T . P^T
#pragma unroll
    for (int mt = 0; mt < KS; ++mt) {
      uint32_t a[4];
      ldmatrix_x4_trans(a, vs + R::offset(v_row, 2 * mt + v_ch));
#pragma unroll
      for (int ng = 0; ng < NG; ++ng) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][ng][c] *= corr[ng][c & 1];
        mma_bf16(acc[mt][ng], a, pb[ng][0], pb[ng][1]);
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int ng = 0; ng < NG; ++ng)
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        l_run[ng][x] += __shfl_xor_sync(0xffffffffu, l_run[ng][x], o);
  __syncthreads();                   // the ring is free for the merge
  MergeBuf mb(smem, G * HD, G);
#pragma unroll
  for (int ng = 0; ng < NG; ++ng)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int g = 8 * ng + 2 * t4 + (c & 1);
      if (g < Gs) {
#pragma unroll
        for (int mt = 0; mt < KS; ++mt)
          mb.acc[(warp * G + g0 + g) * HD + 16 * mt + gq + 8 * (c >> 1)] =
              acc[mt][ng][c];
        if (gq == 0 && c < 2) {
          mb.m[warp * G + g0 + g] = m_run[ng][c];
          mb.l[warp * G + g0 + g] = l_run[ng][c];
        }
      }
    }
}

// ---------------------------------------------------------------------------
// float32: CUDA-core FMAs in full f32
// ---------------------------------------------------------------------------
template <int HD, int SH>
struct F32Cfg {
  static constexpr int ACC = SH * HD / 32;           // accumulators a lane
  static constexpr int SC = 32 * 16;                 // scores a warp
};

template <int HD, int SH, int NT>
__device__ __forceinline__ void f32_walk(unsigned char* smem, const float* qb,
                                         const float* kb, const float* vb,
                                         long long ksl, long long vsl,
                                         const Range& r, int G, int g0,
                                         int Gs, float scale) {
  using R = Ring<float, HD>;
  using C = F32Cfg<HD, SH>;
  constexpr int ACC = C::ACC;
  constexpr int SPW = R::SPW;              // a warp's slots in a tile
  constexpr int PART = HD * SPW / 32;      // hd values of one lane's dot
  constexpr int WARPS = NT / 32;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = (tid >> 5) % DA_WARPS, gw = tid >> 5;
  const int GDs = Gs * HD;
  float* qs = reinterpret_cast<float*>(smem + R::BYTES);   // [G][HD]
  float* sc = qs + (NT / DA_SET_THREADS) * SH * HD +
              gw * C::SC;                                  // [Gs][SPW]
  float* cr = qs + (NT / DA_SET_THREADS) * SH * HD + WARPS * C::SC +
              gw * 32;                                     // [Gs]
  for (int i = tid; i < G * HD; i += NT) qs[i] = qb[i];
  const float* qset = qs + g0 * HD;
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;       // lane g's query
  // lane: slot j of the warp's SPW, part `part` of hd for the scores
  const int j = lane % SPW, part = lane / SPW;
  const int n_tiles = r.hi > r.lo ? (r.hi - r.lo + R::TILE - 1) / R::TILE : 0;

#pragma unroll 1
  for (int p = 0; p < R::STAGES; ++p) {          // every stage filled
    if (p < n_tiles)
      load_tile<float, HD, NT>(smem + p * R::STAGE, kb, vb, ksl, vsl, r, p);
    cp_async_commit();
  }
#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    // tile t is group t: STAGES groups are committed before t = 0, one
    // more (tile t + STAGES - 1, or none) after each wait from t = 1
    if (t == 0)
      cp_async_wait<R::STAGES - 1>();
    else
      cp_async_wait<R::STAGES - 2>();
    __syncthreads();
    if (t > 0) {    // tile t - 1's stage is free for tile t + STAGES - 1
      if (t + R::STAGES - 1 < n_tiles)
        load_tile<float, HD, NT>(smem + ((t - 1) % R::STAGES) * R::STAGE, kb,
                                 vb, ksl, vsl, r, t + R::STAGES - 1);
      cp_async_commit();
    }

    const int s0 = r.lo + t * R::TILE + SPW * warp;
    if (s0 >= r.hi || Gs <= 0) continue;
    const unsigned char* ks = smem + (t % R::STAGES) * R::STAGE;
    const unsigned char* vs = ks + R::TILE_BYTES;
    const int slot = s0 + j;
    const bool ok = r.ok(slot);
    const float4* kr = reinterpret_cast<const float4*>(
        ks + (SPW * warp + j) * R::ROW) + part * (PART / 4);
    __syncwarp();
    for (int g = 0; g < Gs; ++g) {
      const float4* qr =
          reinterpret_cast<const float4*>(qset + g * HD) + part * (PART / 4);
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < PART / 4; ++c) {
        const float4 a = qr[c], b = kr[c];
        dot = fmaf(a.x, b.x, dot);
        dot = fmaf(a.y, b.y, dot);
        dot = fmaf(a.z, b.z, dot);
        dot = fmaf(a.w, b.w, dot);
      }
#pragma unroll
      for (int o = SPW; o < 32; o <<= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (part == 0) sc[g * SPW + j] = ok ? dot * scale : -INFINITY;
    }
    __syncwarp();
    if (lane < Gs) {                 // lane g: the softmax of query g
      float* sg = sc + lane * SPW;
      float mb = -INFINITY;
#pragma unroll
      for (int i = 0; i < SPW; ++i) mb = fmaxf(mb, sg[i]);
      const float m_new = fmaxf(m_run, mb);
      const float safe_m = isfinite(m_new) ? m_new : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < SPW; ++i) {
        const float p = isfinite(sg[i]) ? expf(sg[i] - safe_m) : 0.f;
        sg[i] = p;
        sum += p;
      }
      const float c = isfinite(m_run) ? expf(m_run - safe_m) : 0.f;
      cr[lane] = c;
      l_run = c * l_run + sum;
      m_run = m_new;
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int e = lane + 32 * i;
      if (e < GDs) {
        const int g = e / HD, d = e % HD;
        const float* pg = sc + g * SPW;
        const float* vd = reinterpret_cast<const float*>(vs + SPW * warp *
                                                         R::ROW) + d;
        float a = acc[i] * cr[g];
#pragma unroll
        for (int jj = 0; jj < SPW; ++jj)
          a = fmaf(pg[jj], vd[jj * (R::ROW / 4)], a);
        acc[i] = a;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  MergeBuf mb(smem, G * HD, G);
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int e = lane + 32 * i;
    if (e < GDs) mb.acc[warp * G * HD + g0 * HD + e] = acc[i];
  }
  if (lane < Gs) {
    mb.m[warp * G + g0 + lane] = m_run;
    mb.l[warp * G + g0 + lane] = l_run;
  }
}

// Dynamic shared memory of an instantiation: the walk's (the ring, then
// bf16's P^T buffers or float32's q, scores and corrections), then the
// cluster merge's receive buffer (parts [n][ceil(GD / n)], then their
// (M, lsum) [n][2 G], for at most WQ * SH heads).
template <typename T, int HD, int SH, int WQ>
struct Smem {
  static constexpr int NT = WQ * DA_SET_THREADS;
  static constexpr int WALK =
      Ring<T, HD>::BYTES +
      (sizeof(T) == 2 ? (NT / 32) * Bf16Cfg<HD, SH>::PS_WARP
                      : 4 * (WQ * SH * HD +
                             (NT / 32) * (F32Cfg<HD, SH>::SC + 32)));
  static constexpr int RECV =
      4 * (WQ * SH * HD + DA_MAX_CLUSTER + 2 * DA_MAX_CLUSTER * WQ * SH);
  static constexpr int BYTES = WALK + RECV;
};

// ---------------------------------------------------------------------------
// the kernel: walk, merge the warps, merge the splits
// ---------------------------------------------------------------------------
// Parts j = 0..n-1 of query g, with m at m[j * stride + g] and l at
// l[j * stride + g]: M = max_j m_j, each m_j replaced in place by its
// weight w_j = exp(m_j - M) (0 for a part with no valid slot), and
// lsum = sum_j w_j l_j, in part order. The merged output is then
// sum_j w_j acc_j / max(lsum, 1e-30).
__device__ __forceinline__ void lse_weights(float* m, const float* l,
                                            int stride, int n, int g,
                                            float& M, float& lsum) {
  M = -INFINITY;
  for (int j = 0; j < n; ++j) M = fmaxf(M, m[j * stride + g]);
  const float safe = isfinite(M) ? M : 0.f;
  lsum = 0.f;
  for (int j = 0; j < n; ++j) {
    const float mj = m[j * stride + g];
    const float w = isfinite(mj) ? expf(mj - safe) : 0.f;
    m[j * stride + g] = w;
    lsum = fmaf(w, l[j * stride + g], lsum);
  }
}

// What a launch holds for every block (passed by value).
struct DaKernelArgs {
  long long ksb, ksl, ksh, vsb, vsl, vsh;
  float* ws;
  int* tickets;
  int H, G_kv, gpb, L, split_len, n_split, cluster, window;
  float scale;
};

// The cluster merge, block j of n: where its part's element e goes
// (block i = owner(e) merges [e0(i), e0(i + 1)), e0(i) = i GD / n), and
// the receive buffer of each block: parts' elements [n][P], P =
// ceil(GD / n), then their (M, lsum) [n][2 G].
__device__ __forceinline__ int merge_lo(int i, int GD, int n) {
  return i * GD / n;
}
__device__ __forceinline__ int merge_owner(int e, int GD, int n) {
  return ((e + 1) * n + GD - 1) / GD - 1;
}

// After every block has pushed its part into the receive buffers and the
// cluster barrier: block j merges its elements of the n parts in part
// order, with lse_weights' arithmetic; block 0 writes ml.
template <int NT>
__device__ __forceinline__ void cluster_merge(const MergeBuf& mb,
                                              const float* recv, int G,
                                              int HD, int n, int j,
                                              float* out, float* ml,
                                              size_t row0) {
  const int tid = threadIdx.x, GD = G * HD, P = (GD + n - 1) / n;
  const float* rml = recv + n * P;
  if (tid < G) {
    float M = -INFINITY;
#pragma unroll
    for (int i = 0; i < DA_MAX_CLUSTER; ++i)
      if (i < n) M = fmaxf(M, rml[i * 2 * G + tid]);
    const float safe = isfinite(M) ? M : 0.f;
    float lsum = 0.f;
#pragma unroll
    for (int i = 0; i < DA_MAX_CLUSTER; ++i)
      if (i < n) {
        const float mi = rml[i * 2 * G + tid];
        const float w = isfinite(mi) ? expf(mi - safe) : 0.f;
        mb.w[i * G + tid] = w;
        lsum = fmaf(w, rml[i * 2 * G + G + tid], lsum);
      }
    mb.lf[tid] = lsum;
    if (ml && j == 0) {
      ml[2 * (row0 + tid)] = M;
      ml[2 * (row0 + tid) + 1] = lsum;
    }
  }
  __syncthreads();
  const int e0 = merge_lo(j, GD, n), e1 = merge_lo(j + 1, GD, n);
  for (int e = e0 + tid; e < e1; e += NT) {
    const int g = e / HD;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < DA_MAX_CLUSTER; ++i)
      if (i < n) s = fmaf(mb.w[i * G + g], recv[i * P + e - e0], s);
    out[row0 * HD + e] = ml ? s : s / fmaxf(mb.lf[g], 1e-30f);
  }
}

// Workspace of the ticket path per (b, kvh, group): n_split parts of
// stride gpb * HD + 2 gpb, each acc [Gb][HD], then m [Gb], l [Gb] for
// the group's Gb heads.
template <typename T, int HD, int SH, int WQ>
__global__ void __launch_bounds__(WQ * DA_SET_THREADS, WQ == 1 ? 2 : 1)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ positions,
                        float* __restrict__ out, float* __restrict__ ml,
                        const DaKernelArgs a) {
  constexpr int NT = WQ * DA_SET_THREADS;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int last;
  const int split = blockIdx.x, b = blockIdx.z;
  const int n_grp = (a.G_kv + a.gpb - 1) / a.gpb;
  const int kvh = blockIdx.y / n_grp, gb = (blockIdx.y % n_grp) * a.gpb;
  const int G = min(a.gpb, a.G_kv - gb);          // this block's heads
  const int tid = threadIdx.x, GD = G * HD;
  const int n_split = a.n_split;
  const int lo = split * a.split_len;
  const Range r(lo, min(a.L, lo + a.split_len), positions[b], a.window, a.L);

  // first head of the block, and the heads of this thread's warp set
  const size_t row0 = (size_t)b * a.H + (size_t)kvh * a.G_kv + gb;
  const int g0 = (tid / DA_SET_THREADS) * SH;
  const int Gs = min(SH, G - g0);
  const T* kb = k + b * a.ksb + kvh * a.ksh;
  const T* vb = v + b * a.vsb + kvh * a.vsh;
  if constexpr (sizeof(T) == 2)
    bf16_walk<HD, SH, NT>(smem, q + (row0 + g0) * HD, kb, vb, a.ksl, a.vsl,
                          r, G, g0, Gs, a.scale);
  else
    f32_walk<HD, SH, NT>(smem, q + row0 * HD, kb, vb, a.ksl, a.vsl, r, G, g0,
                         Gs, a.scale);
  __syncthreads();

  // merge the warps (fixed order) into the block's part
  const MergeBuf mb(smem, GD, G);
  if (tid < G) {
    float M, lsum;
    lse_weights(mb.m, mb.l, G, DA_WARPS, tid, M, lsum);
    mb.bml[tid] = M;
    mb.bml[G + tid] = lsum;
  }
  __syncthreads();
  if (n_split > 1 && a.cluster > 1) {
    // push each element of the part to the block that merges it, and the
    // part's (M, lsum) to every block; one cluster barrier, then merge
    cg::cluster_group cluster = cg::this_cluster();
    const int j = (int)cluster.block_rank(), P = (GD + n_split - 1) / n_split;
    float* recv = reinterpret_cast<float*>(smem + Smem<T, HD, SH, WQ>::WALK);
    if (tid < 2 * G)
      for (int i = 0; i < n_split; ++i)
        cluster.map_shared_rank(recv + n_split * P, i)[j * 2 * G + tid] =
            mb.bml[tid];
    for (int e = tid; e < GD; e += NT) {
      const int g = e / HD, i = merge_owner(e, GD, n_split);
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < DA_WARPS; ++w)
        s = fmaf(mb.m[w * G + g], mb.acc[w * GD + e], s);
      cluster.map_shared_rank(recv, i)[j * P + e - merge_lo(i, GD, n_split)] =
          s;
    }
    cluster.sync();
    cluster_merge<NT>(mb, recv, G, HD, n_split, j, out, ml, row0);
    return;
  }
  const size_t pair = (size_t)b * gridDim.y + blockIdx.y;
  const int part = a.gpb * HD + 2 * a.gpb;
  float* wp = n_split > 1 ? a.ws + (pair * n_split + split) * part : nullptr;
  for (int e = tid; e < GD; e += NT) {
    const int g = e / HD;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < DA_WARPS; ++w)
      s = fmaf(mb.m[w * G + g], mb.acc[w * GD + e], s);
    if (n_split == 1) {
      out[row0 * HD + e] = ml ? s : s / fmaxf(mb.bml[G + g], 1e-30f);
    } else {
      wp[e] = s;
      if (e % HD == 0) {
        wp[GD + g] = mb.bml[g];
        wp[GD + G + g] = mb.bml[G + g];
      }
    }
  }
  if (n_split == 1) {
    if (ml && tid < G) {
      ml[2 * (row0 + tid)] = mb.bml[tid];
      ml[2 * (row0 + tid) + 1] = mb.bml[G + tid];
    }
    return;
  }

  // the last block of (b, kvh, group) to arrive merges the parts
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.tickets + pair, 1) == n_split - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* wq = a.ws + pair * n_split * part;
  float* ms = reinterpret_cast<float*>(smem);     // [n_split][2 G]
  float* lf = ms + n_split * 2 * G;               // [G]
  for (int i = tid; i < n_split * 2 * G; i += NT)
    ms[i] = __ldcg(wq + (i / (2 * G)) * part + GD + i % (2 * G));
  __syncthreads();
  if (tid < G) {
    float M;
    lse_weights(ms, ms + G, 2 * G, n_split, tid, M, lf[tid]);
    if (ml) {
      ml[2 * (row0 + tid)] = M;
      ml[2 * (row0 + tid) + 1] = lf[tid];
    }
  }
  __syncthreads();
  for (int e = tid; e < GD; e += NT) {
    const int g = e / HD;
    float s = 0.f;
    for (int j = 0; j < n_split; ++j)
      s = fmaf(ms[j * 2 * G + g], __ldcg(wq + j * part + e), s);
    out[row0 * HD + e] = ml ? s : s / fmaxf(lf[g], 1e-30f);
  }
  if (tid == 0) a.tickets[pair] = 0;              // ready for the next call
}

// The kernel's dynamic shared memory set once per instantiation.
template <typename T, int HD, int SH, int WQ>
static cudaError_t prepare() {
  static cudaError_t done = cudaErrorNotReady;
  if (done == cudaErrorNotReady)
    done = cudaFuncSetAttribute(decode_attention_kernel<T, HD, SH, WQ>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                Smem<T, HD, SH, WQ>::BYTES);
  return done;
}

// What the wrapper fixes per call shape (kept by it between calls, and
// passed by pointer).
struct DaArgs {
  long long ksb, ksl, ksh, vsb, vsl, vsh;
  float* ws;
  int* tickets;
  int B, H, KV, hd, gpb, sh, wq, L, split_len, n_split, cluster, window,
      dtype;
};

template <typename T, int HD, int SH, int WQ>
static int launch(const DaArgs& d, const void* q, const void* k,
                  const void* v, const int* positions, float* out, float* ml,
                  cudaStream_t stream) {
  const int G = d.H / d.KV, n_grp = (G + d.gpb - 1) / d.gpb;
  if (d.gpb > WQ * SH || (long long)d.KV * n_grp > 65535)
    return (int)cudaErrorInvalidValue;
  // the merge buffers and the parts' (m, l) reuse the ring
  if (MergeBuf::bytes(d.gpb * HD, d.gpb) > Ring<T, HD>::BYTES ||
      4 * (d.n_split * 2 * d.gpb + d.gpb) > Ring<T, HD>::BYTES)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = prepare<T, HD, SH, WQ>();
  if (e != cudaSuccess) return (int)e;
  DaKernelArgs a;
  a.ksb = d.ksb; a.ksl = d.ksl; a.ksh = d.ksh;
  a.vsb = d.vsb; a.vsl = d.vsl; a.vsh = d.vsh;
  a.ws = d.ws; a.tickets = d.tickets;
  a.H = d.H; a.G_kv = G; a.gpb = d.gpb; a.L = d.L;
  a.split_len = d.split_len; a.n_split = d.n_split; a.cluster = d.cluster;
  a.window = d.window; a.scale = 1.0f / sqrtf((float)HD);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(d.n_split, d.KV * n_grp, d.B);
  cfg.blockDim = dim3(WQ * DA_SET_THREADS);
  cfg.dynamicSmemBytes = Smem<T, HD, SH, WQ>::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = d.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = d.cluster > 1 ? 1 : 0;
  const cudaError_t le = cudaLaunchKernelEx(
      &cfg, decode_attention_kernel<T, HD, SH, WQ>,
      reinterpret_cast<const T*>(q), reinterpret_cast<const T*>(k),
      reinterpret_cast<const T*>(v), positions, out, ml, a);
  return le != cudaSuccess ? (int)le : (int)cudaGetLastError();
}

// Blocks of one instantiation resident on an SM, and clusters of 8 of
// them resident on the card, as the runtime counts them.
template <typename T, int HD, int SH, int WQ>
static int occupancy(int* blocks, int* clusters8) {
  const cudaError_t e = prepare<T, HD, SH, WQ>();
  if (e != cudaSuccess) return (int)e;
  const int smem = Smem<T, HD, SH, WQ>::BYTES;
  cudaError_t o = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, decode_attention_kernel<T, HD, SH, WQ>, WQ * DA_SET_THREADS,
      smem);
  if (o != cudaSuccess) return (int)o;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(DA_MAX_CLUSTER, 1, 1);
  cfg.blockDim = dim3(WQ * DA_SET_THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = DA_MAX_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(
      clusters8, decode_attention_kernel<T, HD, SH, WQ>, &cfg);
}

// One instantiation per (dtype, hd, heads a warp set takes, warp sets):
// bf16 takes a set of 8 heads or of max(8, 1024 / hd), and 2 sets of 8
// at hd 256; float32 a set of max(8, 1024 / hd), and 2 of 8 at hd 256.
#define DA_KEY(HD, SH, WQ) ((HD) * 1000 + (SH) * 10 + (WQ))
#define DA_CASE(T, FN, HD, SH, WQ, ...) \
  case DA_KEY(HD, SH, WQ): return FN<T, HD, SH, WQ>(__VA_ARGS__);
#define DA_DISPATCH(FN, ...)                                        \
  if (dtype == 1) {                                                 \
    switch (DA_KEY(hd, sh, wq)) {                                   \
      DA_CASE(__nv_bfloat16, FN, 32, 8, 1, __VA_ARGS__)             \
      DA_CASE(__nv_bfloat16, FN, 32, 32, 1, __VA_ARGS__)            \
      DA_CASE(__nv_bfloat16, FN, 64, 8, 1, __VA_ARGS__)             \
      DA_CASE(__nv_bfloat16, FN, 64, 16, 1, __VA_ARGS__)            \
      DA_CASE(__nv_bfloat16, FN, 128, 8, 1, __VA_ARGS__)            \
      DA_CASE(__nv_bfloat16, FN, 256, 8, 1, __VA_ARGS__)            \
      DA_CASE(__nv_bfloat16, FN, 256, 8, 2, __VA_ARGS__)            \
    }                                                               \
  } else if (dtype == 0) {                                          \
    switch (DA_KEY(hd, sh, wq)) {                                   \
      DA_CASE(float, FN, 32, 32, 1, __VA_ARGS__)                    \
      DA_CASE(float, FN, 64, 16, 1, __VA_ARGS__)                    \
      DA_CASE(float, FN, 128, 8, 1, __VA_ARGS__)                    \
      DA_CASE(float, FN, 256, 8, 1, __VA_ARGS__)                    \
      DA_CASE(float, FN, 256, 8, 2, __VA_ARGS__)                    \
    }                                                               \
  }

// q [B, H, hd] contiguous; k / v [B, L, KV, hd] with element strides
// (batch, slot, head) in a->ksb.. and innermost stride 1; positions [B]
// int32; out [B, H, hd] float32. a->gpb query heads per block (n_grp =
// ceil(G / gpb) groups per KV head, G = H / KV) in a->wq warp sets of
// a->sh heads (an instantiation of DA_DISPATCH); a->cluster: 1, or
// n_split (<= 8) for the
// cluster merge; with cluster 1 and n_split > 1, a->ws float32 [B, KV,
// n_grp, n_split, gpb * hd + 2 gpb] scratch and a->tickets int32 [B, KV,
// n_grp], all 0 before the first call (every call leaves them 0). ml:
// null, or float32 [B, H, 2] for the partial result of a shard of a
// cache: each row's max score m and sum l of exp(s - m), with out then
// holding the unnormalised sum_l exp(s - m) cast_T(p) v (no division by
// l). dtype: 0 = float32, 1 = bfloat16. hd must be 32, 64, 128 or 256,
// split_len a multiple of 64 with (n_split - 1) * split_len < L <=
// n_split * split_len.
extern "C" int decode_attention_run(const DaArgs* a, const void* q,
                                    const void* k, const void* v,
                                    const int* positions, float* out,
                                    float* ml, cudaStream_t stream) {
  const int hd = a->hd, sh = a->sh, wq = a->wq, dtype = a->dtype;
  if (a->B <= 0 || a->KV <= 0 || a->H % a->KV || a->L <= 0 ||
      a->window < 0 || a->gpb <= 0 || a->gpb > a->H / a->KV ||
      a->split_len <= 0 || a->split_len % DA_TILE ||
      (long long)a->n_split * a->split_len < a->L ||
      (long long)(a->n_split - 1) * a->split_len >= a->L || a->B > 65535 ||
      (a->cluster != 1 &&
       (a->cluster != a->n_split || a->cluster > DA_MAX_CLUSTER)) ||
      (a->cluster == 1 && a->n_split > 1 && (!a->ws || !a->tickets)))
    return (int)cudaErrorInvalidValue;
  DA_DISPATCH(launch, *a, q, k, v, positions, out, ml, stream)
  return (int)cudaErrorInvalidValue;
}

// blocks: the kernel's blocks resident on one SM for (dtype, hd, sh, wq);
// clusters8: clusters of 8 such blocks resident on the card.
extern "C" int decode_attention_occupancy(int dtype, int hd, int sh, int wq,
                                          int* blocks, int* clusters8) {
  DA_DISPATCH(occupancy, blocks, clusters8)
  return (int)cudaErrorInvalidValue;
}
