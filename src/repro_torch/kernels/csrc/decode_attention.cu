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
// zeros). Output is float32 [B, H, hd].
//
// What bounds it on the H100: bytes. Each K/V element read feeds 2 * G
// multiply-adds, far below the card's ~295 bf16 operations per byte, so
// the least time is the K/V rows the call needs over 3.35 TB/s. With
// window == 0 a row needs only slots <= pos, and no other slot is read.
// Llama-4's decode shape (B 4, KV 8, hd 128, bf16) costs 4096 bytes of
// K + V per slot: 16.8 MB (5.0 us) at L 1024, 537 MB (160 us) at 32768.
//
// Design.
//  * Split L across blocks, combine in the same launch. Grid (n_split,
//    KV, B); a block walks slots [lo, lo + split_len) of one (b, kvh) in
//    64-slot tiles. Each block merges its warps' (m, l, acc) and writes
//    the merged partial to a workspace, then takes a ticket from a
//    per-(b, kvh) counter; the block that arrives last merges the
//    n_split partials by log-sum-exp weights in split order (0, 1, ...),
//    writes the output and sets the counter back to 0 for the next call.
//    So a call is one launch, and the order of every sum is fixed by the
//    shapes alone: repeated calls are bit-identical. n_split == 1 writes
//    the output directly.
//  * Bytes in flight: K and V tiles stay in their own type in shared
//    memory, brought in by 16-byte cp.async.cg copies through a ring of
//    stages (bf16: 3 stages of 32 KB at hd 128, two blocks per SM, so
//    ~128 KB in flight per SM). A slot the block must not use (past L,
//    past pos, or masked by the ring rule) is zero-filled by the copy's
//    src-size 0 form and never read from memory, so a NaN in a stale
//    slot cannot reach a product; its score is also set to -inf.
//  * bf16 on the tensor cores (mma.sync.m16n8k16, f32 accumulation),
//    swap-AB: warp w takes slots [16 w, 16 w + 16) of each tile and keeps
//    its own online-softmax state. Scores S^T [16 slots x 8 queries] =
//    K . Q^T, K from ldmatrix (K rows are the A operand as stored), Q^T
//    held in registers for the whole block (queries padded to a multiple
//    of 8; pad queries score -inf and are never written). Even and odd
//    k-steps go to two accumulators, and the exp is the fast __expf:
//    the block's speed is set by this per-tile chain (scores, max, exp,
//    P^T, P.V), not by the copies, so it is kept short. The max over
//    slots is a lane shuffle within the warp; each lane keeps its own
//    share of l and the lanes' shares are summed once, at the end of
//    the walk. p is rounded to
//    bf16 (the TPU kernel's cast before p . v) and passed through a
//    small warp-private buffer into the B operand of O^T [hd x 8] +=
//    V^T . P^T, with V^T from ldmatrix.trans. K/V rows are XOR-swizzled
//    in 16-byte chunks, so ldmatrix reads without bank conflicts.
//  * float32 keeps CUDA-core FMAs in full f32 (no TF32), on the same
//    pipelined tiles (2 stages, rows padded by 16 bytes): one lane per
//    (slot, half of hd) for the scores, lane g for the softmax of query
//    g, and 32 accumulator elements per lane.
//  * Strides of K and V are passed in (batch, slot, head), so a view of
//    a stacked cache is read in place; the innermost stride must be 1,
//    the other strides multiples of 16 bytes and the base 16-byte
//    aligned (the wrapper checks).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#define DA_THREADS 128
#define DA_WARPS (DA_THREADS / 32)
#define DA_TILE 64            // cache slots per stage: 16 per warp
#define DA_MAX_GD 1024        // G * hd per block

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
// HD: a stage holds DA_TILE K rows, then DA_TILE V rows. bf16 rows are
// unpadded with 16-byte chunk c of row r at c ^ swz(r); float32 rows are
// padded by 16 bytes.
template <typename T, int HD>
struct Ring {
  static constexpr bool BF16 = sizeof(T) == 2;
  static constexpr int CH = HD * (int)sizeof(T) / 16;   // chunks per row
  static constexpr int ROW = HD * (int)sizeof(T) + (BF16 ? 0 : 16);
  static constexpr int TILE_BYTES = DA_TILE * ROW;
  static constexpr int STAGE = 2 * TILE_BYTES;
  static constexpr int STAGES = BF16 ? 3 : 2;
  static constexpr int BYTES = STAGES * STAGE;
  __device__ static int chunk_at(int r, int c) {
    if (!BF16) return c;
    return CH >= 8 ? c ^ (r & 7) : c ^ ((r >> 1) & 3);
  }
  __device__ static int offset(int r, int c) {
    return r * ROW + (chunk_at(r, c) << 4);
  }
};

// What a block walks: slots [lo, hi) of (b, kvh).
struct Range {
  int lo, hi, pos, window;
};

// Issue the copies of tile `t` into ring stage `st` (zero-filled where a
// slot is not used).
template <typename T, int HD>
__device__ __forceinline__ void load_tile(unsigned char* st, const T* kb,
                                          const T* vb, long long ksl,
                                          long long vsl, const Range& r,
                                          int t) {
  using R = Ring<T, HD>;
  const int t0 = r.lo + t * DA_TILE;
#pragma unroll
  for (int c = threadIdx.x; c < 2 * DA_TILE * R::CH; c += DA_THREADS) {
    const int m = c / (DA_TILE * R::CH);           // 0: K, 1: V
    const int j = (c / R::CH) % DA_TILE, ch = c % R::CH;
    const int slot = t0 + j;
    const bool ok = slot < r.hi && slot_valid(slot, r.pos, r.window);
    const T* base = m ? vb : kb;
    const T* p = ok ? base + (m ? vsl : ksl) * slot + ch * (16 / sizeof(T))
                    : base;
    cp_async16(st + m * R::TILE_BYTES + R::offset(j, ch), p, ok ? 16 : 0);
  }
}

// Per-warp state handed to the block merge: acc [DA_WARPS][G][HD], then
// m and l [DA_WARPS][G], in the (already drained) ring.
struct MergeBuf {
  float* acc;
  float* m;
  float* l;
  __device__ MergeBuf(unsigned char* smem, int GD, int G) {
    acc = reinterpret_cast<float*>(smem);
    m = acc + DA_WARPS * GD;
    l = m + DA_WARPS * G;
  }
};

// ---------------------------------------------------------------------------
// bf16: tensor cores. NG query tiles of 8 (G <= 8 NG), HD / 16 k-steps.
// ---------------------------------------------------------------------------
template <int HD>
struct Bf16Cfg {
  static constexpr int NG = DA_MAX_GD / (8 * HD);   // 1, 2 or 4
  static constexpr int KS = HD / 16;
  static constexpr int PS_ROW = 24;                  // bf16 per P^T row
  static constexpr int PS_WARP = NG * 8 * PS_ROW * 2;  // bytes per warp
};

template <int HD>
__device__ __forceinline__ void bf16_walk(
    unsigned char* smem, const __nv_bfloat16* qb, const __nv_bfloat16* kb,
    const __nv_bfloat16* vb, long long ksl, long long vsl, const Range& r,
    int G, float scale) {
  using R = Ring<__nv_bfloat16, HD>;
  using C = Bf16Cfg<HD>;
  constexpr int NG = C::NG, KS = C::KS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(
      smem + R::BYTES + warp * C::PS_WARP);

  // Q^T as B operands: query 8 ng + gq, hd 16 kk + 2 t4 (+1) and +8
  uint32_t qf[NG][KS][2];
#pragma unroll
  for (int ng = 0; ng < NG; ++ng) {
    const int g = 8 * ng + gq;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        qf[ng][kk][h] = g < G ? *reinterpret_cast<const uint32_t*>(
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
  const int n_tiles = r.hi > r.lo ? (r.hi - r.lo + DA_TILE - 1) / DA_TILE : 0;

#pragma unroll 1
  for (int p = 0; p < R::STAGES - 1; ++p) {
    if (p < n_tiles)
      load_tile<__nv_bfloat16, HD>(smem + p * R::STAGE, kb, vb, ksl, vsl, r,
                                   p);
    cp_async_commit();
  }
#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<R::STAGES - 2>();
    __syncthreads();
    if (t + R::STAGES - 1 < n_tiles)
      load_tile<__nv_bfloat16, HD>(
          smem + ((t + R::STAGES - 1) % R::STAGES) * R::STAGE, kb, vb, ksl,
          vsl, r, t + R::STAGES - 1);
    cp_async_commit();

    const unsigned char* ks = smem + (t % R::STAGES) * R::STAGE;
    const unsigned char* vs = ks + R::TILE_BYTES;
    const int s0 = r.lo + t * DA_TILE + 16 * warp;   // the warp's slots
    if (s0 >= r.hi) continue;                        // none in range
    // scores S^T [16 slots x 8 queries] per query tile, even and odd
    // k-steps in two accumulators (half the dependent chain)
    float s[NG][4], s2[NG][4];
#pragma unroll
    for (int ng = 0; ng < NG; ++ng)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[ng][c] = s2[ng][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, ks + R::offset(k_row, 2 * kk + k_ch));
#pragma unroll
      for (int ng = 0; ng < NG; ++ng)
        mma_bf16(kk & 1 ? s2[ng] : s[ng], a, qf[ng][kk][0], qf[ng][kk][1]);
    }
    bool ok[2];
#pragma unroll
    for (int y = 0; y < 2; ++y) {
      const int slot = s0 + gq + 8 * y;
      ok[y] = slot < r.hi && slot_valid(slot, r.pos, r.window);
    }
    // online softmax per query column g = 8 ng + 2 t4 + x; the max is
    // shared by the column's lanes, l is kept per lane (its own slots)
    // and summed over the lanes once, after the walk
    float corr[NG][2];
#pragma unroll
    for (int ng = 0; ng < NG; ++ng) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const bool real = 8 * ng + 2 * t4 + x < G;
        float sc[2], mb = -INFINITY;
#pragma unroll
        for (int y = 0; y < 2; ++y) {
          const float dot = s[ng][2 * y + x] + s2[ng][2 * y + x];
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
          s[ng][2 * y + x] = p;
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
            __float2bfloat16_rn(s[ng][c]);
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
      if (g < G) {
#pragma unroll
        for (int mt = 0; mt < KS; ++mt)
          mb.acc[(warp * G + g) * HD + 16 * mt + gq + 8 * (c >> 1)] =
              acc[mt][ng][c];
        if (gq == 0 && c < 2) {
          mb.m[warp * G + g] = m_run[ng][c];
          mb.l[warp * G + g] = l_run[ng][c];
        }
      }
    }
}

// ---------------------------------------------------------------------------
// float32: CUDA-core FMAs in full f32
// ---------------------------------------------------------------------------
template <int HD>
__device__ __forceinline__ void f32_walk(unsigned char* smem, const float* qb,
                                         const float* kb, const float* vb,
                                         long long ksl, long long vsl,
                                         const Range& r, int G, float scale) {
  using R = Ring<float, HD>;
  constexpr int ACC = DA_MAX_GD / 32;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int GD = G * HD;
  float* qs = reinterpret_cast<float*>(smem + R::BYTES);      // [G][HD]
  float* sc = qs + DA_MAX_GD + warp * 32 * 16;                 // [G][16]
  float* cr = qs + DA_MAX_GD + DA_WARPS * 32 * 16 + warp * 32;  // [G]
  for (int i = tid; i < GD; i += DA_THREADS) qs[i] = qb[i];
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;       // lane g's query
  const int j = lane & 15, half = lane >> 4;
  const int n_tiles = r.hi > r.lo ? (r.hi - r.lo + DA_TILE - 1) / DA_TILE : 0;

#pragma unroll 1
  for (int p = 0; p < R::STAGES - 1; ++p) {
    if (p < n_tiles)
      load_tile<float, HD>(smem + p * R::STAGE, kb, vb, ksl, vsl, r, p);
    cp_async_commit();
  }
#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<R::STAGES - 2>();
    __syncthreads();
    if (t + R::STAGES - 1 < n_tiles)
      load_tile<float, HD>(smem + ((t + R::STAGES - 1) % R::STAGES) *
                                      R::STAGE,
                           kb, vb, ksl, vsl, r, t + R::STAGES - 1);
    cp_async_commit();

    const int s0 = r.lo + t * DA_TILE + 16 * warp;
    if (s0 >= r.hi) continue;
    const unsigned char* ks = smem + (t % R::STAGES) * R::STAGE;
    const unsigned char* vs = ks + R::TILE_BYTES;
    const int slot = s0 + j;
    const bool ok = slot < r.hi && slot_valid(slot, r.pos, r.window);
    const float4* kr = reinterpret_cast<const float4*>(
        ks + (16 * warp + j) * R::ROW) + half * (HD / 8);
    __syncwarp();
    for (int g = 0; g < G; ++g) {
      const float4* qr =
          reinterpret_cast<const float4*>(qs + g * HD) + half * (HD / 8);
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) {
        const float4 a = qr[c], b = kr[c];
        dot = fmaf(a.x, b.x, dot);
        dot = fmaf(a.y, b.y, dot);
        dot = fmaf(a.z, b.z, dot);
        dot = fmaf(a.w, b.w, dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 16);
      if (half == 0) sc[g * 16 + j] = ok ? dot * scale : -INFINITY;
    }
    __syncwarp();
    if (lane < G) {                  // lane g: the softmax of query g
      float* sg = sc + lane * 16;
      float mb = -INFINITY;
#pragma unroll
      for (int i = 0; i < 16; ++i) mb = fmaxf(mb, sg[i]);
      const float m_new = fmaxf(m_run, mb);
      const float safe_m = isfinite(m_new) ? m_new : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
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
      if (e < GD) {
        const int g = e / HD, d = e % HD;
        const float* pg = sc + g * 16;
        const float* vd = reinterpret_cast<const float*>(vs + 16 * warp *
                                                         R::ROW) + d;
        float a = acc[i] * cr[g];
#pragma unroll
        for (int jj = 0; jj < 16; ++jj)
          a = fmaf(pg[jj], vd[jj * (R::ROW / 4)], a);
        acc[i] = a;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  MergeBuf mb(smem, GD, G);
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int e = lane + 32 * i;
    if (e < GD) mb.acc[warp * GD + e] = acc[i];
  }
  if (lane < G) {
    mb.m[warp * G + lane] = m_run;
    mb.l[warp * G + lane] = l_run;
  }
}

// ---------------------------------------------------------------------------
// the kernel: walk, merge the warps, merge the splits (last block)
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

// Workspace per (b, kvh): n_split parts of acc [G][HD], then m [G], l [G].
template <typename T, int HD>
__global__ void __launch_bounds__(DA_THREADS, 2)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ positions,
                        float* __restrict__ ws, int* __restrict__ tickets,
                        float* __restrict__ out, int H, int G, int L,
                        int split_len, int n_split, int window, float scale,
                        long long ksb, long long ksl, long long ksh,
                        long long vsb, long long vsl, long long vsh) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int last;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int KV = gridDim.y, tid = threadIdx.x, GD = G * HD;
  Range r;
  r.pos = positions[b];
  r.window = window;
  r.lo = split * split_len;
  r.hi = min(L, r.lo + split_len);
  if (window == 0) r.hi = min(r.hi, r.pos + 1);   // masked slots not read

  const size_t row0 = (size_t)b * H + (size_t)kvh * G;   // first head
  const T* qb = q + row0 * HD;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;
  if constexpr (sizeof(T) == 2)
    bf16_walk<HD>(smem, qb, kb, vb, ksl, vsl, r, G, scale);
  else
    f32_walk<HD>(smem, qb, kb, vb, ksl, vsl, r, G, scale);
  __syncthreads();

  // merge the warps (fixed order) into the block's part
  const MergeBuf mb(smem, GD, G);
  float* bml = mb.l + DA_WARPS * G;               // [2][G]: M, lsum
  if (tid < G) {
    float M, lsum;
    lse_weights(mb.m, mb.l, G, DA_WARPS, tid, M, lsum);
    bml[tid] = M;
    bml[G + tid] = lsum;
  }
  __syncthreads();
  const size_t pair = (size_t)b * KV + kvh;
  const int part = GD + 2 * G;
  float* wp = ws + (pair * n_split + split) * part;
  for (int e = tid; e < GD; e += DA_THREADS) {
    const int g = e / HD;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < DA_WARPS; ++w)
      a = fmaf(mb.m[w * G + g], mb.acc[w * GD + e], a);
    if (n_split == 1) {
      out[row0 * HD + e] = a / fmaxf(bml[G + g], 1e-30f);
    } else {
      wp[e] = a;
      if (e % HD == 0) {
        wp[GD + g] = bml[g];
        wp[GD + G + g] = bml[G + g];
      }
    }
  }
  if (n_split == 1) return;

  // the last block of (b, kvh) to arrive merges the parts
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + pair, 1) == n_split - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* wq = ws + pair * n_split * part;
  float* ms = reinterpret_cast<float*>(smem);     // [n_split][2 G]
  float* lf = ms + n_split * 2 * G;               // [G]
  for (int i = tid; i < n_split * 2 * G; i += DA_THREADS)
    ms[i] = __ldcg(wq + (i / (2 * G)) * part + GD + i % (2 * G));
  __syncthreads();
  if (tid < G) {
    float M;
    lse_weights(ms, ms + G, 2 * G, n_split, tid, M, lf[tid]);
  }
  __syncthreads();
  for (int e = tid; e < GD; e += DA_THREADS) {
    const int g = e / HD;
    float a = 0.f;
    for (int j = 0; j < n_split; ++j)
      a = fmaf(ms[j * 2 * G + g], __ldcg(wq + j * part + e), a);
    out[row0 * HD + e] = a / fmaxf(lf[g], 1e-30f);
  }
  if (tid == 0) tickets[pair] = 0;                // ready for the next call
}

template <typename T, int HD>
static int smem_bytes() {
  const int ring = Ring<T, HD>::BYTES;
  if (sizeof(T) == 2) return ring + DA_WARPS * Bf16Cfg<HD>::PS_WARP;
  return ring + 4 * (DA_MAX_GD + DA_WARPS * 32 * 16 + DA_WARPS * 32);
}

template <typename T, int HD>
static int launch(const void* q, const void* k, const void* v,
                  const int* positions, float* ws, int* tickets, float* out,
                  int B, int H, int KV, int L, int split_len, int n_split,
                  int window, long long ksb, long long ksl, long long ksh,
                  long long vsb, long long vsl, long long vsh,
                  cudaStream_t stream) {
  const int G = H / KV;
  const int smem = smem_bytes<T, HD>();
  // the merge buffers and the parts' (m, l) reuse the ring
  const int merge = 4 * (DA_WARPS * (G * HD + 2 * G) + 2 * G);
  if (merge > Ring<T, HD>::BYTES ||
      4 * (n_split * 2 * G + G) > Ring<T, HD>::BYTES)
    return (int)cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attention_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const dim3 grid(n_split, KV, B);
  decode_attention_kernel<T, HD><<<grid, DA_THREADS, smem, stream>>>(
      reinterpret_cast<const T*>(q), reinterpret_cast<const T*>(k),
      reinterpret_cast<const T*>(v), positions, ws, tickets, out, H, G, L,
      split_len, n_split, window, 1.0f / sqrtf((float)HD), ksb, ksl, ksh,
      vsb, vsl, vsh);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_hd(int hd, const void* q, const void* k, const void* v,
                     const int* positions, float* ws, int* tickets,
                     float* out, int B, int H, int KV, int L, int split_len,
                     int n_split, int window, long long ksb, long long ksl,
                     long long ksh, long long vsb, long long vsl,
                     long long vsh, cudaStream_t stream) {
#define DA_LAUNCH(HD)                                                        \
  launch<T, HD>(q, k, v, positions, ws, tickets, out, B, H, KV, L,           \
                split_len, n_split, window, ksb, ksl, ksh, vsb, vsl, vsh,    \
                stream)
  switch (hd) {
    case 32: return DA_LAUNCH(32);
    case 64: return DA_LAUNCH(64);
    case 128: return DA_LAUNCH(128);
  }
#undef DA_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// q [B, H, hd] contiguous; k / v [B, L, KV, hd] with element strides
// (batch, slot, head) and innermost stride 1; positions [B] int32; ws
// float32 [B, KV, n_split, G * hd + 2 G] scratch and tickets int32
// [B, KV], all 0 before the first call (every call leaves them 0);
// out [B, H, hd] float32. dtype: 0 = float32, 1 = bfloat16. hd must be
// 32, 64 or 128, G * hd <= 1024, split_len a multiple of 64 with
// (n_split - 1) * split_len < L <= n_split * split_len.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const int* positions,
    float* ws, int* tickets, float* out, int B, int H, int KV, int hd,
    int L, int split_len, int n_split, int window, long long ksb,
    long long ksl, long long ksh, long long vsb, long long vsl,
    long long vsh, int dtype, cudaStream_t stream) {
  if (B <= 0 || KV <= 0 || H % KV || L <= 0 || window < 0 ||
      (H / KV) * hd > DA_MAX_GD || split_len <= 0 || split_len % DA_TILE ||
      (long long)n_split * split_len < L ||
      (long long)(n_split - 1) * split_len >= L || B > 65535 || KV > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, positions, ws, tickets, out,
                                    B, H, KV, L, split_len, n_split, window,
                                    ksb, ksl, ksh, vsb, vsl, vsh, stream);
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, positions, ws, tickets, out, B, H,
                            KV, L, split_len, n_split, window, ksb, ksl, ksh,
                            vsb, vsl, vsh, stream);
  return (int)cudaErrorInvalidValue;
}
