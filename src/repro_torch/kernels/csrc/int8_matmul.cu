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
// Layout. The weight is read K-major: w_q [K, N] is the transposed view of
// an [N, K] row-major tensor (the port's QTensor stores it so), so both
// operands have K contiguous, the only form in which the 8-bit tensor-core
// instructions take them from shared memory.
//
// Three variants, chosen by shape alone (int8_matmul/kernel.py's plan):
//  * wide (M > 64; K % 16 == 0, 16-byte aligned bases): 128 x BN output
//    tiles, BN 128, 192 or 256, BK 128. One producer thread issues TMA
//    loads of A [128 x 128 B] and B [BN x 128 B] with a 128-byte swizzle
//    into a ring of about 200 KB (4, 5 or 6 stages) guarded by mbarriers;
//    two consumer warpgroups each run wgmma.m64nBNk32.s32.s8.s8 on 64 of
//    the rows, accumulating int32 in registers (setmaxnreg moves
//    registers from the producer to them), with one k-tile's products in
//    flight while the next is issued. 256 is the widest tile whose
//    accumulators fit the consumers' registers (170 int8 operations per
//    staged byte); the plan takes the width whose waves of one tile an SM
//    finish first: at M 512, N 18432, 192 gives three full waves of 384
//    tiles, where 256 leaves the third 18% full.
//  * decode (M <= 64, same alignment): swap A and B. A 64 x 128 B tile of
//    the weight is wgmma's A operand and the token rows, padded to NB = 8
//    or 64 by TMA's zero fill, the narrow B (m64nNBk32). One block streams
//    64 weight rows through a ring of 8 KB weight tiles (64 KB or less a
//    block, so three or four blocks share an SM). Where N gives fewer
//    than two blocks an SM, K is split (a function of the shapes): each
//    block writes its int32 partial sums to a workspace; the last block
//    of an n-tile to take a ticket adds the other splits' partials,
//    applies the epilogue and resets the ticket to 0 — one launch, no
//    memset. Integer sums are exact in any order.
//  * ragged (K % 16 != 0 or an unaligned base, where TMA cannot go):
//    mma.sync.m16n8k32 on 64 x 128 tiles staged by masked byte copies,
//    both operands K-major, so B fragments are plain 32-bit loads.
//
// Exact: the int32 sums are exact while 127^2 K < 2^31 (the wrapper
// refuses larger K); the epilogue multiplies left to right with
// round-to-nearest (__fmul_rn), as the reference does, so every variant
// is bit-identical to the plain version. Rows past M, columns past N and
// depth past K are zero-filled in shared memory (TMA's out-of-bounds
// fill, or the masked copies) and masked on the store: the wrapper pads
// nothing.
#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled
                   // is looked up at run time, so nothing links -lcuda
#include <cuda_runtime.h>
#include <stdint.h>

#define IM_BK 128  // K bytes per stage of the TMA variants: one swizzle row

// ---------------------------------------------------------------------------
// PTX helpers: mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// One box of a 2-D tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
// wgmma descriptor of a K-major tile with 128-byte rows in TMA's 128-byte
// swizzle: 8-row groups 1024 bytes apart (SBO), layout type 1 (B128). The
// tile starts 1024-byte aligned; adding 2 moves the start 32 bytes (one
// k32 step) along K inside the swizzle atom.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (it does not see the registers change there).
template <int R>
__device__ __forceinline__ void fence_regs(int* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wgmma.mma_async m64nNk32, s32 += s8 x s8, A and B K-major from shared
// memory: d[N / 2] int32 accumulators per thread.
template <int N>
struct Wgmma;
template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(int* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(int* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(int* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
          "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
          "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
          "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <>
struct Wgmma<192> {
  static __device__ __forceinline__ void mma(int* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
          "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
          "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
          "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
          "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
          "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
          "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
          "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
          "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
          "+r"(d[95])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void mma(int* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
          "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
          "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
          "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
          "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
          "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
          "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
          "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
          "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
          "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
          "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
          "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
          "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
          "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
          "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
        : "l"(a), "l"(b), "r"(1));
  }
};

// The epilogue of one accumulator: ((float)acc * xs[m]) * ws[n], rounded
// to nearest at each step, as the reference multiplies.
__device__ __forceinline__ float dequant(int acc, float xsm, float wsn) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), xsm), wsn);
}

// ---------------------------------------------------------------------------
// wide: warp-specialised TMA + wgmma, 128 x BN tiles
// ---------------------------------------------------------------------------
#define WM_BM 128
#define WM_A_BYTES (WM_BM * IM_BK)
#define WM_THREADS 384  // warpgroups 0, 1: consumers; 2: producer
#define WM_RING (200 * 1024)  // shared memory of the ring

template <int BN>
struct Wide {
  static constexpr int STAGE = WM_A_BYTES + BN * IM_BK;
  static constexpr int STAGES = WM_RING / STAGE;  // 4, 5, 6 at 256, 192, 128
  static constexpr int SMEM = STAGES * STAGE + 1024 + 16 * STAGES;
};

template <int BN>
__global__ void __launch_bounds__(WM_THREADS, 1)
    int8_matmul_wide(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap,
                     const float* __restrict__ xs,
                     const float* __restrict__ ws, float* __restrict__ out,
                     int M, int N, int K) {
  constexpr int STAGE = Wide<BN>::STAGE, STAGES = Wide<BN>::STAGES;
  constexpr int R = BN / 2;  // accumulators per consumer thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle atoms: 1024 B
  const uint32_t full = base + STAGES * STAGE;
  const uint32_t empty = full + 8 * STAGES;
  const int nk = (K + IM_BK - 1) / IM_BK;
  const int m0 = blockIdx.x * WM_BM, n0 = blockIdx.y * BN;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(empty + 8 * s, (kt / STAGES - 1) & 1);
        const uint32_t a = base + s * STAGE;
        mbar_expect_tx(full + 8 * s, STAGE);
        tma_load(a, &xmap, full + 8 * s, kt * IM_BK, m0);
        tma_load(a + WM_A_BYTES, &wmap, full + 8 * s, kt * IM_BK, n0);
      }
    }
  } else {  // consumers: rows wg*64 .. wg*64+63 of the tile, all BN cols
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    int acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0;
    fence_regs<R>(acc);
    // Only the wgmma touch the accumulators inside the loop (any other
    // instruction that did would serialize the wgmma pipeline).
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(full + 8 * s, (kt / STAGES) & 1);
      const uint64_t da = sw128_desc(base + s * STAGE + wg * (64 * IM_BK));
      const uint64_t db = sw128_desc(base + s * STAGE + WM_A_BYTES);
      wg_fence();
#pragma unroll
      for (int k = 0; k < IM_BK / 32; ++k)
        Wgmma<BN>::mma(acc, da + 2 * k, db + 2 * k);
      wg_commit();
      // keep this tile's products in flight; the previous tile's are
      // done, so its stage goes back to the producer
      wg_wait_one();
      if (kt > 0 && (threadIdx.x & 31) == 0)
        mbar_arrive(empty + 8 * ((kt - 1) % STAGES));
    }
    wg_wait_all();
    fence_regs<R>(acc);
    // accumulator 4i + 2h + j: row g + 8h, column 8i + 2t + j
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    // float2 accesses stay 8-byte aligned
    const bool pairs =
        (N & 1) == 0 && (reinterpret_cast<uintptr_t>(ws) & 7) == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wg * 64 + warp * 16 + g + 8 * h;
      if (m >= M) continue;
      const float xsm = xs[m];
      float* orow = out + (size_t)m * N;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int n = n0 + 8 * i + 2 * t;
        if (pairs && n + 1 < N) {
          const float2 wn = *reinterpret_cast<const float2*>(ws + n);
          *reinterpret_cast<float2*>(orow + n) =
              make_float2(dequant(acc[4 * i + 2 * h], xsm, wn.x),
                          dequant(acc[4 * i + 2 * h + 1], xsm, wn.y));
        } else {
          if (n < N) orow[n] = dequant(acc[4 * i + 2 * h], xsm, ws[n]);
          if (n + 1 < N)
            orow[n + 1] = dequant(acc[4 * i + 2 * h + 1], xsm, ws[n + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// decode: swap A and B, split K, combine in the same launch
// ---------------------------------------------------------------------------
#define DC_BN 64  // weight rows (output columns) per block: wgmma's M
#define DC_THREADS 160  // warps 0-3: the consumer warpgroup; 4: producer
#define DC_W_BYTES (DC_BN * IM_BK)

// Ring depth: 64 KB or less a block, so that three or four blocks share
// an SM and a call at N 18432 (288 blocks) is resident at once.
template <int NB>
struct Decode {
  static constexpr int STAGE = DC_W_BYTES + NB * IM_BK;
  static constexpr int STAGES = NB == 8 ? 6 : 4;
  static constexpr int SMEM = STAGES * STAGE + 1024 + 16 * STAGES;
};

template <int NB>
__global__ void __launch_bounds__(DC_THREADS)
    int8_matmul_decode(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap,
                       const float* __restrict__ xs,
                       const float* __restrict__ ws, float* __restrict__ out,
                       int* __restrict__ part, int* __restrict__ tickets,
                       int M, int N, int K, int chunk, int n_split) {
  constexpr int R = NB / 2;  // accumulators per thread
  constexpr int STAGE = Decode<NB>::STAGE, DC_STAGES = Decode<NB>::STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int last;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t full = base + DC_STAGES * STAGE;
  const uint32_t empty = full + 8 * DC_STAGES;
  const int nk = (K + IM_BK - 1) / IM_BK;
  const int kt0 = blockIdx.y * chunk, kt1 = min(nk, kt0 + chunk);
  const int n0 = blockIdx.x * DC_BN;
  if (threadIdx.x == 0) {
    for (int s = 0; s < DC_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // producer warp
    if (threadIdx.x == 128) {
      for (int kt = kt0; kt < kt1; ++kt) {
        const int i = kt - kt0, s = i % DC_STAGES;
        if (i >= DC_STAGES) mbar_wait(empty + 8 * s, (i / DC_STAGES - 1) & 1);
        const uint32_t a = base + s * STAGE;
        mbar_expect_tx(full + 8 * s, STAGE);
        tma_load(a, &wmap, full + 8 * s, kt * IM_BK, n0);
        tma_load(a + DC_W_BYTES, &xmap, full + 8 * s, kt * IM_BK, 0);
      }
    }
    return;
  }
  int acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0;
  for (int kt = kt0; kt < kt1; ++kt) {
    const int i = kt - kt0, s = i % DC_STAGES;
    mbar_wait(full + 8 * s, (i / DC_STAGES) & 1);
    const uint64_t da = sw128_desc(base + s * STAGE);
    const uint64_t db = sw128_desc(base + s * STAGE + DC_W_BYTES);
    fence_regs<R>(acc);
    wg_fence();
#pragma unroll
    for (int k = 0; k < IM_BK / 32; ++k)
      Wgmma<NB>::mma(acc, da + 2 * k, db + 2 * k);
    wg_commit();
    wg_wait_all();
    fence_regs<R>(acc);
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + 8 * s);
  }

  if (n_split > 1) {
    // partials in fragment order: [split][n-tile][thread][R]
    constexpr int stride = 128 * R;
    int4* mine = reinterpret_cast<int4*>(
        part + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * stride +
        threadIdx.x * R);
#pragma unroll
    for (int i = 0; i < R / 4; ++i)
      mine[i] = make_int4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                          acc[4 * i + 3]);
    __threadfence();
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    if (threadIdx.x == 0)
      last = atomicAdd(tickets + blockIdx.x, 1) == n_split - 1;
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    if (!last) return;
    __threadfence();
    for (int sp = 0; sp < n_split; ++sp) {
      if (sp == (int)blockIdx.y) continue;
      const int4* other = reinterpret_cast<const int4*>(
          part + ((size_t)sp * gridDim.x + blockIdx.x) * stride +
          threadIdx.x * R);
#pragma unroll
      for (int i = 0; i < R / 4; ++i) {
        const int4 v = __ldcg(other + i);
        acc[4 * i] += v.x;
        acc[4 * i + 1] += v.y;
        acc[4 * i + 2] += v.z;
        acc[4 * i + 3] += v.w;
      }
    }
    if (threadIdx.x == 0) tickets[blockIdx.x] = 0;  // ready for the next call
  }
  // accumulator 4i + 2h + j: weight row (output column) g + 8h, token
  // row (output row) 8i + 2t + j
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + warp * 16 + g + 8 * h;
    if (n >= N) continue;
    const float wsn = ws[n];
#pragma unroll
    for (int i = 0; i < NB / 8; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int m = 8 * i + 2 * t + j;
        if (m < M)
          out[(size_t)m * N + n] = dequant(acc[4 * i + 2 * h + j], xs[m], wsn);
      }
  }
}

// ---------------------------------------------------------------------------
// ragged: mma.sync on masked byte copies, both operands K-major
// ---------------------------------------------------------------------------
#define RG_BM 64
#define RG_BN 128
#define RG_BK 64
#define RG_THREADS 256

// A tile [64 rows][64 B], B tile [128 rows][64 B]: 4 chunks of 16 B per
// row, chunk c of row r stored at chunk c ^ ((r >> 1) & 3), so that the
// 8 rows of a fragment load fall in distinct banks.
__device__ __forceinline__ int rg_off(int row, int kbyte) {
  return row * RG_BK + ((((kbyte >> 4) ^ (row >> 1)) & 3) << 4) +
         (kbyte & 15);
}

// 16 bytes of `src`, `limit` of them valid, zero-filled past it.
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

// Row `row` of a [rows, K] K-contiguous operand, bytes k0 + kb ..
__device__ __forceinline__ void stage_chunk(unsigned char* dst,
                                            const int8_t* __restrict__ src,
                                            int row, int rows, int K, int gk) {
  int valid = row < rows ? K - gk : 0;
  valid = valid < 0 ? 0 : (valid > 16 ? 16 : valid);
  copy16_masked(dst, valid ? src + (size_t)row * K + gk : src, valid);
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(RG_THREADS)
    int8_matmul_ragged(const int8_t* __restrict__ xq,
                       const float* __restrict__ xs,
                       const int8_t* __restrict__ wq,
                       const float* __restrict__ ws, float* __restrict__ out,
                       int M, int N, int K) {
  __shared__ __align__(16) unsigned char As[RG_BM * RG_BK];
  __shared__ __align__(16) unsigned char Bs[RG_BN * RG_BK];
  const int m0 = blockIdx.y * RG_BM, n0 = blockIdx.x * RG_BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 32 x 32
  const int g = lane >> 2, t = lane & 3;
  int acc[2][4][4] = {};
  for (int k0 = 0; k0 < K; k0 += RG_BK) {
    {  // A: 64 rows x 4 chunks, one per thread
      const int row = tid >> 2, kb = (tid & 3) << 4;
      stage_chunk(As + rg_off(row, kb), xq, m0 + row, M, K, k0 + kb);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // B: 128 rows x 4 chunks, two per thread
      const int c = tid + i * RG_THREADS;
      const int row = c >> 2, kb = (c & 3) << 4;
      stage_chunk(Bs + rg_off(row, kb), wq, n0 + row, N, K, k0 + kb);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < RG_BK / 32; ++ks) {
      const int kb = ks * 32 + t * 4;
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r0 = wm * 32 + mt * 16 + g;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(As + rg_off(r0, kb));
        a[mt][1] = *reinterpret_cast<const uint32_t*>(As + rg_off(r0 + 8, kb));
        a[mt][2] = *reinterpret_cast<const uint32_t*>(As + rg_off(r0, kb + 16));
        a[mt][3] =
            *reinterpret_cast<const uint32_t*>(As + rg_off(r0 + 8, kb + 16));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nr = wn * 32 + j * 8 + g;
        const uint32_t b0 =
            *reinterpret_cast<const uint32_t*>(Bs + rg_off(nr, kb));
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(Bs + rg_off(nr, kb + 16));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_s8(acc[mt][j], a[mt], b0, b1);
      }
    }
    __syncthreads();
  }
  // accumulator r of (mt, j): row g + 8 (r >> 1), column 2t + (r & 1)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 32 + mt * 16 + g + 8 * h;
      if (m >= M) continue;
      const float xsm = xs[m];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * 32 + j * 8 + 2 * t + e;
          if (n < N)
            out[(size_t)m * N + n] = dequant(acc[mt][j][2 * h + e], xsm, ws[n]);
        }
    }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [rows, cols] int8 with cols contiguous; boxes of box_rows x 128 bytes in
// the 128-byte swizzle; out-of-bounds elements read as zero.
static int make_map(CUtensorMap* map, const void* ptr, int rows, int cols,
                    int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {IM_BK, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                         const_cast<void*>(ptr), dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int NB>
static int launch_decode(const CUtensorMap& xmap, const CUtensorMap& wmap,
                         const float* xs, const float* ws, float* out,
                         int* part, int* tickets, int M, int N, int K,
                         int chunk, int n_split, cudaStream_t stream) {
  constexpr int smem = Decode<NB>::SMEM;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        int8_matmul_decode<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const dim3 grid((N + DC_BN - 1) / DC_BN, n_split);
  int8_matmul_decode<NB><<<grid, DC_THREADS, smem, stream>>>(
      xmap, wmap, xs, ws, out, part, tickets, M, N, K, chunk, n_split);
  return (int)cudaGetLastError();
}

template <int BN>
static int launch_wide(const CUtensorMap& xmap, const CUtensorMap& wmap,
                       const float* xs, const float* ws, float* out, int M,
                       int N, int K, cudaStream_t stream) {
  constexpr int smem = Wide<BN>::SMEM;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        int8_matmul_wide<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const dim3 grid((M + WM_BM - 1) / WM_BM, (N + BN - 1) / BN);
  int8_matmul_wide<BN><<<grid, WM_THREADS, smem, stream>>>(xmap, wmap, xs, ws,
                                                           out, M, N, K);
  return (int)cudaGetLastError();
}

// path: 0 ragged; 1 decode (the token rows padded to nb, chunk k-tiles of
// IM_BK per split, n_split splits; part and tickets as the wrapper's plan
// sizes them); 2 wide (tiles 128 x nb, nb 128, 192 or 256).
// x_q [M, K] and w_q ([N, K] in memory) K-contiguous. Returns a
// cudaError_t.
extern "C" int int8_matmul_launch(const int8_t* xq, const float* xs,
                                  const int8_t* wq, const float* ws,
                                  float* out, int* part, int* tickets, int M,
                                  int N, int K, int path, int nb, int chunk,
                                  int n_split, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  if (path == 0) {
    const dim3 grid((N + RG_BN - 1) / RG_BN, (M + RG_BM - 1) / RG_BM);
    int8_matmul_ragged<<<grid, RG_THREADS, 0, stream>>>(xq, xs, wq, ws, out,
                                                        M, N, K);
    return (int)cudaGetLastError();
  }
  CUtensorMap xmap, wmap;
  if (path == 1) {
    if (M > nb || n_split < 1 || chunk < 1) return (int)cudaErrorInvalidValue;
    int e = make_map(&xmap, xq, M, K, nb);
    if (e == 0) e = make_map(&wmap, wq, N, K, DC_BN);
    if (e != 0) return e;
    switch (nb) {
      case 8:
        return launch_decode<8>(xmap, wmap, xs, ws, out, part, tickets, M, N,
                                K, chunk, n_split, stream);
      case 64:
        return launch_decode<64>(xmap, wmap, xs, ws, out, part, tickets, M, N,
                                 K, chunk, n_split, stream);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (path != 2) return (int)cudaErrorInvalidValue;
  int e = make_map(&xmap, xq, M, K, WM_BM);
  if (e == 0) e = make_map(&wmap, wq, N, K, nb);
  if (e != 0) return e;
  switch (nb) {
    case 128:
      return launch_wide<128>(xmap, wmap, xs, ws, out, M, N, K, stream);
    case 192:
      return launch_wide<192>(xmap, wmap, xs, ws, out, M, N, K, stream);
    case 256:
      return launch_wide<256>(xmap, wmap, xs, ws, out, M, N, K, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
