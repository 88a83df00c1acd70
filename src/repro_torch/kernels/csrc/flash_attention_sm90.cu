// Flash attention on Hopper's tensor cores (sm_90a): bf16 q/k/v, head_dim
// 16, 32, 64, 128 or 256 (every bf16 width; the wrapper pads 1-15 to 16,
// 17-31 to 32, flash_attention.py: _route).  float32 takes the 3xTF32
// kernel in flash_attention_tf32.cu.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:flash_attention
// (_kernel), which ran a (B*H, nQ, nK) grid with the key loop innermost,
// carried each query block's running max m, sum l and accumulator acc in
// VMEM scratch from one grid step to the next, skipped (q, k) block pairs
// its liveness test found dead, and padded q/k/v to whole blocks.
//
// Bound: the live (q, k) pairs cost 4 D flops each (QK^T and PV).  At
// qwen2-1.5b's prefill (BH 48, S 2048, D 128, causal) that is 5.16e10
// flops against 5.9e7 bytes of q, k, v and o: bound by operations, 52 us
// at the bf16 tensor-core rate (989 TFLOP/s), 18 us of bytes.  Measured
// on an H100 (chip_smoke.py, PERF.md): 0.165 ms, 32 % of that bound, where
// F.scaled_dot_product_attention takes 0.109 ms.  Design:
//
//   * one CTA of two consumer warpgroups per (bh, 128 query rows); each
//     warpgroup owns 64 rows.  No producer warp: thread 0 issues the TMA
//     loads, which run on their own while both warpgroups compute;
//   * Q is loaded once by TMA into shared memory as bf16, in panels of
//     kPanel = min(D, 64) columns whose rows are swizzled at their own
//     width (128 bytes at D >= 64, 64 at D 32, 32 at D 16; the same mode
//     in the TMA map and in the wgmma descriptors); K and V tiles of kKeys
//     keys (128 at D <= 128, 64 at D = 256) go through a ring of kStages
//     stages in shared memory, filled by TMA and tracked by mbarriers:
//     "full" (the bytes arrived) and "empty" (all 256 threads are done
//     with the stage).  Thread 0 keeps kStages - 1 tiles in flight ahead
//     of the tile the warpgroups compute;
//   * S = Q K^T by wgmma m64nNk16, both operands from shared memory
//     (K-major, no transpose), f32 accumulators in registers;
//   * the online softmax runs in registers on the accumulator fragment
//     (row max and sum over the 4 lanes that share a row), in base-2
//     units (scores times scale * log2 e, ex2.approx).  The mask is
//     computed from positions only on tiles that straddle a causal,
//     window or Sk edge; tiles dead for the whole CTA are never loaded,
//     tiles dead for one warpgroup's 64 rows are skipped by it;
//   * P is rounded to bf16 in registers and is the register A operand of
//     a second wgmma against V in shared memory (MN-major, transposed
//     B); O stays in f32 registers;
//   * the epilogue writes acc / l rounded to bf16, and 0 for rows whose
//     l is 0 (every key masked); with an lse pointer it also writes each
//     row's statistic L = m + log l in natural units (m ln 2 + ln l from
//     the base-2 m it holds; +1e30 where l is 0), the residual of the
//     training backward (models/attention.py: _Flash): one float per
//     row from the lane that holds column 0 of it, no second pass.
//
// Narrow heads (D 16 and 32).  A score costs only 4 D tensor-core flops there,
// against one ex2 on the special-function units (16 a clock per SM, about
// 3.9e12 a second on an H100) and a few f32 operations: the softmax, not
// the MMA, sets the pace.  At q 48 x 2048, k/v 8 x 2048, causal, D 32 the
// 1.01e8 exponents take 0.026 ms, the 1.29e10 tensor-core flops 0.013 ms.
// So at D <= 32 the design keeps 128-key tiles (a K or V tile is 4-8 KB),
// runs a 4-stage ring, and fits two CTAs on an SM (__launch_bounds__ with
// 2 blocks: at most 128 registers a thread; 74 KB of shared memory a
// CTA), so that one CTA's softmax overlaps the other's wgmma on the same
// SM.  Two resident CTAs were chosen over two ping-ponging warpgroups in
// one CTA because the warp schedulers interleave independent CTAs with no
// named barriers or schedule to keep in step, and the wide widths' code
// path stays as it is; D 64/128/256 keep one CTA an SM and 2 stages.
// python -m repro_torch.perf.flash_sweep times these settings against
// 64-key tiles, 2 or 6 stages and 1, 3 or 4 CTAs an SM (PERF.md).
//
// Arithmetic against _kernel (f32 QK^T and PV from widened inputs):
// bf16 x bf16 products are exact in f32, so S differs only in summation
// order.  P is rounded to bf16 before P V: a relative error of at most
// 2^-9 per weight, random in sign, while l sums the f32 weights.  That
// single bf16 product is what ships: it holds FLASH_TOL["bfloat16"] = 2e-2
// against the plain version and the LM logits checks of chip_smoke.py
// (measured in PERF.md), so the split P = P_hi + P_lo (1.5x the flops) is
// not needed.
//
// Ragged edges: Q rows past Sq and K/V rows past Sk lie outside the TMA
// tensor maps, and TMA fills them with zeros (no padded copies).  A key
// past Sk is masked, so its P is exactly 0, and its V row is exactly 0
// rather than stale shared memory: 0 x 0 adds nothing to P V, where
// garbage could be Inf or NaN and poison the row.  Rows past Sq are not
// written.  GQA: query head bh reads kv head bh / group from the same
// tensor map, with no repeated KV.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;    // query rows per CTA: two warpgroups of 64
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Cfg {
  static constexpr bool kNarrow = D <= 32;
  static constexpr int kKeys = D <= 128 ? 128 : 64;
  static constexpr int kStages = kNarrow ? 4 : 2;      // K/V ring depth
  static constexpr int kMinBlocks = kNarrow ? 2 : 1;   // CTAs an SM
  static constexpr int kPanel = D < 64 ? D : 64;  // bf16 columns a panel
  static constexpr int kRowBytes = 2 * kPanel;    // = the swizzle: 128/64/32
  static constexpr int kSteps = kRowBytes / 32;   // k16 steps in a row
  static constexpr int kPanels = D / kPanel;
  static constexpr int kQBytes = kPanels * kRows * kRowBytes;
  static constexpr int kKVBytes = kPanels * kKeys * kRowBytes;  // K or V tile
  // Q, K[kStages], V[kStages], 2 kStages + 1 mbarriers, and slack to align
  // the base to 1024 B
  static constexpr int kSmem =
      kQBytes + 2 * kStages * kKVBytes + 16 * kStages + 32 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
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

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// wait until the phase of the given parity has completed; a wait of more
// than 4 s is a fault of the pipeline and traps (an error, not a hang)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (int spin = 0;; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == 0) t0 = global_ns();
    else if (global_ns() - t0 > 4000000000ull) __trap();
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a tile whose rows of row_bytes (128,
// 64 or 32) carry the swizzle of that width (layout 1, 2 or 3): start
// address, leading and stride byte offsets, all in 16-byte units
template <int row_bytes>
__device__ __forceinline__ uint64_t desc_sw(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  constexpr uint64_t layout =
      row_bytes == 128 ? 1ull : (row_bytes == 64 ? 2ull : 3ull);
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of wgmma registers across the
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma m64nNk16, f32 += bf16 x bf16.  wgmma_ss: A and B from shared
// memory (K-major); scale_d = 0 overwrites d.  wgmma_rs: A from registers
// (the accumulator fragment's layout), B from shared memory transposed
// (MN-major); accumulates.  N is the accumulator's size times 2.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{" 
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
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int D>
__global__ void __launch_bounds__(kThreads, Cfg<D>::kMinBlocks)
    flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                                const __grid_constant__ CUtensorMap k_map,
                                const __grid_constant__ CUtensorMap v_map,
                                __nv_bfloat16* __restrict__ o,
                                float* __restrict__ lse, int sq, int sk,
                                int group, int causal, int has_window,
                                int window, int q_offset, float scale_log2) {
  using C = Cfg<D>;
  constexpr int kKeys = C::kKeys;
  constexpr int kStages = C::kStages;
  constexpr int kPanels = C::kPanels;
  constexpr int kRowBytes = C::kRowBytes;
  constexpr int kS = kKeys / 2;  // score accumulators per thread
  constexpr int kO = D / 2;      // output accumulators per thread

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_q = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024 B
  const uint32_t s_k = s_q + C::kQBytes;        // stage s: + s * kKVBytes
  const uint32_t s_v = s_k + kStages * C::kKVBytes;
  // full[kStages], empty[kStages], q
  const uint32_t bars = s_v + kStages * C::kKVBytes;
  auto full_bar = [=](int s) { return bars + 8u * s; };
  auto empty_bar = [=](int s) { return bars + 8u * (kStages + s); };
  const uint32_t q_bar = bars + 16u * kStages;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;  // consumer warpgroup: rows 64 wg .. 64 wg + 63
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // longest first
  const int kvh = bh / group;

  // the CTA's live key tiles [t_lo, t_hi), by _kernel's liveness test
  const int b_first = q_offset + q0;
  const int b_last = q_offset + min(q0 + kRows, sq) - 1;
  int t_hi = (sk + kKeys - 1) / kKeys;
  if (causal) t_hi = min(t_hi, b_last / kKeys + 1);
  int t_lo = 0;
  if (has_window) {
    const long long dead = (long long)b_first - window - kKeys + 1;
    if (dead >= 0) t_lo = (int)(dead / kKeys) + 1;
  }
  const int n_live = max(t_hi - t_lo, 0);

  // this warpgroup's rows
  const int w_row0 = q0 + 64 * wg;
  const int w_rows = min(64, sq - w_row0);
  const int w_first = q_offset + w_row0;
  const int w_last = w_first + w_rows - 1;

  if (n_live == 0) {  // every pair masked: the rows are 0
    const int rows = min(kRows, sq - q0);
    __nv_bfloat162* out =
        reinterpret_cast<__nv_bfloat162*>(o + ((size_t)bh * sq + q0) * D);
    const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
    for (int i = tid; i < rows * D / 2; i += kThreads) out[i] = zero;
    if (lse != nullptr)
      for (int i = tid; i < rows; i += kThreads)
        lse[(size_t)bh * sq + q0 + i] = -kNegInf;
    return;
  }

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), kThreads);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // load j of the K/V ring: tile t_lo + j into stage j % kStages
  // (thread 0)
  const CUtensorMap* kmap = &k_map;
  const CUtensorMap* vmap = &v_map;
  auto issue_kv = [=](int j) {
    const int s = j % kStages;
    const int key0 = (t_lo + j) * kKeys;
    mbar_expect_tx(full_bar(s), 2 * C::kKVBytes);
#pragma unroll
    for (int p = 0; p < kPanels; ++p) {
      const uint32_t off = s * C::kKVBytes + p * kKeys * kRowBytes;
      tma_load(s_k + off, kmap, full_bar(s), p * C::kPanel, key0, kvh);
      tma_load(s_v + off, vmap, full_bar(s), p * C::kPanel, key0, kvh);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(q_bar, C::kQBytes);
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
      tma_load(s_q + p * kRows * kRowBytes, &q_map, q_bar, p * C::kPanel,
               q0, bh);
    for (int j = 0; j < kStages - 1 && j < n_live; ++j) issue_kv(j);
  }

  // accumulator fragment: element i of a thread is row
  // 16 warp + lane / 4 + 8 ((i / 2) % 2) of the warpgroup's 64, column
  // 8 (i / 4) + 2 (lane % 4) + i % 2
  const int r_in = 16 * warp + (lane >> 2);
  int qpos[2];
  bool rvalid[2];
  float m[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rvalid[h] = w_row0 + r_in + 8 * h < sq;
    qpos[h] = w_first + r_in + 8 * h;
    m[h] = kNegInf;
    l[h] = 0.f;
  }
  float acc[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) acc[i] = 0.f;

  mbar_wait(q_bar, 0);
  for (int it = 0; it < n_live; ++it) {
    if (tid == 0 && it + kStages - 1 < n_live) {
      const int j = it + kStages - 1;
      if (j >= kStages)
        mbar_wait(empty_bar(j % kStages), (j / kStages - 1) & 1);
      issue_kv(j);
    }
    __syncwarp();
    const int s = it % kStages;
    mbar_wait(full_bar(s), (it / kStages) & 1);

    const int k_first = (t_lo + it) * kKeys;
    const int k_last = k_first + kKeys - 1;
    const bool live = w_rows > 0 && !(causal && k_first > w_last) &&
                      !(has_window && w_first - k_last >= window);
    if (live) {
      // S = Q K^T over D / 16 steps of 16 (32 bytes within a swizzled row)
      float sc[kS];
#pragma unroll
      for (int i = 0; i < kS; ++i) sc[i] = 0.f;
      reg_fence(sc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        constexpr int kSteps = C::kSteps;
        const uint32_t koff = (kk % kSteps) * 32;
        const uint32_t qa = s_q + (kk / kSteps) * kRows * kRowBytes +
                            wg * 64 * kRowBytes;
        const uint32_t ka =
            s_k + s * C::kKVBytes + (kk / kSteps) * kKeys * kRowBytes;
        wgmma_ss(sc, desc_sw<kRowBytes>(qa + koff, 16, 8 * kRowBytes),
                 desc_sw<kRowBytes>(ka + koff, 16, 8 * kRowBytes), kk > 0);
      }
      wg_commit();
      wg_wait0();
      reg_fence(sc);

      // mask (edge tiles only), scale to base-2 units, row max
      const bool edge = k_last >= sk || w_rows < 64 ||
                        (causal && k_last > w_first) ||
                        (has_window && w_last - k_first >= window);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        const int h = (i >> 1) & 1;
        float x = sc[i] * scale_log2;
        if (edge) {
          const int kp = k_first + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          const bool ok = rvalid[h] && kp < sk &&
                          (!causal || kp <= qpos[h]) &&
                          (!has_window || qpos[h] - kp < window);
          x = ok ? x : kNegInf;
        }
        sc[i] = x;
        mx[h] = fmaxf(mx[h], x);
      }
      float alpha[2], m_use[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        // a row with no live key so far keeps m = -1e30; exponents are
        // then taken against 0, so its masked p and alpha are exactly 0
        m_use[h] = m_new == kNegInf ? 0.f : m_new;
        alpha[h] = ex2(m[h] - m_use[h]);
        m[h] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        const int h = (i >> 1) & 1;
        const float p = ex2(sc[i] - m_use[h]);
        sc[i] = p;
        sum[h] += p;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
#pragma unroll
      for (int i = 0; i < kO; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // P in bf16, laid out as wgmma's register A fragment: keys
      // 16 kk .. 16 kk + 15 are accumulator columns 8 (2 kk) .. 8 (2 kk + 1) + 7
      uint32_t pa[kKeys / 16][4];
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

      // O += P V over kKeys / 16 steps of 16 keys (16 swizzled rows)
      reg_fence(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        const uint32_t va = s_v + s * C::kKVBytes + kk * 16 * kRowBytes;
        wgmma_rs(acc, pa[kk], desc_sw<kRowBytes>(va, kKeys * kRowBytes,
                                                 8 * kRowBytes));
      }
      wg_commit();
      wg_wait0();
      reg_fence(acc);
    }
    mbar_arrive(empty_bar(s));
  }

  // epilogue: l summed over the 4 lanes of a row, the row statistic,
  // acc / l in bf16
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (lse != nullptr && rvalid[h] && (lane & 3) == 0)
      lse[(size_t)bh * sq + w_row0 + r_in + 8 * h] =
          l[h] > 0.f ? m[h] * kLn2 + logf(l[h]) : -kNegInf;
    l[h] = l[h] > 0.f ? 1.f / l[h] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kO; i += 2) {
    const int h = (i >> 1) & 1;
    if (!rvalid[h]) continue;
    const int row = w_row0 + r_in + 8 * h;
    const int col = 8 * (i >> 2) + 2 * (lane & 3);
    *reinterpret_cast<__nv_bfloat162*>(o + ((size_t)bh * sq + row) * D +
                                       col) =
        __floats2bfloat162_rn(acc[i] * l[h], acc[i + 1] * l[h]);
  }
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// (no link against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &res);
#endif
    if (err != cudaSuccess || res != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (heads, rows, d) bf16 tensor, boxes of min(d, 64) columns x box_rows
// rows, swizzled at the box's row width (128, 64 or 32 bytes, as the
// wgmma descriptors' layout); out-of-bounds rows read as zeros
int make_map(CUtensorMap* map, const void* ptr, int d, int rows, int heads,
             int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)d * 2 * (cuuint64_t)rows};
  const int panel = d < 64 ? d : 64;
  const cuuint32_t box[3] = {(cuuint32_t)panel, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(ptr), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        panel == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                        : panel == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                      : CU_TENSOR_MAP_SWIZZLE_32B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, int bh_kv, int sq, int sk, int group, int causal,
           int has_window, int window, int q_offset, float scale,
           cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap qm, km, vm;
  int err = make_map(&qm, q, D, sq, bh, kRows);
  // with sk == 0 no K/V tile is live: the maps then describe q, unread
  if (!err) err = sk ? make_map(&km, k, D, sk, bh_kv, C::kKeys)
                     : make_map(&km, q, D, sq, bh, C::kKeys);
  if (!err) err = sk ? make_map(&vm, v, D, sk, bh_kv, C::kKeys)
                     : make_map(&vm, q, D, sq, bh, C::kKeys);
  if (err) return err;
  auto kern = flash_attention_sm90_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((sq + kRows - 1) / kRows, bh);
  kern<<<grid, kThreads, C::kSmem, stream>>>(
      qm, km, vm, (__nv_bfloat16*)o, lse, sq, sk, group, causal,
      has_window, window, q_offset, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (bh, sq, d); k, v: (bh_kv, sk, d); o: (bh, sq, d); all contiguous,
// 16-byte aligned bfloat16, d in {16, 32, 64, 128, 256}; lse: (bh, sq)
// float32, or null for no row statistic.
extern "C" int flash_attention_sm90_launch(const void* q, const void* k,
                                           const void* v, void* o,
                                           void* lse, int bh, int bh_kv,
                                           int sq, int sk, int d,
                                           int causal, int has_window,
                                           int window, int q_offset,
                                           float scale, void* stream) {
  if (bh < 0 || bh_kv <= 0 || bh % bh_kv != 0 || sq < 0 || sk < 0 ||
      q_offset < 0 || bh > 65535)
    return (int)cudaErrorInvalidValue;
  if (bh == 0 || sq == 0) return 0;
  const int group = bh / bh_kv;
  cudaStream_t st = (cudaStream_t)stream;
  float* l = (float*)lse;
  switch (d) {
    case 16:
      return launch<16>(q, k, v, o, l, bh, bh_kv, sq, sk, group, causal,
                        has_window, window, q_offset, scale, st);
    case 32:
      return launch<32>(q, k, v, o, l, bh, bh_kv, sq, sk, group, causal,
                        has_window, window, q_offset, scale, st);
    case 64:
      return launch<64>(q, k, v, o, l, bh, bh_kv, sq, sk, group, causal,
                        has_window, window, q_offset, scale, st);
    case 128:
      return launch<128>(q, k, v, o, l, bh, bh_kv, sq, sk, group, causal,
                         has_window, window, q_offset, scale, st);
    case 256:
      return launch<256>(q, k, v, o, l, bh, bh_kv, sq, sk, group, causal,
                         has_window, window, q_offset, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
