// Flash attention in float32 on Hopper's tensor cores (sm_90a): 3xTF32
// wgmma, head_dim 16, 32, 64, 128 or 256 (every float32 width; the
// wrapper pads 1-15 to 16 and 17-31 to 32, flash_attention.py: _route).
// bf16 takes flash_attention_sm90.cu.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:flash_attention
// (_kernel) for float32 q/k/v, which computed QK^T and PV in f32 over a
// (B*H, nQ, nK) grid with the key loop innermost and m, l, acc carried in
// VMEM scratch.
//
// Bound: the live (q, k) pairs cost 4 D flops each.  At qwen2-1.5b's
// prefill (BH 48, Sq = Sk = 2048, D 128, causal) that is 5.16e10 flops.
// One TF32 product keeps 11 significant bits and misses the float32
// tolerance (2e-4); three do not: x = hi + lo with hi = tf32(x) and
// lo = tf32(x - hi), and a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi (the
// lo lo term is below 2^-22 of the product).  So the bound is 3 x 5.16e10
// flops at the TF32 rate (495 TFLOP/s): 0.313 ms, against 0.77 ms for
// plain f32 on the CUDA cores.  Design:
//
//   * a pre-pass (tf32_split_kernel, once per call, counted on its own)
//     splits K and V into hi and lo (cvt.rna.tf32.f32, explicit rounding:
//     the low 13 bits of a raw float32 are never left to the tensor core)
//     and writes V transposed, so that every operand is K-major, the only
//     form wgmma takes for tf32.  Keys are padded with zeros to whole
//     tiles, and within each group of 8 keys V^T holds them in the order
//     key_order (see below).  Each KV head's tiles are read by
//     Sq / kRows x group CTAs, so splitting them in the kernel would
//     repeat the split that many times;
//   * one CTA per (bh, kRows query rows): kWG consumer warpgroups of 64
//     rows and one producer warp.  The producer's lane 0 issues the TMA
//     loads: Q once, then per live key tile K hi + lo into one K buffer
//     and V^T hi + lo into one V buffer, each with a "full" and an
//     "empty" mbarrier, so that K of tile j + 1 loads while the
//     warpgroups compute P V of tile j, and V of tile j + 1 while they
//     compute S of tile j + 1;
//   * Q arrives as f32 (TMA, 128-byte swizzle; 64-byte at D 16, whose
//     rows of Q and K are 64 bytes) and each warpgroup splits
//     its own 64 rows in place into Q hi and Q lo (the same swizzled
//     layout), then fences the generic proxy against the async one;
//   * S = Q K^T by wgmma m64n{kKeys}k8, both operands from shared memory:
//     Q_hi K_hi + Q_hi K_lo + Q_lo K_hi, f32 accumulators in registers;
//   * online softmax in base 2 on the accumulator fragment, as in
//     flash_attention_sm90.cu: the mask is computed only on tiles that
//     straddle a causal, window, Sq or Sk edge; tiles dead for the whole
//     CTA are never loaded, tiles dead for one warpgroup are skipped by it;
//   * O += P V by wgmma m64n{D}k8 with P as the register A operand, split
//     into P hi and P lo in registers: P_hi V_hi + P_hi V_lo + P_lo V_hi.
//     The accumulator fragment holds keys 2t and 2t + 1 (t = lane % 4) of
//     each group of 8, where the tf32 A fragment wants k-slots t and
//     t + 4 (checked on the card by tf32_fragment_probe_kernel).  Rather
//     than shuffle, P's key 2t goes to slot t and key 2t + 1 to slot
//     t + 4, and the pre-pass stores V^T's keys in that same order
//     (key_order): a permutation of P V's summation index;
//   * the epilogue writes acc / l as f32, and 0 for rows whose l is 0;
//     with an lse pointer it also writes each row's statistic
//     L = m + log l in natural units (m ln 2 + ln l; +1e30 where l is 0),
//     the residual of the training backward (models/attention.py:
//     _Flash), one float per row, no second pass.
//
// Shared memory (one stage of K and of V; hi and lo double each operand):
//
//   D     kWG  rows  kKeys  Q hi+lo   K hi+lo   V^T hi+lo   total
//   16    2    128   64     16 KB     8 KB      8 KB        32 KB
//   32    2    128   64     32 KB     16 KB     16 KB       64 KB
//   64    2    128   64     64 KB     32 KB     32 KB       128 KB
//   128   2    128   32     128 KB    32 KB     32 KB       192 KB
//   256   1    64    16     128 KB    32 KB     32 KB       192 KB
//
// plus 40 B of mbarriers and 1 KB of alignment slack, within the 227 KB a
// block may hold.  At D 256 a V^T row of 16 keys is 64 bytes, so V^T uses
// the 64-byte swizzle there.  Two stages would not fit at D 128 and 256
// (256 KB).  At D 32 and 16 they would fit, and so would two CTAs an SM,
// but on an H100 both ran slower than this one-stage, one-CTA design at
// q 48 x 2048, k/v 8 x 2048, causal (python -m repro_torch.perf.flash_sweep;
// PERF.md): two CTAs cap a thread at 96 registers, which spills at 64
// keys and serialises more at 32.  A score costs only 3 x 4 D tensor-core
// flops there, against its ex2 and the split of P into hi and lo on the
// CUDA cores.  D 16 has its own build rather than padding to 32: the
// padding doubled the products, loads and splits of Q and K for nothing
// (PERF.md, row 5b).  Ragged edges: Q rows past Sq lie outside the tensor map and
// read as zeros, keys past Sk are zeros in the padded scratch and masked,
// so P and V are exactly 0 there.  GQA: query head bh reads kv head
// bh / group through one tensor map, with no repeated KV.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// V^T's key order within each group of 8 keys: slot j holds key
// key_order(j) = 0, 2, 4, 6, 1, 3, 5, 7 (ref.py: TF32_KEY_ORDER)
__host__ __device__ constexpr int key_order(int j) {
  return j < 4 ? 2 * j : 2 * j - 7;
}
// the accumulator element (of the 4 a thread holds in a group of 8 key
// columns) that goes into register r of the tf32 A fragment:
// p_reg(r) = 0, 2, 1, 3 (flash_attention.py: TF32_P_REGS)
__host__ __device__ constexpr int p_reg(int r) {
  return 2 * (r & 1) + (r >> 1);
}
// key rows are padded to a multiple of this in the split scratch
constexpr int kKeyPad = 64;

template <int D>
struct Cfg {
  static constexpr int kWG = D <= 128 ? 2 : 1;
  static constexpr int kRows = 64 * kWG;
  static constexpr int kKeys = D <= 64 ? 64 : (D == 128 ? 32 : 16);
  static constexpr int kThreads = 128 * kWG + 32;
  // Q and K in panels of kPanel f32 columns whose rows (kRowBytes: 128,
  // or 64 at D 16) carry the swizzle of their width; k8 steps of 32 bytes
  static constexpr int kPanel = D < 32 ? D : 32;
  static constexpr int kRowBytes = 4 * kPanel;
  static constexpr int kSteps = kRowBytes / 32;
  static constexpr int kPanels = D / kPanel;
  static constexpr int kQBytes = kRows * D * 4;  // Q hi (Q lo the same)
  static constexpr int kKBytes = kKeys * D * 4;  // one K tile, hi or lo
  static constexpr int kVRow = kKeys >= 32 ? 128 : kKeys * 4;  // V^T row
  static constexpr int kVPanels = kKeys * 4 / kVRow;
  static constexpr int kVBytes = D * kKeys * 4;  // one V^T tile, hi or lo
  static constexpr int kSmem =
      2 * kQBytes + 2 * kKBytes + 2 * kVBytes + 64 + 1024;
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

// wgmma shared-memory descriptor of a K-major tile in 8-row atoms:
// start address and stride between atoms in 16-byte units, 128-byte
// (rows of 128 B, atoms of 1024 B) or 64-byte swizzle (64 B, 512 B)
__device__ __forceinline__ uint64_t desc_sw(uint32_t addr, int row_bytes) {
  const uint64_t layout = row_bytes == 128 ? 1ull : 2ull;
  const uint32_t sbo = 8u * row_bytes;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
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

// shared-memory writes of the generic proxy, made visible to wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier over the 128 threads of one warpgroup (ids 1.. ; 0 is
// __syncthreads)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
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

// round to nearest (ties away from zero) to tf32's 10 mantissa bits; the
// result is a float32 bit pattern whose low 13 bits are 0
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// x = hi + lo, both tf32 (x - hi is exact in f32)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// d (+)= A B^T, m64n16k8: A and B from shared memory (K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A B^T, m64n32k8: A and B from shared memory (K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A B^T, m64n64k8: A and B from shared memory (K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
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

// d (+)= A B^T, m64n8k8: A from registers, B from shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[4],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (+)= A B^T, m64n16k8: A from registers, B from shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (+)= A B^T, m64n32k8: A from registers, B from shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (+)= A B^T, m64n64k8: A from registers, B from shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (+)= A B^T, m64n128k8: A from registers, B from shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (+)= A B^T, m64n256k8: A from registers, B from shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
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
      "}, {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
    flash_attention_tf32_kernel(const __grid_constant__ CUtensorMap q_map,
                                const __grid_constant__ CUtensorMap k_map,
                                const __grid_constant__ CUtensorMap v_map,
                                float* __restrict__ o,
                                float* __restrict__ lse, int sq, int sk,
                                int bh_kv, int group, int causal,
                                int has_window, int window, int q_offset,
                                float scale_log2) {
  using C = Cfg<D>;
  constexpr int kRows = C::kRows;
  constexpr int kKeys = C::kKeys;
  constexpr int kS = kKeys / 2;  // score accumulators per thread
  constexpr int kO = D / 2;      // output accumulators per thread
  constexpr int kConsumers = 128 * C::kWG;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_qhi = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024 B
  const uint32_t s_qlo = s_qhi + C::kQBytes;
  const uint32_t s_khi = s_qlo + C::kQBytes;
  const uint32_t s_klo = s_khi + C::kKBytes;
  const uint32_t s_vhi = s_klo + C::kKBytes;
  const uint32_t s_vlo = s_vhi + C::kVBytes;
  const uint32_t bars = s_vlo + C::kVBytes;
  const uint32_t q_full = bars, k_full = bars + 8, k_empty = bars + 16,
                 v_full = bars + 24, v_empty = bars + 32;
  uint8_t* const smem_base = smem_raw + (s_qhi - raw);

  const int tid = threadIdx.x;
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

  if (n_live == 0) {  // every pair masked: the rows are 0
    const int rows = min(kRows, sq - q0);
    float4* out = reinterpret_cast<float4*>(o + ((size_t)bh * sq + q0) * D);
    for (int i = tid; i < rows * D / 4; i += C::kThreads)
      out[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (lse != nullptr)
      for (int i = tid; i < rows; i += C::kThreads)
        lse[(size_t)bh * sq + q0 + i] = -kNegInf;
    return;
  }

  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(k_full, 1);
    mbar_init(v_full, 1);
    mbar_init(k_empty, kConsumers);
    mbar_init(v_empty, kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // the producer warp: lane 0 issues every TMA load
    if (tid != kConsumers) return;
    mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
    for (int p = 0; p < C::kPanels; ++p)
      tma_load(s_qhi + p * kRows * C::kRowBytes, &q_map, q_full,
               p * C::kPanel, q0, bh);
    for (int j = 0; j < n_live; ++j) {
      const int key0 = (t_lo + j) * kKeys;
      if (j > 0) mbar_wait(k_empty, (j - 1) & 1);
      mbar_expect_tx(k_full, 2 * C::kKBytes);
#pragma unroll
      for (int p = 0; p < C::kPanels; ++p) {
        const uint32_t off = p * kKeys * C::kRowBytes;
        tma_load(s_khi + off, &k_map, k_full, p * C::kPanel, key0, kvh);
        tma_load(s_klo + off, &k_map, k_full, p * C::kPanel, key0,
                 bh_kv + kvh);
      }
      if (j > 0) mbar_wait(v_empty, (j - 1) & 1);
      mbar_expect_tx(v_full, 2 * C::kVBytes);
#pragma unroll
      for (int p = 0; p < C::kVPanels; ++p) {
        const uint32_t off = p * D * C::kVRow;
        const int c0 = key0 + p * (C::kVRow / 4);
        tma_load(s_vhi + off, &v_map, v_full, c0, 0, kvh);
        tma_load(s_vlo + off, &v_map, v_full, c0, 0, bh_kv + kvh);
      }
    }
    return;
  }

  const int wg = tid >> 7;  // consumer warpgroup: rows 64 wg .. 64 wg + 63
  const int wtid = tid & 127;
  const int warp = wtid >> 5;
  const int lane = tid & 31;

  // this warpgroup's rows
  const int w_row0 = q0 + 64 * wg;
  const int w_rows = min(64, sq - w_row0);
  const int w_first = q_offset + w_row0;
  const int w_last = w_first + w_rows - 1;

  // Q: split this warpgroup's 64 rows of every panel in place into hi
  // (where TMA left the f32 values) and lo (the same offset in Q lo);
  // the swizzle moves whole 16-byte chunks, so it does not matter here
  mbar_wait(q_full, 0);
  constexpr int kChunks = 64 * C::kPanel / 4;  // 16-byte chunks a panel
#pragma unroll 4
  for (int i = wtid; i < C::kPanels * kChunks; i += 128) {
    const int p = i / kChunks;
    const int within = i % kChunks;
    const uint32_t off = p * kRows * C::kRowBytes + wg * 64 * C::kRowBytes +
                         within * 16;
    float4* hi = reinterpret_cast<float4*>(smem_base + off);
    float4* lo = reinterpret_cast<float4*>(smem_base + C::kQBytes + off);
    const float4 x = *hi;
    uint32_t h[4], l[4];
    split(x.x, h[0], l[0]);
    split(x.y, h[1], l[1]);
    split(x.z, h[2], l[2]);
    split(x.w, h[3], l[3]);
    *hi = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                      __uint_as_float(h[2]), __uint_as_float(h[3]));
    *lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                      __uint_as_float(l[2]), __uint_as_float(l[3]));
  }
  fence_async_smem();
  wg_sync(wg);

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

  const uint32_t qa_hi = s_qhi + wg * 64 * C::kRowBytes;
  const uint32_t qa_lo = s_qlo + wg * 64 * C::kRowBytes;
  for (int it = 0; it < n_live; ++it) {
    const int k_first = (t_lo + it) * kKeys;
    const int k_last = k_first + kKeys - 1;
    const bool live = w_rows > 0 && !(causal && k_first > w_last) &&
                      !(has_window && w_first - k_last >= window);
    float sc[kS];
    mbar_wait(k_full, it & 1);
    if (live) {
      // S = Q_hi K_hi + Q_hi K_lo + Q_lo K_hi over D / 8 steps of 8
      // (32 bytes within a swizzled row)
#pragma unroll
      for (int i = 0; i < kS; ++i) sc[i] = 0.f;
      reg_fence(sc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        constexpr int kRow = C::kRowBytes, kSteps = C::kSteps;
        const uint32_t qoff =
            (kk / kSteps) * kRows * kRow + (kk % kSteps) * 32;
        const uint32_t koff =
            (kk / kSteps) * kKeys * kRow + (kk % kSteps) * 32;
        const uint64_t kh = desc_sw(s_khi + koff, kRow);
        const uint64_t qh = desc_sw(qa_hi + qoff, kRow);
        wgmma_ss(sc, qh, kh, kk > 0);
        wgmma_ss(sc, qh, desc_sw(s_klo + koff, kRow), 1);
        wgmma_ss(sc, desc_sw(qa_lo + qoff, kRow), kh, 1);
      }
      wg_commit();
      wg_wait0();
      reg_fence(sc);
    }
    mbar_arrive(k_empty);

    uint32_t pa_hi[kKeys / 8][4], pa_lo[kKeys / 8][4];
    if (live) {
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
      // P split into hi and lo as tf32 A fragments, key group g (8 keys)
      // in step g; register r takes accumulator element p_reg(r)
#pragma unroll
      for (int g = 0; g < kKeys / 8; ++g)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split(sc[4 * g + p_reg(r)], pa_hi[g][r], pa_lo[g][r]);
    }

    mbar_wait(v_full, it & 1);
    if (live) {
      // O += P_hi V_hi + P_hi V_lo + P_lo V_hi over kKeys / 8 steps of 8
      reg_fence(acc);
      wg_fence();
#pragma unroll
      for (int g = 0; g < kKeys / 8; ++g) {
        const uint32_t voff = (g * 32 / C::kVRow) * D * C::kVRow +
                              (g * 32) % C::kVRow;
        const uint64_t vh = desc_sw(s_vhi + voff, C::kVRow);
        wgmma_rs(acc, pa_hi[g], vh, 1);
        wgmma_rs(acc, pa_hi[g], desc_sw(s_vlo + voff, C::kVRow), 1);
        wgmma_rs(acc, pa_lo[g], vh, 1);
      }
      wg_commit();
      wg_wait0();
      reg_fence(acc);
    }
    mbar_arrive(v_empty);
  }

  // epilogue: l summed over the 4 lanes of a row, the row statistic,
  // acc / l in f32
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
    *reinterpret_cast<float2*>(o + ((size_t)bh * sq + row) * D + col) =
        make_float2(acc[i] * l[h], acc[i + 1] * l[h]);
  }
}

// The pre-pass: k (bh_kv, sk, d) -> k_split (2, bh_kv, sk_pad, d) = (hi,
// lo); v (bh_kv, sk, d) -> vt_split (2, bh_kv, d, sk_pad), transposed
// with each group of 8 keys in key_order.  Keys past sk are zeros.  One
// block of 32 x 8 threads per (32 keys, 32 columns, kv head), through a
// 32 x 33 shared tile for the transpose; a block's columns past d (d 16)
// are skipped.  Bound by bytes: 8 B read and 16 B written per element
// pair.
__global__ void __launch_bounds__(256) tf32_split_kernel(
    const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ k_split, float* __restrict__ vt_split, int bh_kv,
    int sk, int sk_pad, int d) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int key0 = blockIdx.x * 32, d0 = blockIdx.y * 32, h = blockIdx.z;
  const size_t plane = (size_t)bh_kv * sk_pad * d;  // hi -> lo
  const bool col = d0 + tx < d;
  for (int r = ty; r < 32; r += 8) {
    const int key = key0 + r;
    const size_t src = ((size_t)h * sk + key) * d + d0 + tx;
    const float x = key < sk && col ? k[src] : 0.f;
    const float y = key < sk && col ? v[src] : 0.f;
    uint32_t hi, lo;
    split(x, hi, lo);
    const size_t dst = ((size_t)h * sk_pad + key) * d + d0 + tx;
    if (col) {
      k_split[dst] = __uint_as_float(hi);
      k_split[plane + dst] = __uint_as_float(lo);
    }
    tile[r][tx] = y;
  }
  __syncthreads();
  const int src_key = (tx & ~7) | key_order(tx & 7);
  for (int r = ty; r < 32 && d0 + r < d; r += 8) {
    uint32_t hi, lo;
    split(tile[src_key][r], hi, lo);
    const size_t dst = ((size_t)h * d + d0 + r) * sk_pad + key0 + tx;
    vt_split[dst] = __uint_as_float(hi);
    vt_split[plane + dst] = __uint_as_float(lo);
  }
}

// The fragment probe: one warpgroup issues a wgmma m64n8k8 with A from
// registers, thread (warp w, lane) putting 128 w + 4 lane + r + 1 into
// register r, against B = the 8 x 8 identity in shared memory (128-byte
// swizzle), so D = A: out[row * 8 + k] names the thread and register
// that supply A's element (row, k).  The wrapper checks the kernel's
// key_order and p_reg against it.
__global__ void __launch_bounds__(128) tf32_fragment_probe_kernel(
    float* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_b = (raw + 1023u) & ~1023u;
  float* b = reinterpret_cast<float*>(smem_raw + (s_b - raw));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int i = tid; i < 8 * 32; i += 128) b[i] = 0.f;
  __syncthreads();
  if (tid < 8) {  // B row n (K-major), element k = n, swizzled chunk
    const int n = tid, k = tid;
    b[(n * 128 + (((k / 4) ^ n) * 16) + (k % 4) * 4) / 4] = 1.f;
  }
  fence_async_smem();
  __syncthreads();
  uint32_t a[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    a[r] = __float_as_uint((float)(128 * warp + 4 * lane + r + 1));
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  reg_fence(d);
  wg_fence();
  wgmma_rs(d, a, desc_sw(s_b, 128), 0);
  wg_commit();
  wg_wait0();
  reg_fence(d);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1);
    const int col = 2 * (lane & 3) + (i & 1);
    out[row * 8 + col] = d[i];
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

// a (heads, rows, cols) f32 tensor, boxes of box_cols x box_rows, with the
// swizzle of box_cols * 4 bytes (128 or 64); out-of-bounds rows read as 0
int make_map(CUtensorMap* map, const void* ptr, int cols, int rows,
             int heads, int box_cols, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 4,
                                 (cuuint64_t)cols * 4 * (cuuint64_t)rows};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                        const_cast<void*>(ptr), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_128B
                                       : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
int launch(const void* q, const void* k_split, const void* vt_split, void* o,
           float* lse, int bh, int bh_kv, int sq, int sk, int sk_pad,
           int group, int causal, int has_window, int window, int q_offset,
           float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap qm, km, vm;
  int err = make_map(&qm, q, D, sq, bh, C::kPanel, C::kRows);
  if (!err) err = make_map(&km, k_split, D, sk_pad, 2 * bh_kv, C::kPanel,
                           C::kKeys);
  if (!err) err = make_map(&vm, vt_split, sk_pad, D, 2 * bh_kv,
                           C::kVRow / 4, D);
  if (err) return err;
  auto kern = flash_attention_tf32_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((sq + C::kRows - 1) / C::kRows, bh);
  kern<<<grid, C::kThreads, C::kSmem, stream>>>(
      qm, km, vm, (float*)o, lse, sq, sk, bh_kv, group, causal,
      has_window, window, q_offset, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (bh, sq, d) float32; k_split: (2, bh_kv, sk_pad, d) and vt_split:
// (2, bh_kv, d, sk_pad), tf32_split_launch's output; o: (bh, sq, d)
// float32; all contiguous and 16-byte aligned, d in {16, 32, 64, 128,
// 256}, sk_pad a positive multiple of 64 and >= sk; lse: (bh, sq)
// float32, or null for no row statistic.
extern "C" int flash_attention_tf32_launch(const void* q, const void* k_split,
                                           const void* vt_split, void* o,
                                           void* lse, int bh, int bh_kv,
                                           int sq, int sk, int sk_pad, int d,
                                           int causal, int has_window,
                                           int window,
                                           int q_offset, float scale,
                                           void* stream) {
  if (bh < 0 || bh_kv <= 0 || bh % bh_kv != 0 || sq < 0 || sk < 0 ||
      q_offset < 0 || bh > 65535 || sk_pad < sk || sk_pad <= 0 ||
      sk_pad % kKeyPad != 0)
    return (int)cudaErrorInvalidValue;
  if (bh == 0 || sq == 0) return 0;
  const int group = bh / bh_kv;
  cudaStream_t st = (cudaStream_t)stream;
  float* l = (float*)lse;
  switch (d) {
    case 16:
      return launch<16>(q, k_split, vt_split, o, l, bh, bh_kv, sq, sk,
                        sk_pad, group, causal, has_window, window, q_offset,
                        scale, st);
    case 32:
      return launch<32>(q, k_split, vt_split, o, l, bh, bh_kv, sq, sk,
                        sk_pad, group, causal, has_window, window, q_offset,
                        scale, st);
    case 64:
      return launch<64>(q, k_split, vt_split, o, l, bh, bh_kv, sq, sk,
                        sk_pad, group, causal, has_window, window, q_offset,
                        scale, st);
    case 128:
      return launch<128>(q, k_split, vt_split, o, l, bh, bh_kv, sq, sk,
                         sk_pad, group, causal, has_window, window, q_offset,
                         scale, st);
    case 256:
      return launch<256>(q, k_split, vt_split, o, l, bh, bh_kv, sq, sk,
                         sk_pad, group, causal, has_window, window, q_offset,
                         scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// k, v: (bh_kv, sk, d) float32; k_split: (2, bh_kv, sk_pad, d); vt_split:
// (2, bh_kv, d, sk_pad); d a multiple of 16, sk_pad a multiple of 64 >= sk.
extern "C" int tf32_split_launch(const void* k, const void* v, void* k_split,
                                 void* vt_split, int bh_kv, int sk,
                                 int sk_pad, int d, void* stream) {
  if (bh_kv <= 0 || sk < 0 || sk_pad < sk || sk_pad % kKeyPad != 0 ||
      d <= 0 || d % 16 != 0 || bh_kv > 65535)
    return (int)cudaErrorInvalidValue;
  if (sk_pad == 0) return 0;
  const dim3 grid(sk_pad / 32, (d + 31) / 32, bh_kv);
  tf32_split_kernel<<<grid, dim3(32, 8), 0, (cudaStream_t)stream>>>(
      (const float*)k, (const float*)v, (float*)k_split, (float*)vt_split,
      bh_kv, sk, sk_pad, d);
  return (int)cudaGetLastError();
}

// out: (64, 8) float32 (see tf32_fragment_probe_kernel)
extern "C" int tf32_fragment_probe_launch(void* out, void* stream) {
  tf32_fragment_probe_kernel<<<1, 128, 2048, (cudaStream_t)stream>>>(
      (float*)out);
  return (int)cudaGetLastError();
}
