// Fixed-order event delivery fused with STDP's LTD, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/plastic_step.py:plastic_delivery_ltd
// (_plastic_kernel), which streamed the lane-packed entry blocks of the
// delivered rows once, scatter-added their weights into a VMEM-resident
// ring with a one-hot MXU contraction, and wrote the depressed weights
// back.  Here the weights are float32 (plastic runs, or a static run with
// float32 storage), so the order of the additions into each ring word is
// part of the result, and float atomics cannot give the reference's
// order.  The reference adds the delivered entries one after another in
// (row, k) order; for one target that is the order of its slots in the
// target-major inverse index (core/stdp.py: build_inverse_index).
//
// So the kernel pulls: one warp per target j, on a persistent grid whose
// blocks first copy the delivered-row bitmap (one bit per source row,
// ref.delivered_bits) into shared memory.  The warp keeps j's d_ring ring
// words in lanes 0..d_ring-1 and walks j's incoming slots 32 at a time.
// Each lane turns its virtual slot into a tier-local one, v, finds v's
// row by a 32-bit multiply-high and shift (the divisor is the tier's row
// capacity; constants from the wrapper), and keeps the slot if the
// row's bit is set.  Delay and plastic bit come from the target-major
// byte array tm (core/stdp.py: target_major_meta), read coalesced beside
// the slots, so a kept slot gathers only its OLD weight and, if plastic,
// writes w' = w + neg_a_minus * x_post[j] in place (the masks are exactly
// 0 or 1, so this is the reference's w + dw_unit * mask; each synapse has
// one target, so no two warps write one weight).  The kept weights are
// then added into the ring words in slot order, one chain per ring word:
// lane ri takes the ballot of the kept lanes whose ring row is ri and
// adds their weights in lane order, one shuffle per step, all chains at
// once.  The order into each word (lane order within a chunk, chunks in
// order) is the reference's.  Every add and multiply is rounded on its
// own (__fadd_rn/__fmul_rn, and the build passes --fmad=false), as XLA
// computes them in the reference.  Each block also adds the nnz of its
// share of the delivered rows to the event counter.
//
// Bound: device-memory traffic.  The function needs only the delivered
// synapses' entries (target, weight, delay, mask), the new weights, the
// ring and x_post.  This pull design reads more: every slot of the index
// and its tm byte (5 B per synapse of the tier's targets, whatever
// fires), then, for the delivered synapses only, gathers the weight (4 B,
// random rows, sector-sized: 32 B per 4 B used) and writes w' (4 B); the
// ring is read and written once.  At low rates the index walk is most of
// its traffic, the price of the fixed order without a sort.  The previous
// kernel also gathered delay and mask, divided in 64 bits for every slot
// and ran one serial chain over all kept lanes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;  // 8 warps: 8 targets at a time per block
constexpr int kUnroll = 4;     // 32-slot chunks read ahead per warp
// Shared memory the kernel declares statically (count_events' block_sum):
// the wrapper fits the bitmap into what a block has beside it
// (plastic_step.py: STATIC_SMEM holds the same number).
constexpr int kStaticSmem = 64;
static_assert(sizeof(int) <= kStaticSmem,
              "the static shared arrays outgrew their reserve");

// The nnz of the delivered rows whose bitmap words fall to this block.
__device__ void count_events(const uint32_t* __restrict__ bits, int n_words,
                             const int32_t* __restrict__ nnz,
                             int32_t* __restrict__ events) {
  __shared__ int block_sum;
  if (threadIdx.x == 0) block_sum = 0;
  __syncthreads();
  int sum = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_words;
       i += gridDim.x * blockDim.x) {
    for (uint32_t b = bits[i]; b; b &= b - 1)
      sum += nnz[i * 32 + __ffs(b) - 1];
  }
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_down_sync(kFull, sum, o);
  if ((threadIdx.x & 31) == 0 && sum) atomicAdd(&block_sum, sum);
  __syncthreads();
  if (threadIdx.x == 0 && block_sum) atomicAdd(events, block_sum);
}

__global__ void __launch_bounds__(kThreads) plastic_delivery_kernel(
    const int32_t* __restrict__ slots, const int32_t* __restrict__ n_in,
    const int8_t* __restrict__ tm, int n_targets, int k_in, int base,
    int size, unsigned magic, int shift, const uint32_t* __restrict__ bits,
    int n_words, const int32_t* __restrict__ nnz,
    int32_t* __restrict__ events, float* __restrict__ w,
    const float* __restrict__ x_post, float neg_a_minus, bool ltd,
    float* __restrict__ ring, int n_local, int d_ring, int t_slot) {
  extern __shared__ uint32_t sbits[];
  for (int i = threadIdx.x; i < n_words; i += blockDim.x) sbits[i] = bits[i];
  if (events) count_events(bits, n_words, nnz, events);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int j = blockIdx.x * warps + (threadIdx.x >> 5); j < n_targets;
       j += gridDim.x * warps) {
    float r = lane < d_ring ? ring[(size_t)lane * n_local + j] : 0.0f;
    const float dw_unit = ltd ? __fmul_rn(neg_a_minus, x_post[j]) : 0.0f;
    const int n = n_in[j];
    const int32_t* row_slots = slots + (size_t)j * k_in;
    const int8_t* row_tm = tm + (size_t)j * k_in;
    for (int s0 = 0; s0 < n; s0 += 32 * kUnroll) {
      unsigned vs[kUnroll];  // tier-local slots, kUnroll chunks in flight
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int s = s0 + u * 32 + lane;
        vs[u] = s < n ? (unsigned)(row_slots[s] - base) : 0xffffffffu;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {  // the chunks in slot order
        const unsigned v = vs[u];
        bool keep = false;
        float wv = 0.0f;
        int ring_row = -1;
        if (v < (unsigned)size) {  // in this tier (v < 2^31)
          const unsigned row = __umulhi(v << 1, magic) >> shift;  // v / cap
          if ((sbits[row >> 5] >> (row & 31)) & 1u) {
            const int m = (int)(uint8_t)row_tm[s0 + u * 32 + lane];
            keep = true;
            wv = w[v];
            ring_row = (t_slot + (m & 0x7f)) % d_ring;
            if (ltd && (m & 0x80)) w[v] = __fadd_rn(wv, dw_unit);
          }
        }
        if (!__ballot_sync(kFull, keep)) continue;
        // one chain per ring word: lane ri adds the kept weights whose
        // ring row is ri, in lane order
        unsigned mine = 0u;
        for (int ri = 0; ri < d_ring; ++ri) {
          const unsigned b = __ballot_sync(kFull, ring_row == ri);
          if (lane == ri) mine = b;
        }
        while (__any_sync(kFull, mine != 0u)) {
          const int src = mine ? __ffs(mine) - 1 : lane;
          const float wi = __shfl_sync(kFull, wv, src);
          if (mine) {
            r = __fadd_rn(r, wi);
            mine &= mine - 1;
          }
        }
      }
    }
    if (lane < d_ring) ring[(size_t)lane * n_local + j] = r;
  }
}

}  // namespace

// One tier: slots/n_in/tm are the target-major index over all tiers,
// [base, base + size) this tier's virtual range (size < 2^31), and
// magic/shift divide a tier-local slot by the tier's row capacity
// (row = umulhi(v << 1, magic) >> shift).  bits: the delivered-row bitmap
// of the tier, n_words words (the wrapper checks they fit the shared
// memory a block has beside kStaticSmem); nnz and events (may be null)
// count the events.  ltd: write w' for the plastic synapses; x_post may
// be null without it.
// Returns cudaError_t.
extern "C" int plastic_delivery_launch(
    const void* slots, const void* n_in, const void* tm, int n_targets,
    int k_in, int base, int size, unsigned magic, int shift, const void* bits,
    int n_words, const void* nnz, void* events, void* w, const void* x_post,
    float neg_a_minus, int ltd, void* ring, int n_local, int d_ring,
    int t_slot, void* stream) {
  if (d_ring < 1 || d_ring > 32 || k_in < 1 || n_words < 1 ||
      (ltd && x_post == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_targets <= 0) return 0;
  const size_t smem = (size_t)n_words * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        plastic_delivery_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // persistent grid: as many blocks as fit on the card at once (looked up
  // again only when the bitmap's size or the device changes)
  static int last_dev = -1, sms = 0, per_sm = 0;
  static size_t last_smem = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev != last_dev || smem != last_smem) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, plastic_delivery_kernel, kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    last_dev = dev;
    last_smem = smem;
  }
  const int warps = kThreads / 32;
  int blocks = (n_targets + warps - 1) / warps;
  if (blocks > sms * per_sm) blocks = sms * per_sm;
  if (blocks < 1) blocks = 1;
  plastic_delivery_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)slots, (const int32_t*)n_in, (const int8_t*)tm,
      n_targets, k_in, base, size, magic, shift, (const uint32_t*)bits,
      n_words, (const int32_t*)nnz, (int32_t*)events, (float*)w,
      (const float*)x_post, neg_a_minus, ltd != 0, (float*)ring, n_local,
      d_ring, t_slot);
  return (int)cudaGetLastError();
}
