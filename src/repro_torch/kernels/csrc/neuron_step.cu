// The head of one simulation step in one launch, for Hopper (sm_90a):
// ring slot + drive, LIF+SFA, slot zeroing, delivered-row bitmap, count.
//
// Replaces the TPU kernel repro/kernels/lif_step.py:lif_step_pallas
// (_kernel) on the engine's step, fused with the elementwise work the
// reference's step does around it (repro/core/engine.py: step reads
// i_ring[slot] + drive, runs the LIF update, sets i_ring[slot] to 0) and
// with the drop rule of the reference's compaction
// (repro/kernels/synaptic_accum.py: compact_events delivers the first
// active_cap spiking rows, ascending), written as the bitmap the column
// delivery kernel reads (kernels/ref.py: delivered_bits).
//
// Bound: memory traffic.  Per neuron 21 B are read (the ring word, the
// drive, v, c, refrac and the active byte) and 20.125 B written (v', c',
// refrac', spk, the zeroed ring word and one bitmap bit): 3.26 MB at
// 79,360 neurons, 0.974 us at 3.35 TB/s.  At that size a launch's fixed
// ramp and tail are most of the time, so the design's aim is one launch
// in place of the dozen small ones it replaces (the add, the LIF kernel,
// the zeroing, and the cumsum, pack and sum of the bitmap and count).
//
//   * One thread per neuron, 256-thread blocks.  Each warp's 32 rows
//     give one bitmap word by __ballot_sync (bit r % 32 of word r / 32
//     is row r); the grid covers the sink row and the padding, whose
//     bits are 0.
//   * Each block's thread 0 writes the block's 8 words, then adds the
//     block's count and one ticket to a single 64-bit word (ticket in
//     the high half, count in the low half) with one atomic.  The block
//     that draws the last ticket has the total, writes the count and
//     resets the word to 0 for the next launch.  Only when the count
//     exceeds active_cap does it also clear the bits of rows past rank
//     active_cap, with a popcount prefix over the words.
//   * v, c and refrac may be updated in place (out == in): each thread
//     reads its own elements before it writes them, so no pointer here
//     is __restrict__ but the ones that never alias.
//
// Rounding contract: as csrc/lif_step.cu, the two fused multiply-adds of
// the reference's XLA build are stated with __fmaf_rn and every other
// operation with __f*_rn; the ring + drive sum is __fadd_rn, as the
// reference adds them in float32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Block-wide exclusive prefix sum of one int per thread.  Every thread
// of the block must call it.
__device__ int block_exclusive_scan(int x) {
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int base = 0;
  for (int w = 0; w < warp; ++w) base += warp_sums[w];
  return base + incl - x;
}

// the lowest `room` set bits of x (room <= 0: none)
__device__ __forceinline__ unsigned lowest_bits(unsigned x, int room) {
  unsigned keep = 0;
  for (int j = 0; j < room && x != 0; ++j) {
    const unsigned low = x & (0u - x);
    keep |= low;
    x ^= low;
  }
  return keep;
}

__global__ void __launch_bounds__(kThreads) neuron_step_kernel(
    float* ring_row, const float* __restrict__ drive, const float* v,
    const float* c, const int32_t* refrac,
    const uint8_t* __restrict__ active, float* v_out, float* c_out,
    int32_t* refrac_out, float* __restrict__ spk_out, unsigned* bits,
    int n_words, int32_t* count_out, int active_cap,
    unsigned long long* ticket_count, int n, float leak_decay,
    float neg_g_dt, float v_rest, float v_reset, float theta,
    float sfa_decay, float alpha_c, int refrac_steps) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool spiked = false;
  if (k < n) {
    const float i_total = __fadd_rn(ring_row[k], drive[k]);
    ring_row[k] = 0.0f;
    const float vk = v[k];
    const float ck = c[k];
    const int32_t rk = refrac[k];
    const bool has_rest = v_rest != 0.0f;
    const float u = has_rest ? __fsub_rn(vk, v_rest) : vk;
    float v_int = __fmaf_rn(neg_g_dt, ck, __fmaf_rn(u, leak_decay, i_total));
    if (has_rest) v_int = __fadd_rn(v_int, v_rest);
    const float v_new = rk > 0 ? v_reset : v_int;
    spiked = (v_new >= theta) && (active[k] != 0);
    const float s = spiked ? 1.0f : 0.0f;
    v_out[k] = spiked ? v_reset : v_new;
    c_out[k] = __fmaf_rn(ck, sfa_decay, __fmul_rn(alpha_c, s));
    refrac_out[k] = spiked ? refrac_steps : (rk > 1 ? rk - 1 : 0);
    spk_out[k] = s;
  }
  const unsigned word = __ballot_sync(kFull, spiked);
  __shared__ unsigned words[kWarps];
  __shared__ bool is_last;
  __shared__ int total;
  if (lane == 0) words[warp] = word;
  __syncthreads();
  if (threadIdx.x == 0) {
    // one thread writes the block's words, so that its one fence orders
    // them before the ticket
    int sum = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int gw = blockIdx.x * kWarps + w;
      if (bits != nullptr && gw < n_words) bits[gw] = words[w];
      sum += __popc(words[w]);
    }
    if (bits != nullptr) __threadfence();
    const unsigned long long old =
        atomicAdd(ticket_count, (1ull << 32) | (unsigned long long)sum);
    is_last = (old >> 32) == gridDim.x - 1;
    total = (int)(old & 0xffffffffull) + sum;
  }
  __syncthreads();
  if (!is_last) return;

  // the last block: the total is known, and every block's words are
  // visible once this block's acquire fence is past
  if (threadIdx.x == 0) {
    *count_out = total;
    *ticket_count = 0ull;
  }
  if (bits == nullptr || total <= active_cap) return;
  __threadfence();
  // keep the first active_cap set bits: each thread a run of words
  const int per = (n_words + kThreads - 1) / kThreads;
  const int w0 = min((int)threadIdx.x * per, n_words);
  const int w1 = min(w0 + per, n_words);
  int mine = 0;
  for (int w = w0; w < w1; ++w) mine += __popc(__ldcg(bits + w));
  int before = block_exclusive_scan(mine);
  for (int w = w0; w < w1; ++w) {
    const unsigned x = __ldcg(bits + w);
    const int pc = __popc(x);
    if (before + pc > active_cap)
      bits[w] = lowest_bits(x, active_cap - before);
    before += pc;
  }
}

int grid_for(int n) {
  const int n_words = n / 32 + 1;  // rows 0 .. n (the sink), 32 a word
  return (n_words + kWarps - 1) / kWarps;
}

}  // namespace

// ring_row: the ring's row of this step's slot (read, then zeroed).
// bits: int32 (n / 32 + 1,) words, or null (no bitmap).  count_out: one
// int32.  ticket_count: one 64-bit word, 0 before the first launch (each
// launch leaves it 0).
extern "C" int neuron_step_launch(
    void* ring_row, const void* drive, const void* v, const void* c,
    const void* refrac, const void* active, void* v_out, void* c_out,
    void* refrac_out, void* spk_out, void* bits, void* count_out,
    int active_cap, void* ticket_count, int n, float leak_decay,
    float neg_g_dt, float v_rest, float v_reset, float theta,
    float sfa_decay, float alpha_c, int refrac_steps, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  neuron_step_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (float*)ring_row, (const float*)drive, (const float*)v,
      (const float*)c, (const int32_t*)refrac, (const uint8_t*)active,
      (float*)v_out, (float*)c_out, (int32_t*)refrac_out, (float*)spk_out,
      (unsigned*)bits, n / 32 + 1, (int32_t*)count_out, active_cap,
      (unsigned long long*)ticket_count, n, leak_decay, neg_g_dt, v_rest,
      v_reset, theta, sfa_decay, alpha_c, refrac_steps);
  return (int)cudaGetLastError();
}
