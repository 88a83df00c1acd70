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
// So the kernel pulls: one warp per target j.  The warp keeps j's d_ring
// ring words in lanes 0..d_ring-1, walks j's incoming slots 32 at a time
// (coalesced slot reads), and each lane keeps its slot if it lies in this
// tier and its source row was delivered this step (flag[row], from the
// compaction's rank).  A kept lane reads the OLD weight and delay, and
// for a plastic synapse writes w' = w + (neg_a_minus * x_post[j]) * mask
// in place (each synapse has one target, so no two warps write one
// weight).  The kept slots are then added into the ring words in slot
// order: a ballot lists them, and for each in turn the weight and slot
// are broadcast by shuffle and the lane owning that ring word adds it.
// Every add and multiply is rounded on its own (__fadd_rn/__fmul_rn, and
// the build passes --fmad=false), as XLA computes them in the reference.
//
// Bound: device-memory traffic.  It reads every slot of the index
// (4 B per synapse of the tier's targets, whatever fires) and, for the
// delivered synapses only, gathers weight, delay and mask (9 B, random
// rows) and writes w' (4 B); the ring is read and written once.  The
// gathers are sector-sized (32 B per 4 B used), so the kernel runs well
// below the byte bound; a sort of the delivered entries by target would
// make them coalesced, at the price of a sort per step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__global__ void plastic_delivery_kernel(
    const int32_t* __restrict__ slots, const int32_t* __restrict__ n_in,
    int n_targets, int k_in, long long base, long long size, int cap,
    const uint8_t* __restrict__ flag, float* __restrict__ w,
    const int8_t* __restrict__ dslot, const float* __restrict__ mask,
    const float* __restrict__ x_post, float neg_a_minus,
    float* __restrict__ ring, int n_local, int d_ring, int t_slot) {
  const int j = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (j >= n_targets) return;  // whole warps only: the shuffles stay full
  float r = lane < d_ring ? ring[(size_t)lane * n_local + j] : 0.0f;
  const float dw_unit = mask ? __fmul_rn(neg_a_minus, x_post[j]) : 0.0f;
  const int n = n_in[j];
  const int32_t* row_slots = slots + (size_t)j * k_in;
  for (int s0 = 0; s0 < n; s0 += 32) {
    const int s = s0 + lane;
    bool keep = false;
    float wv = 0.0f;
    int ring_row = 0;
    if (s < n) {
      const long long v = (long long)row_slots[s] - base;
      if (v >= 0 && v < size && flag[v / cap]) {
        keep = true;
        wv = w[v];
        ring_row = (t_slot + (int)dslot[v]) % d_ring;
        if (mask) {
          const float m = mask[v];
          if (m > 0.0f) w[v] = __fadd_rn(wv, __fmul_rn(dw_unit, m));
        }
      }
    }
    unsigned kept = __ballot_sync(kFull, keep);
    while (kept) {
      const int src = __ffs(kept) - 1;
      kept &= kept - 1;
      const float wi = __shfl_sync(kFull, wv, src);
      const int ri = __shfl_sync(kFull, ring_row, src);
      if (lane == ri) r = __fadd_rn(r, wi);
    }
  }
  if (lane < d_ring) ring[(size_t)lane * n_local + j] = r;
}

}  // namespace

// One tier: slots/n_in are the inverse index over all tiers, [base,
// base + size) this tier's virtual range, cap its row capacity; flag has
// one byte per row (sink row included).  mask and x_post may both be null
// (delivery only: the weights are not written).  Returns cudaError_t.
extern "C" int plastic_delivery_launch(
    const void* slots, const void* n_in, int n_targets, int k_in,
    long long base, long long size, int cap, const void* flag, void* w,
    const void* dslot, const void* mask, const void* x_post,
    float neg_a_minus, void* ring, int n_local, int d_ring, int t_slot,
    void* stream) {
  if (d_ring < 1 || d_ring > 32 || cap < 1 || k_in < 1 ||
      (mask == nullptr) != (x_post == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_targets <= 0) return 0;
  const int threads = 256;  // 8 warps: 8 targets per block
  const int per_block = threads / 32;
  const int blocks = (n_targets + per_block - 1) / per_block;
  plastic_delivery_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)slots, (const int32_t*)n_in, n_targets, k_in, base,
      size, cap, (const uint8_t*)flag, (float*)w, (const int8_t*)dslot,
      (const float*)mask, (const float*)x_post, neg_a_minus, (float*)ring,
      n_local, d_ring, t_slot);
  return (int)cudaGetLastError();
}
