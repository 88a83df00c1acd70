// Spike compaction for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/spike_compact.py:spike_compact_pallas
// (_compact_kernel), which streamed the spike mask in (8, 128) chunks on a
// sequential grid, carried the running count in SMEM scratch, and
// scattered each spiking index to its output slot with a one-hot MXU
// product (indices carried as float32).  Here one block of 1024 threads
// loops over the mask 1024 entries at a time: an exact int32 block prefix
// scan (warp shuffles, then a scan of the 32 warp totals) gives each
// spiking row its rank, the row is written to idx[rank] while rank < cap,
// and the running count moves on.  At the end the tail of idx is filled
// with the sink row n_rows and the uncapped count is stored.
//
// Bound: the mask is read once (4 B per row) and idx written once (4 B per
// slot); at ~80K rows that is under 1 MB, so one block's loop of ~80
// iterations and the launch itself, not the bytes, set the time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads) spike_compact_kernel(
    const float* __restrict__ spikes, int n_rows, int cap,
    int32_t* __restrict__ idx, int32_t* __restrict__ count) {
  __shared__ int warp_sum[32];
  __shared__ int running;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) running = 0;
  __syncthreads();
  for (int c0 = 0; c0 < n_rows; c0 += kThreads) {
    const int row = c0 + tid;
    const int live = (row < n_rows && spikes[row] > 0.0f) ? 1 : 0;
    int incl = live;  // inclusive scan within the warp
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {  // exclusive scan of the warp totals
      const int t = warp_sum[lane];
      int s = t;
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, s, off);
        if (lane >= off) s += y;
      }
      warp_sum[lane] = s - t;
    }
    __syncthreads();
    const int base = running;
    const int rank = base + warp_sum[warp] + incl - 1;
    if (live && rank < cap) idx[rank] = row;
    __syncthreads();  // every thread has read running and warp_sum
    if (tid == kThreads - 1) running = rank + 1;
    __syncthreads();
  }
  const int total = running;
  for (int i = (total < cap ? total : cap) + tid; i < cap; i += kThreads)
    idx[i] = n_rows;
  if (tid == 0) *count = total;
}

}  // namespace

// spikes: float32 (>= n_rows,); idx: int32 (cap,); count: int32 (1,).
extern "C" int spike_compact_launch(const void* spikes, int n_rows, int cap,
                                    void* idx, void* count, void* stream) {
  if (n_rows < 0 || cap < 0) return (int)cudaErrorInvalidValue;
  spike_compact_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)spikes, n_rows, cap, (int32_t*)idx, (int32_t*)count);
  return (int)cudaGetLastError();
}
