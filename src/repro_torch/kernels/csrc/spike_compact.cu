// Spike compaction for Hopper (sm_90a): one launch, many blocks, one pass.
//
// Replaces the TPU kernel repro/kernels/spike_compact.py:spike_compact_pallas
// (_compact_kernel), which streamed the spike mask in (8, 128) chunks on a
// sequential grid, carried the running count in SMEM scratch, and
// scattered each spiking index to its output slot with a one-hot MXU
// product (indices carried as float32).  Output: the ascending indices of
// the first min(count, cap) rows with spikes > 0, the sink row n_rows in
// the remaining slots, and the uncapped count, all exact int32.
//
// Bound: the mask is read once (4 B per row) and idx written once (4 B
// per slot): at 79,360 rows and cap 63,520 that is 0.57 MB, 0.17 us at
// 3.35 TB/s, so what a design can win is latency.  Measured on an H100
// (chip_smoke.py, PERF.md): 6.3 us of device time per call at 79,360
// rows and 8.0 us at 714,240, where the one-block kernel this design
// replaced took 53 us and 454 us; the wrapper's host work (20-50 us a
// call) is now the larger part of a call.  Design:
//
//   * tiles of 4096 rows; a persistent grid of at most as many blocks as
//     fit on the card at once (the wrapper asks the occupancy API), each
//     walking tiles blockIdx.x, + gridDim.x, ...; 256 threads, each warp
//     a run of 512 rows read as four coalesced float4 loads per lane (a
//     scalar tail at n_rows and for a spike vector that is not 16-byte
//     aligned);
//   * a warp ranks its rows with one __ballot_sync per float4 lane
//     (__popc of the lanes below); one scan of the 8 warp totals per tile;
//   * the tile's offset comes from decoupled look-back over a status
//     array of 64-bit words (epoch:30 | flag:2 | value:32), flag A = the
//     tile's own count, P = the inclusive prefix: warp 0 publishes A,
//     reads up to 32 predecessors at once, sums back to the nearest P and
//     publishes P.  The epoch is a per-call tag held on the device, in the
//     status array's header (word 0; word 1 counts the blocks done): every
//     block reads it at its start, and the call's last block to finish
//     advances it, so words of earlier calls read as not yet published
//     and the array needs no clearing launch between calls.  A call
//     replayed from a CUDA graph tags its words afresh, as an eager call
//     does.  At the last epoch the last block clears the tile words and
//     starts again at epoch 1;
//   * once the last tile's P is published, every block reads the total
//     and fills its share of the sink tail [min(total, cap), cap).  The
//     wait is safe because every block of the grid is resident at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 4;                         // float4 per lane per tile
constexpr int kWarpRows = 32 * 4 * kVecs;        // 512
constexpr int kTileRows = kWarps * kWarpRows;    // 4096
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kFlagA = 1;  // the tile's own count
constexpr uint32_t kFlagP = 2;  // the inclusive prefix through the tile
constexpr int kHeader = 2;      // status words before the tiles' words
constexpr uint32_t kEpochs = 1u << 30;  // tags 1 .. kEpochs - 1

typedef unsigned long long u64;

__device__ __forceinline__ u64 ld_acquire(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(u64* p, u64 v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ u64 status_word(uint32_t epoch, uint32_t flag,
                                           uint32_t value) {
  return ((u64)((epoch << 2) | flag) << 32) | value;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// the word of tile k once it is published in this call: spin until then.
// A wait of more than 4 s is a fault (a grid larger than the card holds
// at once, or a header not advanced by the previous call) and traps: an
// error, not a hang
__device__ __forceinline__ u64 wait_status(const u64* status, int k,
                                           uint32_t epoch, uint32_t need) {
  uint64_t t0 = 0;
  for (int spin = 0;; ++spin) {
    const u64 w = ld_acquire(status + k);
    if ((uint32_t)(w >> 34) == epoch && ((w >> 32) & 3u) >= need) return w;
    if (spin == 0) t0 = global_ns();
    else if (global_ns() - t0 > 4000000000ull) __trap();
  }
}

// live bits of rows r .. r + 3 (bit e: row r + e)
__device__ __forceinline__ uint32_t live4(const float* __restrict__ spikes,
                                          int r, int n, int vec) {
  if (vec && r + 3 < n) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(spikes + r));
    return (uint32_t)(x.x > 0.f) | ((uint32_t)(x.y > 0.f) << 1) |
           ((uint32_t)(x.z > 0.f) << 2) | ((uint32_t)(x.w > 0.f) << 3);
  }
  uint32_t m = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (r + e < n && spikes[r + e] > 0.f) m |= 1u << e;
  return m;
}

__global__ void __launch_bounds__(kThreads) spike_compact_kernel(
    const float* __restrict__ spikes, int n_rows, int cap, int n_tiles,
    int vec, int32_t* __restrict__ idx, int32_t* __restrict__ count,
    u64* __restrict__ header, int status_len) {
  __shared__ int warp_base[kWarps];
  __shared__ int tile_base;
  __shared__ uint32_t s_epoch;
  __shared__ int s_last;
  u64* __restrict__ status = header + kHeader;
  const int tid = threadIdx.x;
  // this call's epoch: no block advances it before every block of the
  // call has read it (the advance waits for all blocks to be done)
  if (tid == 0) s_epoch = (uint32_t)ld_acquire(header);
  __syncthreads();
  const uint32_t epoch = s_epoch;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;

  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    // lane's rows: row0 + 128 v + 4 lane + e, v < kVecs, e < 4
    const int row0 = t * kTileRows + warp * kWarpRows;
    uint32_t bits[kVecs];
#pragma unroll
    for (int v = 0; v < kVecs; ++v)
      bits[v] = live4(spikes, row0 + 128 * v + 4 * lane, n_rows, vec);
    int before[kVecs];  // the warp's live rows ahead of lane's group v
    int warp_count = 0;
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      int ahead = 0, tot = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const unsigned b = __ballot_sync(kFull, (bits[v] >> e) & 1u);
        ahead += __popc(b & below);
        tot += __popc(b);
      }
      before[v] = warp_count + ahead;
      warp_count += tot;
    }
    if (lane == 0) warp_base[warp] = warp_count;
    __syncthreads();

    if (warp == 0) {
      const int x = lane < kWarps ? warp_base[lane] : 0;
      int incl = x;
#pragma unroll
      for (int off = 1; off < kWarps; off <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += y;
      }
      const int total = __shfl_sync(kFull, incl, kWarps - 1);
      if (lane < kWarps) warp_base[lane] = incl - x;
      int prefix = 0;
      if (t == 0) {
        if (lane == 0) st_release(status, status_word(epoch, kFlagP, total));
      } else {
        if (lane == 0)
          st_release(status + t, status_word(epoch, kFlagA, total));
        // lane i reads tile top - i; stop at the nearest P
        for (int top = t - 1;; top -= 32) {
          const int k = top - lane;
          uint32_t flag = kFlagP, val = 0;
          if (k >= 0) {
            const u64 w = wait_status(status, k, epoch, kFlagA);
            flag = (uint32_t)(w >> 32) & 3u;
            val = (uint32_t)w;
          }
          const unsigned p = __ballot_sync(kFull, flag == kFlagP);
          const int nearest = p ? __ffs(p) - 1 : 32;
          int part = lane <= nearest ? (int)val : 0;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            part += __shfl_xor_sync(kFull, part, off);
          prefix += part;
          if (p) break;
        }
        if (lane == 0)
          st_release(status + t, status_word(epoch, kFlagP, prefix + total));
      }
      if (lane == 0) tile_base = prefix;
    }
    __syncthreads();

    const int base = tile_base + warp_base[warp];
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!((bits[v] >> e) & 1u)) continue;
        const int rank = base + before[v] + __popc(bits[v] & ((1u << e) - 1u));
        if (rank < cap) idx[rank] = row0 + 128 * v + 4 * lane + e;
      }
    }
    __syncthreads();  // warp_base and tile_base are reused by the next tile
  }

  // the total, once the last tile's prefix is published; then the sink
  // tail, split over the grid
  int total = 0;
  if (n_tiles > 0) {
    if (tid == 0)
      tile_base = (int)(uint32_t)wait_status(status, n_tiles - 1, epoch,
                                             kFlagP);
    __syncthreads();
    total = tile_base;
  }
  for (int i = min(total, cap) + blockIdx.x * kThreads + tid; i < cap;
       i += gridDim.x * kThreads)
    idx[i] = n_rows;
  if (blockIdx.x == 0 && tid == 0) *count = total;

  // the last block done advances the epoch for the next call on the
  // stream (and, at the last epoch, clears the tile words first)
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    s_last = atomicAdd(header + 1, 1ull) == (u64)(gridDim.x - 1);
  }
  __syncthreads();
  if (!s_last) return;
  const bool wrap = epoch + 1 >= kEpochs;
  if (wrap)
    for (int i = tid; i < status_len; i += kThreads) status[i] = 0;
  __syncthreads();
  if (tid == 0) {
    header[1] = 0;
    __threadfence();
    st_release(header, wrap ? 1ull : (u64)(epoch + 1));
  }
}

}  // namespace

extern "C" int spike_compact_tile_rows() { return kTileRows; }

// blocks of the kernel that fit on the device at once
extern "C" int spike_compact_max_blocks(int device, int* out) {
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, spike_compact_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  *out = sms * per_sm;
  return 0;
}

extern "C" int spike_compact_header_words() { return kHeader; }

// spikes: float32 (>= n_rows,), 16-byte aligned if vec; idx: int32 (cap,);
// count: int32 (1,); status: (kHeader + status_len) 64-bit words: the
// header (the epoch, 1 .. 2^30 - 1, then the blocks done, 0) and
// status_len >= the tiles of n_rows words, none of them tagged with a
// later epoch than the header's (all zero at first); grid: blocks, at
// least 1 and at most spike_compact_max_blocks.  Calls that share a
// status array must run in stream order.
extern "C" int spike_compact_launch(const void* spikes, int n_rows, int cap,
                                    void* idx, void* count, void* status,
                                    int status_len, int grid, int vec,
                                    void* stream) {
  const int n_tiles = (int)(((long long)n_rows + kTileRows - 1) / kTileRows);
  if (n_rows < 0 || cap < 0 || grid < 1 || status_len < n_tiles)
    return (int)cudaErrorInvalidValue;
  spike_compact_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)spikes, n_rows, cap, n_tiles, vec, (int32_t*)idx,
      (int32_t*)count, (u64*)status, status_len);
  return (int)cudaGetLastError();
}
