// Event delivery (row gather fused with the ring scatter-add) for Hopper
// (sm_90a): two kernels.
//
// Both replace the TPU kernel repro/kernels/synaptic_accum.py:
// _scatter_entries (_accum_kernel), reached from event_delivery_banded.
// The TPU version gathers event rows into a lane-packed entry stream and
// scatters it with a two-level one-hot MXU contraction over ring tiles;
// both are TPU workarounds.
//
// deliver_columns_kernel (the engine's route).  One block, or a few
// splits, per target column T of col_width neurons.  T's ring window,
// d_ring x col_width words, lives in shared memory.  The block walks the
// (source group S -> T, delay d) pairs of the tier's run descriptor
// (kernels/synaptic_accum.py: build_column_runs), 32 rows of one pair at
// a time (an item): for each delivered row (a bit of the delivered-row
// bitmap) the descriptor gives where the row's entries for T start and
// how many there are, and the delay comes with the pair, so no per-entry
// delay byte is read.  In a round each warp lays out one item's runs end
// to end, then all the block's threads walk the round's entries together
// (neighbouring threads on neighbouring entries, coalesced target ids and
// bf16 weights) and add them into the window with shared-memory atomics:
// a source column that fires in bulk is spread over the whole block, and
// the splits of T take every splits-th item, so they share T's work.
// Where the tier's weights allow it (every weight times 2^s a whole
// number, every target's summed |weight| times 2^s below 2^24), the window
// holds those whole numbers in int32 and adds them with native integer
// atomics, then converts back exactly; otherwise it is float32 (a
// compare-and-swap loop per add).  The window is then flushed: a plain
// read-add-write of each touched ring word when one block owns T, a
// float4 reduction (red.global.add.v4.f32) when T is split.  The old
// kernel's one scattered L2 atomic per synaptic event becomes at most
// splits x d_ring x col_width global updates per column.  Each block also
// adds the nnz of its share of the delivered rows to the event counter.
//
// Bound: device-memory traffic, the delivered rows' entries (6 B per
// event with int32 ids, 4 B with int16) plus the ring.  What held the old
// kernel at a tenth of that bound was the scattered 4-byte atomics into
// L2 (about 42 G events/s); here they land in shared memory, and what is
// left is the per-entry work of the shared atomics and the two-level
// search for each entry's run.
//
// deliver_rows_kernel (the legacy synaptic_accum(idx, ...) entry, whose
// rows may come in any order and repeat).  One warp per listed row: it
// skips the sink row, reads the row's entries (target id, bf16 weight,
// delay slot int8) with neighbouring lanes on neighbouring entries, and
// adds each weight into ring[(t_slot + dslot) % d_ring][tgt] with a
// float atomicAdd into device memory.  Lane 0 adds the row's nnz to the
// event counter.
//
// Exactness: both add in no fixed order.  With bfloat16 weights and the
// 0.5 mV drive every ring value, and every partial sum, is a multiple of
// 2^-9 below 2^15, so float32 sums are exact in any order and the ring is
// bit-identical to the sequential reference (the int window holds the
// same sums, scaled by 2^9).  One edge differs: a ring word that holds
// -0.0 and whose entries sum to exactly zero keeps -0.0 under the int
// window, where the reference's sequence gives +0.0; the engine's ring
// never holds -0.0 (it starts at +0.0 and no weight is zero).  Float32 weights would show
// the order in the last bits, so both kernels take bfloat16 weights only;
// float32 tables go to the fixed-order kernel (plastic_delivery.cu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename TgtT>
__global__ void deliver_rows_kernel(
    const int32_t* __restrict__ idx, int n_idx, const TgtT* __restrict__ tgt,
    const __nv_bfloat16* __restrict__ w, const int8_t* __restrict__ dslot,
    const int32_t* __restrict__ nnz, int cap, int sink_row,
    float* __restrict__ ring, int n_local, int d_ring, int t_slot,
    int32_t* __restrict__ events) {
  const int warp = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= n_idx) return;
  const int row = idx[warp];
  if (row == sink_row) return;  // compaction padding: nothing to deliver
  const int n = nnz ? nnz[row] : cap;
  const size_t base = (size_t)row * cap;
  for (int k = lane; k < n; k += 32) {
    const int t = (int)tgt[base + k];
    const float wk = __bfloat162float(w[base + k]);
    const int slot = (t_slot + (int)dslot[base + k]) % d_ring;
    atomicAdd(ring + (size_t)slot * n_local + t, wk);
  }
  if (lane == 0 && events) atomicAdd(events, n);
}

constexpr unsigned kFull = 0xffffffffu;
constexpr int kColThreads = 512;           // 16 warps per target column
constexpr int kColWarps = kColThreads / 32;
constexpr unsigned kNegZero = 0x80000000u;  // -0.0f: untouched window word
// Shared memory the column kernel declares statically (block_sum, s_excl,
// s_start, s_row0, s_woff, s_items): the wrapper sizes the dynamic ring
// window to what a block has beside it (synaptic_accum.py:
// COLUMN_STATIC_SMEM holds the same number).
constexpr int kColStaticSmem = 4608;
static_assert(sizeof(int) * (1 + kColWarps * 33 + kColWarps * 32 +
                             2 * kColWarps + kColWarps + 1) <= kColStaticSmem,
              "the column kernel's static shared arrays outgrew their "
              "reserve");

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

// Window word type: the weights scaled by 2^s to exact integers (int), or
// float32 for tables whose weights are not on such a grid.
template <bool kFixed> struct Window;
template <> struct Window<true> {
  using T = int;
  static __device__ T empty() { return 0; }
  static __device__ bool untouched(T v) { return v == 0; }
  static __device__ void add(T* p, float w, float scale) {
    atomicAdd(p, __float2int_rn(w * scale));  // exact: w * 2^s is whole
  }
  static __device__ float value(T v, float inv_scale) {
    return (float)v * inv_scale;  // exact: |v| < 2^24
  }
};
template <> struct Window<false> {
  using T = float;
  static __device__ T empty() { return __uint_as_float(kNegZero); }
  static __device__ bool untouched(T v) {
    return __float_as_uint(v) == kNegZero;
  }
  static __device__ void add(T* p, float w, float) { atomicAdd(p, w); }
  static __device__ float value(T v, float) { return v; }
};

constexpr int kUnroll = 4;  // entries in flight per lane

template <typename TgtT, bool kFixed>
__global__ void __launch_bounds__(kColThreads) deliver_columns_kernel(
    const uint32_t* __restrict__ bits, int n_rows,
    const int32_t* __restrict__ nnz, const TgtT* __restrict__ tgt,
    const __nv_bfloat16* __restrict__ w, int cap,
    const int32_t* __restrict__ pair_ptr, const int32_t* __restrict__ pair_src,
    const int32_t* __restrict__ pair_dslot,
    const unsigned long long* __restrict__ runs, int row_group,
    int col_width, int splits, bool vec4, float scale,
    float inv_scale, float* __restrict__ ring, int n_local, int d_ring,
    int t_slot, int32_t* __restrict__ events) {
  using W = Window<kFixed>;
  using T = typename W::T;
  extern __shared__ float smem[];
  T* win = reinterpret_cast<T*>(smem);  // d_ring x col_width: T's window
  const int tcol = blockIdx.x / splits, split = blockIdx.x % splits;
  const int col0 = tcol * col_width;
  const int width = min(col_width, n_local - col0);
  for (int i = threadIdx.x; i < d_ring * col_width; i += blockDim.x)
    win[i] = W::empty();
  if (events) count_events(bits, (n_rows + 32) >> 5, nnz, events);
  __syncthreads();

  // A round: each warp takes one item (32 rows of one pair's source
  // group; this split's items are every splits-th of T's) and lays its
  // delivered rows' runs end to end; then the whole block walks the
  // round's entries together, so one heavy item (a source column that
  // fires in bulk) is spread over every thread.
  __shared__ int s_excl[kColWarps][33];    // run starts in the item; [32]: total
  __shared__ int s_start[kColWarps][32];   // run starts in the row
  __shared__ int s_row0[kColWarps];        // the item's first row
  __shared__ int s_woff[kColWarps];        // the pair's window row - col0
  __shared__ int s_items[kColWarps + 1];   // item starts in the round
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = (row_group + 31) >> 5;
  const int p0 = pair_ptr[tcol];
  const int n_items = (pair_ptr[tcol + 1] - p0) * chunks;
  const int n_mine = split < n_items ? (n_items - split + splits - 1) / splits
                                     : 0;
  for (int j0 = 0; j0 < n_mine; j0 += kColWarps) {
    const int j = j0 + warp;
    int len = 0, start = 0, row0 = 0, woff = 0;
    if (j < n_mine) {
      const int item = split + j * splits;
      const int p = p0 + item / chunks;
      const int g = (item % chunks) * 32 + lane;
      row0 = pair_src[p] * row_group + (item % chunks) * 32;
      woff = ((t_slot + pair_dslot[p]) % d_ring) * col_width - col0;
      const int row = row0 + lane;
      if (g < row_group && row < n_rows &&
          ((bits[row >> 5] >> (row & 31)) & 1u)) {
        const unsigned long long run = runs[(size_t)p * row_group + g];
        len = (int)(run & 0xffffffffu);
        start = (int)(run >> 32);
      }
    }
    int incl = len;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    s_excl[warp][lane] = incl - len;
    s_start[warp][lane] = start;
    if (lane == 31) s_excl[warp][32] = incl;
    if (lane == 0) {
      s_row0[warp] = row0;
      s_woff[warp] = woff;
    }
    __syncthreads();
    if (warp == 0) {  // the round's items laid end to end
      const int tot = lane < kColWarps ? s_excl[lane][32] : 0;
      int acc = tot;
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, acc, o);
        if (lane >= o) acc += t;
      }
      if (lane < kColWarps) s_items[lane] = acc - tot;
      if (lane == kColWarps - 1) s_items[kColWarps] = acc;
    }
    __syncthreads();
    const int total = s_items[kColWarps];
    for (int t0 = 0; t0 < total; t0 += kColThreads * kUnroll) {
      int at_w[kUnroll];
      int tg[kUnroll];
      float wv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u * kColThreads + threadIdx.x;
        tg[u] = -1;
        if (t < total) {
          // the last item, then the last run, that starts at or before t
          // (an empty one shares its start with the next)
          int it = 0;
#pragma unroll
          for (int step = kColWarps / 2; step > 0; step >>= 1)
            if (s_items[it + step] <= t) it += step;
          const int ti = t - s_items[it];
          int r = 0;
#pragma unroll
          for (int step = 16; step > 0; step >>= 1)
            if (s_excl[it][r + step] <= ti) r += step;
          const size_t at = (size_t)(s_row0[it] + r) * cap + s_start[it][r] +
                            (ti - s_excl[it][r]);
          tg[u] = (int)tgt[at];
          wv[u] = __bfloat162float(w[at]);
          at_w[u] = s_woff[it];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (tg[u] >= 0) W::add(win + (at_w[u] + tg[u]), wv[u], scale);
    }
    __syncthreads();  // the next round rewrites the shared arrays
  }

  // flush the touched words of the window into the ring
  if (vec4) {  // width, col_width, col0 and n_local multiples of 4
    const int w4 = width >> 2;
    for (int i = threadIdx.x; i < d_ring * w4; i += blockDim.x) {
      const int sl = i / w4, c = (i - sl * w4) << 2;
      const T* src = win + sl * col_width + c;
      if (W::untouched(src[0]) && W::untouched(src[1]) &&
          W::untouched(src[2]) && W::untouched(src[3]))
        continue;  // adding an untouched word would change nothing
      float4 v = make_float4(W::value(src[0], inv_scale),
                             W::value(src[1], inv_scale),
                             W::value(src[2], inv_scale),
                             W::value(src[3], inv_scale));
      float* dst = ring + (size_t)sl * n_local + col0 + c;
      if (splits == 1) {
        float4 r = *reinterpret_cast<float4*>(dst);
        r.x += v.x; r.y += v.y; r.z += v.z; r.w += v.w;
        *reinterpret_cast<float4*>(dst) = r;
      } else {
        atomicAdd(reinterpret_cast<float4*>(dst), v);  // red.global.add.v4.f32
      }
    }
  } else {
    for (int i = threadIdx.x; i < d_ring * width; i += blockDim.x) {
      const int sl = i / width, c = i - sl * width;
      const T v = win[sl * col_width + c];
      if (W::untouched(v)) continue;
      float* dst = ring + (size_t)sl * n_local + col0 + c;
      if (splits == 1) *dst += W::value(v, inv_scale);
      else atomicAdd(dst, W::value(v, inv_scale));
    }
  }
}

template <typename TgtT, bool kFixed>
int launch_columns(const void* bits, int n_rows, const void* nnz,
                   const void* tgt, const void* w, int cap,
                   const void* pair_ptr, const void* pair_src,
                   const void* pair_dslot, const void* runs, int row_group,
                   int col_width, int n_tcols, int splits, float scale,
                   void* ring, int n_local, int d_ring, int t_slot,
                   void* events, cudaStream_t stream) {
  const size_t smem = (size_t)d_ring * col_width * sizeof(float);
  auto kern = deliver_columns_kernel<TgtT, kFixed>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const bool vec4 = col_width % 4 == 0 && n_local % 4 == 0 &&
                    ((uintptr_t)ring & 15u) == 0;
  kern<<<n_tcols * splits, kColThreads, smem, stream>>>(
      (const uint32_t*)bits, n_rows, (const int32_t*)nnz, (const TgtT*)tgt,
      (const __nv_bfloat16*)w, cap, (const int32_t*)pair_ptr,
      (const int32_t*)pair_src, (const int32_t*)pair_dslot,
      (const unsigned long long*)runs, row_group, col_width, splits, vec4,
      scale,
      1.0f / scale, (float*)ring, n_local, d_ring, t_slot, (int32_t*)events);
  return (int)cudaGetLastError();
}

template <typename TgtT>
int launch(const void* idx, int n_idx, const void* tgt, const void* w,
           const void* dslot, const void* nnz, int cap, int sink_row,
           void* ring, int n_local, int d_ring, int t_slot, void* events,
           cudaStream_t stream) {
  const int threads = 256;  // 8 warps: 8 event rows per block
  const int rows_per_block = threads / 32;
  const int blocks = (n_idx + rows_per_block - 1) / rows_per_block;
  deliver_rows_kernel<TgtT><<<blocks, threads, 0, stream>>>(
      (const int32_t*)idx, n_idx, (const TgtT*)tgt,
      (const __nv_bfloat16*)w,
      (const int8_t*)dslot, (const int32_t*)nnz, cap, sink_row, (float*)ring,
      n_local, d_ring, t_slot, (int32_t*)events);
  return (int)cudaGetLastError();
}

}  // namespace

// tgt_bytes: 2 (int16) or 4 (int32); w_bytes must be 2 (bfloat16).
// nnz may be null (every row is read to cap); events may be null.
extern "C" int deliver_rows_launch(
    const void* idx, int n_idx, const void* tgt, int tgt_bytes, const void* w,
    int w_bytes, const void* dslot, const void* nnz, int cap, int sink_row,
    void* ring, int n_local, int d_ring, int t_slot, void* events,
    void* stream) {
  if (w_bytes != 2) return (int)cudaErrorInvalidValue;
  if (n_idx <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (tgt_bytes == 2)
    return launch<int16_t>(idx, n_idx, tgt, w, dslot, nnz, cap, sink_row,
                           ring, n_local, d_ring, t_slot, events, s);
  if (tgt_bytes == 4)
    return launch<int32_t>(idx, n_idx, tgt, w, dslot, nnz, cap, sink_row,
                           ring, n_local, d_ring, t_slot, events, s);
  return (int)cudaErrorInvalidValue;
}

// One tier through its run descriptor.  bits: the delivered-row bitmap
// (one bit per row, the sink row's bit 0); pair_ptr (n_tcols + 1),
// pair_src, pair_dslot (n_pairs), runs (n_pairs, row_group) 64-bit words
// packed as start << 32 | len.  scale: 2^s with every weight times 2^s a whole
// number and every window sum below 2^24 in magnitude (the int window),
// or 0 for a float32 window.  events may be null.  The wrapper checks
// that the window, d_ring x col_width words, fits the shared memory a
// block has beside kColStaticSmem.
extern "C" int deliver_columns_launch(
    const void* bits, int n_rows, const void* nnz, const void* tgt,
    int tgt_bytes, const void* w, int w_bytes, int cap, const void* pair_ptr,
    const void* pair_src, const void* pair_dslot, const void* runs,
    int row_group, int col_width, int n_tcols, int splits, float scale,
    void* ring, int n_local, int d_ring, int t_slot, void* events,
    void* stream) {
  if (w_bytes != 2 || row_group < 1 || col_width < 1 ||
      splits < 1 || d_ring < 1 || scale < 0.0f)
    return (int)cudaErrorInvalidValue;
  if (n_tcols <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define COLUMNS(TGT, FIXED)                                                  \
  launch_columns<TGT, FIXED>(bits, n_rows, nnz, tgt, w, cap, pair_ptr,       \
                             pair_src, pair_dslot, runs, row_group,          \
                             col_width, n_tcols, splits, FIXED ? scale : 1.f, \
                             ring, n_local, d_ring, t_slot, events, s)
  const bool fixed = scale > 0.0f;
  if (tgt_bytes == 2)
    return fixed ? COLUMNS(int16_t, true) : COLUMNS(int16_t, false);
  if (tgt_bytes == 4)
    return fixed ? COLUMNS(int32_t, true) : COLUMNS(int32_t, false);
#undef COLUMNS
  return (int)cudaErrorInvalidValue;
}
