// Blocked online-softmax (flash) attention for Hopper (sm_90a), on the
// CUDA cores.  Replaced; timed only: no route of flash_attention.py takes
// it any more.  bf16 at every head_dim goes to flash_attention_sm90.cu and
// float32 to flash_attention_tf32.cu, both on the tensor cores.  It stays
// as the kernel chip_smoke.py times beside them on the same inputs
// (flash_attention.py: _launch("simt", ...)); its removal is queued.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:flash_attention
// (_kernel), which ran a (B*H, nQ, nK) grid with the key loop innermost,
// carried the running max m, sum l and accumulator acc of each 128-row
// query block in VMEM scratch from one grid step to the next, skipped the
// product of a (q, k) block pair that its liveness test found dead, and
// padded q/k/v to whole blocks.  On Hopper the grid runs in no order, so
// the key loop lives inside the block:
//
//   * one block of 4 warps per (bh, tile of 64 query rows); the tile's
//     rows are staged once in shared memory as float32;
//   * for each live tile of 64 keys (the TPU kernel's liveness test: key
//     in range, causal k_first <= q_last, window q_first - k_last <
//     window), K and V are staged in shared memory as float32, rows past
//     Sk as zeros, so no padded copy of q/k/v is ever made;
//   * each warp owns 16 query rows and skips a tile that is dead for its
//     own rows (so causal prefill does about half the products).  Lane
//     (rg, kg) = (lane / 8, lane % 8) computes the scores of rows
//     rg + 4i (i < 4) against keys kg + 8j (j < 8), reduces each row's
//     max and sum over its 8 lanes with shuffles, and keeps m, l and its
//     rows' slice of acc (D / 8 columns) in registers;
//   * p goes through a 16 x 64 shared buffer per warp into acc += p V.
//
// Arithmetic follows _kernel: f32 dot products (fmaf), s = q.k * scale,
// masked scores NEG_INF = -1e30 and p = 0 on masked pairs, m/l/acc in
// f32, output acc / l where l > 0 and 0 where a row saw no key, rounded
// to q's dtype.  GQA: query head bh reads kv head bh / (BH / BH_kv).
// With an lse pointer the epilogue also writes each row's statistic
// L = m + log l (float32, +1e30 where a row saw no key), the residual of
// the training backward (models/attention.py: _Flash), from the m and l
// it already holds: one float per row, no second pass.
//
// Bound: the live (q, k) pairs cost 4 D flops each (QK^T and PV); at
// qwen2-1.5b's prefill (BH 48, S 2048, D 128) that is 5.2e10 flops per
// call against 2.5e7 bytes of q, k, v and o, so the kernel is bound by
// operations: 52 us at the bf16 tensor-core rate, 0.77 ms at the f32 rate
// of the CUDA cores this kernel uses.  What the design does about it:
// every K/V element staged in shared memory feeds 64 query rows, scores
// never leave the SM, dead tiles are skipped per warp, and the inner
// products read float4 operands (a padded K row stride keeps those reads
// free of bank conflicts).  Tensor-core products (wgmma) and TMA staging
// are left for a later redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;          // query rows per block
constexpr int kKeys = 64;          // keys per staged tile
constexpr int kWarps = kRows / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kPStride = kKeys + 8;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Io;

template <>
struct Io<float> {
  __device__ static float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ static float out(float x) { return x; }
};

template <>
struct Io<__nv_bfloat16> {
  // four bf16 (8 bytes) widened exactly to float32
  __device__ static float4 load4(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    return make_float4(__uint_as_float(u.x << 16),
                       __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xffff0000u));
  }
  __device__ static __nv_bfloat16 out(float x) {
    return __float2bfloat16_rn(x);
  }
};

template <int D>
__host__ __device__ constexpr int smem_floats() {
  return kRows * D + kKeys * (D + 4) + kKeys * D + kWarps * 16 * kPStride;
}

// rows [row0, row0 + 64) of an (n, D) matrix into shared memory with row
// stride ld floats; rows at or past n are zeros
template <typename T, int D>
__device__ void stage(float* dst, int ld, const T* src, int row0, int n) {
  constexpr int kVec = D / 4;
  for (int i = threadIdx.x; i < 64 * kVec; i += kThreads) {
    const int r = i / kVec;
    const int c = (i % kVec) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) x = Io<T>::load4(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = x;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
    int sq, int sk, int group, int causal, int has_window, int window,
    int q_offset, float scale) {
  constexpr int kQStride = D;
  constexpr int kKStride = D + 4;
  constexpr int kVStride = D;
  constexpr int kVec = D >= 32 ? 4 : D / 8;  // columns per P.V load
  constexpr int kChunks = D / (8 * kVec);     // loads per lane per key
  constexpr int kCols = D / 8;                // acc columns per lane

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kRows * kQStride;
  float* vs = ks + kKeys * kKStride;
  float* ps = vs + kKeys * kVStride;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kRows;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rg = lane >> 3;
  const int kg = lane & 7;
  float* pw = ps + warp * 16 * kPStride;
  const T* qh = q + (size_t)bh * sq * D;
  const T* kh = k + (size_t)(bh / group) * sk * D;
  const T* vh = v + (size_t)(bh / group) * sk * D;

  stage<T, D>(qs, kQStride, qh, q0, sq);

  // the block's and this warp's first and last query positions
  const int b_first = q_offset + q0;
  const int b_last = q_offset + min(q0 + kRows, sq) - 1;
  const int w_row0 = q0 + warp * 16;
  const int w_rows = min(16, sq - w_row0);
  const int w_first = q_offset + w_row0;
  const int w_last = w_first + w_rows - 1;

  int qpos[4];
  bool rvalid[4];
  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = w_row0 + rg + 4 * i;
    rvalid[i] = row < sq;
    qpos[i] = q_offset + row;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const int n_tiles = (sk + kKeys - 1) / kKeys;
  for (int t = 0; t < n_tiles; ++t) {
    const int k_first = t * kKeys;
    const int k_last = k_first + kKeys - 1;
    // block-level liveness (uniform over the block), as _kernel tests it
    if (causal && k_first > b_last) continue;
    if (has_window && b_first - k_last >= window) continue;
    __syncthreads();  // every warp is done with the previous tile
    stage<T, D>(ks, kKStride, kh, k_first, sk);
    stage<T, D>(vs, kVStride, vh, k_first, sk);
    __syncthreads();
    // warp-level liveness over the warp's own rows (uniform over a warp)
    if (w_rows <= 0) continue;
    if (causal && k_first > w_last) continue;
    if (has_window && w_first - k_last >= window) continue;

    // scores of rows rg + 4i against keys kg + 8j
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            qs + (warp * 16 + rg + 4 * i) * kQStride + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(ks + (kg + 8 * j) * kKStride + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv.x, a);
          a = fmaf(qv[i].y, kv.y, a);
          a = fmaf(qv[i].z, kv.z, a);
          a = fmaf(qv[i].w, kv.w, a);
          s[i][j] = a;
        }
      }
    }

    // mask, then the online-softmax update of each row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      unsigned live = 0;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kp = k_first + kg + 8 * j;
        const bool ok = rvalid[i] && kp < sk && (!causal || kp <= qpos[i]) &&
                        (!has_window || qpos[i] - kp < window);
        live |= (ok ? 1u : 0u) << j;
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = ((live >> j) & 1u) ? expf(s[i][j] - m_new) : 0.f;
        s[i][j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      sum += __shfl_xor_sync(kFull, sum, 4);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        pw[(rg + 4 * i) * kPStride + kg + 8 * j] = s[i][j];
    }
    __syncwarp();

    // acc += p V over the tile's keys, four keys at a time
#pragma unroll 1
    for (int kk = 0; kk < kKeys; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(
            pw + (rg + 4 * i) * kPStride + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = vs + (kk + u) * kVStride;
#pragma unroll
        for (int ch = 0; ch < kChunks; ++ch) {
          const int col = (kg + 8 * ch) * kVec;
          float vv[kVec];
          if constexpr (kVec == 4) {
            const float4 x = *reinterpret_cast<const float4*>(vrow + col);
            vv[0] = x.x;
            vv[1] = x.y;
            vv[2] = x.z;
            vv[3] = x.w;
          } else {
#pragma unroll
            for (int c = 0; c < kVec; ++c) vv[c] = vrow[col + c];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = u == 0 ? pv[i].x
                            : u == 1 ? pv[i].y
                            : u == 2 ? pv[i].z
                                     : pv[i].w;
#pragma unroll
            for (int c = 0; c < kVec; ++c)
              acc[i][ch * kVec + c] = fmaf(p, vv[c], acc[i][ch * kVec + c]);
          }
        }
      }
    }
    __syncwarp();  // p is read before the next tile writes it
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!rvalid[i]) continue;
    T* orow = o + ((size_t)bh * sq + w_row0 + rg + 4 * i) * D;
    const bool seen = l[i] > 0.f;
    if (lse != nullptr && kg == 0)
      lse[(size_t)bh * sq + w_row0 + rg + 4 * i] =
          seen ? m[i] + logf(l[i]) : -kNegInf;
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch)
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        const float x = seen ? acc[i][ch * kVec + c] / l[i] : 0.f;
        orow[(kg + 8 * ch) * kVec + c] = Io<T>::out(x);
      }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, int sq, int sk, int group, int causal, int has_window,
           int window, int q_offset, float scale, cudaStream_t stream) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  auto kern = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (sq + kRows - 1) / kRows);
  kern<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, sq, sk, group,
      causal, has_window, window, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v, void* o,
             float* lse, int bh, int sq, int sk, int group, int causal,
             int has_window, int window, int q_offset, float scale,
             cudaStream_t stream) {
  switch (d) {
    case 8:
      return launch<T, 8>(q, k, v, o, lse, bh, sq, sk, group, causal,
                          has_window, window, q_offset, scale, stream);
    case 16:
      return launch<T, 16>(q, k, v, o, lse, bh, sq, sk, group, causal,
                           has_window, window, q_offset, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, bh, sq, sk, group, causal,
                           has_window, window, q_offset, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, bh, sq, sk, group, causal,
                           has_window, window, q_offset, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, bh, sq, sk, group, causal,
                            has_window, window, q_offset, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, lse, bh, sq, sk, group, causal,
                            has_window, window, q_offset, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (bh, sq, d); k, v: (bh_kv, sk, d); o: (bh, sq, d); all contiguous,
// 16-byte aligned, float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1);
// lse: (bh, sq) float32, or null for no row statistic.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int bh,
                                      int bh_kv, int sq, int sk, int d,
                                      int is_bf16, int causal,
                                      int has_window, int window,
                                      int q_offset, float scale,
                                      void* stream) {
  if (bh < 0 || bh_kv <= 0 || bh % bh_kv != 0 || sq < 0 || sk < 0 ||
      q_offset < 0 || (sq + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  if (bh == 0 || sq == 0) return 0;
  const int group = bh / bh_kv;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch<__nv_bfloat16>(d, q, k, v, o, (float*)lse, bh, sq, sk,
                                   group, causal, has_window, window,
                                   q_offset, scale, st);
  return dispatch<float>(d, q, k, v, o, (float*)lse, bh, sq, sk, group,
                         causal, has_window, window, q_offset, scale, st);
}
