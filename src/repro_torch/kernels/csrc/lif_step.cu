// Fused LIF+SFA neuron update for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/lif_step.py:lif_step_pallas
// (_kernel).  One thread per neuron; each thread reads v, c, refrac,
// i_total, active once and writes v', c', refrac', spk once, so the
// kernel is bound by memory traffic: 17 B read + 16 B written per neuron.
//
// Rounding contract: the JAX reference's XLA build contracts the update
// into fused multiply-adds,
//     v_int = fma(-g_sfa*dt, c, fma(v - v_rest, leak, i)) (+ v_rest)
//     c'    = fma(c, sfa_decay, alpha_c * spk)
// (the v_rest terms fold away at v_rest = 0).  The kernel states each
// fma with __fmaf_rn and every other operation with __f*_rn, which nvcc
// never contracts, so its result is the reference's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void lif_step_kernel(
    const float* __restrict__ v, const float* __restrict__ c,
    const int32_t* __restrict__ refrac, const float* __restrict__ i_total,
    const uint8_t* __restrict__ active, float* __restrict__ v_out,
    float* __restrict__ c_out, int32_t* __restrict__ refrac_out,
    float* __restrict__ spk_out, int n, float leak_decay, float neg_g_dt,
    float v_rest, float v_reset, float theta, float sfa_decay, float alpha_c,
    int refrac_steps) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const float vk = v[k];
  const float ck = c[k];
  const int32_t rk = refrac[k];
  const bool has_rest = v_rest != 0.0f;
  const float u = has_rest ? __fsub_rn(vk, v_rest) : vk;
  float v_int = __fmaf_rn(neg_g_dt, ck, __fmaf_rn(u, leak_decay, i_total[k]));
  if (has_rest) v_int = __fadd_rn(v_int, v_rest);
  const float v_new = rk > 0 ? v_reset : v_int;
  const bool spiked = (v_new >= theta) && (active[k] != 0);
  const float s = spiked ? 1.0f : 0.0f;
  v_out[k] = spiked ? v_reset : v_new;
  c_out[k] = __fmaf_rn(ck, sfa_decay, __fmul_rn(alpha_c, s));
  refrac_out[k] = spiked ? refrac_steps : (rk > 1 ? rk - 1 : 0);
  spk_out[k] = s;
}

}  // namespace

extern "C" int lif_step_launch(
    const void* v, const void* c, const void* refrac, const void* i_total,
    const void* active, void* v_out, void* c_out, void* refrac_out,
    void* spk_out, int n, float leak_decay, float neg_g_dt, float v_rest,
    float v_reset, float theta, float sfa_decay, float alpha_c,
    int refrac_steps, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  lif_step_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)v, (const float*)c, (const int32_t*)refrac,
      (const float*)i_total, (const uint8_t*)active, (float*)v_out,
      (float*)c_out, (int32_t*)refrac_out, (float*)spk_out, n, leak_decay,
      neg_g_dt, v_rest, v_reset, theta, sfa_decay, alpha_c, refrac_steps);
  return (int)cudaGetLastError();
}
