"""Leaky Integrate-and-Fire neuron with Spike-Frequency Adaptation.

Model (Gigante, Mattia, Del Giudice 2007 form, discretized at dt):

    V[t+1] = V_rest + (V[t] - V_rest) * exp(-dt/tau_m)
             + I_syn + I_ext - g_sfa * c[t] * dt        (if not refractory)
    c[t+1] = c[t] * exp(-dt/tau_c) + alpha_c * spiked
    spike  : V >= theta  ->  V <- V_reset, refractory for tau_arp

State is float32 except the refractory counter (int32); shapes are flat
``(n_neurons,)`` tensors in a dict ``{"v", "c", "refrac"}``.

Rounding contract.  The JAX reference compiles this update with XLA,
which contracts the multiply-adds into fused multiply-adds.  At the
default parameters (``v_rest = 0`` and ``dt = 1`` fold away) it computes

    v_int = fma(-g_sfa, c, fma(v, leak_decay, i))
    c'    = fma(c, sfa_decay, alpha_c * spk)

and the port computes exactly that (``kernels.ref.lif_step_ref``; the
CUDA kernel uses ``__fmaf_rn``), so spike trains match bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..kernels.ref import lif_step_ref


@dataclasses.dataclass(frozen=True)
class LIFParams:
    dt_ms: float = 1.0
    tau_m_ms: float = 20.0      # membrane time constant
    v_rest_mv: float = 0.0
    v_reset_mv: float = 0.0
    theta_mv: float = 20.0      # firing threshold
    tau_arp_ms: float = 2.0     # absolute refractory period
    tau_c_ms: float = 120.0     # SFA time constant
    alpha_c: float = 1.0        # SFA increment per spike
    g_sfa: float = 0.025        # SFA conductance (mV per unit c per ms)
    # synaptic efficacies (delta-current jumps, mV)
    j_exc_mv: float = 0.35
    j_inh_mv: float = -1.6      # ~4.5x exc (inhibition-dominated balance)
    j_ext_mv: float = 0.50

    @property
    def leak_decay(self) -> float:
        return float(np.exp(-self.dt_ms / self.tau_m_ms))

    @property
    def sfa_decay(self) -> float:
        return float(np.exp(-self.dt_ms / self.tau_c_ms))

    @property
    def refrac_steps(self) -> int:
        return int(round(self.tau_arp_ms / self.dt_ms))

    def kernel_args(self) -> dict:
        """Keyword arguments of ``kernels.lif_step`` / ``ref.lif_step_ref``:
        every constant rounded to float32 once, as XLA folds them."""
        def f32(x):
            return float(np.float32(x))
        return dict(leak_decay=f32(self.leak_decay),
                    sfa_decay=f32(self.sfa_decay),
                    neg_g_dt=-f32(self.g_sfa * self.dt_ms),
                    v_rest=f32(self.v_rest_mv), v_reset=f32(self.v_reset_mv),
                    theta=f32(self.theta_mv), alpha_c=f32(self.alpha_c),
                    refrac_steps=self.refrac_steps)


def init_state(n: int, params: LIFParams,
               rng: np.random.Generator | None = None, device="cuda"):
    """Initial membrane state; small voltage jitter to break symmetry.
    Draws the same numbers as the reference for the same ``rng``."""
    dev = resolve_device(device)
    rng = rng or np.random.default_rng(0)
    v0 = rng.uniform(params.v_rest_mv, 0.5 * params.theta_mv, size=n)
    return {
        "v": torch.from_numpy(v0.astype(np.float32)).to(dev),
        "c": torch.zeros((n,), dtype=torch.float32, device=dev),
        "refrac": torch.zeros((n,), dtype=torch.int32, device=dev),
    }


def lif_sfa_step(state: dict, i_total_mv: torch.Tensor, params: LIFParams,
                 active_mask: torch.Tensor | None = None):
    """One dt update (plain PyTorch on any device).  ``i_total_mv`` is the
    summed synaptic + external delta-current for this step (mV).
    Returns (new_state, spikes f32)."""
    v = state["v"]
    a = (active_mask if active_mask is not None
         else torch.ones_like(v, dtype=torch.bool))
    v, c, r, spk = lif_step_ref(v, state["c"], state["refrac"], i_total_mv,
                                a, **params.kernel_args())
    return {"v": v, "c": c, "refrac": r}, spk
