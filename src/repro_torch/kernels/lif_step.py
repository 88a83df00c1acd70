"""Fused LIF+SFA neuron update: the CUDA kernel's wrapper.

Replaces the TPU kernel ``repro/kernels/lif_step.py:lif_step_pallas``.
The kernel (``csrc/lif_step.cu``) runs one thread per neuron and is
bound by memory traffic: 17 B read (v, c, refrac, i_total f32/i32 and
the active byte) and 16 B written (v', c', refrac', spk) per neuron,
each once.  The TPU version's (512, 128) block layout has no
counterpart: the flat arrays are read as they are.

The wrapper launches the kernel for CUDA tensors and takes the plain
version (``ref.lif_step_ref``, float64-evaluated fused multiply-adds)
for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import lif_step_ref

_P = ctypes.c_void_p
_F = ctypes.c_float
_I = ctypes.c_int


def _launcher():
    lib = _build.library("lif_step")
    fn = lib.lif_step_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 9 + [_I] + [_F] * 7 + [_I, _P]
        fn.restype = _I
    return fn


def _check_inputs(v, c, refrac, i_total, active):
    n = v.shape[0]
    want = ((v, torch.float32), (c, torch.float32), (refrac, torch.int32),
            (i_total, torch.float32), (active, torch.bool))
    for x, dt in want:
        if x.dtype != dt or x.shape != (n,) or not x.is_contiguous() \
                or x.device != v.device:
            raise ValueError(
                f"lif_step takes contiguous ({n},) tensors on {v.device} "
                f"(v, c, i_total f32; refrac i32; active bool); got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}")


def lif_step_cuda(v, c, refrac, i_total, active, *, leak_decay, sfa_decay,
                  neg_g_dt, v_rest, v_reset, theta, alpha_c, refrac_steps):
    """Launch the CUDA kernel.  Returns new (v, c, refrac, spk) tensors."""
    _check_inputs(v, c, refrac, i_total, active)
    if v.device.type != "cuda":
        raise ValueError("lif_step_cuda takes CUDA tensors")
    n = v.shape[0]
    v_o, c_o, s_o = (torch.empty_like(v) for _ in range(3))
    r_o = torch.empty_like(refrac)
    err = _launcher()(
        v.data_ptr(), c.data_ptr(), refrac.data_ptr(), i_total.data_ptr(),
        active.data_ptr(), v_o.data_ptr(), c_o.data_ptr(), r_o.data_ptr(),
        s_o.data_ptr(), n, leak_decay, neg_g_dt, v_rest, v_reset, theta,
        sfa_decay, alpha_c, refrac_steps, _build.stream_ptr(v))
    _build.check(err, "lif_step")
    _build.count_launch("lif_step")
    return v_o, c_o, r_o, s_o


def lif_step(v, c, refrac, i_total, active, **params):
    """Fused update on flat (n,) state tensors.  Returns (v, c, refrac,
    spk).  CUDA tensors launch the kernel, CPU tensors take the plain
    version."""
    if _build.on_cuda(v):
        return lif_step_cuda(v, c, refrac, i_total, active, **params)
    _check_inputs(v, c, refrac, i_total, active)
    return lif_step_ref(v, c, refrac, i_total, active, **params)
