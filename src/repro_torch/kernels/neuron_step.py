"""The head of one simulation step in one launch: the CUDA kernel's
wrapper.

Replaces the TPU kernel ``repro/kernels/lif_step.py:lif_step_pallas`` on
the engine's step, fused with the elementwise work around it.  The
kernel (``csrc/neuron_step.cu``) reads the ring's slot row and the
drive, runs the LIF+SFA update, zeroes the slot row, and writes the
spike vector, the local tier's delivered-row bitmap (the first
``active_cap`` spiking rows, ``ref.delivered_bits``) and the step's
spike count: one launch where the step ran about a dozen.  It moves
21 B read and 20.125 B written per neuron, so it is bound by memory
traffic, and at the engine's sizes by a launch's fixed cost.

Each block adds its count and a ticket to one 64-bit word; the block
that draws the last ticket writes the count and resets the word.  That
word is allocated once per device and kept, so that a captured CUDA
graph may hold its address; calls that share a device must run on one
stream.

The wrapper launches the kernel for CUDA tensors and takes the plain
version (``ref.neuron_step_ref``) for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import _build
from .ref import neuron_step_ref

_P = ctypes.c_void_p
_F = ctypes.c_float
_I = ctypes.c_int

# device -> its ticket-and-count word (int64, zero between launches):
# kept for the life of the process, so a captured launch never outlives it
_TICKETS: Dict[torch.device, torch.Tensor] = {}


def _launcher():
    fn = _build.library("neuron_step").neuron_step_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 12 + [_I, _P, _I] + [_F] * 7 + [_I, _P]
        fn.restype = _I
    return fn


def n_words(n: int) -> int:
    """Words of the delivered-row bitmap of ``n`` rows (the sink row
    included, as ``ref.delivered_bits`` packs it)."""
    return (n + 32) // 32


def _check(ring, slot, drive, v, c, refrac, active, active_cap, out):
    n = v.shape[0]
    want = [(drive, torch.float32), (v, torch.float32), (c, torch.float32),
            (refrac, torch.int32), (active, torch.bool)]
    if out is not None:
        want += list(zip(out, (torch.float32, torch.float32, torch.int32)))
    ok = (ring.dtype == torch.float32 and ring.dim() == 2
          and ring.shape[1] == n and ring.is_contiguous()
          and ring.device == v.device and 0 <= slot < ring.shape[0]
          and (active_cap is None or active_cap >= 0)
          and all(x.dtype == dt and x.shape == (n,) and x.is_contiguous()
                  and x.device == v.device for x, dt in want))
    if not ok:
        raise ValueError(
            f"neuron_step takes a contiguous float32 (d_ring, {n}) ring "
            f"with 0 <= slot < d_ring and contiguous ({n},) tensors on "
            f"{v.device} (drive, v, c f32; refrac i32; active bool; out v, "
            f"c, refrac), active_cap None or >= 0; got ring {ring.dtype} "
            f"{tuple(ring.shape)} slot {slot}, active_cap {active_cap}, "
            + ", ".join(f"{x.dtype} {tuple(x.shape)} on {x.device}"
                        for x, _ in want))


def neuron_step_cuda(ring, slot: int, drive, v, c, refrac, active, *,
                     active_cap: Optional[int], out=None, leak_decay,
                     sfa_decay, neg_g_dt, v_rest, v_reset, theta, alpha_c,
                     refrac_steps):
    """Launch the kernel.  ``out``: the (v, c, refrac) tensors to write
    (they may be the inputs themselves), new ones when None.  Returns
    (v', c', refrac', spk f32, bits int32 or None, count int32 0-d);
    ``ring[slot]`` is zeroed in place."""
    _check(ring, slot, drive, v, c, refrac, active, active_cap, out)
    if v.device.type != "cuda":
        raise ValueError("neuron_step_cuda takes CUDA tensors")
    n = v.shape[0]
    v_o, c_o, r_o = out if out is not None else (
        torch.empty_like(v), torch.empty_like(c), torch.empty_like(refrac))
    spk = torch.empty_like(v)
    bits = (torch.empty((n_words(n),), dtype=torch.int32, device=v.device)
            if active_cap is not None else None)
    count = torch.empty((), dtype=torch.int32, device=v.device)
    ticket = _TICKETS.get(v.device)
    if ticket is None:
        ticket = _TICKETS[v.device] = torch.zeros((1,), dtype=torch.int64,
                                                  device=v.device)
    err = _launcher()(
        ring.data_ptr() + 4 * slot * n, drive.data_ptr(), v.data_ptr(),
        c.data_ptr(), refrac.data_ptr(), active.data_ptr(), v_o.data_ptr(),
        c_o.data_ptr(), r_o.data_ptr(), spk.data_ptr(),
        bits.data_ptr() if bits is not None else None, count.data_ptr(),
        active_cap if active_cap is not None else 0, ticket.data_ptr(), n,
        leak_decay, neg_g_dt, v_rest, v_reset, theta, sfa_decay, alpha_c,
        refrac_steps, _build.stream_ptr(v))
    _build.check(err, "neuron_step")
    _build.count_launch("neuron_step")
    return v_o, c_o, r_o, spk, bits, count


def neuron_step(ring, slot: int, drive, v, c, refrac, active, *,
                active_cap: Optional[int] = None, out=None, **params):
    """The step's head on flat (n,) state tensors and the (d_ring, n)
    ring: ``i = ring[slot] + drive``, the LIF+SFA update, ``ring[slot] =
    0``, and with ``active_cap`` the delivered-row bitmap.  Returns (v',
    c', refrac', spk, bits or None, count int32 0-d).  CUDA tensors
    launch the kernel, CPU tensors take the plain version."""
    if _build.on_cuda(v):
        return neuron_step_cuda(ring, slot, drive, v, c, refrac, active,
                                active_cap=active_cap, out=out, **params)
    _check(ring, slot, drive, v, c, refrac, active, active_cap, out)
    res = neuron_step_ref(ring, slot, drive, v, c, refrac, active,
                          active_cap=active_cap, **params)
    if out is None:
        return res
    for dst, src in zip(out, res[:3]):
        dst.copy_(src)
    return (*out, *res[3:])
