"""Spike compaction: the CUDA kernel's wrapper.

Replaces the TPU kernel ``repro/kernels/spike_compact.py:
spike_compact_pallas``.  The kernel (``csrc/spike_compact.cu``) is one
block that loops over the spike mask with an exact int32 prefix scan:
no index passes through a float.  It is bound by its launch, not by its
bytes (4 B read per row and 4 B written per output slot, under 1 MB at
79,360 rows).

The wrapper launches the kernel for CUDA tensors and takes the plain
version (``ref.spike_compact_ref``: cumsum and scatter) for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import spike_compact_ref

_P = ctypes.c_void_p
_I = ctypes.c_int


def _launcher():
    lib = _build.library("spike_compact")
    fn = lib.spike_compact_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _I, _I, _P, _P, _P]
        fn.restype = _I
    return fn


def _check(spikes: torch.Tensor, n_rows: int, active_cap: int) -> None:
    if spikes.dtype != torch.float32 or spikes.dim() != 1 \
            or spikes.shape[0] < n_rows or not spikes.is_contiguous() \
            or n_rows < 0 or active_cap < 0:
        raise ValueError(
            f"spike_compact takes a contiguous float32 (>= n_rows,) spike "
            f"vector and n_rows, active_cap >= 0; got {spikes.dtype} "
            f"{tuple(spikes.shape)}, n_rows={n_rows}, "
            f"active_cap={active_cap}")


def spike_compact_cuda(spikes: torch.Tensor, n_rows: int, active_cap: int):
    """Launch the kernel.  Returns (idx int32 (active_cap,), count int32
    0-d)."""
    _check(spikes, n_rows, active_cap)
    if spikes.device.type != "cuda":
        raise ValueError("spike_compact_cuda takes a CUDA tensor")
    idx = torch.empty((active_cap,), dtype=torch.int32, device=spikes.device)
    count = torch.empty((1,), dtype=torch.int32, device=spikes.device)
    err = _launcher()(spikes.data_ptr(), n_rows, active_cap, idx.data_ptr(),
                      count.data_ptr(), _build.stream_ptr(spikes))
    _build.check(err, "spike_compact")
    _build.count_launch("spike_compact")
    return idx, count[0]


def spike_compact(spikes: torch.Tensor, n_rows: int, active_cap: int):
    """Drop-in for ``ref.compact_events`` with an int32 count: the
    ascending indices of the first ``min(count, active_cap)`` rows with
    ``spikes > 0``, padded with the sink row ``n_rows``, and the uncapped
    spike count.  CUDA tensors launch the kernel, CPU tensors take the
    plain version."""
    if _build.on_cuda(spikes):
        return spike_compact_cuda(spikes, n_rows, active_cap)
    _check(spikes, n_rows, active_cap)
    return spike_compact_ref(spikes, n_rows, active_cap)
