"""Spike compaction: the CUDA kernel's wrapper.

Replaces the TPU kernel ``repro/kernels/spike_compact.py:
spike_compact_pallas``.  The kernel (``csrc/spike_compact.cu``) is one
launch of a persistent grid that ranks the spiking rows of 4096-row
tiles with warp ballots and finds each tile's offset by decoupled
look-back over a per-device status array, exact int32 throughout: no
index passes through a float.  Its bytes (4 B read per row, 4 B written
per output slot) take well under a microsecond at 79,360 rows, so its
time is latency: the launch and one chain of look-back reads (PERF.md
gives the measured times).

The status array is scratch that the wrapper allocates once per device
(zeroed once, replaced by a larger one when a larger ``n_rows`` comes)
and keeps.  Its first two words are a header the kernel keeps: the
epoch that tags this call's words, and a count of the blocks done; the
call's last block advances the epoch.  So no clearing launch runs
between calls, and a call captured in a CUDA graph tags its words
afresh at every replay.  Calls that share a device must run on one
stream.  A replaced array is kept alive, since a graph captured before
may still replay a call on it.

The wrapper launches the kernel for CUDA tensors and takes the plain
version (``ref.spike_compact_ref``: cumsum and scatter) for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple

import torch

from . import _build
from .ref import spike_compact_ref

_P = ctypes.c_void_p
_I = ctypes.c_int

TILE_ROWS = 4096          # rows per tile (csrc/spike_compact.cu: kTileRows)
EPOCHS = 1 << 30          # tags 1 .. EPOCHS - 1, then the array is cleared
HEADER_WORDS = 2          # the epoch, the blocks done (csrc: kHeader)


class Plan(NamedTuple):
    tiles: int            # 4096-row tiles of the mask
    grid: int             # blocks launched (persistent, all resident)
    status_words: int     # 64-bit status words the call needs


def plan(n_rows: int, max_blocks: int) -> Plan:
    """Grid and scratch of one call over ``n_rows`` rows on a device that
    holds ``max_blocks`` blocks of the kernel at once."""
    if n_rows < 0 or max_blocks < 1:
        raise ValueError(f"plan takes n_rows >= 0 and max_blocks >= 1; got "
                         f"{n_rows}, {max_blocks}")
    tiles = -(-n_rows // TILE_ROWS)
    return Plan(tiles, max(1, min(tiles, max_blocks)), max(tiles, 1))


def new_status(words: int, device) -> torch.Tensor:
    """A status array of ``words`` tile words behind its header: epoch 1,
    no block done, every tile word zero."""
    status = torch.zeros((HEADER_WORDS + words,), dtype=torch.int64,
                         device=device)
    status[0] = 1
    return status


class _Scratch:
    """The per-device status array (with its epoch header) and the
    device's resident-block limit."""

    def __init__(self, device: torch.device, max_blocks: int):
        self.device = device
        self.max_blocks = max_blocks
        self.status = new_status(0, device)
        self.retired: list = []

    def get(self, words: int) -> torch.Tensor:
        if self.status.numel() - HEADER_WORDS < words:
            self.retired.append(self.status)
            self.status = new_status(words, self.device)
        return self.status


_SCRATCH: Dict[torch.device, _Scratch] = {}


def _lib():
    lib = _build.library("spike_compact")
    if lib.spike_compact_launch.argtypes is None:
        lib.spike_compact_launch.argtypes = [_P, _I, _I, _P, _P, _P, _I, _I,
                                             _I, _P]
        lib.spike_compact_launch.restype = _I
        lib.spike_compact_max_blocks.argtypes = [_I, ctypes.POINTER(_I)]
        lib.spike_compact_max_blocks.restype = _I
        lib.spike_compact_tile_rows.restype = _I
        if lib.spike_compact_tile_rows() != TILE_ROWS or \
                lib.spike_compact_header_words() != HEADER_WORDS:
            raise RuntimeError("csrc/spike_compact.cu's tile or header "
                               "differs from TILE_ROWS / HEADER_WORDS")
    return lib


def _scratch(device: torch.device) -> _Scratch:
    sc = _SCRATCH.get(device)
    if sc is None:
        out = _I(0)
        _build.check(_lib().spike_compact_max_blocks(device.index or 0,
                                                     ctypes.byref(out)),
                     "spike_compact (occupancy query)")
        sc = _SCRATCH[device] = _Scratch(device, out.value)
    return sc


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
    lib = _lib()
    dev = spikes.device if spikes.device.index is not None else \
        torch.device("cuda", torch.cuda.current_device())
    sc = _scratch(dev)
    p = plan(n_rows, sc.max_blocks)
    status = sc.get(p.status_words)
    out = torch.empty((active_cap + 1,), dtype=torch.int32, device=dev)
    err = lib.spike_compact_launch(
        spikes.data_ptr(), n_rows, active_cap, out.data_ptr(),
        out.data_ptr() + 4 * active_cap, status.data_ptr(),
        status.numel() - HEADER_WORDS, p.grid,
        int(spikes.data_ptr() % 16 == 0), _build.stream_ptr(spikes))
    _build.check(err, "spike_compact")
    _build.count_launch("spike_compact")
    return out[:active_cap], out[active_cap]


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
