"""Blocked online-softmax (flash) attention: the CUDA kernel's wrapper.

Replaces the TPU kernel ``repro/kernels/flash_attention.py:
flash_attention``.  The kernel (``csrc/flash_attention.cu``) runs one
block per (query head, tile of 64 query rows), stages 64-key tiles of K
and V in shared memory, keeps each row's running max, sum and
accumulator in float32 registers and skips key tiles that are fully
masked.  It is bound by operations: 4 D flops per live (q, k) pair.
Ragged edges are masked in the kernel, so q/k/v are never padded.

It takes q ``(BH, Sq, D)`` and k, v ``(BH_kv, Sk, D)`` with ``BH %
BH_kv == 0`` (GQA: query head ``bh`` reads kv head ``bh // (BH //
BH_kv)``), all contiguous, float32 or bfloat16, D in ``HEAD_DIMS``; the
output is ``(BH, Sq, D)`` in q's dtype and fully masked rows are 0.

The wrapper launches the kernel for CUDA tensors and takes the plain
version (``ref.attention_ref``) for CPU tensors.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .ref import attention_ref

HEAD_DIMS = (8, 16, 32, 64, 128, 256)
INPUT_DTYPES = (torch.float32, torch.bfloat16)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _launcher():
    lib = _build.library("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 4 + [_I] * 10 + [_F, _P]
        fn.restype = _I
    return fn


def _check(q, k, v, q_offset: int) -> None:
    ok = (q.dim() == 3 and k.dim() == 3 and v.dim() == 3
          and k.shape == v.shape and q.shape[2] == k.shape[2]
          and k.shape[0] > 0 and q.shape[0] % k.shape[0] == 0)
    if not ok:
        raise ValueError(
            f"attention takes q (BH, Sq, D) and k, v (BH_kv, Sk, D) with "
            f"BH % BH_kv == 0; got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    if q.shape[2] not in HEAD_DIMS:
        raise ValueError(f"attention takes head_dim in {HEAD_DIMS}; got "
                         f"{q.shape[2]}")
    if q.dtype not in INPUT_DTYPES or not k.dtype == v.dtype == q.dtype:
        raise ValueError(f"attention takes float32 or bfloat16 q, k, v of "
                         f"one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("attention takes contiguous q, k, v")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"attention takes q, k, v on one device; got "
                         f"{q.device}, {k.device}, {v.device}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0; got {q_offset}")


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None,
                         scale: Optional[float] = None,
                         q_offset: int = 0) -> torch.Tensor:
    """Launch the kernel.  Returns a new (BH, Sq, D) tensor."""
    _check(q, k, v, q_offset)
    if q.device.type != "cuda":
        raise ValueError("flash_attention_cuda takes CUDA tensors")
    for x in (q, k, v):
        if x.data_ptr() % 16:
            raise ValueError("attention takes 16-byte aligned q, k, v")
    bh, sq, d = q.shape
    bh_kv, sk, _ = k.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    err = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, bh_kv,
        sq, sk, d, int(q.dtype == torch.bfloat16), int(bool(causal)),
        int(window is not None), int(window or 0), int(q_offset),
        float(scale), _build.stream_ptr(q))
    _build.check(err, "flash_attention")
    _build.count_launch("flash_attention")
    return out


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Masked GQA attention (see the module docstring).  CUDA tensors
    launch the kernel, CPU tensors take the plain version."""
    if _build.on_cuda(q):
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    scale=scale, q_offset=q_offset)
    _check(q, k, v, q_offset)
    return attention_ref(q, k, v, causal=causal, window=window,
                         scale=scale, q_offset=q_offset)
