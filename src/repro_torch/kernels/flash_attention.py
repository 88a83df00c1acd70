"""Blocked online-softmax (flash) attention: the CUDA kernels' wrapper.

Replaces the TPU kernel ``repro/kernels/flash_attention.py:
flash_attention``.  Two kernels, one route each (``_route``):

* ``"sm90"`` -- bfloat16 q/k/v with head_dim 64, 128 or 256
  (``SM90_HEAD_DIMS``), the LM serving path's case:
  ``csrc/flash_attention_sm90.cu`` runs both products on the tensor
  cores (``wgmma``, bf16 x bf16 -> f32, P rounded to bf16 for P V) with
  Q and a 2-stage K/V ring loaded by TMA; counted as
  ``flash_attention``;
* ``"simt"`` -- float32 at every head_dim, and bfloat16 with head_dim 8,
  16 or 32: ``csrc/flash_attention.cu`` computes in f32 on the CUDA
  cores (float32 keeps its full precision; TF32 would not hold the
  float32 tolerance); counted as ``flash_attention_simt``.

Both run one block per (query head, tile of query rows), keep each
row's running max, sum and accumulator in float32 registers and skip key
tiles that are fully masked.  They are bound by operations: 4 D flops
per live (q, k) pair.  Ragged edges are masked in the kernels, so
q/k/v are never padded.

They take q ``(BH, Sq, D)`` and k, v ``(BH_kv, Sk, D)`` with ``BH %
BH_kv == 0`` (GQA: query head ``bh`` reads kv head ``bh // (BH //
BH_kv)``), all contiguous, float32 or bfloat16, D in ``HEAD_DIMS``; the
output is ``(BH, Sq, D)`` in q's dtype and fully masked rows are 0.

The wrapper launches a kernel for CUDA tensors and takes the plain
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
SM90_HEAD_DIMS = (64, 128, 256)
INPUT_DTYPES = (torch.float32, torch.bfloat16)
# launch-count name of each route's kernel
ROUTE_KERNELS = {"sm90": "flash_attention", "simt": "flash_attention_simt"}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _route(dtype: torch.dtype, d: int) -> str:
    """The kernel that takes (dtype, head_dim): ``"sm90"`` (tensor
    cores) for bfloat16 with D in ``SM90_HEAD_DIMS``, ``"simt"`` (CUDA
    cores, f32) for every other case the wrapper accepts."""
    if dtype not in INPUT_DTYPES or d not in HEAD_DIMS:
        raise ValueError(f"no flash-attention kernel takes {dtype} with "
                         f"head_dim {d}")
    if dtype == torch.bfloat16 and d in SM90_HEAD_DIMS:
        return "sm90"
    return "simt"


def _launcher(route: str):
    if route == "sm90":
        fn = _build.library("flash_attention_sm90") \
            .flash_attention_sm90_launch
        if fn.argtypes is None:
            fn.argtypes = [_P] * 4 + [_I] * 9 + [_F, _P]
            fn.restype = _I
        return fn
    fn = _build.library("flash_attention").flash_attention_launch
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
    """Launch the kernel of ``_route(q.dtype, D)``.  Returns a new (BH,
    Sq, D) tensor."""
    _check(q, k, v, q_offset)
    return _launch(_route(q.dtype, q.shape[2]), q, k, v, causal=causal,
                   window=window, scale=scale, q_offset=q_offset)


def _launch(route: str, q, k, v, *, causal: bool = True,
            window: Optional[int] = None, scale: Optional[float] = None,
            q_offset: int = 0) -> torch.Tensor:
    """Launch the kernel of ``route`` on checked inputs.  The CUDA-core
    kernel takes every case; chip_smoke.py times it beside the
    tensor-core kernel at the same bf16 shape through this function."""
    if q.device.type != "cuda":
        raise ValueError("flash_attention_cuda takes CUDA tensors")
    for x in (q, k, v):
        if x.data_ptr() % 16:
            raise ValueError("attention takes 16-byte aligned q, k, v")
    if route not in ROUTE_KERNELS or (
            route == "sm90" and _route(q.dtype, q.shape[2]) != "sm90"):
        raise ValueError(f"route {route!r} does not take {q.dtype} with "
                         f"head_dim {q.shape[2]}")
    bh, sq, d = q.shape
    bh_kv, sk, _ = k.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    mask = (int(bool(causal)), int(window is not None), int(window or 0),
            int(q_offset))
    if route == "sm90":
        err = _launcher(route)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh,
            bh_kv, sq, sk, d, *mask, float(scale), _build.stream_ptr(q))
    else:
        err = _launcher(route)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh,
            bh_kv, sq, sk, d, int(q.dtype == torch.bfloat16), *mask,
            float(scale), _build.stream_ptr(q))
    _build.check(err, ROUTE_KERNELS[route])
    _build.count_launch(ROUTE_KERNELS[route])
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
