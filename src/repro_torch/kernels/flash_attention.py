"""Blocked online-softmax (flash) attention: the CUDA kernels' wrapper.

Replaces the TPU kernel ``repro/kernels/flash_attention.py:
flash_attention``.  Two routes (``_route``), both on the tensor cores:

* ``"sm90"`` -- bfloat16 q/k/v at every head_dim, built for 16, 32,
  64, 128 and 256 (``SM90_HEAD_DIMS``), the LM serving path's case:
  ``csrc/flash_attention_sm90.cu`` runs both products on the tensor
  cores (``wgmma``, bf16 x bf16 -> f32, P rounded to bf16 for P V) with
  Q and a K/V ring loaded by TMA (2 stages at D 64-256; at D 16 and 32,
  rows of 32 and 64 bytes in the 32- and 64-byte swizzles, 4 stages and
  two CTAs an SM); counted as ``flash_attention``;
* ``"tf32"`` -- float32 q/k/v at every head_dim, built for 16, 32, 64,
  128 and 256 (``TF32_HEAD_DIMS``): ``csrc/flash_attention_tf32.cu`` runs
  both products on the tensor cores as three TF32 products each
  (3xTF32: ``hi hi + hi lo + lo hi`` with ``x = hi + lo``; one TF32
  product would not hold the float32 tolerance), after a pre-pass
  kernel that splits K and V into hi and lo and writes V transposed
  (``tf32_split_cuda``, counted as ``tf32_split``); counted as
  ``flash_attention_tf32``.

Both run one block per (query head, tile of query rows), keep each
row's running max, sum and accumulator in float32 registers and skip key
tiles that are fully masked.  Their work is 4 D flops per live (q, k)
pair (three times that on the TF32 route); at D 32 and below the
exponent of each pair on the special-function units weighs as much.
Ragged edges are masked in the kernels, so q/k/v are never padded on
the sequence (the TF32 route's split scratch pads the keys with zeros).

They take q ``(BH, Sq, D)`` and k, v ``(BH_kv, Sk, D)`` with ``BH %
BH_kv == 0`` (GQA: query head ``bh`` reads kv head ``bh // (BH //
BH_kv)``), all contiguous, float32 or bfloat16, ``1 <= D <= 256``; the
output is ``(BH, Sq, D)`` in q's dtype and fully masked rows are 0.
The kernels are built for the widths of their route: a head of another
width is zero-padded on its last axis to the smallest width of its
route that holds it (``padded_head_dim``: 12 -> 16, 20 -> 32 and 112
-> 128 on both routes), with the scale of the true width, and the
output is sliced back (``with_padded_head``).  Zero columns add exactly
0 to every q.k and give zero output columns, so the result and the row
statistic are those of the unpadded function; the reference's kernel
takes any D the same way (it pads only the sequence).
With ``return_lse`` each kernel also writes every row's statistic
``L = m + log l`` (float32 ``(BH, Sq)`` in natural units, ``+1e30`` on
a fully masked row), the residual of the training backward
(``models.attention._Flash``), from the m and l its epilogue already
holds: one float per row and no second pass.  Without it the kernels
write no statistic, and serving launches what it launched before.

The wrapper launches a kernel for CUDA tensors and takes the plain
version (``ref.attention_ref``) for CPU tensors.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .ref import TF32_KEY_ORDER, TF32_KEY_PAD, attention_ref

SM90_HEAD_DIMS = (16, 32, 64, 128, 256)
TF32_HEAD_DIMS = (16, 32, 64, 128, 256)
# the widths each kernel is built for; the wrapper takes 1..MAX_HEAD_DIM
ROUTE_HEAD_DIMS = {"sm90": SM90_HEAD_DIMS, "tf32": TF32_HEAD_DIMS}
HEAD_DIMS = tuple(sorted(set(SM90_HEAD_DIMS + TF32_HEAD_DIMS)))
MAX_HEAD_DIM = 256
INPUT_DTYPES = (torch.float32, torch.bfloat16)
# launch-count name of each route's kernel
ROUTE_KERNELS = {"sm90": "flash_attention", "tf32": "flash_attention_tf32"}
SPLIT_KERNEL = "tf32_split"     # the TF32 route's pre-pass
# the TF32 kernel's P V operand order (csrc/flash_attention_tf32.cu): slot
# j of each group of 8 keys of the split V^T holds key TF32_KEY_ORDER[j]
# (ref.py), and register r of P's tf32 A fragment holds accumulator
# element TF32_P_REGS[r] of the thread's 4 in that group
TF32_P_REGS = (0, 2, 1, 3)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _route(dtype: torch.dtype, d: int) -> str:
    """The kernel that takes (dtype, head_dim): ``"sm90"`` (tensor
    cores, bf16) for bfloat16, ``"tf32"`` (tensor cores, 3xTF32) for
    float32, at every D from 1 to ``MAX_HEAD_DIM`` (a width the route's
    kernel is not built for is padded, ``padded_head_dim``)."""
    if dtype not in INPUT_DTYPES or not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"no flash-attention kernel takes {dtype} with "
                         f"head_dim {d}")
    return "sm90" if dtype == torch.bfloat16 else "tf32"


def padded_head_dim(route: str, d: int) -> int:
    """The smallest width the kernel of ``route`` is built for that holds
    head_dim ``d`` (``d`` itself when it is one)."""
    for w in ROUTE_HEAD_DIMS[route]:
        if w >= d:
            return w
    raise ValueError(f"route {route!r} takes no head_dim {d}")


def with_padded_head(fn, route: str, q, k, v, *, scale=None, **kw):
    """``fn(q, k, v, scale=..., **kw)`` on q, k, v zero-padded on their
    last axis to ``padded_head_dim(route, D)``, with the scale of the
    true width (``1/sqrt(D)`` unless given), the output sliced back to
    D.  ``fn`` returns the output, or ``(output, statistic)`` with
    ``return_lse``; the statistic needs no slicing.  Zero columns add
    exactly 0 to every q.k, so the result is ``fn``'s on the unpadded
    inputs (up to its rounding)."""
    d = q.shape[-1]
    dp = padded_head_dim(route, d)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if dp == d:
        return fn(q, k, v, scale=scale, **kw)
    pad = [torch.nn.functional.pad(x, (0, dp - d)) for x in (q, k, v)]
    res = fn(*pad, scale=scale, **kw)
    if isinstance(res, tuple):
        return (res[0][..., :d].contiguous(),) + tuple(res[1:])
    return res[..., :d].contiguous()


def _tf32_lib():
    lib = _build.library("flash_attention_tf32")
    if lib.flash_attention_tf32_launch.argtypes is None:
        lib.flash_attention_tf32_launch.argtypes = \
            [_P] * 5 + [_I] * 10 + [_F, _P]
        lib.flash_attention_tf32_launch.restype = _I
        lib.tf32_split_launch.argtypes = [_P] * 4 + [_I] * 4 + [_P]
        lib.tf32_split_launch.restype = _I
        lib.tf32_fragment_probe_launch.argtypes = [_P, _P]
        lib.tf32_fragment_probe_launch.restype = _I
    return lib


def _launcher(route: str):
    if route == "tf32":
        return _tf32_lib().flash_attention_tf32_launch
    fn = _build.library("flash_attention_sm90").flash_attention_sm90_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 5 + [_I] * 9 + [_F, _P]
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
    if not 1 <= q.shape[2] <= MAX_HEAD_DIM:
        raise ValueError(f"attention takes head_dim 1..{MAX_HEAD_DIM}; got "
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


def tf32_split_cuda(k: torch.Tensor, v: torch.Tensor):
    """Launch the TF32 route's pre-pass on float32 k, v ``(BH_kv, Sk,
    D)`` (CUDA, contiguous, D a multiple of 16): returns ``(k_split,
    vt_split)``, ``(2, BH_kv, Sk_pad, D)`` and ``(2, BH_kv, D, Sk_pad)``
    float32 (hi then lo, V transposed with each group of 8 keys in
    ``TF32_KEY_ORDER``, keys past Sk zero; ``Sk_pad``: Sk rounded up to
    a positive multiple of ``ref.TF32_KEY_PAD``).  Bit for bit
    ``ref.tf32_split_ref``."""
    if (k.device.type != "cuda" or v.device != k.device
            or k.dtype != torch.float32 or v.dtype != torch.float32
            or k.dim() != 3 or k.shape != v.shape or k.shape[2] % 16
            or not (k.is_contiguous() and v.is_contiguous())):
        raise ValueError("tf32_split_cuda takes contiguous float32 CUDA k, "
                         "v of one shape (BH_kv, Sk, D), D a multiple of "
                         f"16; got {k.dtype} {tuple(k.shape)} on "
                         f"{k.device}, {v.dtype} {tuple(v.shape)}")
    bh_kv, sk, d = k.shape
    sk_pad = max(-(-sk // TF32_KEY_PAD), 1) * TF32_KEY_PAD
    k_split = torch.empty((2, bh_kv, sk_pad, d), dtype=torch.float32,
                          device=k.device)
    vt_split = torch.empty((2, bh_kv, d, sk_pad), dtype=torch.float32,
                           device=k.device)
    err = _tf32_lib().tf32_split_launch(
        k.data_ptr(), v.data_ptr(), k_split.data_ptr(), vt_split.data_ptr(),
        bh_kv, sk, sk_pad, d, _build.stream_ptr(k))
    _build.check(err, SPLIT_KERNEL)
    _build.count_launch(SPLIT_KERNEL)
    return k_split, vt_split


def tf32_fragment_layout(device="cuda") -> torch.Tensor:
    """Run the TF32 kernel's fragment probe on the card: a wgmma with
    register A against the identity.  Returns the (64, 8) int64 map of
    the tf32 A fragment: entry (row, k) is ``128 warp + 4 lane + r`` of
    the thread and register that supply A's element (row, k).  Not
    counted: it is no part of attention."""
    out = torch.zeros((64, 8), dtype=torch.float32, device=device)
    err = _tf32_lib().tf32_fragment_probe_launch(out.data_ptr(),
                                                 _build.stream_ptr(out))
    _build.check(err, "tf32_fragment_probe")
    return out.round().long() - 1


def tf32_fragment_errors(layout: torch.Tensor) -> int:
    """The A-fragment elements where the TF32 kernel would put another P
    value than the key order ``TF32_KEY_ORDER`` asks for, by the probe's
    ``layout``: register r of thread (warp, lane) holds accumulator
    element ``c = TF32_P_REGS[r]``, that is row ``16 warp + lane // 4 +
    8 (c // 2)`` and key ``2 (lane % 4) + c % 2`` of its group, which
    must be A's element (row, k) with key ``TF32_KEY_ORDER[k]``.  0 when
    the kernel's layout assumptions hold."""
    bad = 0
    for row in range(64):
        for k in range(8):
            src = int(layout[row, k])
            warp, lane, r = src // 128, (src % 128) // 4, src % 4
            c = TF32_P_REGS[r]
            bad += (16 * warp + lane // 4 + 8 * (c // 2),
                    2 * (lane % 4) + c % 2) != (row, TF32_KEY_ORDER[k])
    return bad


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None,
                         scale: Optional[float] = None,
                         q_offset: int = 0, return_lse: bool = False):
    """Launch the kernel of ``_route(q.dtype, D)``, on q, k, v padded to
    the route's width where D is not one (``with_padded_head``).
    Returns a new (BH, Sq, D) tensor, and with ``return_lse`` also the
    rows' ``(BH, Sq)`` float32 statistic."""
    _check(q, k, v, q_offset)
    route = _route(q.dtype, q.shape[2])

    def launch(q, k, v, **kw):
        return _launch(route, q, k, v, **kw)
    return with_padded_head(launch, route, q, k, v, causal=causal,
                            window=window, scale=scale, q_offset=q_offset,
                            return_lse=return_lse)


def _launch(route: str, q, k, v, *, causal: bool = True,
            window: Optional[int] = None, scale: Optional[float] = None,
            q_offset: int = 0, split=None, return_lse: bool = False):
    """Launch the kernel of ``route`` on checked inputs at a width it is
    built for.  ``split``: the TF32 route's pre-pass output for these k, v
    (``tf32_split_cuda``), made here when None; chip_smoke.py passes it
    to time the attention kernel on its own.  ``return_lse``: also write
    and return the rows' statistic (see the module docstring)."""
    if q.device.type != "cuda":
        raise ValueError("flash_attention_cuda takes CUDA tensors")
    for x in (q, k, v):
        if x.data_ptr() % 16:
            raise ValueError("attention takes 16-byte aligned q, k, v")
    bh, sq, d = q.shape
    if d not in ROUTE_HEAD_DIMS.get(route, ()) or _route(q.dtype, d) != route:
        raise ValueError(f"route {route!r} does not take {q.dtype} with "
                         f"head_dim {d}")
    bh_kv, sk, _ = k.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    lse = (torch.empty((bh, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    lse_ptr = None if lse is None else lse.data_ptr()
    mask = (int(bool(causal)), int(window is not None), int(window or 0),
            int(q_offset))
    if route == "tf32":
        k_split, vt_split = split if split is not None \
            else tf32_split_cuda(k, v)
        sk_pad = k_split.shape[2]
        if (k_split.shape != (2, bh_kv, sk_pad, d) or sk_pad < max(sk, 1)
                or sk_pad % TF32_KEY_PAD
                or vt_split.shape != (2, bh_kv, d, sk_pad)
                or k_split.dtype != torch.float32
                or vt_split.dtype != torch.float32
                or k_split.device != q.device
                or vt_split.device != q.device
                or not (k_split.is_contiguous()
                        and vt_split.is_contiguous())):
            raise ValueError("split is not tf32_split_cuda's output for "
                             "these k, v")
        err = _launcher(route)(
            q.data_ptr(), k_split.data_ptr(), vt_split.data_ptr(),
            out.data_ptr(), lse_ptr, bh, bh_kv, sq, sk, k_split.shape[2], d,
            *mask,
            float(scale), _build.stream_ptr(q))
    else:
        err = _launcher(route)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse_ptr, bh, bh_kv, sq, sk, d, *mask, float(scale),
            _build.stream_ptr(q))
    _build.check(err, ROUTE_KERNELS[route])
    _build.count_launch(ROUTE_KERNELS[route])
    return out if lse is None else (out, lse)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None,
                    q_offset: int = 0, return_lse: bool = False):
    """Masked GQA attention (see the module docstring); with
    ``return_lse``, ``(out, lse)``.  CUDA tensors launch the kernel, CPU
    tensors take the plain version."""
    if _build.on_cuda(q):
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    scale=scale, q_offset=q_offset,
                                    return_lse=return_lse)
    _check(q, k, v, q_offset)
    return attention_ref(q, k, v, causal=causal, window=window,
                         scale=scale, q_offset=q_offset,
                         return_lse=return_lse)
