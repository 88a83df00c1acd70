"""PyTorch/CUDA port of the DPSNN simulator (``repro``) for NVIDIA Hopper.

The layout mirrors ``repro``: ``core/`` (connectivity, grid, neuron,
synapse tables, STDP, engine), ``kernels/`` (hand-written CUDA kernels,
each with its plain PyTorch version beside it), ``obs/`` (the spike
recorder) and ``configs/``.  The port
imports ``torch`` and numpy, never ``jax`` and nothing of ``repro``.

Device rule: every entry point takes ``device=`` and defaults to
``"cuda"``.  Asking for CUDA on a machine without it raises; nothing
moves to the CPU on its own.  CPU runs (the tests) pass
``device="cpu"`` and then run every kernel's plain version.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    CUDA device is present (never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev
