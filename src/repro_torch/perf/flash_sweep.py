"""Tile and occupancy sweep of the narrow-head flash kernels on the card.

Builds variants of ``kernels/csrc/flash_attention_sm90.cu`` (bf16) and
``kernels/csrc/flash_attention_tf32.cu`` (float32) that differ from the
shipped kernels only in the configuration of head_dim 32 and below (key
tile, ring depth, CTAs an SM, warpgroups a CTA), holds a small windowed
GQA call of each against the plain version, and times each at the
narrowed qwen2-1.5b prefill shape (q 48 x 2048 x D, k/v 8 x 2048 x D,
causal; D 32 and 16)::

    python -m repro_torch.perf.flash_sweep [--out FILE]

It needs a CUDA card and ``nvcc``.  Each variant prints one JSON line:
its settings, ptxas registers and spill bytes of its narrow instances,
the largest difference from the plain version, and the device ms of each
shape, timed twice (the stream held while the calls are enqueued, so no
host gap enters).  The shipped configuration runs first and again last,
as the spread of the run.  The card's name and power limit come last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..kernels import _build
from ..kernels import flash_attention as fa
from ..kernels.ref import attention_ref

# (source, the line of its Cfg or kernel that a setting replaces, the
# replacement with the setting's value as {})
_SM90 = "flash_attention_sm90"
_TF32 = "flash_attention_tf32"
_PATCHES = {
    (_SM90, "keys"): ("  static constexpr int kKeys = D <= 128 ? 128 : 64;",
                      "  static constexpr int kKeys = "
                      "D <= 32 ? {} : (D <= 128 ? 128 : 64);"),
    (_SM90, "stages"): ("  static constexpr int kStages = kNarrow ? 4 : 2;",
                        "  static constexpr int kStages = "
                        "kNarrow ? {} : 2;"),
    (_SM90, "blocks"): ("  static constexpr int kMinBlocks = "
                        "kNarrow ? 2 : 1;",
                        "  static constexpr int kMinBlocks = "
                        "kNarrow ? {} : 1;"),
    (_TF32, "wg"): ("  static constexpr int kWG = D <= 128 ? 2 : 1;",
                    "  static constexpr int kWG = "
                    "D <= 32 ? {} : (D <= 128 ? 2 : 1);"),
    (_TF32, "keys"): ("  static constexpr int kKeys = "
                      "D <= 64 ? 64 : (D == 128 ? 32 : 16);",
                      "  static constexpr int kKeys = "
                      "D <= 32 ? {} : (D <= 64 ? 64 : (D == 128 ? 32 : 16));"),
    (_TF32, "blocks"): ("__global__ void __launch_bounds__"
                        "(Cfg<D>::kThreads, 1)",
                        "__global__ void __launch_bounds__"
                        "(Cfg<D>::kThreads, D <= 32 ? {} : 1)"),
}
SHIPPED = {_SM90: {"keys": 128, "stages": 4, "blocks": 2},
           _TF32: {"wg": 2, "keys": 64, "blocks": 1}}
VARIANTS = [
    (_SM90, {"keys": 128, "stages": 2, "blocks": 2}),
    (_SM90, {"keys": 128, "stages": 6, "blocks": 2}),
    (_SM90, {"keys": 128, "stages": 4, "blocks": 1}),
    (_SM90, {"keys": 64, "stages": 4, "blocks": 3}),
    (_SM90, {"keys": 64, "stages": 4, "blocks": 4}),
    (_TF32, {"wg": 2, "keys": 64, "blocks": 2}),
    (_TF32, {"wg": 2, "keys": 32, "blocks": 2}),
    (_TF32, {"wg": 3, "keys": 64, "blocks": 1}),
]
SHAPE = (48, 8, 2048)          # q heads, kv heads, sequence
HEAD_DIMS = (32, 16)
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-4}


def variant_source(source: str, settings: dict) -> str:
    """The text of ``csrc/<source>.cu`` with ``settings`` applied."""
    text = (_build.CSRC / f"{source}.cu").read_text()
    for key, value in settings.items():
        old, new = _PATCHES[(source, key)]
        if text.count(old) != 1:
            raise RuntimeError(f"csrc/{source}.cu no longer holds the line "
                               f"{old!r} that the sweep replaces")
        text = text.replace(old, new.format(value))
    return text


def _build_one(path: Path, text: str) -> str:
    path.with_suffix(".cu").write_text(text)
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                          str(path), str(path.with_suffix(".cu"))],
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed for {path.name}:\n{out.stdout}"
                           f"{out.stderr}")
    return out.stdout + out.stderr


def narrow_ptxas(log: str) -> dict:
    """Registers and spill bytes of the head_dim-16 and -32 kernel
    instances in an nvcc ``-Xptxas -v`` log, by head_dim."""
    out, cur = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"_kernelILi(\d+)E", line)
            cur = int(m.group(1)) if m and int(m.group(1)) <= 32 else None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            out.setdefault(cur, {})["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(cur, {})["registers"] = int(m.group(1))
    return out


def device_ms(fn, iters: int = 20) -> float:
    """Mean device ms per call of ``fn()``, the calls enqueued behind a
    sleeping kernel so that they run back to back."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * 2e9) + 1_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def run(out_path=None) -> list:
    if not torch.cuda.is_available():
        raise RuntimeError("the sweep times kernels on a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = [(s, SHIPPED[s], "shipped") for s in (_SM90, _TF32)]
    runs += [(s, v, "variant") for s, v in VARIANTS]
    runs += [(s, SHIPPED[s], "shipped, again") for s in (_SM90, _TF32)]
    bdir = _build.build_dir() / "sweep"
    bdir.mkdir(parents=True, exist_ok=True)

    def lib_path(source: str, settings: dict) -> Path:
        tag = "-".join(f"{k}{v}" for k, v in settings.items())
        return bdir / f"lib{source}-{tag}.so"
    builds = {lib_path(s, v): variant_source(s, v) for s, v, _ in runs}
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        logs = dict(zip(builds, pool.map(_build_one, builds,
                                         builds.values())))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    hq, hkv, s = SHAPE
    inputs = {d: [torch.randn((h, s, d), device="cuda", generator=gen)
                  for h in (hq, hkv, hkv)] for d in HEAD_DIMS}
    small = [torch.randn(shape, device="cuda", generator=gen)
             for shape in ((8, 130, 32), (1, 300, 32), (1, 300, 32))]
    rows = []
    saved = dict(_build._LIBS)
    try:
        for source, settings, role in runs:
            path = lib_path(source, settings)
            _build._LIBS[source] = ctypes.CDLL(str(path))
            dtype = torch.bfloat16 if source == _SM90 else torch.float32
            x = [t.to(dtype) for t in small]
            got = fa.flash_attention_cuda(*x, causal=True, window=40)
            want = attention_ref(*x, causal=True, window=40)
            err = float((got.float() - want.float()).abs().max())
            if err > TOL[dtype] * (1 + float(want.float().abs().max())):
                raise RuntimeError(f"{source} {settings}: differs from the "
                                   f"plain version by {err}")
            row = {"kernel": source, "role": role, "settings": settings,
                   "dtype": str(dtype).removeprefix("torch."),
                   "ptxas": narrow_ptxas(logs[path]),
                   "max_abs_err": err}
            for d in HEAD_DIMS:
                q, k, v = (t.to(dtype) for t in inputs[d])
                call = lambda: fa.flash_attention_cuda(q, k, v, causal=True)
                row[f"ms_d{d}"] = [device_ms(call), device_ms(call)]
            rows.append(row)
            print(json.dumps(row), flush=True)
    finally:
        _build._LIBS.clear()
        _build._LIBS.update(saved)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    if out_path:
        Path(out_path).write_text(json.dumps({"card": card, "rows": rows},
                                             indent=1))
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the rows as JSON here")
    args = ap.parse_args(argv)
    run(args.out)


if __name__ == "__main__":
    main()
