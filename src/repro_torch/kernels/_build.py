"""Build, load and count the CUDA kernels.

Each source ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library
``build/torch_kernels/lib<name>-<hash>.so`` at the root of the checkout
(``REPRO_TORCH_BUILD_DIR`` overrides the directory), then loaded with
ctypes.  nvcc's output, with ptxas's ``-v`` figures of every kernel
(registers, shared memory, spills, stack), is kept beside the library as
``lib<name>-<hash>.log`` (``log_path``), which the ``hopper-geometry``
lint pass reads (``analysis.hopper_geometry.check_built``); a library
without its log is built again.  The build happens at first use;
``build_all`` starts one ``nvcc`` per source, all at once.  Nothing is
compiled at import time.

Every wrapper counts its launches here (``count_launch``), so a run can
show that its main path went through the kernels.  While a CUDA graph is
captured (``capture_tally``) the wrappers' counts go to the graph's
tally instead, and each replay adds that tally (``count_replay``): the
counts stay the kernels' launches on the device.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("lif_step", "neuron_step", "event_delivery", "plastic_delivery",
           "spike_compact", "flash_attention_sm90", "flash_attention_tf32")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

# the shared memory one block may use on sm_90 (dynamic, after opting in)
SMEM_BYTES = 232_448

_LIBS: Dict[str, ctypes.CDLL] = {}
_LAUNCHES: Dict[str, int] = {}
_TALLY: Optional[Dict[str, int]] = None   # set while a graph is captured
_DEFAULT_BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
                      / "torch_kernels")


def build_dir() -> Path:
    # repro-lint: ignore[tracer-purity] the build's paths are read at a
    # kernel's first launch; a graph's loop steps eagerly before it
    # captures, so no capture reaches them
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    # repro-lint: ignore[tracer-purity] as above
    return Path(env) if env else _DEFAULT_BUILD_DIR


def _nvcc() -> str:
    # repro-lint: ignore[tracer-purity] looked up at a kernel's first
    # build, which no capture reaches (see build_dir)
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    # repro-lint: ignore[tracer-purity] as above
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        # repro-lint: ignore[tracer-purity] as above
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (set CUDA_HOME or PATH)")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"lib{name}-{tag[:12]}.so"


def log_path(name: str) -> Path:
    """nvcc's output (ptxas's figures) of the built ``csrc/<name>.cu``."""
    return _lib_path(name).with_suffix(".log")


def _tmp(out: Path, kind: str) -> Path:
    """This process's temporary file beside the library ``out``."""
    # repro-lint: ignore[tracer-purity] named at a kernel's first build,
    # which no capture reaches (see build_dir)
    return out.with_suffix(f".{os.getpid()}.{kind}")


def _start(name: str) -> Optional[subprocess.Popen]:
    out = _lib_path(name)
    if out.exists() and log_path(name).exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(_tmp(out, "tmp")),
           str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    out = _lib_path(name)
    log_tmp = _tmp(out, "logtmp")
    log_tmp.write_text(log)
    # repro-lint: ignore[tracer-purity] the build's end, at a kernel's
    # first launch, which no capture reaches (see build_dir)
    os.replace(log_tmp, log_path(name))
    # repro-lint: ignore[tracer-purity] as above
    os.replace(_tmp(out, "tmp"), out)


def build_all() -> None:
    """Compile every kernel source that is not built yet, in parallel."""
    procs = {name: _start(name) for name in SOURCES}
    for name, proc in procs.items():
        _finish(name, proc)


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu`` (built if needed)."""
    lib = _LIBS.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise on a nonzero ``cudaError_t`` from a launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")


def on_cuda(x: torch.Tensor) -> bool:
    """Routing rule of every wrapper: True for a CUDA tensor (launch the
    kernel), False for a CPU tensor (take the plain version); any other
    device raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {x.device}")


def stream_ptr(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def count_launch(name: str) -> None:
    counts = _TALLY if _TALLY is not None else _LAUNCHES
    counts[name] = counts.get(name, 0) + 1


@contextlib.contextmanager
def capture_tally():
    """Within the block, launches are counted into the dict it yields
    (the kernels a CUDA graph captures), not as launches."""
    global _TALLY
    _TALLY = {}
    try:
        yield _TALLY
    finally:
        _TALLY = None


def count_replay(name: str, tally: Dict[str, int]) -> None:
    """One replay of the graph ``name``: count it, and the kernels of its
    ``capture_tally`` as launched once more each."""
    count_launch(name)
    for kernel, n in tally.items():
        _LAUNCHES[kernel] = _LAUNCHES.get(kernel, 0) + n


def launch_counts() -> Dict[str, int]:
    return dict(_LAUNCHES)


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """The launches counted since ``before`` (a ``launch_counts()``)."""
    return {k: n - before.get(k, 0) for k, n in sorted(_LAUNCHES.items())
            if n != before.get(k, 0)}


def reset_launch_counts() -> None:
    _LAUNCHES.clear()
