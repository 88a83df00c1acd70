"""The port's repro-lint (``repro_torch.analysis``): one counterpart, in
torch idiom, of each test of ``tests/test_repro_lint.py``.  Every pass
flags its seeded violation and stays silent on its clean twin; the
language-neutral fixtures (meta-drift, deprecated-api, pragmas) give the
same ``(line, check)`` findings as the reference analyzer; the port's
derived table storage is the reference's for every committed config; the
live port lints clean through the CLI; the hopper-geometry pass holds
the CUDA sources and a ptxas log to the H100's budgets.

The violation fixtures live as source strings (written to temp files
where a pass reads the disk), never as real modules -- the linters run
over ``src``, and these snippets must never count as repo code.
"""

import ast
import importlib
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest

import repro.analysis as ref_analysis
from repro_torch.analysis import (ALL_CHECKERS, DeprecatedApiChecker,
                                  DonationChecker, DtypeContractsChecker,
                                  HopperGeometryChecker, MetaDriftChecker,
                                  Module, Project, TracerPurityChecker)
from repro_torch.analysis import donation, hopper_geometry
from repro_torch.checkpoint.store import (AsyncWriterThread,
                                          set_thread_asserts,
                                          thread_asserts_enabled)

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"


def run_checker(checker, sources, paths=None):
    """Lint in-memory sources; returns the surviving findings."""
    mods = [Module(paths[i] if paths else f"fixture_{i}.py", source=src)
            for i, src in enumerate(sources)]
    return Project(mods).run([checker()])


def run_reference(checker, sources, paths=None):
    mods = [ref_analysis.Module(paths[i] if paths else f"fixture_{i}.py",
                                source=src)
            for i, src in enumerate(sources)]
    return ref_analysis.Project(mods).run([checker()])


def assert_flags(checker, bad, clean, paths=None):
    """The pass must flag the seeded violation and stay silent on the
    clean twin."""
    hits = run_checker(checker, [bad], paths)
    assert hits, f"{checker.name} missed its seeded violation"
    assert all(f.check == checker.name for f in hits)
    quiet = run_checker(checker, [clean], paths)
    assert not quiet, f"{checker.name} false-positive on clean twin: " \
        f"{[str(f) for f in quiet]}"
    return hits


def same_as_reference(port_checker, ref_checker, sources, paths=None):
    """The port's and the reference's findings as ``(line, check)``."""
    mine = {(f.line, f.check) for f in run_checker(port_checker, sources,
                                                   paths)}
    theirs = {(f.line, f.check) for f in run_reference(ref_checker, sources,
                                                       paths)}
    assert mine == theirs, (mine, theirs)
    return mine


# ---------------------------------------------------------------------------
# tracer-purity: the capture set
# ---------------------------------------------------------------------------

CAPTURED_RNG_BAD = '''
import numpy as np
import torch

def body(state):
    noise = np.random.default_rng(0).normal()   # host RNG at capture time
    state["v"].add_(noise)

def capture(graph, state):
    graph.capture_begin()
    body(state)
    graph.capture_end()
'''

CAPTURED_RNG_CLEAN = '''
import torch

def body(state, gen):
    state["v"].add_(torch.poisson(state["rate"], generator=gen))

def capture(graph, state, gen):
    graph.register_generator_state(gen)
    graph.capture_begin()
    body(state, gen)
    graph.capture_end()
'''


def test_tracer_purity_flags_host_rng_in_captured_body():
    hits = assert_flags(TracerPurityChecker, CAPTURED_RNG_BAD,
                        CAPTURED_RNG_CLEAN)
    assert any("numpy.random" in f.message for f in hits)


CAPTURED_BRANCH_BAD = '''
import torch

def step(v, graph):
    with torch.cuda.graph(graph):
        total = torch.sum(v)
        if total > 0:                  # read on the host, once
            v.mul_(2.0)
'''

CAPTURED_BRANCH_CLEAN = '''
import torch

def step(v, graph):
    with torch.cuda.graph(graph):
        total = torch.sum(v)
        if v.shape[0] > 0:             # a static shape check is fine
            v.copy_(torch.where(total > 0, v * 2.0, v))
'''


def test_tracer_purity_flags_python_branch_on_device_value():
    hits = assert_flags(TracerPurityChecker, CAPTURED_BRANCH_BAD,
                        CAPTURED_BRANCH_CLEAN)
    assert any("`if`" in f.message for f in hits)


CAPTURED_IO_BAD = '''
import torch

def inner(x):
    print("step", x)                   # host I/O inside a capture
    return x * 2

def step(x):
    return inner(x)

graphed = torch.cuda.make_graphed_callables(step, (torch.zeros(4),))
'''


def test_tracer_purity_follows_the_call_graph():
    # `inner` is captured only transitively (the graphed step calls it)
    hits = run_checker(TracerPurityChecker, [CAPTURED_IO_BAD])
    assert any("print" in f.message and f.line == 5 for f in hits), \
        [str(f) for f in hits]


SUBCLASS_LOOP = '''
import torch

class Loop:
    def capture(self, graph):
        graph.capture_begin()
        self._one()
        graph.capture_end()

    def _one(self):
        raise NotImplementedError

class Static(Loop):
    def _one(self):
        n = torch.count_nonzero(self.spikes)
        return n.item()                # a sync inside the capture
'''


@pytest.mark.parametrize("sync", [
    "return n.item()", "return n.cpu()", "torch.cuda.synchronize()",
    "return int(n)", "return self.spikes.numpy()"])
def test_tracer_purity_flags_syncs_in_a_subclass_step(sync):
    """A capture loop written in a base class reaches each subclass's
    step; every host sync there is flagged."""
    src = SUBCLASS_LOOP.replace("return n.item()", sync)
    hits = run_checker(TracerPurityChecker, [src])
    assert any(f.line == 16 for f in hits), [str(f) for f in hits]
    clean = SUBCLASS_LOOP.replace("return n.item()", "return n")
    assert not run_checker(TracerPurityChecker, [clean])


@pytest.mark.parametrize("bad,clean", [
    ("import numpy as np\nx = np.random.rand(4)\n",
     "import numpy as np\nx = np.random.default_rng(7).random(4)\n"),
    ("import torch\nx = torch.rand(4)\n",
     "import torch\ng = torch.Generator()\nx = torch.rand(4, generator=g)\n"),
    ("import torch\nx = torch.poisson(torch.ones(4))\n",
     "import torch\ng = torch.Generator()\n"
     "x = torch.poisson(torch.ones(4), g)\n"),
    ("import torch\nx = torch.empty(4).uniform_()\n",
     "import torch\ng = torch.Generator()\n"
     "x = torch.empty(4).uniform_(generator=g)\n"),
], ids=["np-legacy", "torch-rand", "torch-poisson", "inplace-uniform"])
def test_tracer_purity_flags_unseeded_rng_anywhere(bad, clean):
    hits = assert_flags(TracerPurityChecker, bad, clean)
    assert "global" in hits[0].message or "hidden" in hits[0].message


def test_tracer_purity_allows_host_timing_outside_capture():
    clean = '''
import time
import torch

def wall(graph):
    t0 = time.perf_counter()
    graph.replay()
    torch.cuda.synchronize()
    return time.perf_counter() - t0
'''
    assert not run_checker(TracerPurityChecker, [clean])


TELEMETRY_SPAN_BAD = '''
import time

from repro_torch.obs import telemetry

def body(state):
    with telemetry.span("inner"):      # a span inside the capture
        t0 = time.monotonic()          # the clock reads at capture time
        state["v"].add_(1.0)
    return t0

def capture(graph, state):
    graph.capture_begin()
    body(state)
    graph.capture_end()
'''

TELEMETRY_SPAN_CLEAN = '''
from repro_torch.obs import telemetry

def body(state):
    state["v"].add_(1.0)

def capture(graph, state):
    graph.capture_begin()
    body(state)
    graph.capture_end()

def replay(graph):
    with telemetry.span("segment"):    # wraps the replay call site
        graph.replay()
'''


def test_tracer_purity_flags_telemetry_span_in_captured_body():
    hits = assert_flags(TracerPurityChecker, TELEMETRY_SPAN_BAD,
                        TELEMETRY_SPAN_CLEAN)
    assert any("telemetry repro_torch.obs.telemetry.span" in f.message
               for f in hits), [str(f) for f in hits]
    assert any("time.monotonic" in f.message for f in hits), \
        [str(f) for f in hits]


# ---------------------------------------------------------------------------
# dtype-bounds
# ---------------------------------------------------------------------------

F64_CLEAN = '''
import torch

def fan(n):
    return torch.zeros(n, dtype=torch.float32)
'''


@pytest.mark.parametrize("spelling", [
    "torch.zeros(n, dtype=torch.float64)", "torch.zeros(n).double()",
    "torch.zeros(n, dtype=torch.double)", "np.zeros(n, dtype=np.float64)",
    'torch.zeros(n).to(dtype="float64")'])
def test_dtype_flags_float64_in_core_only(spelling):
    bad = "import numpy as np\n" + F64_CLEAN.replace(
        "torch.zeros(n, dtype=torch.float32)", spelling)
    hits = assert_flags(DtypeContractsChecker, bad, F64_CLEAN,
                        paths=["src/repro_torch/core/fixture.py"])
    assert "f32-first" in hits[0].message
    # the same source outside core//kernels/ is not flagged
    assert not run_checker(DtypeContractsChecker, [bad],
                           paths=["src/repro_torch/obs/fixture.py"])


@pytest.mark.parametrize("bad", [
    "torch.sum(w.to(torch.bfloat16))", "w.half() @ x",
    "ring.index_add_(0, idx, w.bfloat16())",
    "torch.cumsum(w, 0, dtype=torch.float16)",
    "torch.matmul(w.to(dtype=torch.bfloat16), x)"])
def test_dtype_flags_accumulation_in_storage_dtype(bad):
    src = f'''
import torch

def total(w, x, ring, idx):
    return {bad}
'''
    clean = src.replace("bfloat16", "float32").replace("half()", "float()") \
        .replace("float16", "float32")
    hits = assert_flags(DtypeContractsChecker, src, clean,
                        paths=["src/repro_torch/obs/fixture.py"])
    assert "storage dtype" in hits[0].message


INT16_BAD = '''
from repro_torch.core.synapses import TableStorage

st = TableStorage(tgt_dtype="int16", weight_dtype="bfloat16",
                  accum_dtype="float32", cap_local=4, halo_caps=())
'''


def test_dtype_flags_handmade_int16_storage():
    hits = run_checker(DtypeContractsChecker, [INT16_BAD],
                       paths=["src/repro_torch/obs/fixture.py"])
    assert any("hand-built" in f.message for f in hits)
    # inside core/synapses.py itself (where the bound lives) it's fine
    assert not run_checker(DtypeContractsChecker, [INT16_BAD],
                           paths=["src/repro_torch/core/synapses.py"])


def test_dtype_int16_bound_and_storage_match_the_reference():
    """Every committed grid x law x tiling: the port derives the
    reference's table storage, and where it picks int16 target ids
    n_local stays under 2**15 (the real constructors of both packages,
    so the check can't drift from the code)."""
    from repro.analysis.dtype_contracts import _TILINGS as REF_TILINGS
    from repro.configs import snn as ref_snn
    from repro_torch.analysis.dtype_contracts import (_TILINGS,
                                                      derived_storages)
    from repro_torch.configs import snn as port_snn
    assert _TILINGS == REF_TILINGS
    cases = dict(ref_snn.CASES, reduced=ref_snn.reduced_case())
    checked = int16 = 0
    for name, ty, tx, spec, storage, err in derived_storages(port_snn):
        assert err is None, (name, ty, tx, err)
        ref_spec = cases[name].engine_config(ty, tx).spec()
        assert storage.meta() == ref_spec.storage().meta(), (name, ty, tx)
        assert spec.n_local == ref_spec.n_local
        if storage.tgt_dtype == "int16":
            assert spec.n_local < 2 ** 15, (name, ty, tx)
            int16 += 1
        checked += 1
    assert checked == sum(1 for c in cases.values() for ty, tx in _TILINGS
                          if not c.grid[0] % ty and not c.grid[1] % tx)
    assert int16 > 0


# ---------------------------------------------------------------------------
# donation: in-place aliasing
# ---------------------------------------------------------------------------

DONATION_BAD = '''
from repro_torch.core import dist_engine as de

def run(cfg, state, inputs):
    sim = de.make_sim_fn(cfg, 10)
    new, per = sim(state, inputs)
    return per, state["metrics"]       # state was updated in place
'''

DONATION_CLEAN = '''
from repro_torch.core import dist_engine as de

def run(cfg, state, inputs):
    sim = de.make_sim_fn(cfg, 10)
    state, per = sim(state, inputs)    # canonical rebinding
    return per, state["metrics"]
'''


def test_donation_flags_read_after_inplace_call():
    hits = assert_flags(DonationChecker, DONATION_BAD, DONATION_CLEAN)
    assert "`state`" in hits[0].message


ALIAS_BAD = '''
from repro_torch.models.model import make_train_step

def train(cfg, opt, params, opt_state, batch):
    step = make_train_step(cfg, opt)
    before = params["embed"]           # an alias, not a copy
    params, opt_state, out = step(params, opt_state, batch)
    return (params["embed"] - before).abs().max()
'''


@pytest.mark.parametrize("copy", [
    'params["embed"].clone()', 'params["embed"].detach().clone()'])
def test_donation_flags_alias_read_after_the_step(copy):
    """The torch form of the donated-carry bug: an alias taken before the
    in-place step reads the new values after it (no failure, no
    warning); a clone is clean."""
    hits = run_checker(DonationChecker, [ALIAS_BAD])
    assert any(f.line == 8 and "`before`" in f.message for f in hits), \
        [str(f) for f in hits]
    assert not run_checker(DonationChecker, [
        ALIAS_BAD.replace('params["embed"]           #', copy + "  #")])


DONATION_FACTORY_ATTR = '''
from repro_torch.core.dist_engine import make_sim_fn

class Driver:
    def __init__(self, cfg):
        self.sim = make_sim_fn(cfg, 10)

    def segment(self, state, inputs):
        v0 = state["neuron"]["v"]
        state, per = self.sim(state, inputs)
        return v0                      # read through the sim's update
'''


def test_donation_tracks_inplace_factories_through_attributes():
    hits = run_checker(DonationChecker, [DONATION_FACTORY_ATTR])
    assert any(f.line == 11 for f in hits), [str(f) for f in hits]


DONATION_BRANCH_CLEAN = '''
from repro_torch.core import dist_engine as de

def drive(cfg, state, inputs, timed):
    sim = de.make_sim_fn(cfg, 10)
    state, per = sim(state, inputs)
    if timed:
        state, per = sim(state, inputs)   # rebinding inside the branch
    return state, per
'''


def test_donation_branches_merge_without_false_positives():
    assert not run_checker(DonationChecker, [DONATION_BRANCH_CLEAN])


def test_donation_inplace_factories_resolve_to_real_functions():
    """Every name in the pass's in-place list is a function of the live
    port whose updated positions are parameters of what it returns."""
    assert donation.INPLACE_FACTORIES
    for dotted, positions in donation.INPLACE_FACTORIES.items():
        mod, name = dotted.rsplit(".", 1)
        fn = getattr(importlib.import_module(mod), name)
        assert callable(fn) and fn.__module__ == mod, dotted
        assert positions and all(p >= 0 for p in positions)
        assert "in place" in " ".join((fn.__doc__ or "").split()), dotted


# ---------------------------------------------------------------------------
# meta-drift (language-neutral: the reference's findings, line for line)
# ---------------------------------------------------------------------------

META_BAD = '''
from repro_torch.checkpoint.store import refuse_meta_drift

class SimDriver:
    def _meta(self):
        return {"grid": self.grid, "law": self.law, "seed": self.seed,
                "table_realization": 3, "radius": self.radius,
                "cap_headroom": self.cap_headroom}

    def _restore(self, meta):
        refuse_meta_drift(
            meta, self._meta(),
            ("grid", "law", "radius", "seed", "table_realization"),
            "dir")
'''

META_CLEAN = META_BAD.replace(
    '("grid", "law", "radius", "seed", "table_realization")',
    '("grid", "law", "radius", "seed", "table_realization", '
    '"cap_headroom")')
DRIVER = ["src/repro_torch/runtime/sim_driver.py"]


def test_meta_drift_flags_unvalidated_manifest_key():
    hits = assert_flags(MetaDriftChecker, META_BAD, META_CLEAN,
                        paths=DRIVER)
    assert any("cap_headroom" in f.message for f in hits)
    for src in (META_BAD, META_CLEAN):
        same_as_reference(MetaDriftChecker, ref_analysis.MetaDriftChecker,
                          [src], DRIVER)


def test_meta_drift_requires_identity_keys_refused():
    src = '''
class SimDriver:
    def _meta(self):
        return {"grid": 1}
'''
    hits = run_checker(MetaDriftChecker, [src], paths=DRIVER)
    assert any("identity key 'seed'" in f.message for f in hits)
    same_as_reference(MetaDriftChecker, ref_analysis.MetaDriftChecker,
                      [src], DRIVER)


def test_meta_drift_storage_fields_roundtrip():
    src = '''
import dataclasses

@dataclasses.dataclass(frozen=True)
class TableStorage:
    tgt_dtype: str
    weight_dtype: str

    def meta(self):
        return {"tgt_dtype": self.tgt_dtype}   # weight_dtype missing
'''
    paths = ["src/repro_torch/core/synapses.py"]
    hits = run_checker(MetaDriftChecker, [src], paths=paths)
    assert any("weight_dtype" in f.message for f in hits)
    same_as_reference(MetaDriftChecker, ref_analysis.MetaDriftChecker,
                      [src], paths)


# ---------------------------------------------------------------------------
# pytree-aux: not ported (the port registers no pytree node)
# ---------------------------------------------------------------------------

def test_port_registers_no_pytree_node():
    """``pytree-aux`` guards the static aux data of registered pytree
    nodes; the port registers none (``tree.py`` flattens only dicts,
    lists and tuples), so the pass is not ported.  Should the port ever
    register one, this test fails and the pass is due."""
    assert "pytree-aux" not in {c.name for c in ALL_CHECKERS}
    for path in PORT.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            name = (node.attr if isinstance(node, ast.Attribute)
                    else node.id if isinstance(node, ast.Name) else "")
            assert not name.startswith(("register_pytree",
                                        "_register_pytree")), path


# ---------------------------------------------------------------------------
# hopper-geometry
# ---------------------------------------------------------------------------

KERNEL_CU = '''
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStaticSmem = 64;

__device__ int block_sum_of(int x) {
  __shared__ int partial[kWarps];
  return x + partial[0];
}

__global__ void __launch_bounds__(kThreads) plastic_delivery_kernel(int* y) {
  extern __shared__ unsigned sbits[];
  __shared__ int block_sum;
  y[0] = block_sum_of(block_sum);
}

template <int D>
struct Cfg {
  static constexpr bool kNarrow = D <= 32;
  static constexpr int kMinBlocks = kNarrow ? 2 : 1;
  static constexpr int kSmem = 128 * D * 2 + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, Cfg<D>::kMinBlocks)
    attn_kernel(float* o) {
  using C = Cfg<D>;
  o[0] = C::kSmem;
}

__global__ void plain_kernel(float* y) { y[0] = 1.f; }

int go(float* y) {
  const int threads = 512;
  plain_kernel<<<1, threads, 0, 0>>>(y);
  return launch<16>() + launch<64>();
}
'''

GEOMETRY_TREE = {
    "kernels/_build.py": 'SOURCES = ("plastic_delivery",)\n'
                         "SMEM_BYTES = 232_448\n",
    "kernels/plastic_step.py": "STATIC_SMEM = 64\n",
    "kernels/synaptic_accum.py": "COLUMN_STATIC_SMEM = 4608\n"
                                 "COLUMN_WARPS = 16\n",
    "kernels/csrc/plastic_delivery.cu": KERNEL_CU,
    "core/connectivity.py": "NEURONS_PER_COLUMN = 1240\n",
    "core/engine.py": "class EngineConfig:\n    d_ring: int = 8\n",
}


def lint_tree(tmp_path, edits=None):
    """hopper-geometry over a fixture tree (``edits``: path -> (old,
    new) text replacements)."""
    root = tmp_path / "src" / "repro_torch"
    for rel, text in GEOMETRY_TREE.items():
        old, new = (edits or {}).get(rel, ("", ""))
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text.replace(old, new) if old else text)
    return Project.from_paths([str(root)]).run([HopperGeometryChecker()])


def test_hopper_geometry_clean_fixture_and_live_sources(tmp_path):
    assert not lint_tree(tmp_path)
    live = Project.from_paths([str(PORT / "kernels"),
                               str(PORT / "core")]).run(
        [HopperGeometryChecker()])
    assert not live, [str(f) for f in live]


@pytest.mark.parametrize("edit,needle", [
    (("kernels/plastic_step.py", ("64", "128")), "kStaticSmem = 64"),
    (("kernels/csrc/plastic_delivery.cu",
      ("__launch_bounds__(kThreads)", "__launch_bounds__(100)")),
     "multiple of 32"),
    (("kernels/csrc/plastic_delivery.cu",
      ("__launch_bounds__(kThreads)", "__launch_bounds__(2048)")),
     "N <= 1024"),
    (("kernels/_build.py", ('("plastic_delivery",)', '("plastic_delivery", '
                            '"gone")')), "does not exist"),
    (("kernels/_build.py", ('("plastic_delivery",)', '()')),
     "not in _build.SOURCES"),
], ids=["mirror", "bounds-32", "bounds-1024", "missing-file", "unlisted"])
def test_hopper_geometry_flags_misdeclarations(tmp_path, edit, needle):
    hits = lint_tree(tmp_path, dict([edit]))
    assert any(needle in f.message for f in hits), [str(f) for f in hits]


@pytest.mark.parametrize("edit,needle", [
    (("kernels/csrc/plastic_delivery.cu",
      ("__shared__ int partial[kWarps]", "__shared__ int partial[64]")),
     "exceed the 64 B its wrapper declares"),
    (("kernels/csrc/plastic_delivery.cu",
      ("128 * D * 2 + 1024", "128 * D * 64 + 1024")),
     "the declared occupancy cannot happen"),
    (("kernels/csrc/plastic_delivery.cu",
      ("128 * D * 2 + 1024", "128 * D * 32 + 1024")),
     "SMEM_BYTES"),
], ids=["static-over-declared", "per-sm-fit", "over-a-block"])
def test_hopper_geometry_flags_shared_memory_blowout(tmp_path, edit,
                                                     needle):
    hits = lint_tree(tmp_path, dict([edit]))
    assert any(needle in f.message for f in hits), [str(f) for f in hits]


def test_hopper_geometry_column_window_budget(tmp_path):
    """The column kernel's ring window at the engine's default d_ring
    over the paper's column, beside its static arrays: clean at d_ring 8
    (39,680 + 4,608 B), flagged when the ring grows past the block."""
    assert not lint_tree(tmp_path)
    hits = lint_tree(tmp_path, {"core/engine.py": ("= 8", "= 48")})
    assert any("ring window" in f.message for f in hits), \
        [str(f) for f in hits]


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123plastic_delivery_kernelEPi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_123plastic_delivery_kernelEPi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 36 bytes smem, 368 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111attn_kernelILi16EEEvPf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_111attn_kernelILi16EEEvPf
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 368 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111attn_kernelILi64EEEvPf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_111attn_kernelILi64EEEvPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 368 bytes cmem[0]
ptxas info    : Compiling entry function '_Z12plain_kernelPf' for 'sm_90a'
ptxas info    : Function properties for _Z12plain_kernelPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, 368 bytes cmem[0]
"""


@pytest.mark.parametrize("case", ["within", "registers", "unbounded",
                                  "smem", "unknown"])
def test_hopper_geometry_ptxas_reader_and_card_check(case):
    """The card half on a hand-written ``-Xptxas -v`` log: figures read
    per entry, spills reported but not gated; a register budget broken
    at two CTAs an SM (or, for a kernel without launch bounds, at its
    launch site's block size), static shared memory above the wrapper's
    declaration, and an entry no source declares each fail."""
    kernels = hopper_geometry.source_geometry(
        "plastic_delivery", KERNEL_CU, {"plastic_delivery_kernel": 64})
    log = {"within": PTXAS_LOG,
           "registers": PTXAS_LOG.replace("Used 128 registers",
                                          "Used 136 registers"),
           "unbounded": PTXAS_LOG.replace("Used 64 registers",
                                          "Used 160 registers"),
           "smem": PTXAS_LOG.replace("36 bytes smem", "96 bytes smem"),
           "unknown": PTXAS_LOG.replace("attn_kernelILi64", "attn_kernelILi99")
           }[case]
    rows, errors = hopper_geometry.check_figures("plastic_delivery", log,
                                                 kernels)
    first = hopper_geometry.parse_ptxas(log)[1]
    assert (first["registers"], first["spill_stores"], first["spill_loads"],
            first["stack"]) == ({"registers": 136}.get(case, 128), 4, 4, 8)
    if case == "within":
        assert not errors, errors
        assert [r["kernel"] for r in rows] == [
            "plastic_delivery_kernel", "attn_kernel<16>", "attn_kernel<64>",
            "plain_kernel"]
        assert rows[0]["smem"] == 36 and rows[0]["registers"] == 40
        assert rows[3]["threads"] == 512          # from its launch site
    else:
        want = {"registers": "exceed the SM's 65536",
                "unbounded": "512 threads x 160 registers",
                "smem": "above the declared 64 B",
                "unknown": "no __global__ of the source declares"}[case]
        assert any(want in e for e in errors), errors


# ---------------------------------------------------------------------------
# deprecated-api (language-neutral: the reference's findings)
# ---------------------------------------------------------------------------

DEPRECATED_IMPORT_BAD = '''
from repro.core.engine import run, simulate
from repro.core import engine

def drive(s, t, c):
    run(s, t, c, 10)
    return engine.run_plastic(s, t, {}, c, 10)
'''

DEPRECATED_CLEAN = '''
from repro.core.engine import simulate

def analyze_run(d):
    return d

class Driver:
    def run(self, n):              # unrelated method named run
        return n

def drive(s, t, c, d):
    simulate(s, t, c, 10, plasticity={})
    analyze_run(d)
    return Driver().run(3)
'''


def port_spelling(src: str) -> str:
    return src.replace("from repro.", "from repro_torch.")


def test_deprecated_api_flags_imports_and_calls():
    bad, clean = map(port_spelling, (DEPRECATED_IMPORT_BAD,
                                     DEPRECATED_CLEAN))
    hits = assert_flags(DeprecatedApiChecker, bad, clean)
    msgs = "\n".join(f.message for f in hits)
    assert "import of retired" in msgs
    assert "run_plastic" in msgs and "simulate" in msgs
    # each package's spelling gives the same lines in its own analyzer
    for ref_src, port_src in ((DEPRECATED_IMPORT_BAD, bad),
                              (DEPRECATED_CLEAN, clean)):
        mine = {(f.line, f.check) for f in run_checker(
            DeprecatedApiChecker, [port_src])}
        theirs = {(f.line, f.check) for f in run_reference(
            ref_analysis.DeprecatedApiChecker, [ref_src])}
        assert mine == theirs


def test_deprecated_api_flags_alias_resurrection_in_engine():
    resurrected = ("def run(state, tables, cfg, n_steps):\n"
                   "    return state\n")
    engine = ["src/repro_torch/core/engine.py"]
    hits = run_checker(DeprecatedApiChecker, [resurrected], paths=engine)
    assert hits and "redefinition" in hits[0].message
    same_as_reference(DeprecatedApiChecker,
                      ref_analysis.DeprecatedApiChecker, [resurrected],
                      engine)
    # the same def anywhere else is NOT the retired alias
    assert not run_checker(DeprecatedApiChecker, [resurrected],
                           paths=["src/repro_torch/runtime/other.py"])


# ---------------------------------------------------------------------------
# pragmas (language-neutral: the reference's findings)
# ---------------------------------------------------------------------------

PRAGMA_CASES = {
    "inline": ("import numpy as np\n"
               "x = np.random.rand(4)  "
               "# repro-lint: ignore[tracer-purity] fixture\n"),
    "above": ("import numpy as np\n"
              "# repro-lint: ignore[tracer-purity] fixture\n"
              "x = np.random.rand(4)\n"),
    "wrong_check": ("import numpy as np\n"
                    "x = np.random.rand(4)  "
                    "# repro-lint: ignore[donation] wrong pass\n"),
}


def test_pragma_suppresses_inline_and_above_line():
    assert not run_checker(TracerPurityChecker, [PRAGMA_CASES["inline"]])
    assert not run_checker(TracerPurityChecker, [PRAGMA_CASES["above"]])
    assert run_checker(TracerPurityChecker, [PRAGMA_CASES["wrong_check"]])
    for src in PRAGMA_CASES.values():
        same_as_reference(TracerPurityChecker,
                          ref_analysis.TracerPurityChecker, [src])


def test_file_pragma_suppresses_whole_file():
    src = ("# repro-lint: ignore-file[tracer-purity] generator fixture\n"
           "import torch\n"
           "x = torch.rand(4)\n"
           "y = torch.randn(2)\n")
    assert not run_checker(TracerPurityChecker, [src])
    assert run_checker(TracerPurityChecker, [src.split("\n", 1)[1]])
    np_src = src.replace("import torch", "import numpy as np").replace(
        "torch.rand(", "np.random.rand(").replace("torch.randn(",
                                                  "np.random.randn(")
    same_as_reference(TracerPurityChecker, ref_analysis.TracerPurityChecker,
                      [np_src])


# ---------------------------------------------------------------------------
# the live port is clean, via the real CLI
# ---------------------------------------------------------------------------

def lint_cli(*args):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.lint", *args],
        capture_output=True, text=True, env=env, cwd=ROOT)


@pytest.mark.parametrize("fmt", ["text", "json"])
def test_analyzer_clean_on_live_port(fmt):
    proc = lint_cli("--format", fmt)          # default path: the port
    assert proc.returncode == 0, proc.stdout + proc.stderr
    if fmt == "json":
        assert proc.stdout.strip() == "[]"


def test_live_capture_set_holds_the_engine_capture():
    """A clean lint of the port means something only if its capture set
    is the engine's: ``GraphLoop._capture``'s region, the graph steps it
    reaches and the kernel wrappers they launch, with the launch counter
    (which runs inside every capture) under the check, not a pragma."""
    proj = Project.from_paths([str(PORT)])
    regions = {(r.module.modname, r.enclosing.qual if r.enclosing else None)
               for r in proj.regions}
    assert ("repro_torch.core.engine", "GraphLoop._capture") in regions
    captured = {f.key for f in proj.captured}
    for key in [("repro_torch.core.engine", "GraphLoop._one"),
                ("repro_torch.core.engine", "_StepGraph._one"),
                ("repro_torch.core.dist_engine", "_DistStepGraph._one"),
                ("repro_torch.core.engine", "_step"),
                ("repro_torch.kernels.neuron_step", "neuron_step_cuda"),
                ("repro_torch.kernels.synaptic_accum", "deliver_columns_cuda"),
                ("repro_torch.kernels.plastic_step",
                 "plastic_delivery_ltd_cuda"),
                ("repro_torch.kernels.spike_compact", "spike_compact_cuda"),
                ("repro_torch.kernels._build", "count_launch")]:
        assert key in captured, key
    build = next(m for m in proj.modules
                 if m.modname == "repro_torch.kernels._build")
    assert "tracer-purity" not in build.file_pragmas
    count = next(f for f in proj.captured
                 if f.key == ("repro_torch.kernels._build", "count_launch"))
    lines = range(count.node.lineno, count.node.end_lineno + 1)
    assert not any("tracer-purity" in build.line_pragmas.get(i, ())
                   for i in lines)


def test_cli_lists_every_pass_and_refuses_unknown_checks():
    proc = lint_cli("--list")
    assert proc.returncode == 0
    names = {"tracer-purity", "deprecated-api", "dtype-bounds", "donation",
             "meta-drift", "hopper-geometry"}
    assert names == {c.name for c in ALL_CHECKERS}
    for name in names:
        assert name in proc.stdout
    proc = lint_cli("--select", "pallas-geometry")
    assert proc.returncode == 2 and "unknown check" in proc.stderr


# ---------------------------------------------------------------------------
# AsyncWriterThread owning-thread assertion, on the port's store
# ---------------------------------------------------------------------------

class _Writer(AsyncWriterThread):
    """Minimal subclass with spooler-style non-queue state."""

    def __init__(self):
        self.offset = 0
        super().__init__()

    def _write(self, item):
        pass

    def append(self, n):
        self._assert_owner("append")
        self.offset += n
        self._submit(n)


@pytest.fixture
def thread_asserts():
    set_thread_asserts(True)
    try:
        yield
    finally:
        set_thread_asserts(False)


def test_owner_thread_append_passes_under_asserts(thread_asserts):
    assert thread_asserts_enabled()
    w = _Writer()
    try:
        w.append(3)
        w.wait()
        assert w.offset == 3
    finally:
        w.close()


def test_foreign_thread_append_raises_under_asserts(thread_asserts):
    w = _Writer()
    err = []
    try:
        t = threading.Thread(
            target=lambda: err.append(
                pytest.raises(AssertionError, w.append, 1)))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        assert err and "owned by" in str(err[0].value)
        assert w.offset == 0           # the race never mutated state
    finally:
        w.close()


def test_asserts_off_by_default():
    assert not thread_asserts_enabled()
    w = _Writer()
    hit = []
    try:
        t = threading.Thread(target=lambda: hit.append(w.append(1)))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        assert w.offset == 1           # permissive without --sanitize
    finally:
        w.close()
