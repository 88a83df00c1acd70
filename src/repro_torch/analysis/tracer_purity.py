"""Capture-purity pass (``tracer-purity``).

A CUDA graph records the device work of its capture once and replays
it: host code inside the capture runs only while capturing.  A host
sync (``.item()``, ``.cpu()``, ``torch.cuda.synchronize``) there fails
the capture; a host RNG draw, a wall-clock read or a telemetry span
runs once and is frozen into (or missing from) every replay; a Python
branch on a device value is decided once, at capture time, for every
replay.  Determinism underpins bit-identical resume, so two families of
findings, the reference analyzer's in torch terms:

1. **Inside the capture set** (functions reachable from the code
   between ``capture_begin()`` and ``capture_end()``, a ``with
   torch.cuda.graph(...)`` body or ``torch.cuda.make_graphed_callables``;
   see ``core``): any call into ``numpy.random`` / stdlib ``random`` /
   ``time`` / ``datetime``, telemetry spans/exporters
   (``repro_torch.obs.telemetry`` / ``repro_torch.perf.trace``), host
   I/O (``open``/``print``/``np.save``/``json.dump``/...),
   ``torch.cuda.synchronize``, ``.cpu()`` / ``.numpy()``, and ``.item()``
   / ``.tolist()`` / ``bool()`` / ``int()`` / ``float()`` / Python
   ``if`` / ``while`` / ``assert`` on a value produced by a torch op
   (light taint propagation through local assignments;
   ``.shape`` / ``.dtype`` / ``.numel()`` / ``len()`` reads do not
   taint).

2. **Anywhere**: *unseeded* host RNG -- legacy ``np.random.<fn>``
   module-level draws, ``np.random.default_rng()`` with no seed, stdlib
   ``random`` draws -- and a torch draw without an explicit
   ``generator=`` (``torch.rand*``, ``randint``, ``randperm``,
   ``normal``, ``poisson``, ``bernoulli``, ``multinomial``, the in-place
   ``.uniform_`` / ``.normal_`` / ``.exponential_`` / ...), which reads
   the global generator: the port's rule is an explicit generator per
   state, so a run is a function of its seeds.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Set

from .core import Checker, Finding, FnInfo, Module, Project

NAME = "tracer-purity"

_HOST_MODULE_PREFIXES = ("numpy.random.", "random.", "time.", "datetime.")
# runtime-telemetry spans/exporters are host-side observers: inside a
# capture the span's clock reads once, at capture time, and measures
# nothing per replay
_TELEMETRY_PREFIXES = ("repro_torch.obs.telemetry.", "repro_torch.perf.trace.")
_HOST_IO_CALLS = {"open", "print", "input"}
_HOST_IO_PREFIXES = ("os.", "json.dump", "json.load", "pickle.",
                     "numpy.save", "numpy.load", "numpy.savez",
                     "builtins.open", "builtins.print", "shutil.",
                     "pathlib.")
# methods that sync the host with the stream, whatever the receiver (a
# copy to the host, a stream's or an event's synchronize)
_SYNC_METHODS = {"cpu", "numpy", "synchronize"}
# methods that read a device value on the host when called on a tensor
_HOST_READ_METHODS = {"item", "tolist"}
# torch namespaces whose call results are not device values
_UNTAINTED_TORCH = ("torch.cuda.", "torch.device", "torch.Size",
                    "torch.finfo", "torch.iinfo", "torch.is_tensor",
                    "torch.get_default_dtype", "torch.Generator",
                    "torch.backends.", "torch.distributed.")
# attribute reads and method calls that yield host values even on a
# device tensor
_STATIC_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda", "layout",
                 "requires_grad"}
_STATIC_METHODS = {"size", "numel", "dim", "element_size", "stride",
                   "is_contiguous", "data_ptr", "nelement", "get_device",
                   "item", "tolist"}
# (a host read's result is a host value: the read itself is the finding)
_STATIC_CALLS = {"len", "isinstance", "type", "getattr", "hasattr",
                 "float", "int", "bool", "str"}

_LEGACY_NP_RANDOM = {
    "rand", "randn", "randint", "random", "random_sample", "normal",
    "uniform", "choice", "shuffle", "permutation", "seed",
    "standard_normal", "poisson", "binomial", "exponential", "gamma",
    "beta",
}
_STDLIB_RANDOM = {
    "random", "randint", "randrange", "choice", "choices", "shuffle",
    "sample", "uniform", "gauss", "normalvariate", "seed", "betavariate",
    "expovariate", "vonmisesvariate",
}
# torch draws that read the global generator unless given generator=
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "normal", "poisson",
                "bernoulli", "multinomial", "rand_like", "randn_like",
                "randint_like"}
_TORCH_INPLACE_DRAWS = {"uniform_", "normal_", "exponential_", "bernoulli_",
                        "random_", "geometric_", "log_normal_", "cauchy_"}


def _fn_body(fn: FnInfo) -> List[ast.stmt]:
    return list(getattr(fn.node, "body", []))


def _walk_skip_nested(stmts: Iterable[ast.stmt]):
    """Walk statements without descending into nested function defs
    (those are separate FnInfos, analyzed if themselves captured)."""
    for stmt in stmts:
        stack = [stmt]
        while stack:
            node = stack.pop()
            yield node
            for child in ast.iter_child_nodes(node):
                if not isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef,
                                          ast.Lambda)):
                    stack.append(child)


def _has_generator(call: ast.Call, positional_at: int = -1) -> bool:
    if any(kw.arg in ("generator", None) for kw in call.keywords):
        return True                      # generator= or **kwargs
    return 0 <= positional_at < len(call.args)


class _Taint:
    """Very light flow-insensitive-within-branches taint tracker."""

    def __init__(self, mod: Module):
        self.mod = mod
        self.tainted: Set[str] = set()

    def tainted_names_in(self, expr: ast.expr) -> List[ast.Name]:
        out: List[ast.Name] = []
        self._scan(expr, out)
        return out

    def _scan(self, node: ast.AST, out: List[ast.Name]):
        if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
            return                       # x.shape is static
        if isinstance(node, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return                       # x is None reads no value
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _STATIC_METHODS:
                return                   # x.numel() is a host int
            dn = self.mod.resolve_dotted(node.func)
            if dn in _STATIC_CALLS:
                return                   # len(x) / isinstance(x, T)
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load) \
                and node.id in self.tainted:
            out.append(node)
            return
        for child in ast.iter_child_nodes(node):
            self._scan(child, out)

    def value_is_device(self, expr: ast.expr) -> bool:
        if isinstance(expr, ast.Call):
            dn = self.mod.resolve_dotted(expr.func)
            if dn and dn.startswith("torch.") \
                    and not dn.startswith(_UNTAINTED_TORCH):
                return True
        return bool(self.tainted_names_in(expr))

    def assign(self, targets: Iterable[ast.expr], device: bool):
        for t in targets:
            if isinstance(t, ast.Name):
                (self.tainted.add if device
                 else self.tainted.discard)(t.id)
            elif isinstance(t, (ast.Tuple, ast.List)):
                self.assign(t.elts, device)


class TracerPurityChecker(Checker):
    name = NAME
    description = ("host syncs, RNG, clocks, I/O and Python branches on "
                   "device values inside CUDA-graph captures; unseeded "
                   "host RNG and torch draws without generator= anywhere")

    def run(self, project: Project) -> Iterable[Finding]:
        for mod in project.modules:
            yield from self._unseeded_rng(mod)
        for region in project.regions:
            yield from self._check_stmts(region.module, region.stmts,
                                         "a CUDA-graph capture")
        for fn in project.captured:
            yield from self._check_stmts(fn.module, _fn_body(fn),
                                         f"captured function {fn.qual}")

    # ---- global unseeded-RNG scan -------------------------------------
    def _unseeded_rng(self, mod: Module) -> Iterable[Finding]:
        for node in mod.nodes:
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) \
                    and f.attr in _TORCH_INPLACE_DRAWS \
                    and not _has_generator(node):
                yield Finding(
                    mod.path, node.lineno, self.name,
                    f".{f.attr}() without generator= draws from torch's "
                    "global generator; pass the run's torch.Generator")
                continue
            dn = mod.resolve_dotted(f)
            if not dn:
                continue
            if dn.startswith("torch.") and dn[6:] in _TORCH_DRAWS:
                pos = 1 if dn == "torch.poisson" else -1
                if not _has_generator(node, pos):
                    yield Finding(
                        mod.path, node.lineno, self.name,
                        f"{dn}() without generator= draws from torch's "
                        "global generator; pass the run's torch.Generator")
            elif dn.startswith("numpy.random."):
                tail = dn[len("numpy.random."):]
                if tail in _LEGACY_NP_RANDOM:
                    yield Finding(
                        mod.path, node.lineno, self.name,
                        f"legacy np.random.{tail}() draws from hidden "
                        "global state; use np.random.default_rng(seed)")
                elif tail == "default_rng" and not node.args \
                        and not node.keywords:
                    yield Finding(
                        mod.path, node.lineno, self.name,
                        "np.random.default_rng() without a seed breaks "
                        "deterministic table realization")
            elif dn.startswith("random.") \
                    and dn[len("random."):] in _STDLIB_RANDOM:
                yield Finding(
                    mod.path, node.lineno, self.name,
                    f"stdlib {dn}() is unseeded global-state RNG; "
                    "use np.random.default_rng(seed) or a torch.Generator")

    # ---- capture-set purity -------------------------------------------
    def _check_stmts(self, mod: Module, stmts: List[ast.stmt],
                     where: str) -> Iterable[Finding]:
        for node in _walk_skip_nested(stmts):
            if isinstance(node, ast.Call):
                dn = mod.resolve_dotted(node.func)
                if dn:
                    yield from self._host_call(mod, node, dn, where)
                f = node.func
                if isinstance(f, ast.Attribute) \
                        and f.attr in _SYNC_METHODS and not node.args:
                    yield Finding(
                        mod.path, node.lineno, self.name,
                        f".{f.attr}() inside {where}: a host sync, which "
                        "fails the capture")
        # second sweep, statement-ordered, for the taint checks
        yield from self._taint_sweep(mod, stmts, _Taint(mod), where)

    def _host_call(self, mod: Module, node: ast.Call, dn: str,
                   where: str) -> Iterable[Finding]:
        if any(dn.startswith(p) for p in _TELEMETRY_PREFIXES):
            yield Finding(
                mod.path, node.lineno, self.name,
                f"telemetry {dn}() inside {where}: spans are host-side "
                "observers -- inside a capture the clock reads once, at "
                "capture time, and measures no replay; wrap the replay "
                "call site instead")
        elif any(dn.startswith(p) for p in _HOST_MODULE_PREFIXES):
            yield Finding(
                mod.path, node.lineno, self.name,
                f"{dn}() inside {where}: host RNG/clock calls run once "
                "at capture time, not per replay -- nondeterministic "
                "resume")
        elif dn in _HOST_IO_CALLS \
                or any(dn.startswith(p) for p in _HOST_IO_PREFIXES):
            yield Finding(
                mod.path, node.lineno, self.name,
                f"host I/O {dn}() inside {where}: runs at capture time "
                "only, never on a replay")

    def _taint_sweep(self, mod: Module, stmts: List[ast.stmt],
                     taint: _Taint, where: str) -> Iterable[Finding]:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                if stmt.value is None:
                    continue
                device = taint.value_is_device(stmt.value)
                yield from self._value_escapes(mod, stmt.value, taint, where)
                taint.assign(stmt.targets if isinstance(stmt, ast.Assign)
                             else [stmt.target], device)
            elif isinstance(stmt, ast.AugAssign):
                yield from self._value_escapes(mod, stmt.value, taint, where)
                if taint.value_is_device(stmt.value):
                    taint.assign([stmt.target], True)
            elif isinstance(stmt, (ast.If, ast.While)):
                kind = "if" if isinstance(stmt, ast.If) else "while"
                yield from self._value_escapes(mod, stmt.test, taint, where)
                for name in taint.tainted_names_in(stmt.test):
                    yield Finding(
                        mod.path, stmt.lineno, self.name,
                        f"Python `{kind}` on device value `{name.id}` in "
                        f"{where}: decided once at capture time (and a "
                        "sync); use torch.where or a host-side value")
                yield from self._taint_sweep(mod, list(stmt.body), taint,
                                             where)
                yield from self._taint_sweep(mod, list(stmt.orelse), taint,
                                             where)
            elif isinstance(stmt, ast.Assert):
                for name in taint.tainted_names_in(stmt.test):
                    yield Finding(
                        mod.path, stmt.lineno, self.name,
                        f"`assert` on device value `{name.id}` in {where}:"
                        " a sync at capture time; check shapes/dtypes or "
                        "check outside the capture")
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                if taint.value_is_device(stmt.iter):
                    yield Finding(
                        mod.path, stmt.lineno, self.name,
                        f"Python `for` over a device value in {where}: "
                        "reads it on the host at capture time")
                yield from self._taint_sweep(mod, list(stmt.body), taint,
                                             where)
            elif isinstance(stmt, (ast.Return, ast.Expr)):
                if stmt.value is not None:
                    yield from self._value_escapes(mod, stmt.value, taint,
                                                   where)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                yield from self._taint_sweep(mod, list(stmt.body), taint,
                                             where)
            elif isinstance(stmt, ast.Try):
                for block in (stmt.body, stmt.orelse, stmt.finalbody,
                              *[h.body for h in stmt.handlers]):
                    yield from self._taint_sweep(mod, list(block), taint,
                                                 where)

    def _value_escapes(self, mod: Module, expr: ast.expr, taint: _Taint,
                       where: str) -> Iterable[Finding]:
        """float()/int()/bool()/.item()/.tolist() read a device value on
        the host."""
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call):
                continue
            dn = mod.resolve_dotted(node.func)
            if dn in ("float", "int", "bool") and node.args \
                    and taint.value_is_device(node.args[0]):
                yield Finding(
                    mod.path, node.lineno, self.name,
                    f"{dn}() on a device value in {where}: a host sync "
                    "at capture time")
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _HOST_READ_METHODS \
                    and taint.value_is_device(node.func.value):
                yield Finding(
                    mod.path, node.lineno, self.name,
                    f".{node.func.attr}() on a device value in {where}: "
                    "a host sync at capture time")
