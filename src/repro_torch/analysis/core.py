"""Shared infrastructure of the port's contract analyzer (repro-lint).

The analyzer (``python -m repro_torch.launch.lint``) is repo-aware: each
pass encodes an invariant of this codebase (in-place updates read
through a stale alias, meta fields missing from drift refusal, host
syncs inside a CUDA-graph capture, ...).  This module holds what every
pass shares:

  * ``Module`` -- one parsed source file: AST, import-alias resolution,
    per-line / per-file suppression pragmas;
  * ``Project`` -- a set of modules plus the *call graph* and the
    **capture set**: every function reachable from the code between a
    ``CUDAGraph.capture_begin()`` and its ``capture_end()``, from the
    body of a ``with torch.cuda.graph(...)`` block, or from a callable
    passed to ``torch.cuda.make_graphed_callables``.  A capture records
    the device work once and replays it: a host sync inside it fails
    the capture, and a host RNG draw or clock read is frozen into every
    replay.  Purity checks apply only inside the capture set -- the same
    calls in eager host code are fine;
  * a tiny constant-expression evaluator (kernel geometry constants);
  * the ``Finding`` record and the ``Checker`` base class.

The call graph is the reference analyzer's (``repro.analysis.core``),
with two additions for the port's classes: a ``self.method(...)`` call
also reaches the method of that name in every subclass of the caller's
class (a capture loop written once in a base class reaches each
subclass's step), and ``self.attr.method(...)`` reaches ``method`` of
the classes ``self.attr`` is seen to hold (an assignment from a
parameter annotated with a project class, or from a call of one).

Suppression: a violating line may carry an inline pragma with a reason::

    fan = np.zeros(shape, dtype=np.float64)  # repro-lint: ignore[dtype-bounds] host-side analytic precision

(the pragma may also sit on a comment line directly above the
violation), and a whole file opts out of one check with a comment
line::

    # repro-lint: ignore-file[tracer-purity] reason...

Pragmas without a named check are invalid (a bare "ignore everything"
escape hatch would defeat the point of per-invariant passes).  The
grammar and the check names are the reference analyzer's, so one pragma
serves both linters where the meaning carries over.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

_PRAGMA_RE = re.compile(
    r"#\s*repro-lint:\s*(ignore(?:-file)?)\[([a-zA-Z0-9_,\- ]+)\]")

# callables whose function-valued arguments are captured into a graph
CAPTURE_CALLS = ("torch.cuda.make_graphed_callables",
                 "torch.cuda.graphs.make_graphed_callables")
# context managers whose body is captured
CAPTURE_CONTEXTS = ("torch.cuda.graph", "torch.cuda.graphs.graph")


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One contract violation, anchored to a source line."""
    path: str
    line: int
    check: str
    message: str

    def __str__(self):
        return f"{self.path}:{self.line}: [{self.check}] {self.message}"


class Checker:
    """One invariant pass.  ``name`` is the pragma/selection key."""

    name: str = ""
    description: str = ""

    def run(self, project: "Project") -> Iterable[Finding]:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

def module_name_for(path: str) -> str:
    """Dotted module name: paths under a ``src/`` root import as
    ``repro_torch.x.y``; everything else (tests, benchmarks, examples)
    gets a path-derived name that is unique but never collides with an
    importable one."""
    norm = path.replace(os.sep, "/")
    if "/src/" in norm or norm.startswith("src/"):
        idx = norm.rfind("/src/")
        tail = norm[idx + 5:] if idx >= 0 else norm[len("src/"):]
        return tail[:-3].replace("/", ".") if tail.endswith(".py") \
            else tail.replace("/", ".")
    return norm[:-3].replace("/", ".") if norm.endswith(".py") \
        else norm.replace("/", ".")


class Module:
    """One parsed file: AST + import aliases + suppression pragmas."""

    def __init__(self, path: str, source: Optional[str] = None,
                 modname: Optional[str] = None):
        if source is None:
            with open(path) as f:
                source = f.read()
        self.path = path
        self.source = source
        self.modname = modname or module_name_for(path)
        self.tree = ast.parse(source, filename=path)
        self.nodes = list(ast.walk(self.tree))     # every pass walks them
        self.lines = source.splitlines()
        self.line_pragmas: Dict[int, Set[str]] = {}
        self.file_pragmas: Set[str] = set()
        for i, line in enumerate(self.lines, start=1):
            m = _PRAGMA_RE.search(line)
            if not m:
                continue
            checks = {c.strip() for c in m.group(2).split(",") if c.strip()}
            if m.group(1) == "ignore-file":
                self.file_pragmas |= checks
                continue
            self.line_pragmas.setdefault(i, set()).update(checks)
            if line.lstrip().startswith("#"):
                # a pragma on a comment-only line covers the remainder
                # of its comment block and the first code line after it
                j = i + 1
                while j <= len(self.lines) \
                        and self.lines[j - 1].lstrip().startswith("#"):
                    self.line_pragmas.setdefault(j, set()).update(checks)
                    j += 1
                self.line_pragmas.setdefault(j, set()).update(checks)
        self.aliases = self._collect_aliases()
        self.scope: Optional[_Scope] = None     # set by Project._index

    # ---- imports -------------------------------------------------------
    def _collect_aliases(self) -> Dict[str, str]:
        """name -> fully dotted origin (``F`` -> ``torch.nn.functional``,
        ``compress_tables`` ->
        ``repro_torch.core.synapses.compress_tables``)."""
        out: Dict[str, str] = {}
        for node in self.nodes:
            if isinstance(node, ast.Import):
                for a in node.names:
                    out[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom):
                base = import_base(self.modname, node)
                for a in node.names:
                    if a.name == "*":
                        continue
                    out[a.asname or a.name] = (
                        f"{base}.{a.name}" if base else a.name)
        return out

    def resolve_dotted(self, expr: ast.expr) -> Optional[str]:
        """Dotted name of an expression with its root import-alias
        expanded; ``None`` for non-name expressions.  ``self.x`` keeps
        the literal ``self`` root (callers resolve via class scope)."""
        parts: List[str] = []
        node = expr
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(node.id)
        parts.reverse()
        root = parts[0]
        if root in self.aliases:
            parts[0] = self.aliases[root]
        return ".".join(parts)

    def suppressed(self, check: str, line: int) -> bool:
        if check in self.file_pragmas:
            return True
        return check in self.line_pragmas.get(line, ())


def import_base(modname: str, node: ast.ImportFrom) -> str:
    """The dotted module a ``from ... import`` names, relative levels
    resolved against ``modname``."""
    if not node.level:
        return node.module or ""
    pkg = modname.split(".")[:-1]
    return ".".join(pkg[:len(pkg) - (node.level - 1)]
                    + ([node.module] if node.module else []))


# ---------------------------------------------------------------------------
# Functions, call graph, capture set
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FnInfo:
    """One function (or method, or nested function) in the project."""
    module: Module
    qual: str                         # "Class.method" / "outer.inner"
    node: ast.AST                     # FunctionDef | AsyncFunctionDef
    parent: Optional["FnInfo"]

    @property
    def key(self) -> Tuple[str, str]:
        return (self.module.modname, self.qual)

    @property
    def line(self) -> int:
        return self.node.lineno

    def __hash__(self):
        return hash(self.key)

    def __eq__(self, other):
        return isinstance(other, FnInfo) and self.key == other.key


class _Scope:
    def __init__(self, parent: Optional["_Scope"]):
        self.parent = parent
        self.names: Dict[str, FnInfo] = {}

    def lookup(self, name: str) -> Optional[FnInfo]:
        s: Optional[_Scope] = self
        while s is not None:
            if name in s.names:
                return s.names[name]
            s = s.parent
        return None


@dataclasses.dataclass
class CallSite:
    call: ast.Call
    callee: Optional[str]             # resolved dotted name (or None)
    enclosing: Optional[FnInfo]       # None at module level
    module: Module


@dataclasses.dataclass
class CaptureRegion:
    """Statements captured into a CUDA graph where they are written."""
    module: Module
    enclosing: Optional[FnInfo]       # None at module level
    stmts: List[ast.stmt]


def _stmts_between(body: List[ast.stmt], first: int,
                   last: Optional[int]) -> List[ast.stmt]:
    """The outermost statements of ``body`` (nested blocks searched)
    that start after line ``first`` and before ``last`` (None: the
    end)."""
    out = []
    for st in body:
        if first < st.lineno and (last is None or st.lineno < last):
            out.append(st)
        elif not isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
            inner = [x for block in ("body", "orelse", "finalbody")
                     for x in getattr(st, block, None) or []]
            inner += [x for h in getattr(st, "handlers", []) for x in h.body]
            out += _stmts_between(inner, first, last)
    return out


class Project:
    """A set of modules plus the shared call-graph / capture-set core."""

    def __init__(self, modules: Sequence[Module]):
        self.modules = list(modules)
        self.functions: Dict[Tuple[str, str], FnInfo] = {}
        self.calls: List[CallSite] = []
        self.calls_in: Dict[Optional[Tuple[str, str]], List[CallSite]] = {}
        # simple class name -> names of its bases' last segments
        self.class_bases: Dict[str, Set[str]] = {}
        # (class, attribute) -> the classes ``self.<attribute>`` holds
        self.attr_types: Dict[Tuple[str, str], Set[str]] = {}
        self._index()
        self._infer_attr_types()
        self.regions: List[CaptureRegion] = self.capture_regions()
        self.captured: Set[FnInfo] = self._capture_closure()

    @classmethod
    def from_paths(cls, paths: Sequence[str]) -> "Project":
        files: List[str] = []
        for p in paths:
            if os.path.isfile(p):
                files.append(p)
                continue
            for root, dirs, names in os.walk(p):
                dirs[:] = [d for d in dirs
                           if d not in ("__pycache__", ".git")]
                files.extend(os.path.join(root, n)
                             for n in names if n.endswith(".py"))
        return cls([Module(f) for f in sorted(set(files))])

    # ---- indexing ------------------------------------------------------
    def _index(self):
        for mod in self.modules:
            self._index_module(mod)

    def _index_module(self, mod: Module):
        project = self

        class V(ast.NodeVisitor):
            def __init__(self):
                self.scope = _Scope(None)
                self.fn_stack: List[Optional[FnInfo]] = [None]
                self.class_stack: List[str] = []

            def _qual(self, name: str) -> str:
                enc = self.fn_stack[-1]
                if enc is not None and not self.class_stack:
                    return f"{enc.qual}.{name}"
                return ".".join(self.class_stack + [name])

            def visit_ClassDef(self, node: ast.ClassDef):
                bases = project.class_bases.setdefault(node.name, set())
                for b in node.bases:
                    dn = mod.resolve_dotted(b)
                    if dn:
                        bases.add(dn.split(".")[-1])
                self.class_stack.append(node.name)
                self.generic_visit(node)
                self.class_stack.pop()

            def _visit_fn(self, node):
                info = FnInfo(mod, self._qual(node.name), node,
                              self.fn_stack[-1])
                project.functions[info.key] = info
                self.scope.names[node.name] = info
                saved_classes = self.class_stack
                self.class_stack = []
                self.scope = _Scope(self.scope)
                self.fn_stack.append(info)
                self.generic_visit(node)
                self.fn_stack.pop()
                self.scope = self.scope.parent
                self.class_stack = saved_classes

            visit_FunctionDef = _visit_fn
            visit_AsyncFunctionDef = _visit_fn

            def visit_Call(self, node: ast.Call):
                enc = self.fn_stack[-1]
                site = CallSite(call=node, callee=mod.resolve_dotted(
                    node.func), enclosing=enc, module=mod)
                project.calls.append(site)
                project.calls_in.setdefault(enc.key if enc else None,
                                            []).append(site)
                self.generic_visit(node)

        v = V()
        v.visit(mod.tree)
        mod.scope = v.scope              # module-level name -> FnInfo

    def _infer_attr_types(self):
        """``self.a = x`` in a method, with ``x`` a parameter annotated
        with a project class or a call of one: ``self.a`` holds it."""
        for fn in self.functions.values():
            if "." not in fn.qual or not isinstance(
                    fn.node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            cls = fn.qual.split(".")[0]
            params = {}
            for a in fn.node.args.args + fn.node.args.kwonlyargs:
                ann = a.annotation
                if isinstance(ann, ast.Constant) and isinstance(ann.value,
                                                                str):
                    params[a.arg] = ann.value
                elif ann is not None:
                    dn = fn.module.resolve_dotted(ann)
                    if dn:
                        params[a.arg] = dn.split(".")[-1]
            for stmt in ast.walk(fn.node):
                if not isinstance(stmt, ast.Assign):
                    continue
                for t in stmt.targets:
                    pairs = [(t, stmt.value)]
                    if isinstance(t, ast.Tuple) and isinstance(
                            stmt.value, ast.Tuple) \
                            and len(t.elts) == len(stmt.value.elts):
                        pairs = list(zip(t.elts, stmt.value.elts))
                    for tgt, val in pairs:
                        if not (isinstance(tgt, ast.Attribute)
                                and isinstance(tgt.value, ast.Name)
                                and tgt.value.id == "self"):
                            continue
                        held = None
                        if isinstance(val, ast.Name):
                            held = params.get(val.id)
                        elif isinstance(val, ast.Call):
                            dn = fn.module.resolve_dotted(val.func)
                            held = dn.split(".")[-1] if dn else None
                        if held in self.class_bases:
                            self.attr_types.setdefault(
                                (cls, tgt.attr), set()).add(held)

    # ---- call resolution -----------------------------------------------
    def lookup_dotted(self, dotted: str) -> Optional[FnInfo]:
        """Find a repo function by fully-qualified dotted name."""
        parts = dotted.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            key = (".".join(parts[:cut]), ".".join(parts[cut:]))
            if key in self.functions:
                return self.functions[key]
        return None

    def _subclasses(self, cls: str) -> Set[str]:
        out, frontier = set(), [cls]
        while frontier:
            c = frontier.pop()
            for name, bases in self.class_bases.items():
                if c in bases and name not in out:
                    out.add(name)
                    frontier.append(name)
        return out

    def _method_targets(self, cls: str, meth: str) -> Set[FnInfo]:
        names = {cls} | self._subclasses(cls)
        return {f for f in self.functions.values()
                if "." in f.qual and f.qual.rsplit(".", 1)[1] == meth
                and f.qual.rsplit(".", 1)[0] in names}

    def _attr_method_targets(self, cls: str, attr: str,
                             meth: str) -> Set[FnInfo]:
        out: Set[FnInfo] = set()
        for held in self.attr_types.get((cls, attr), ()):
            out |= self._method_targets(held, meth)
        return out

    def targets_of(self, site: CallSite) -> Set[FnInfo]:
        """The repo functions a call site may reach."""
        callee, fn, mod = site.callee, site.enclosing, site.module
        if not callee:
            return set()
        if callee.startswith("self.") and fn is not None \
                and "." in fn.qual:
            parts = callee.split(".")
            cls = fn.qual.split(".")[0]
            if len(parts) == 2:
                return self._method_targets(cls, parts[1])
            if len(parts) == 3:
                return self._attr_method_targets(cls, parts[1], parts[2])
            return set()
        target = self.lookup_dotted(callee)
        if target is None and "." not in callee:
            target = self._resolve_name(fn, mod, callee)
        return {target} if target is not None else set()

    def _resolve_name(self, enc: Optional[FnInfo], mod: Module,
                      name: str) -> Optional[FnInfo]:
        """A bare name: a nested def of an enclosing function, else a
        module-level def, else an imported repo function."""
        if enc is not None:
            for c in self.functions.values():
                if c.module is mod and c.qual.split(".")[-1] == name:
                    p = c.parent
                    while p is not None:
                        if p == enc:
                            return c
                        p = p.parent
        top = mod.scope.lookup(name) if mod.scope else None
        if top is not None:
            return top
        dn = mod.aliases.get(name)
        return self.lookup_dotted(dn) if dn else None

    def _fn_args_of(self, site: CallSite) -> Set[FnInfo]:
        """Function-valued arguments of a call, resolved lexically
        (``functools.partial(fn, ...)`` unwrapped)."""
        out: Set[FnInfo] = set()
        args = list(site.call.args) + [kw.value for kw in site.call.keywords]
        for a in args:
            if isinstance(a, ast.Call) and a.args:
                dn = site.module.resolve_dotted(a.func)
                if dn and dn.endswith("partial"):
                    a = a.args[0]
            if isinstance(a, (ast.Tuple, ast.List)):
                elts = a.elts
            else:
                elts = [a]
            for e in elts:
                if isinstance(e, ast.Name):
                    fn = self._resolve_name(site.enclosing, site.module,
                                            e.id)
                    if fn is not None:
                        out.add(fn)
        return out

    def callees_of(self, fn: FnInfo) -> Set[FnInfo]:
        out: Set[FnInfo] = set()
        for site in self.calls_in.get(fn.key, ()):
            out |= self.targets_of(site)
        return out

    # ---- the capture set ----------------------------------------------
    def capture_regions(self) -> List[CaptureRegion]:
        """Every captured stretch of code: the statements between a
        ``capture_begin()`` call and the next ``capture_end()`` of the
        same function (or its end), and each ``with torch.cuda.graph``
        body."""
        out = []
        by_fn: Dict[Tuple[str, Optional[Tuple[str, str]]],
                    List[CallSite]] = {}
        for site in self.calls:
            f = site.call.func
            if isinstance(f, ast.Attribute) \
                    and f.attr in ("capture_begin", "capture_end"):
                key = (site.module.path,
                       site.enclosing.key if site.enclosing else None)
                by_fn.setdefault(key, []).append(site)
        for sites in by_fn.values():
            sites.sort(key=lambda s: s.call.lineno)
            for i, s in enumerate(sites):
                if s.call.func.attr != "capture_begin":
                    continue
                end = next((t.call.lineno for t in sites[i + 1:]
                            if t.call.func.attr == "capture_end"), None)
                body = s.enclosing.node.body if s.enclosing \
                    else s.module.tree.body
                out.append(CaptureRegion(
                    s.module, s.enclosing,
                    _stmts_between(body, s.call.lineno, end)))
        for mod in self.modules:
            for node in mod.nodes:
                if not isinstance(node, (ast.With, ast.AsyncWith)):
                    continue
                for item in node.items:
                    e = item.context_expr
                    dn = mod.resolve_dotted(e.func) \
                        if isinstance(e, ast.Call) else None
                    if dn in CAPTURE_CONTEXTS:
                        out.append(CaptureRegion(
                            mod, self._enclosing_fn(mod, node),
                            list(node.body)))
        return out

    def _enclosing_fn(self, mod: Module, node: ast.AST) -> Optional[FnInfo]:
        best = None
        for f in self.functions.values():
            if f.module is mod and f.node.lineno <= node.lineno \
                    <= f.node.end_lineno:
                if best is None or f.node.lineno > best.node.lineno:
                    best = f
        return best

    def _capture_closure(self) -> Set[FnInfo]:
        entries: Set[FnInfo] = set()
        for region in self.regions:
            inside = {id(n) for st in region.stmts for n in ast.walk(st)}
            enc = region.enclosing
            for site in self.calls_in.get(enc.key if enc else None, ()):
                if site.module is region.module and id(site.call) in inside:
                    entries |= self.targets_of(site)
        for site in self.calls:
            if site.callee in CAPTURE_CALLS:
                entries |= self._fn_args_of(site)
        seen = set(entries)
        frontier = list(entries)
        while frontier:
            fn = frontier.pop()
            for callee in self.callees_of(fn):
                if callee not in seen:
                    seen.add(callee)
                    frontier.append(callee)
        return seen

    # ---- running checkers ---------------------------------------------
    def run(self, checkers: Sequence[Checker]) -> List[Finding]:
        by_path = {m.path: m for m in self.modules}
        out: List[Finding] = []
        for c in checkers:
            for f in c.run(self):
                mod = by_path.get(f.path)
                if mod is not None and mod.suppressed(f.check, f.line):
                    continue
                out.append(f)
        return sorted(set(out))


# ---------------------------------------------------------------------------
# Small shared helpers
# ---------------------------------------------------------------------------

def find_module(project: Project, suffix: str) -> Optional[Module]:
    """The project's module whose path ends with ``suffix``."""
    for m in project.modules:
        if m.path.replace("\\", "/").endswith(suffix):
            return m
    return None


def eval_const(expr: ast.expr, env: Dict[str, int]) -> Optional[int]:
    """Fold an integer constant expression (literals, names from
    ``env``, + - * // / % ** and unary -); ``None`` if not constant."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, int):
        return expr.value
    if isinstance(expr, ast.Name):
        return env.get(expr.id)
    if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.USub):
        v = eval_const(expr.operand, env)
        return None if v is None else -v
    if isinstance(expr, ast.BinOp):
        a = eval_const(expr.left, env)
        b = eval_const(expr.right, env)
        if a is None or b is None:
            return None
        op = expr.op
        if isinstance(op, ast.Add):
            return a + b
        if isinstance(op, ast.Sub):
            return a - b
        if isinstance(op, ast.Mult):
            return a * b
        if isinstance(op, (ast.FloorDiv, ast.Div)):
            return a // b if b else None
        if isinstance(op, ast.Mod):
            return a % b if b else None
        if isinstance(op, ast.Pow):
            return a ** b
    return None


def module_int_constants(mod: Module) -> Dict[str, int]:
    """Module-level ``NAME = <int expr>`` assignments, constant-folded
    in source order (later names may reference earlier ones)."""
    env: Dict[str, int] = {}
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            v = eval_const(node.value, env)
            if v is not None:
                env[node.targets[0].id] = v
    return env


def str_literals(expr: ast.expr) -> List[str]:
    """String literals inside a tuple/list/set display (or a lone str)."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return [expr.value]
    if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
        return [e.value for e in expr.elts
                if isinstance(e, ast.Constant) and isinstance(e.value, str)]
    return []
