"""Hopper launch-geometry pass (``hopper-geometry``).

The port's counterpart of the reference's ``pallas-geometry``: the
CUDA kernels of ``kernels/csrc/`` are only correct *and* only launch
under shared-memory and register facts that are declared twice, once
in CUDA and once in the Python wrapper that sizes the launch
(``synaptic_accum.COLUMN_STATIC_SMEM`` is ``kColStaticSmem``; the ring
window a column block holds is what ``_build.SMEM_BYTES`` leaves beside
it).  A drift between the two either overflows a block's shared memory
(the launch is refused) or silently shrinks the window.

The static half runs on the CPU, over the Python modules of the lint
scope and the ``csrc/*.cu`` files beside ``kernels/_build.py``:

* **Sources listed**: every ``csrc/*.cu`` is in ``_build.SOURCES`` and
  every entry there has a file;
* **Mirrored constants**: each Python mirror equals its CUDA constant
  (``MIRRORS``);
* **Static shared memory**: each kernel's ``__shared__`` arrays (its
  own and those of the ``__device__`` functions it calls, dims folded
  from the file's ``constexpr int`` lines) fit the static shared memory
  its wrapper declares (the mirror), or the 48 KiB static limit;
* **Launch bounds**: every ``__launch_bounds__(N[, M])`` has
  ``N <= 1024`` and ``N`` a multiple of 32;
* **Per-SM fit**: for the flash kernels' ``Cfg<D>`` at every head width
  the file instantiates, ``minBlocks * (kSmem + 1 KiB) <= 233,472`` B
  (the SM's shared memory, 1 KiB reserved per CTA), else the declared
  occupancy cannot happen, and ``kSmem <= SMEM_BYTES``;
* **The column window**: the event-delivery ring window at the engine's
  default ``d_ring`` (read from ``EngineConfig``) over the paper's
  column (``NEURONS_PER_COLUMN``), plus ``COLUMN_STATIC_SMEM``, fits in
  ``SMEM_BYTES``.

The card half, ``check_built()``, holds each built library's ptxas
figures (registers, static shared memory, spills, stack: the ``-Xptxas
-v`` log that ``_build`` keeps beside each library as
``lib<name>-<hash>.log``) against the same declarations.  It fails on
static shared memory above the declared value, on ``threads x
registers x minBlocks > 65,536`` and on a per-SM fit the figures break;
spills are reported, not gated.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

from .core import (Checker, Finding, Module, Project, find_module,
                   module_int_constants, str_literals)

NAME = "hopper-geometry"

SM_SMEM_BYTES = 233_472          # shared memory of one H100 SM
CTA_RESERVED_SMEM = 1024         # the system's reserve per resident CTA
STATIC_SMEM_LIMIT = 48 * 1024    # static __shared__ a block may declare
SM_REGISTERS = 65_536
MAX_THREADS = 1024
# (Python module, its constant, CUDA source, its constant, the kernel
# whose static shared memory the constant declares, or None)
MIRRORS = (
    ("synaptic_accum.py", "COLUMN_STATIC_SMEM", "event_delivery",
     "kColStaticSmem", "deliver_columns_kernel"),
    ("synaptic_accum.py", "COLUMN_WARPS", "event_delivery", "kColWarps",
     None),
    ("plastic_step.py", "STATIC_SMEM", "plastic_delivery", "kStaticSmem",
     "plastic_delivery_kernel"),
)
_ELEM_BYTES = {"char": 1, "bool": 1, "int8_t": 1, "uint8_t": 1,
               "short": 2, "int16_t": 2, "uint16_t": 2, "half": 2,
               "__half": 2, "__nv_bfloat16": 2, "int": 4, "unsigned": 4,
               "float": 4, "int32_t": 4, "uint32_t": 4, "double": 8,
               "int64_t": 8, "uint64_t": 8, "u64": 8, "long": 8}


# ---------------------------------------------------------------------------
# A small evaluator of C integer constant expressions
# ---------------------------------------------------------------------------

_TOKEN = re.compile(r"\s*(0x[0-9a-fA-F]+|\d+|[A-Za-z_]\w*|<<|>>|<=|>=|==|"
                    r"!=|&&|\|\||[-+*/%()<>?:!])")
_BINARY = [("?",), ("||",), ("&&",), ("==", "!="), ("<", "<=", ">", ">="),
           ("<<", ">>"), ("+", "-"), ("*", "/", "%")]


def c_eval(expr: str, env: Dict[str, int]) -> Optional[int]:
    """Fold a C integer expression (literals with u/l suffixes, names
    from ``env``, ``sizeof`` of a scalar type, arithmetic, shifts,
    comparisons, ``&&``/``||``/``!`` and ``?:``); None if it is not
    constant under ``env``."""
    text = re.sub(r"(\d)[uUlL]+\b", r"\1", expr)
    text = re.sub(r"sizeof\s*\(\s*(\w+)\s*\)",
                  lambda m: str(_ELEM_BYTES.get(m.group(1), -1)), text)
    text = re.sub(r"\btrue\b", "1", re.sub(r"\bfalse\b", "0", text))
    toks, pos = [], 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if not m or not m.group(1):
            if text[pos:].strip():
                return None
            break
        toks.append(m.group(1))
        pos = m.end()
    try:
        val, rest = _parse(toks, 0, env)
    except (KeyError, IndexError, ValueError, ZeroDivisionError):
        return None
    return val if rest == len(toks) and val is not None else None


def _parse(toks, level, env):
    if level == len(_BINARY):
        return _unary(toks, env)
    if _BINARY[level] == ("?",):
        cond, i = _parse(toks, level + 1, env)
        if i < len(toks) and toks[i] == "?":
            a, i = _parse_from(toks, i + 1, 0, env)
            if toks[i] != ":":
                raise ValueError("?: without :")
            b, i = _parse_from(toks, i + 1, 0, env)
            return (a if cond else b), i
        return cond, i
    left, i = _parse(toks, level + 1, env)
    while i < len(toks) and toks[i] in _BINARY[level]:
        op = toks[i]
        right, i = _parse_from(toks, i + 1, level + 1, env)
        left = _apply(op, left, right)
    return left, i


def _parse_from(toks, start, level, env):
    val, i = _parse(toks[start:], level, env)
    return val, start + i


def _unary(toks, env):
    t = toks[0]
    if t in ("-", "!", "+"):
        v, i = _unary(toks[1:], env)
        return {"-": -v, "!": int(not v), "+": v}[t], i + 1
    if t == "(":
        v, i = _parse_from(toks, 1, 0, env)
        if toks[i] != ")":
            raise ValueError("unbalanced (")
        return v, i + 1
    if re.fullmatch(r"0x[0-9a-fA-F]+|\d+", t):
        return int(t, 0), 1
    return env[t], 1


def _apply(op, a, b):
    if op in ("/", "%") and b == 0:
        raise ZeroDivisionError
    return {"+": a + b, "-": a - b, "*": a * b,
            "/": int(a / b), "%": a - b * int(a / b),
            "<<": a << b, ">>": a >> b, "<": int(a < b), "<=": int(a <= b),
            ">": int(a > b), ">=": int(a >= b), "==": int(a == b),
            "!=": int(a != b), "&&": int(bool(a and b)),
            "||": int(bool(a or b))}[op]


# ---------------------------------------------------------------------------
# What a CUDA source declares
# ---------------------------------------------------------------------------

_CONST = re.compile(r"^\s*(?:static\s+)?(?:const|constexpr)\s+(?:int|bool|"
                    r"unsigned)\s+(\w+)\s*=\s*([^;]+);", re.M)
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\("
                     r"(?P<lb>[^()]*)\)\s*)?(?P<name>\w+)\s*\(")
_DEVICE = re.compile(r"__device__\s+(?:__forceinline__\s+)?[\w:<>]+\s+"
                     r"(?P<name>\w+)\s*\(")
_SHARED = re.compile(r"(?<!extern )__shared__\s+(?:alignas\(\d+\)\s+)?"
                     r"(?P<type>[\w:]+)\s+(?P<name>\w+)(?P<dims>(?:\s*\["
                     r"[^\]]+\])*)\s*;")
_CFG = re.compile(r"template\s*<\s*int\s+D\s*>\s*struct\s+Cfg\s*\{")
_INSTANCES = re.compile(r"launch<(\d+)>")


def file_constants(text: str) -> Dict[str, int]:
    """Every foldable ``const``/``constexpr`` int of the file, in order
    (file scope and function locals alike; the first wins)."""
    env: Dict[str, int] = {}
    for name, expr in _CONST.findall(text):
        if name not in env:
            v = c_eval(expr, env)
            if v is not None:
                env[name] = v
    return env


def _body(text: str, start: int) -> Tuple[str, int]:
    """The brace-matched body that opens at or after ``start``."""
    i = text.index("{", start)
    depth = 0
    for j in range(i, len(text)):
        depth += {"{": 1, "}": -1}.get(text[j], 0)
        if depth == 0:
            return text[i:j + 1], j + 1
    raise ValueError("unbalanced braces")


def cfg_constants(text: str, d: int, env: Dict[str, int]) -> Dict[str, int]:
    """``Cfg<D>``'s constants at head width ``d`` ({} if no Cfg)."""
    m = _CFG.search(text)
    if not m:
        return {}
    body, _ = _body(text, m.start())
    out = dict(env, D=d)
    for name, expr in _CONST.findall(body):
        v = c_eval(expr, out)
        if v is not None:
            out[name] = v
    return out


def _shared_bytes(body: str, env: Dict[str, int]) -> Tuple[int, List[str]]:
    total, unknown = 0, []
    for m in _SHARED.finditer(body):
        size = _ELEM_BYTES.get(m.group("type"))
        n = 1
        for dim in re.findall(r"\[([^\]]+)\]", m.group("dims")):
            v = c_eval(dim, env)
            n = None if v is None or n is None else n * v
        if size is None or n is None:
            unknown.append(m.group("name"))
        else:
            total += size * n
    return total, unknown


@dataclasses.dataclass
class KernelGeometry:
    """One kernel (one head width of a ``Cfg<D>`` template)."""
    source: str
    kernel: str
    line: int
    d: Optional[int]                 # head width of a Cfg<D> instance
    threads: Optional[int]           # __launch_bounds__ N, else the
    #                                  launch site's block size
    min_blocks: int                  # __launch_bounds__ M (1 if absent)
    bounded: bool
    static_smem: int                 # its __shared__ arrays, folded
    unknown_shared: List[str]        # arrays whose size did not fold
    declared_smem: int               # the static smem its wrapper allows
    dyn_smem: Optional[int]          # Cfg<D>::kSmem, where there is one
    launch_bounds: str               # as written

    @property
    def label(self) -> str:
        return self.kernel if self.d is None else f"{self.kernel}<{self.d}>"


def source_geometry(source: str, text: str,
                    declared: Dict[str, int]) -> List[KernelGeometry]:
    """The kernels of one CUDA source. ``declared``: kernel -> the
    static shared memory its wrapper declares."""
    env = file_constants(text)
    devices = {}
    for m in _DEVICE.finditer(text):
        try:
            devices[m.group("name")] = _body(text, m.end())[0]
        except ValueError:
            continue
    widths = sorted({int(x) for x in _INSTANCES.findall(text)}) \
        if _CFG.search(text) else []
    out = []
    for m in _GLOBAL.finditer(text):
        name, lb = m.group("name"), m.group("lb")
        body, _ = _body(text, m.end())
        reached, frontier = {}, [body]      # the __device__ fns it calls
        while frontier:
            b = frontier.pop()
            for fn, fbody in devices.items():
                if fn not in reached and re.search(rf"\b{fn}\s*\(", b):
                    reached[fn] = fbody
                    frontier.append(fbody)
        templated = "Cfg<D>" in (lb or "") or "Cfg<D>" in body
        line = text.count("\n", 0, m.start()) + 1
        for d in (widths if templated else [None]):
            cenv = cfg_constants(text, d, env) if d is not None else env
            args = [a.strip() for a in (lb or "").split(",") if a.strip()]
            vals = [c_eval(re.sub(r"\b(?:Cfg<D>|C)::", "", a), cenv)
                    for a in args]
            threads = vals[0] if vals else _launch_threads(text, name, env)
            smem, unknown = 0, []
            for part in [body] + list(reached.values()):
                b, u = _shared_bytes(part, cenv)
                smem, unknown = smem + b, unknown + u
            out.append(KernelGeometry(
                source=source, kernel=name, line=line, d=d,
                threads=threads,
                min_blocks=(vals[1] if len(vals) > 1 and vals[1] else 1),
                bounded=bool(vals), static_smem=smem,
                unknown_shared=unknown,
                declared_smem=declared.get(name, STATIC_SMEM_LIMIT),
                dyn_smem=cenv.get("kSmem") if d is not None else None,
                launch_bounds=lb or ""))
    return out


def _launch_threads(text: str, kernel: str,
                    env: Dict[str, int]) -> Optional[int]:
    """The block size of ``kernel<<<grid, block, ...>>>``, where one
    launch site names the kernel and its block folds to a constant."""
    sizes = {c_eval(m.group(1), env) for m in re.finditer(
        rf"\b{kernel}\s*(?:<[^<>;]*>)?\s*<<<[^,]+,\s*([^,>]+)", text)}
    return sizes.pop() if len(sizes) == 1 else None


def geometry_findings(g: KernelGeometry,
                      smem_bytes: int) -> Iterable[str]:
    """The static half's complaints about one kernel."""
    if g.bounded and (g.threads is None or g.threads > MAX_THREADS
                      or g.threads % 32):
        yield (f"{g.label}: __launch_bounds__({g.launch_bounds}) needs "
               f"N <= {MAX_THREADS} and a multiple of 32 (N = {g.threads})")
    if g.unknown_shared:
        yield (f"{g.label}: __shared__ {', '.join(g.unknown_shared)} "
               "have sizes that do not fold to constants")
    if g.static_smem > g.declared_smem:
        yield (f"{g.label}: {g.static_smem} B of static __shared__ arrays "
               f"exceed the {g.declared_smem} B its wrapper declares")
    if g.dyn_smem is not None:
        if g.dyn_smem > smem_bytes:
            yield (f"{g.label}: kSmem = {g.dyn_smem} B exceeds a block's "
                   f"{smem_bytes} B (SMEM_BYTES)")
        per_sm = g.min_blocks * (g.dyn_smem + g.static_smem
                                 + CTA_RESERVED_SMEM)
        if per_sm > SM_SMEM_BYTES:
            yield (f"{g.label}: {g.min_blocks} CTAs x (kSmem {g.dyn_smem} + "
                   f"{g.static_smem} + {CTA_RESERVED_SMEM}) = {per_sm} B "
                   f"exceed an SM's {SM_SMEM_BYTES} B: the declared "
                   "occupancy cannot happen")


# ---------------------------------------------------------------------------
# The static pass
# ---------------------------------------------------------------------------

def _assign_line(mod: Module, name: str) -> int:
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name
                for t in node.targets):
            return node.lineno
    return 1


def _engine_d_ring_default(project: Project) -> int:
    mod = find_module(project, "core/engine.py")
    for node in ast.walk(mod.tree) if mod else ():
        if isinstance(node, ast.ClassDef) and node.name == "EngineConfig":
            for s in node.body:
                if isinstance(s, ast.AnnAssign) \
                        and isinstance(s.target, ast.Name) \
                        and s.target.id == "d_ring" \
                        and isinstance(s.value, ast.Constant) \
                        and isinstance(s.value.value, int):
                    return s.value.value
    return 8


class HopperGeometryChecker(Checker):
    name = NAME
    description = ("CUDA sources listed, Python mirrors of CUDA constants, "
                   "static/dynamic shared memory and launch bounds vs the "
                   "H100's budgets")

    def run(self, project: Project) -> Iterable[Finding]:
        build = find_module(project, "kernels/_build.py")
        if build is None:
            return
        kdir = Path(build.path).parent
        csrc = kdir / "csrc"
        sources = []
        for node in build.tree.body:
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "SOURCES"
                    for t in node.targets):
                sources = str_literals(node.value)
        line = _assign_line(build, "SOURCES")
        on_disk = sorted(p.stem for p in csrc.glob("*.cu"))
        for s in sorted(set(on_disk) - set(sources)):
            yield Finding(build.path, line, NAME,
                          f"csrc/{s}.cu is not in _build.SOURCES: it is "
                          "never built or checked")
        for s in sorted(set(sources) - set(on_disk)):
            yield Finding(build.path, line, NAME,
                          f"_build.SOURCES names {s!r} but csrc/{s}.cu "
                          "does not exist")
        smem_bytes = module_int_constants(build).get("SMEM_BYTES", 0)
        texts = {s: (csrc / f"{s}.cu").read_text() for s in on_disk}

        declared: Dict[str, int] = {}
        for pyfile, pyname, src, cname, kernel in MIRRORS:
            mod = find_module(project, f"kernels/{pyfile}")
            if mod is None or src not in texts:
                continue
            py = module_int_constants(mod).get(pyname)
            cu = file_constants(texts[src]).get(cname)
            if py != cu:
                yield Finding(
                    mod.path, _assign_line(mod, pyname), NAME,
                    f"{pyname} = {py} but csrc/{src}.cu has {cname} = "
                    f"{cu}: the wrapper sizes its launch from a number the "
                    "kernel does not declare")
            if kernel is not None and py is not None:
                declared[kernel] = py

        for s, text in texts.items():
            path = str(csrc / f"{s}.cu")
            for g in source_geometry(s, text, declared):
                for msg in geometry_findings(g, smem_bytes):
                    yield Finding(path, g.line, NAME, msg)

        accum = find_module(project, "kernels/synaptic_accum.py")
        conn = find_module(project, "core/connectivity.py")
        if accum is not None and conn is not None and smem_bytes:
            static = module_int_constants(accum).get("COLUMN_STATIC_SMEM", 0)
            width = module_int_constants(conn).get("NEURONS_PER_COLUMN", 0)
            d_ring = _engine_d_ring_default(project)
            window = 4 * d_ring * width
            if window + static > smem_bytes:
                yield Finding(
                    accum.path, _assign_line(accum, "COLUMN_STATIC_SMEM"),
                    NAME,
                    f"the column kernel's ring window at d_ring {d_ring} "
                    f"over a {width}-neuron column ({window} B) plus "
                    f"COLUMN_STATIC_SMEM ({static} B) exceeds SMEM_BYTES "
                    f"({smem_bytes} B)")


# ---------------------------------------------------------------------------
# The card half: ptxas's figures against the declarations
# ---------------------------------------------------------------------------

def parse_ptxas(log: str) -> List[dict]:
    """Each kernel entry of a ``-Xptxas -v`` log: ``entry`` (mangled),
    ``registers``, ``smem`` (static bytes), ``spill_stores``,
    ``spill_loads``, ``stack`` (frame bytes)."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"entry": m.group(1), "registers": 0, "smem": 0,
                   "spill_stores": 0, "spill_loads": 0, "stack": 0}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = \
                map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(s.group(1)) if s else 0
    return out


def _match(entry: str, kernels: List[KernelGeometry]) \
        -> Optional[KernelGeometry]:
    for g in kernels:
        if entry == g.kernel:            # an unmangled (extern "C") entry
            return g
        at = entry.find(f"{len(g.kernel)}{g.kernel}")
        if at < 0:
            continue
        if g.d is None:
            return g
        m = re.match(r"ILi(\d+)E", entry[at + len(str(len(g.kernel)))
                                          + len(g.kernel):])
        if m and int(m.group(1)) == g.d:
            return g
    return None


def check_figures(source: str, log: str, kernels: List[KernelGeometry]) \
        -> Tuple[List[dict], List[str]]:
    """ptxas's figures of one library against its kernels' declared
    geometry: one row per entry (with ``kernel``, ``threads``,
    ``min_blocks``, ``declared_smem``) and the failures."""
    rows, errors = [], []
    entries = parse_ptxas(log)
    if not entries:
        errors.append(f"{source}: no kernel entry in its ptxas log")
    for e in entries:
        g = _match(e["entry"], kernels)
        if g is None:
            errors.append(f"{source}: ptxas built {e['entry']}, which no "
                          "__global__ of the source declares")
            continue
        row = dict(e, source=source, kernel=g.label, threads=g.threads,
                   min_blocks=g.min_blocks, declared_smem=g.declared_smem,
                   launch_bounds=g.launch_bounds)
        rows.append(row)
        if e["smem"] > g.declared_smem:
            errors.append(f"{g.label}: ptxas allots {e['smem']} B of static "
                          f"shared memory, above the declared "
                          f"{g.declared_smem} B")
        if g.threads is not None and g.threads * e["registers"] \
                * g.min_blocks > SM_REGISTERS:
            errors.append(f"{g.label}: {g.threads} threads x "
                          f"{e['registers']} registers x {g.min_blocks} "
                          f"blocks exceed the SM's {SM_REGISTERS}")
        if g.dyn_smem is not None:
            per_sm = g.min_blocks * (g.dyn_smem + e["smem"]
                                     + CTA_RESERVED_SMEM)
            if per_sm > SM_SMEM_BYTES:
                errors.append(f"{g.label}: {g.min_blocks} x (kSmem "
                              f"{g.dyn_smem} + {e['smem']} + "
                              f"{CTA_RESERVED_SMEM}) = {per_sm} B exceed an "
                              f"SM's {SM_SMEM_BYTES} B")
    return rows, errors


def declared_static_smem() -> Dict[str, int]:
    """kernel -> the static shared memory the live wrappers declare."""
    from ..kernels import plastic_step, synaptic_accum
    consts = {"synaptic_accum.py": vars(synaptic_accum),
              "plastic_step.py": vars(plastic_step)}
    return {kernel: consts[py][name]
            for py, name, _, _, kernel in MIRRORS if kernel is not None}


def check_built(sources=None) -> List[dict]:
    """The card half over the built libraries (``kernels._build``):
    every row of ``check_figures`` for each source, or raises
    ``RuntimeError`` naming every failure (a library never built, or a
    log missing, is one)."""
    from ..kernels import _build
    declared = declared_static_smem()
    rows, errors = [], []
    for s in sources or _build.SOURCES:
        log_path = _build.log_path(s)
        if not log_path.exists():
            errors.append(f"{s}: no ptxas log at {log_path} (not built)")
            continue
        kernels = source_geometry(
            s, (_build.CSRC / f"{s}.cu").read_text(), declared)
        r, e = check_figures(s, log_path.read_text(), kernels)
        rows += r
        errors += e
    if errors:
        raise RuntimeError("hopper-geometry: " + "; ".join(errors))
    return rows
