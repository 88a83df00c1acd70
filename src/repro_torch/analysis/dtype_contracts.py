"""Dtype/overflow contract pass (``dtype-bounds``).

The compressed synapse tables trade bytes for invariants: int16 in-tile
target ids are only sound while ``n_local < 2**15``, bfloat16 weights
are only value-exact because every *accumulation* happens in float32,
and ``core/``/``kernels/`` stay float32-first so a stray float64
promotion can't silently double the memory envelope (or leave the card's
fast paths: float64 runs at a fraction of float32's rate on an H100).
Three sub-checks, the reference analyzer's in torch terms:

1. **int16 bound, cross-checked against committed configs**: for every
   grid x law case in ``repro_torch.configs.snn`` (paper Table 1 grids
   plus the reduced test case) over the committed tilings, if the
   derived ``TableStorage`` selects int16 target ids then the tile's
   ``n_local`` must fit; runs the port's real constructors at lint time
   so the check can never drift from the code (skipped, not failed, if
   the package isn't importable).  A ``TableStorage(tgt_dtype="int16")``
   literal outside ``core/synapses.py`` is flagged statically: storage
   must come from ``spec.storage()``/``from_meta`` so the bound is
   derived, never asserted by hand.
2. **No accumulation in a storage dtype**: reductions / contractions
   (``torch.sum``, ``matmul``, ``einsum``, ``cumsum``, ``mm``, ``bmm``,
   the ``@`` operator, ``index_add_``, ``scatter_add_``, and the tensor
   methods of the same names) whose operand is visibly cast to a
   16/8-bit dtype in the same expression (``.to(torch.bfloat16)``,
   ``.bfloat16()``, ``.half()``, a ``torch.float16`` argument), or that
   name such a dtype as their own ``dtype=``.
3. **No float64 in ``core/``/``kernels/``**: ``torch.float64``,
   ``torch.double``, ``.double()``, ``np.float64``, a ``"float64"``
   dtype string, ``astype(float)``; host-side analytic code that *needs*
   float64 precision carries an explicit pragma.
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional

from .core import Checker, Finding, Module, Project, find_module

NAME = "dtype-bounds"

_ACCUM_CALLS = {"torch.sum", "torch.matmul", "torch.einsum", "torch.cumsum",
                "torch.mm", "torch.bmm", "torch.prod", "torch.mean",
                "torch.dot", "torch.addmm", "torch.baddbmm",
                "torch.index_add", "torch.scatter_add"}
_ACCUM_METHODS = {"sum", "cumsum", "prod", "mean", "matmul", "mm", "bmm",
                  "dot", "index_add_", "scatter_add_", "index_add",
                  "scatter_add"}
# 16- and 8-bit dtypes: a storage format, never an accumulator
_STORAGE_DTYPES = {"bfloat16", "float16", "half", "int16", "short", "int8",
                   "uint8"}
_CAST_METHODS = {"bfloat16", "half", "short", "char", "byte"}
_F64_NAMES = {"float64", "double"}
_F32_FIRST_DIRS = ("/core/", "/kernels/")
_TILINGS = ((1, 1), (1, 2), (2, 2), (4, 4), (8, 8))


def _is_f32_first(mod: Module) -> bool:
    p = mod.path.replace("\\", "/")
    return "src/repro" in p and any(d in p for d in _F32_FIRST_DIRS)


def _names_storage_dtype(expr: ast.expr, mod: Module) -> bool:
    """``torch.bfloat16`` / ``"float16"`` and the like."""
    if isinstance(expr, ast.Constant):
        return expr.value in _STORAGE_DTYPES
    dn = mod.resolve_dotted(expr)
    return bool(dn) and dn.startswith(("torch.", "numpy.")) \
        and dn.split(".")[-1] in _STORAGE_DTYPES


def _casts_to_storage_dtype(expr: ast.expr, mod: Module) -> bool:
    """True if the expression visibly casts to a 16/8-bit dtype."""
    for node in ast.walk(expr):
        if not isinstance(node, ast.Call) \
                or not isinstance(node.func, ast.Attribute):
            continue
        attr = node.func.attr
        if attr in _CAST_METHODS and not node.args:
            return True
        if attr in ("to", "type", "astype"):
            args = list(node.args) + [kw.value for kw in node.keywords]
            if any(_names_storage_dtype(a, mod) for a in args):
                return True
    return False


def _accum_operands(node: ast.AST, mod: Module) -> Optional[list]:
    """The operands of an accumulating call or ``@``, else None."""
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
        return [node.left, node.right]
    if not isinstance(node, ast.Call):
        return None
    args = list(node.args) + [kw.value for kw in node.keywords
                              if kw.arg != "dtype"]
    dn = mod.resolve_dotted(node.func)
    if dn in _ACCUM_CALLS:
        return args
    if isinstance(node.func, ast.Attribute) \
            and node.func.attr in _ACCUM_METHODS:
        return [node.func.value] + args
    return None


class DtypeContractsChecker(Checker):
    name = NAME
    description = ("int16 target-id bound vs committed configs, no "
                   "accumulation in storage dtypes, no float64 in "
                   "core//kernels/")

    def run(self, project: Project) -> Iterable[Finding]:
        for mod in project.modules:
            if _is_f32_first(mod):
                yield from self._no_float64(mod)
            yield from self._no_storage_accum(mod)
            yield from self._no_handmade_int16(mod)
        yield from self._int16_bound_vs_configs(project)

    # ---- float64 ------------------------------------------------------
    def _no_float64(self, mod: Module) -> Iterable[Finding]:
        for node in mod.nodes:
            if isinstance(node, ast.Attribute) and node.attr in _F64_NAMES \
                    and (mod.resolve_dotted(node) or "").startswith(
                        ("torch.", "numpy.")):
                yield Finding(
                    mod.path, node.lineno, self.name,
                    f"{node.attr} in core//kernels/: f32-first contract "
                    "(float64 is slow on the card and doubles the memory "
                    "envelope)")
            elif isinstance(node, ast.Constant) and node.value == "float64":
                yield Finding(
                    mod.path, node.lineno, self.name,
                    '"float64" dtype string in core//kernels/: '
                    "f32-first contract")
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute):
                if node.func.attr == "double" and not node.args:
                    yield Finding(
                        mod.path, node.lineno, self.name,
                        ".double() in core//kernels/: f32-first contract")
                elif node.func.attr == "astype" and node.args and \
                        isinstance(node.args[0], ast.Name) and \
                        node.args[0].id == "float":
                    yield Finding(
                        mod.path, node.lineno, self.name,
                        "astype(float) promotes to float64 on host numpy")

    # ---- accumulation in storage dtype --------------------------------
    def _no_storage_accum(self, mod: Module) -> Iterable[Finding]:
        for node in mod.nodes:
            operands = _accum_operands(node, mod)
            if operands is None:
                continue
            own = isinstance(node, ast.Call) and any(
                kw.arg == "dtype" and _names_storage_dtype(kw.value, mod)
                for kw in node.keywords)
            if own or any(_casts_to_storage_dtype(a, mod)
                          for a in operands):
                yield Finding(
                    mod.path, node.lineno, self.name,
                    "accumulation over a value cast to a storage "
                    "dtype: cast to float32 *before* the reduction "
                    "(16-bit partial sums are not value-exact)")

    # ---- hand-built int16 storage -------------------------------------
    def _no_handmade_int16(self, mod: Module) -> Iterable[Finding]:
        if mod.path.replace("\\", "/").endswith("core/synapses.py"):
            return
        for node in mod.nodes:
            if not isinstance(node, ast.Call):
                continue
            dn = mod.resolve_dotted(node.func)
            if not dn or dn.split(".")[-1] != "TableStorage":
                continue
            for kw in node.keywords:
                if kw.arg == "tgt_dtype" and \
                        isinstance(kw.value, ast.Constant) and \
                        kw.value.value == "int16":
                    yield Finding(
                        mod.path, node.lineno, self.name,
                        "hand-built TableStorage(tgt_dtype='int16'): "
                        "the n_local < 2**15 bound is only checked by "
                        "spec.storage()/TableStorage.from_meta -- "
                        "derive storage, don't assert it")

    # ---- the live bound vs every committed config ---------------------
    def _int16_bound_vs_configs(self, project: Project) \
            -> Iterable[Finding]:
        cfg_mod = find_module(project, "repro_torch/configs/snn.py")
        if cfg_mod is None:
            return                       # configs not in the lint scope
        try:
            from ..configs import snn as snn_configs
        except ImportError:
            return                       # lint run outside the repo env
        for cname, ty, tx, spec, storage, err in derived_storages(
                snn_configs):
            if err is not None:
                yield Finding(
                    cfg_mod.path, 1, self.name,
                    f"config {cname} @ {ty}x{tx} failed to construct "
                    f"during bound check: {err!r}")
            elif storage.tgt_dtype == "int16" and spec.n_local >= 2 ** 15:
                yield Finding(
                    cfg_mod.path, 1, self.name,
                    f"config {cname} @ {ty}x{tx}: int16 target ids "
                    f"but n_local={spec.n_local} >= 2**15 -- "
                    "in-tile ids overflow")


def derived_storages(snn_configs):
    """``(case name, ty, tx, spec, storage, error)`` for every committed
    case (with the reduced one) over every tiling that divides its grid;
    ``error`` is the exception a constructor raised, else None."""
    cases = dict(snn_configs.CASES)
    cases["reduced"] = snn_configs.reduced_case()
    for cname, case in sorted(cases.items()):
        for ty, tx in _TILINGS:
            if case.grid[0] % ty or case.grid[1] % tx:
                continue
            try:
                spec = case.engine_config(ty, tx).spec()
                yield cname, ty, tx, spec, spec.storage(), None
            except Exception as e:  # noqa: BLE001 - report, don't crash
                yield cname, ty, tx, None, None, e
