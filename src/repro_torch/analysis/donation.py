"""In-place aliasing pass (``donation``).

Where the reference donates a buffer to a jitted call
(``donate_argnums``), the port updates the argument in place and returns
it: ``dist_engine.make_sim_fn``'s ``sim(state, inputs)`` writes every
leaf of ``state``, and the train step of ``models.model`` writes the
parameters and the optimizer state.  Reading the old reference after the
call does not fail as a donated buffer would: it silently reads the
*new* values.  That is the torch form of the bug class the reference's
pass was written for (a donated carry reused to compute a post-hoc
metric), and it is worse for being quiet.

The pass is repo-aware in two steps:

1. **In-place factories**: ``INPLACE_FACTORIES`` names the port's
   callables whose *returned* function updates its arguments at the
   given positions in place (the list is held against the live package
   by a test, so it cannot drift).  ``sim = make_sim_fn(...)`` then
   marks ``sim`` (a local or a ``self.<attr>``) as updating in place.
2. **Per-function linear scan**, the reference's: after a call of such
   a name, the names passed at its updated positions are *dead* unless
   the same statement rebinds them (the canonical ``state, per =
   sim(state, inputs)``); so is every **alias** bound before the call
   to that argument or to a subscript or attribute of it (``v0 =
   state["neuron"]["v"]``), whether or not the argument is rebound.  A
   later read of a dead name is a finding.  A ``.clone()`` /
   ``.copy()`` / ``copy.deepcopy`` binding is a copy, not an alias.
   ``if``/``else`` branches are merged by intersection (a name must die
   on *all* paths to stay dead), keeping the pass false-positive-free at
   the cost of missing some single-branch bugs.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .core import Checker, Finding, FnInfo, Module, Project

NAME = "donation"

# factory -> the positions its returned callable updates in place
INPLACE_FACTORIES: Dict[str, Tuple[int, ...]] = {
    "repro_torch.core.dist_engine.make_sim_fn": (0,),
    "repro_torch.models.model.make_train_step": (0, 1),
    "repro_torch.models.model.make_compressed_pod_train_step": (0, 1, 2),
}


def _assign_target_names(stmt: ast.stmt) -> Set[str]:
    out: Set[str] = set()
    targets: List[ast.expr] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)) \
            and stmt.target is not None:
        targets = [stmt.target]
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        targets = [stmt.target]

    def flat(t):
        if isinstance(t, ast.Name):
            out.add(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                flat(e)
        elif isinstance(t, ast.Starred):
            flat(t.value)
    for t in targets:
        flat(t)
    return out


def _alias_root(value: ast.expr) -> Optional[str]:
    """The name ``value`` aliases: ``x``, ``x[...]``, ``x.attr`` and
    chains of them, never through a call (``x["v"].clone()``,
    ``x.copy()`` and ``copy.deepcopy(x)`` are copies; ``x.float()`` may
    or may not be one and is left alone)."""
    node = value
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


class _Factories:
    """Which names and attributes hold an in-place callable."""

    def __init__(self, project: Project):
        # (modname, Class, attr) -> updated positions
        self.class_attrs: Dict[Tuple[str, str, str], Tuple[int, ...]] = {}
        for fn in project.functions.values():
            if "." not in fn.qual:
                continue
            cls = fn.qual.split(".")[0]
            for stmt in ast.walk(fn.node):
                if not isinstance(stmt, ast.Assign):
                    continue
                pos = self.positions_for_value(fn.module, stmt.value)
                if not pos:
                    continue
                for t in stmt.targets:
                    if isinstance(t, ast.Attribute) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id == "self":
                        self.class_attrs[
                            (fn.module.modname, cls, t.attr)] = pos

    def positions_for_value(self, mod: Module,
                            value: ast.expr) -> Optional[Tuple[int, ...]]:
        """Updated positions if ``value`` calls an in-place factory."""
        if not isinstance(value, ast.Call):
            return None
        dn = mod.resolve_dotted(value.func)
        if not dn:
            return None
        if dn in INPLACE_FACTORIES:
            return INPLACE_FACTORIES[dn]
        if "." not in dn:                # a bare name in its own module
            return INPLACE_FACTORIES.get(f"{mod.modname}.{dn}")
        return None


class DonationChecker(Checker):
    name = NAME
    description = ("reads of arguments (or their aliases) after a call "
                   "that updates them in place (make_sim_fn's sim, the "
                   "train step)")

    def run(self, project: Project) -> Iterable[Finding]:
        factories = _Factories(project)
        for fn in project.functions.values():
            yield from self._scan_fn(fn, factories)

    def _scan_fn(self, fn: FnInfo, factories: _Factories) \
            -> Iterable[Finding]:
        cls = fn.qual.split(".")[0] if "." in fn.qual else None
        findings: List[Finding] = []
        self._scan_block(list(getattr(fn.node, "body", [])), set(), {}, {},
                         factories, fn.module, cls, findings)
        return findings

    def _inplace_call(self, call: ast.Call, local: Dict,
                      factories: _Factories, mod: Module,
                      cls: Optional[str]) -> Optional[Tuple[int, ...]]:
        f = call.func
        if isinstance(f, ast.Name) and f.id in local:
            return local[f.id]
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.value.id == "self" and cls:
            return factories.class_attrs.get((mod.modname, cls, f.attr))
        return None

    def _scan_block(self, stmts: List[ast.stmt], dead: Set[str],
                    aliases: Dict[str, str],
                    local: Dict[str, Tuple[int, ...]], factories: _Factories,
                    mod: Module, cls: Optional[str],
                    findings: List[Finding]):
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            rebound = _assign_target_names(stmt)

            # only this statement's *own* expressions are examined here;
            # nested statement lists (if/for bodies) are scanned
            # recursively so their rebindings are tracked correctly
            if isinstance(stmt, (ast.If, ast.While)):
                own_exprs: List[ast.AST] = [stmt.test]
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                own_exprs = [stmt.iter]
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                own_exprs = [i.context_expr for i in stmt.items]
            elif isinstance(stmt, ast.Try):
                own_exprs = []
            else:
                own_exprs = [stmt]

            updated_here: Set[str] = set()
            for expr in own_exprs:
                for node in ast.walk(expr):
                    if isinstance(node, ast.Call):
                        pos = self._inplace_call(node, local, factories,
                                                 mod, cls)
                        for p in pos or ():
                            if p < len(node.args) and isinstance(
                                    node.args[p], ast.Name):
                                updated_here.add(node.args[p].id)
                    if isinstance(node, ast.Name) \
                            and isinstance(node.ctx, ast.Load) \
                            and node.id in dead:
                        findings.append(Finding(
                            mod.path, node.lineno, self.name,
                            f"`{node.id}` was updated in place by a call "
                            "above (or aliases an argument that was): it "
                            "now reads the new values; clone it before "
                            "the call or rebind the result"))

            if isinstance(stmt, ast.Assign):
                # new in-place callables, and aliases of live names
                pos = factories.positions_for_value(mod, stmt.value)
                for name in rebound:
                    if pos:
                        local[name] = pos
                    aliases.pop(name, None)
                root = _alias_root(stmt.value)
                if root is not None and root not in rebound:
                    for t in stmt.targets:
                        if isinstance(t, ast.Name):
                            aliases[t.id] = root

            if isinstance(stmt, ast.If):
                d1, d2 = set(dead), set(dead)
                self._scan_block(list(stmt.body), d1, dict(aliases), local,
                                 factories, mod, cls, findings)
                self._scan_block(list(stmt.orelse), d2, dict(aliases), local,
                                 factories, mod, cls, findings)
                dead.clear()
                dead |= (d1 & d2)
            elif isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                self._scan_block(list(stmt.body), set(dead), dict(aliases),
                                 local, factories, mod, cls, findings)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                self._scan_block(list(stmt.body), dead, aliases, local,
                                 factories, mod, cls, findings)
            elif isinstance(stmt, ast.Try):
                self._scan_block(list(stmt.body), dead, aliases, local,
                                 factories, mod, cls, findings)
                for h in stmt.handlers:
                    self._scan_block(list(h.body), set(dead), dict(aliases),
                                     local, factories, mod, cls, findings)
                self._scan_block(list(stmt.orelse), dead, aliases, local,
                                 factories, mod, cls, findings)
                self._scan_block(list(stmt.finalbody), dead, aliases, local,
                                 factories, mod, cls, findings)

            # an updated name dies unless this very statement rebinds it;
            # its aliases die with it, rebound or not
            stale = {a for a, root in aliases.items()
                     if root in updated_here}
            dead |= (updated_here - rebound) | (stale - rebound)
            dead -= rebound
            for a in stale:
                aliases.pop(a, None)
