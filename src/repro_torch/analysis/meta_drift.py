"""Meta-drift coverage pass (``meta-drift``).

A checkpoint manifest's meta dict is the *identity* of the saved state:
resume must refuse when a trajectory-affecting field differs.  The bug
class is a new field written into ``_meta()`` that never gets validated
on the restore path -- resume then silently reinterprets old bytes under
a new model.  The port's driver writes the reference's manifest, so this
pass is the reference's cross-reference, inside the port's
``runtime/sim_driver.py``:

* every key the driver *produces* (string keys of the ``_meta()`` dict
  literal plus ``meta["k"] = ...`` assignments in ``_save``), against
* every key the restore path *consumes* (string literals passed to
  ``refuse_meta_drift`` key tuples, ``meta.get("k")`` reads, and
  ``meta["k"]`` subscripts anywhere in the module).

A produced-but-never-consumed key is a finding; intentionally
report-only keys carry a pragma with the reason.  Three structural
checks ride along: the required identity keys (grid / law / seed /
table_realization) must appear in a ``refuse_meta_drift`` call, the
``"stdp"`` meta value must come from ``dataclasses.asdict`` (field
renames then show up as drift instead of comparing dataclass reprs),
and every ``TableStorage`` dataclass field (``core/synapses.py``) must
round-trip through its ``meta()`` dict so storage drift can't hide a
field.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Set

from .core import (Checker, Finding, Module, Project, find_module,
                   str_literals)

NAME = "meta-drift"

REQUIRED_IDENTITY_KEYS = {"grid", "law", "seed", "table_realization"}


def _dict_str_keys(d: ast.Dict) -> List[ast.Constant]:
    return [k for k in d.keys
            if isinstance(k, ast.Constant) and isinstance(k.value, str)]


class MetaDriftChecker(Checker):
    name = NAME
    description = ("checkpoint meta keys produced by the sim driver "
                   "must be consumed (refused-on-drift or read) on the "
                   "restore path")

    def run(self, project: Project) -> Iterable[Finding]:
        driver = find_module(project, "runtime/sim_driver.py")
        if driver is not None:
            yield from self._coverage(driver)
            yield from self._stdp_is_asdict(driver)
        syn = find_module(project, "core/synapses.py")
        if syn is not None:
            yield from self._storage_roundtrip(syn)

    # ---- produced vs consumed -----------------------------------------
    def _coverage(self, mod: Module) -> Iterable[Finding]:
        produced: List[ast.Constant] = []      # key Constant nodes
        consumed: Set[str] = set()

        for node in mod.nodes:
            # _meta()'s dict literal(s): any dict returned by a function
            # named _meta
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name == "_meta":
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Return) \
                            and isinstance(sub.value, ast.Dict):
                        produced.extend(_dict_str_keys(sub.value))
            # meta["k"] = ...  (production); meta["k"] / m.get("k") reads
            if isinstance(node, ast.Subscript) \
                    and isinstance(node.slice, ast.Constant) \
                    and isinstance(node.slice.value, str):
                if isinstance(node.ctx, ast.Store):
                    produced.append(node.slice)
                else:
                    consumed.add(node.slice.value)
            if isinstance(node, ast.Call):
                func = node.func
                if isinstance(func, ast.Attribute) and func.attr == "get" \
                        and node.args \
                        and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str):
                    consumed.add(node.args[0].value)
                dn = mod.resolve_dotted(func)
                if dn and dn.split(".")[-1] == "refuse_meta_drift":
                    for a in list(node.args) + [k.value
                                                for k in node.keywords]:
                        consumed.update(str_literals(a))

        refused: Set[str] = set()
        for node in mod.nodes:
            if isinstance(node, ast.Call):
                dn = mod.resolve_dotted(node.func)
                if dn and dn.split(".")[-1] == "refuse_meta_drift":
                    for a in list(node.args) + [k.value
                                                for k in node.keywords]:
                        refused.update(str_literals(a))

        seen: Set[str] = set()
        for key_node in produced:
            key = key_node.value
            if key in seen:
                continue
            seen.add(key)
            if key not in consumed:
                yield Finding(
                    mod.path, key_node.lineno, self.name,
                    f"meta key '{key}' is written to the checkpoint "
                    "manifest but never validated or read on the "
                    "restore path -- drift in it goes unnoticed "
                    "(refuse_meta_drift it, read it, or pragma with "
                    "a reason)")

        for key in sorted(REQUIRED_IDENTITY_KEYS - refused):
            yield Finding(
                mod.path, 1, self.name,
                f"identity key '{key}' is not in any "
                "refuse_meta_drift() call: resume would accept a "
                "checkpoint from a different model")

    # ---- stdp must serialize via asdict -------------------------------
    def _stdp_is_asdict(self, mod: Module) -> Iterable[Finding]:
        for node in mod.nodes:
            if not (isinstance(node, (ast.FunctionDef,
                                      ast.AsyncFunctionDef))
                    and node.name == "_meta"):
                continue
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Return) \
                        or not isinstance(sub.value, ast.Dict):
                    continue
                for k, v in zip(sub.value.keys, sub.value.values):
                    if not (isinstance(k, ast.Constant)
                            and k.value == "stdp"):
                        continue
                    ok = any(isinstance(c, ast.Call)
                             and (dn := mod.resolve_dotted(c.func))
                             and dn.split(".")[-1] == "asdict"
                             for c in ast.walk(v))
                    if not ok:
                        yield Finding(
                            mod.path, v.lineno, self.name,
                            "meta 'stdp' must serialize via "
                            "dataclasses.asdict so per-field drift is "
                            "comparable across versions")

    # ---- TableStorage fields round-trip through meta() ----------------
    def _storage_roundtrip(self, mod: Module) -> Iterable[Finding]:
        for node in mod.nodes:
            if not (isinstance(node, ast.ClassDef)
                    and node.name == "TableStorage"):
                continue
            fields = [s.target.id for s in node.body
                      if isinstance(s, ast.AnnAssign)
                      and isinstance(s.target, ast.Name)]
            meta_keys: Set[str] = set()
            meta_fn = None
            for s in node.body:
                if isinstance(s, ast.FunctionDef) and s.name == "meta":
                    meta_fn = s
                    for sub in ast.walk(s):
                        if isinstance(sub, ast.Dict):
                            meta_keys.update(
                                c.value for c in _dict_str_keys(sub))
            if meta_fn is None:
                yield Finding(mod.path, node.lineno, self.name,
                              "TableStorage has no meta() serializer")
                continue
            for f in fields:
                if f not in meta_keys:
                    yield Finding(
                        mod.path, meta_fn.lineno, self.name,
                        f"TableStorage field '{f}' missing from "
                        "meta(): storage drift in it is invisible to "
                        "resume validation")
