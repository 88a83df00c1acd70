"""Deprecated-API pass (``deprecated-api``).

The reference retired its ``core.engine.run`` / ``run_plastic``
aliases: ``simulate(state, tables, cfg, n_steps, plasticity=...)`` is
the one entry point, and the ensemble path (``ensemble=``) exists only
there.  The port never had the aliases; a resurrected one would fork the
API -- new call sites would miss ensembles and every keyword the aliases
never grew.  This pass keeps them dead in the port:

* **imports** of a retired name (``from repro_torch.core.engine import
  run``, any alias/relative spelling);
* **calls** that resolve to a retired dotted name
  (``engine.run(...)``, ``repro_torch.core.run_plastic(...)``);
* **redefinition**: a top-level ``def run`` / ``def run_plastic``
  appearing in ``core/engine.py`` itself.

Unrelated ``run`` functions (``SimDriver.run``, ``GraphLoop.run``,
fixtures) are out of scope: only names resolving into
``repro_torch.core.engine`` (or re-exports via ``repro_torch.core``)
count.
"""

from __future__ import annotations

import ast
from typing import Iterable

from .core import Checker, Finding, Project, import_base

NAME = "deprecated-api"

# retired dotted name -> replacement shown in the finding
RETIRED = {
    "repro_torch.core.engine.run":
        "repro_torch.core.engine.simulate",
    "repro_torch.core.engine.run_plastic":
        "repro_torch.core.engine.simulate(..., plasticity=...)",
    "repro_torch.core.run":
        "repro_torch.core.engine.simulate",
    "repro_torch.core.run_plastic":
        "repro_torch.core.engine.simulate(..., plasticity=...)",
}
RETIRED_NAMES = ("run", "run_plastic")
ENGINE_MODULES = ("repro_torch.core.engine", "repro_torch.core")


class DeprecatedApiChecker(Checker):
    name = NAME
    description = ("retired engine entry points (run/run_plastic) must "
                   "not be imported, called, or redefined -- use "
                   "simulate(..., plasticity=...)")

    def run(self, project: Project) -> Iterable[Finding]:
        for mod in project.modules:
            yield from self._imports(mod)
            yield from self._redefinition(mod)
        for site in project.calls:
            if site.callee in RETIRED:
                yield Finding(
                    site.module.path, site.call.lineno, NAME,
                    f"call to retired {site.callee}(); use "
                    f"{RETIRED[site.callee]}")

    def _imports(self, mod) -> Iterable[Finding]:
        for node in mod.nodes:
            if not isinstance(node, ast.ImportFrom):
                continue
            base = import_base(mod.modname, node)
            for a in node.names:
                if f"{base}.{a.name}" in RETIRED:
                    yield Finding(
                        mod.path, node.lineno, NAME,
                        f"import of retired {base}.{a.name}; use "
                        f"{RETIRED[f'{base}.{a.name}']}")

    def _redefinition(self, mod) -> Iterable[Finding]:
        if mod.modname not in ENGINE_MODULES \
                and not mod.path.replace("\\", "/").endswith(
                    "core/engine.py"):
            return
        for node in mod.tree.body:             # top level only
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name in RETIRED_NAMES:
                yield Finding(
                    mod.path, node.lineno, NAME,
                    f"redefinition of retired engine alias "
                    f"{node.name!r}; the one entry point is simulate()")
