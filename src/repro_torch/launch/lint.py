"""repro-lint CLI for the port: run its contract analyzer.

Static passes over the source tree enforcing the invariants the port's
guarantees rest on -- capture purity and explicit generators, dtype and
overflow bounds, in-place aliasing, checkpoint-meta drift coverage,
retired entry points, and the CUDA kernels' launch geometry (one pass
each; see ``repro_torch.analysis``).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.lint     # src/repro_torch
    PYTHONPATH=src python -m repro_torch.launch.lint --select donation src/repro_torch
    PYTHONPATH=src python -m repro_torch.launch.lint --list

Suppress a single finding with a reasoned inline pragma::

    x = np.zeros(n, dtype=np.float64)  # repro-lint: ignore[dtype-bounds] host analytic

or a whole file with ``# repro-lint: ignore-file[<check>] <reason>``.
Exit codes: 0 clean, 1 findings, 2 an unknown check.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..analysis import ALL_CHECKERS, Project


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.lint",
        description="the port's contract analyzer (repro-lint)")
    p.add_argument("paths", nargs="*", default=None,
                   help="files or directories to analyze "
                   "(default: src/repro_torch)")
    p.add_argument("--select", action="append", default=None,
                   metavar="CHECK",
                   help="run only the named check(s); repeatable")
    p.add_argument("--list", action="store_true",
                   help="list available checks and exit")
    p.add_argument("--format", choices=("text", "json"), default="text")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    names = {c.name: c for c in ALL_CHECKERS}

    if args.list:
        for name, cls in sorted(names.items()):
            print(f"{name:16s} {cls.description}")
        return 0

    selected = args.select or sorted(names)
    unknown = [s for s in selected if s not in names]
    if unknown:
        print(f"unknown check(s): {', '.join(unknown)} "
              f"(have: {', '.join(sorted(names))})", file=sys.stderr)
        return 2

    project = Project.from_paths(args.paths or ["src/repro_torch"])
    findings = project.run([names[s]() for s in selected])

    if args.format == "json":
        print(json.dumps(
            [{"path": f.path, "line": f.line, "check": f.check,
              "message": f.message} for f in findings], indent=1))
    else:
        for f in findings:
            print(f)
        status = (f"{len(findings)} finding(s)" if findings
                  else "clean")
        print(f"repro-lint: {status} -- {len(project.modules)} file(s), "
              f"{len(selected)} check(s), {len(project.captured)} "
              "captured function(s)", file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
