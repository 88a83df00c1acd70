"""Activity analysis over spooled spike logs -> JSON report.

Computes the paper-family activity statistics (firing-rate
distributions, ISI CV, population rate with Down/Up segmentation and a
slow-wave vs awake-like regime call) from the spike logs a recorded run
(``python -m repro_torch.launch.sim --record``) spooled under
``<ckpt_dir>/spool``, and -- given several runs -- the comparison table
the connectivity-law studies are built on.  The port of
``repro.launch.analyze``; it reads the reference's spools as well.

One run::

    PYTHONPATH=src python -m repro_torch.launch.analyze \\
        --run /tmp/snn_ckpt --out results/analysis.json

Gaussian vs exponential comparison (labels are free-form)::

    PYTHONPATH=src python -m repro_torch.launch.analyze \\
        --run gauss=/tmp/snn_gauss --run expo=/tmp/snn_expo \\
        --out results/law_comparison.json

A spool with member streams (an ensemble run)
expands into one labeled report per member stream --
``label/member_000``, ... -- plus the member-vs-member comparison
table; ``--member M`` restricts to one member.
"""

from __future__ import annotations

import argparse
import json
import os

from ..obs.analysis import analyze_run, compare_runs, strip_private
from ..obs.spool import member_dirs, member_name
from ..obs.telemetry import read_jsonl, summarize


def parse_run(spec: str):
    """``label=dir`` or bare ``dir`` (label = basename)."""
    if "=" in spec:
        label, path = spec.split("=", 1)
    else:
        path = spec
        label = os.path.basename(os.path.normpath(spec))
    if not label:
        raise SystemExit(f"--run {spec!r}: empty label")
    return label, path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run", action="append", required=True,
                    metavar="[LABEL=]DIR",
                    help="recorded run directory (repeatable; the spool/ "
                         "subdirectory is found automatically)")
    ap.add_argument("--out", default=os.path.join("results",
                                                  "analysis.json"))
    ap.add_argument("--steps", type=int, default=None,
                    help="simulated steps (default: inferred from the "
                         "run's checkpoints)")
    ap.add_argument("--bin-steps", type=int, default=5,
                    help="population-rate bin width in steps")
    ap.add_argument("--smooth-bins", type=int, default=5,
                    help="moving-average window for Up/Down thresholding")
    ap.add_argument("--updown-frac", type=float, default=0.3,
                    help="Up threshold as a fraction of the p10-p90 span")
    ap.add_argument("--telemetry", action="append", default=[],
                    metavar="[LABEL=]FILE.jsonl",
                    help="telemetry stream from a traced run "
                         "(--telemetry-out); summarized into the report "
                         "(per-span wall totals, segment throughput)")
    ap.add_argument("--member", type=int, default=None,
                    help="ensemble runs: analyze only this member "
                         "stream (default: every member, labeled "
                         "LABEL/member_NNN)")
    args = ap.parse_args(argv)

    runs = dict(parse_run(s) for s in args.run)
    if len(runs) != len(args.run):
        raise SystemExit("--run labels must be unique")
    runs, plain = {}, runs
    saw_ensemble = False
    for label, path in plain.items():
        members = member_dirs(path)
        if not members:
            runs[label] = path
            continue
        saw_ensemble = True
        if args.member is not None:
            name = member_name(args.member)
            if name not in members:
                raise SystemExit(
                    f"--member {args.member}: {path} has members "
                    f"{sorted(members)}")
            members = {name: members[name]}
        for name, mpath in members.items():
            runs[f"{label}/{name}"] = mpath
    if args.member is not None and not saw_ensemble:
        raise SystemExit("--member: none of the runs is an ensemble")
    reports = {label: analyze_run(path, t_steps=args.steps,
                                  bin_steps=args.bin_steps,
                                  smooth_bins=args.smooth_bins,
                                  updown_frac=args.updown_frac)
               for label, path in runs.items()}
    payload = {"runs": {k: strip_private(r) for k, r in reports.items()}}
    if len(reports) > 1:
        payload["comparison"] = compare_runs(reports)
    if args.telemetry:
        payload["telemetry"] = {
            label: summarize(read_jsonl(path))
            for label, path in (parse_run(s) for s in args.telemetry)}

    for label, r in reports.items():
        ud = r["population"]["updown"]
        cv = r["isi"]["mean_cv"]
        print(f"{label}: events={r['n_events']} "
              f"mean_rate_hz={r['mean_rate_hz']:.2f} "
              f"isi_cv={'n/a' if cv is None else round(cv, 3)} "
              f"regime={ud['regime']} up_fraction={ud['up_fraction']:.2f}")
    if len(reports) > 1:
        for pair, row in payload["comparison"]["pairs"].items():
            ratio = row["mean_rate_ratio"]
            print(f"{pair}: mean_rate_ratio="
                  f"{'n/a' if ratio is None else round(ratio, 3)} "
                  f"rate_ks={row['rate_ks_statistic']}")
    for label, t in payload.get("telemetry", {}).items():
        seg = t.get("segments")
        rate = (f"{seg['steps_per_s_mean']:.1f} steps/s over {seg['n']} "
                "segment(s)" if seg else "no segment metrics")
        print(f"telemetry {label}: {t['processes']} process(es), "
              f"{sum(s['count'] for s in t['spans'].values())} span(s), "
              f"{rate}")

    d = os.path.dirname(args.out)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    print(f"wrote {args.out}")
    return payload


if __name__ == "__main__":
    main()
