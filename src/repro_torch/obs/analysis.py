"""Activity analysis over spooled spike logs (the paper-family stats).

The port of ``repro.obs.analysis`` (pure numpy; its reports equal the
reference's on the same logs).

The DPSNN companion studies validate the simulator by *activity*, not
just throughput: firing-rate distributions (Pastorelli et al. 2018,
arXiv:1803.08833) and slow-wave vs awake-like regime statistics
(Pastorelli et al. 2019, Front. Syst. Neurosci. 13:33).  This module
computes those families from the observatory's spooled ``(step, gid)``
event logs:

  * per-neuron and per-column firing-rate distributions (columns are
    tiling-invariant, so "per-tile" statistics survive elastic
    retiles), plus per-shard-log event totals;
  * ISI coefficient of variation (irregularity of single-neuron spike
    trains; ~1 for Poisson-like firing);
  * population-rate time series with thresholded Down/Up state
    segmentation and a slow-wave vs awake-like regime call:
    the smoothed population rate is thresholded at ``lo + frac * (hi -
    lo)`` (lo/hi = 10th/90th percentile); a run that keeps toggling
    between Down and Up states with a duty cycle away from saturation
    classifies as ``slow_wave_like``, a run pinned in the Up state as
    ``awake_like``, and a run with (almost) no spikes as ``silent``;
  * multi-run comparison tables (e.g. Gaussian vs exponential law):
    mean-rate ratios and the two-sample Kolmogorov-Smirnov statistic
    between per-neuron rate distributions.

Everything returns plain JSON-serializable dicts; the
``repro_torch.launch.analyze`` CLI renders them under ``results/``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from .spool import load_events, read_header, shard_events


def _percentiles(x: np.ndarray, qs=(5, 25, 50, 75, 95)) -> dict:
    return {f"p{q:02d}": float(np.percentile(x, q)) for q in qs}


def rate_distribution(counts: np.ndarray, sim_sec: float,
                      n_bins: int = 24) -> dict:
    """Firing-rate distribution of ``counts`` spike counts over
    ``sim_sec`` seconds (one entry per neuron or per column)."""
    rates = counts / max(sim_sec, 1e-9)
    hi = float(rates.max()) if len(rates) else 0.0
    edges = np.linspace(0.0, max(hi, 1e-9), n_bins + 1)
    hist, _ = np.histogram(rates, bins=edges)
    out = {
        "n": int(len(rates)),
        "mean_hz": float(rates.mean()) if len(rates) else 0.0,
        "std_hz": float(rates.std()) if len(rates) else 0.0,
        "min_hz": float(rates.min()) if len(rates) else 0.0,
        "max_hz": hi,
        "fraction_silent": float(np.mean(counts == 0)) if len(counts)
        else 1.0,
        "hist": {"edges_hz": [float(e) for e in edges],
                 "counts": [int(c) for c in hist]},
    }
    if len(rates):
        out.update(_percentiles(rates))
    return out


def isi_cv(events: np.ndarray, min_spikes: int = 3) -> dict:
    """Per-neuron inter-spike-interval coefficient of variation.

    Neurons with fewer than ``min_spikes`` spikes (< 2 intervals) carry
    no irregularity information and are excluded (their count is
    reported).  CV ~ 1 is Poisson-like, << 1 regular, >> 1 bursty.
    """
    if len(events) == 0:
        return {"n_neurons": 0, "n_excluded": 0,
                "mean_cv": None, "median_cv": None}
    order = np.lexsort((events["step"], events["gid"]))
    gid = events["gid"][order].astype(np.int64)
    step = events["step"][order].astype(np.int64)
    isi = np.diff(step)
    same = gid[1:] == gid[:-1]                    # interval stays in-neuron
    # segment boundaries per neuron
    uniq, start, counts = np.unique(gid, return_index=True,
                                    return_counts=True)
    cvs = []
    excluded = 0
    for s, c in zip(start, counts):
        if c < min_spikes:
            excluded += 1
            continue
        iv = isi[s:s + c - 1]
        assert same[s:s + c - 1].all()
        m = iv.mean()
        cvs.append(iv.std() / m if m > 0 else 0.0)
    if not cvs:
        return {"n_neurons": 0, "n_excluded": excluded,
                "mean_cv": None, "median_cv": None}
    cvs = np.asarray(cvs)
    return {"n_neurons": int(len(cvs)), "n_excluded": int(excluded),
            "mean_cv": float(cvs.mean()), "median_cv": float(np.median(cvs)),
            **_percentiles(cvs)}


def population_rate(events: np.ndarray, t_steps: int, n_neurons: int,
                    dt_ms: float, bin_steps: int = 1) -> np.ndarray:
    """(n_bins,) mean per-neuron rate in Hz per time bin."""
    n_bins = -(-t_steps // bin_steps)
    counts = np.bincount(events["step"].astype(np.int64) // bin_steps,
                         minlength=n_bins)[:n_bins]
    bin_sec = bin_steps * dt_ms * 1e-3
    return counts / max(n_neurons, 1) / bin_sec


def updown_segmentation(pop_hz: np.ndarray, smooth_bins: int = 5,
                        frac: float = 0.3) -> dict:
    """Threshold the (smoothed) population rate into Down/Up states.

    Threshold = ``lo + frac * (hi - lo)`` with lo/hi the 10th/90th
    percentile of the smoothed series -- scale-free, so the same
    segmentation applies to the Gaussian net at ~8 Hz and the
    exponential net at ~35 Hz.  Durations are reported in bins.
    """
    if len(pop_hz) == 0 or float(pop_hz.max()) <= 0.0:
        return {"regime": "silent", "threshold_hz": 0.0,
                "up_fraction": 0.0, "n_up_periods": 0, "n_down_periods": 0,
                "mean_up_bins": None, "mean_down_bins": None}
    k = max(1, min(smooth_bins, len(pop_hz)))
    # edge-replicated moving average ("same"-mode convolution zero-pads,
    # which fakes Down states at the series boundaries)
    padded = np.pad(pop_hz, (k // 2, k - 1 - k // 2), mode="edge")
    sm = np.convolve(padded, np.ones(k) / k, mode="valid")
    lo, hi = np.percentile(sm, 10), np.percentile(sm, 90)
    if hi - lo < 0.25 * sm.mean():
        # sustained firing with small fluctuations: thresholding inside
        # the noise band would fabricate state flips
        return {"regime": "awake_like", "threshold_hz": float(lo),
                "up_fraction": 1.0, "n_up_periods": 1, "n_down_periods": 0,
                "mean_up_bins": float(len(sm)), "mean_down_bins": None}
    thr = float(lo + frac * (hi - lo))
    up = sm > thr
    edges = np.flatnonzero(np.diff(up.astype(np.int8)))
    bounds = np.concatenate([[-1], edges, [len(up) - 1]])
    durations = np.diff(bounds)
    states = up[bounds[1:]]                      # state of each run-length
    up_d = durations[states]
    down_d = durations[~states]
    up_fraction = float(np.mean(up))
    if up_fraction >= 0.95 or len(down_d) == 0:
        regime = "awake_like"
    elif len(up_d) >= 2 and len(down_d) >= 1 and up_fraction > 0.02:
        regime = "slow_wave_like"
    else:
        regime = "sparse"
    return {
        "regime": regime, "threshold_hz": thr,
        "up_fraction": up_fraction,
        "n_up_periods": int(len(up_d)), "n_down_periods": int(len(down_d)),
        "mean_up_bins": float(up_d.mean()) if len(up_d) else None,
        "mean_down_bins": float(down_d.mean()) if len(down_d) else None,
    }


def ks_statistic(a: np.ndarray, b: np.ndarray) -> float:
    """Two-sample Kolmogorov-Smirnov statistic (max ECDF distance) --
    the "distinct distribution" score for rate-distribution tables."""
    if len(a) == 0 or len(b) == 0:
        return 0.0
    grid = np.sort(np.concatenate([a, b]))
    ca = np.searchsorted(np.sort(a), grid, side="right") / len(a)
    cb = np.searchsorted(np.sort(b), grid, side="right") / len(b)
    return float(np.abs(ca - cb).max())


def _infer_t_steps(run_dir: str, events: np.ndarray) -> int:
    """Best-effort run length: the latest checkpoint label when the
    spool sits inside a run directory (exact -- the driver checkpoints
    at the final step), else the last event's step + 1 (biased low if
    the run ended silent)."""
    from ..checkpoint.store import latest_step
    d = os.path.abspath(run_dir)
    cands = [d, os.path.dirname(d)]
    # a member stream sits at <run>/spool/member_NNN -- walk up past
    # the spool wrapper directories to the checkpointed run itself
    while (os.path.basename(d).startswith("member_")
           or os.path.basename(d) == "spool"):
        d = os.path.dirname(d)
        cands.append(d)
    for c in dict.fromkeys(cands):
        last = latest_step(c)
        if last is not None:
            return int(last)
    return int(events["step"].max()) + 1 if len(events) else 0


def analyze_run(run_dir: str, t_steps: Optional[int] = None,
                bin_steps: int = 5, smooth_bins: int = 5,
                updown_frac: float = 0.3) -> dict:
    """Full activity report for one recorded run.

    ``run_dir``: the run (checkpoint) directory or its ``spool``
    subdirectory.  ``t_steps``: simulated steps; inferred from the run's
    checkpoints (or the last event) when omitted.
    """
    header = read_header(run_dir)
    events = load_events(run_dir)
    if t_steps is None:
        t_steps = _infer_t_steps(run_dir, events)
    n_neurons = int(header["n_neurons"])
    n_per_col = int(header["grid"][2])
    dt_ms = float(header.get("dt_ms", 1.0))
    sim_sec = t_steps * dt_ms * 1e-3
    gid = events["gid"].astype(np.int64)
    neuron_counts = np.bincount(gid, minlength=n_neurons) if len(events) \
        else np.zeros(n_neurons, np.int64)
    col_counts = neuron_counts.reshape(-1, n_per_col).sum(axis=1) \
        / n_per_col                    # mean per-neuron count per column
    pop = population_rate(events, t_steps, n_neurons, dt_ms, bin_steps)
    report = {
        "run_dir": os.path.abspath(run_dir),
        "law": header.get("law"), "grid": header.get("grid"),
        "seed": header.get("seed"),
        "t_steps": int(t_steps), "sim_seconds": sim_sec,
        "n_events": int(len(events)),
        "mean_rate_hz": float(len(events)) / max(n_neurons, 1)
        / max(sim_sec, 1e-9),
        "rates": rate_distribution(neuron_counts, sim_sec),
        "rates_per_column": rate_distribution(col_counts, sim_sec,
                                              n_bins=16),
        "per_shard_events": {k: int(len(v))
                             for k, v in shard_events(run_dir).items()},
        "isi": isi_cv(events),
        "population": {
            "bin_steps": bin_steps,
            "mean_hz": float(pop.mean()) if len(pop) else 0.0,
            "peak_hz": float(pop.max()) if len(pop) else 0.0,
            "updown": updown_segmentation(pop, smooth_bins, updown_frac),
        },
        "_neuron_rates": neuron_counts / max(sim_sec, 1e-9),  # stripped
    }
    if len(pop) <= 512:                  # keep JSON bounded for long runs
        report["population"]["series_hz"] = [float(x) for x in pop]
    return report


def compare_runs(reports: Dict[str, dict]) -> dict:
    """Cross-run comparison table (e.g. Gaussian vs exponential).

    For every ordered pair: mean-rate ratio and the KS statistic
    between per-neuron rate distributions.
    """
    labels = list(reports)
    table = {}
    for i, a in enumerate(labels):
        for b in labels[i + 1:]:
            ra = reports[a].get("_neuron_rates")
            rb = reports[b].get("_neuron_rates")
            ma = reports[a]["mean_rate_hz"]
            mb = reports[b]["mean_rate_hz"]
            table[f"{a}_vs_{b}"] = {
                "mean_rate_ratio": ma / mb if mb > 0 else None,
                "rate_ks_statistic": ks_statistic(
                    np.asarray(ra), np.asarray(rb))
                if ra is not None and rb is not None else None,
            }
    return {
        "mean_rate_hz": {k: r["mean_rate_hz"] for k, r in reports.items()},
        "regime": {k: r["population"]["updown"]["regime"]
                   for k, r in reports.items()},
        "pairs": table,
    }


def strip_private(report: dict) -> dict:
    """Drop the in-memory-only arrays before JSON serialization."""
    return {k: v for k, v in report.items() if not k.startswith("_")}
