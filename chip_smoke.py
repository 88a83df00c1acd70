#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. build: ``nvcc`` compiles every CUDA source of the port (one process
   per source, in parallel) into ``build/torch_kernels/``;
2. kernel checks on the card, each kernel against its plain PyTorch
   version on the same inputs: the LIF update on random state
   (``spk``/``refrac`` exact, ``v``/``c`` within 1 ulp), event delivery
   on real tables -- 4x4x1240 (int16 ids) and 8x8x1240 (int32 ids) --
   at three spike densities, one above ``active_cap`` (ring exact, event
   and drop counts equal), and spike compaction at three densities
   (exact);
3. the static path, through the library API (``build_shard_tables`` ->
   ``init_sim_state`` -> ``simulate``), single shard, 8x8 columns of the
   paper's 1240 neurons, both connectivity laws: kernel-path steps
   against plain-path steps from the same seed (rasters and rings
   identical), then timed kernel-path steps;
4. the plastic path (``init_plasticity`` -> ``simulate(plasticity=)``),
   both laws: 30 kernel-path steps on the card against 30 plain-path
   steps on the CPU at 4x4x1240 with the card's drive injected (rasters,
   weights, traces and ring identical), then timed kernel-path steps at
   8x8x1240; from its mid-run state, one step of the fixed-order
   delivery + LTD kernel against its plain version on CPU copies (ring,
   weights and counts exact);
5. the recorded path (``simulate(recorder=)``), static 8x8x1240: the
   default capacity (no drops; the events are the raster's spikes) and a
   small one (drops counted), each timed beside the same steps with the
   recorder off;
6. timing of each kernel at its path's shapes: the device time of the
   kernel (torch.profiler), of its plain version and of one PyTorch
   library call where there is one; the wrapper's time per call (CUDA
   events, host launch cost included); and the least time the card
   could take (bytes over 3.35 TB/s).

Launch counts are zeroed just before each of phases 3-5 and read just
after it.  It prints the metrics, a ``{"kernels": [...]}`` line, the
card's name and power limit, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It needs one CUDA card and the repository checkout around it.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
F32_OPS_PER_S = 67e12              # H100 SXM float32 rate outside the MXU
GRID, N_PER_COLUMN = 8, 1240       # the main path's network
PARITY_STEPS, TIMED_STEPS = 100, 500       # static path
PLASTIC_PARITY_STEPS, PLASTIC_STEPS = 30, 200
PARITY_GRID = 4                            # CPU parity of the plastic path
RECORD_STEPS, SMALL_CAPACITY = 100, 1000
LAWS = ("gaussian", "exponential")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def call_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean time per call of ``fn()`` between two CUDA events: device
    time plus whatever host time the launches leave the device idle."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time per call of ``fn()``: the summed durations of the
    kernels (and memsets) it runs, from torch.profiler's CUDA trace.
    Where the trace holds no device event, the time between two CUDA
    events (``call_ms``) stands in, and a line says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us > 0:
        return us / iters / 1e3
    print(f"device_ms: the profiler saw no device time for "
          f"{getattr(fn, '__name__', fn)}; timed with CUDA events instead")
    return call_ms(fn, iters, warmup=0)


def ulps(x, y):
    """Elementwise distance in float32 ulps (same-sign values)."""
    import torch
    return (x.view(torch.int32).long() - y.view(torch.int32).long()).abs()


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def check_lif(n: int, gen) -> dict:
    import torch
    from repro_torch.core.neuron import LIFParams
    from repro_torch.kernels import ref
    from repro_torch.kernels.lif_step import lif_step_cuda
    dev = "cuda"
    kw = LIFParams().kernel_args()
    v = torch.rand(n, device=dev, generator=gen) * 35.0 - 10.0
    c = torch.rand(n, device=dev, generator=gen) * 5.0
    r = torch.randint(0, 3, (n,), device=dev, generator=gen,
                      dtype=torch.int32)
    i = torch.randint(-4000, 4000, (n,), device=dev,
                      generator=gen).float() * 2.0 ** -9
    a = torch.rand(n, device=dev, generator=gen) < 0.95
    # edge: v_int == theta exactly (v = c = 0, i = theta) must spike
    v[:64], c[:64], r[:64], i[:64], a[:64] = 0.0, 0.0, 0, kw["theta"], True
    vk, ck, rk, sk = lif_step_cuda(v, c, r, i, a, **kw)
    vp, cp, rp, sp = ref.lif_step_ref(v, c, r, i, a, **kw)
    torch.cuda.synchronize()
    require(torch.equal(sk, sp), "LIF kernel: spikes differ from plain")
    require(bool(sk[:64].all()), "LIF kernel: v == theta did not spike")
    require(torch.equal(rk, rp), "LIF kernel: refrac differs from plain")
    du = max(int(ulps(vk, vp).max()), int(ulps(ck, cp).max()))
    require(du <= 1, f"LIF kernel: v/c differ by {du} ulp from plain")
    n_diff = int((vk != vp).sum() + (ck != cp).sum())
    err = max(float((vk - vp).abs().max()), float((ck - cp).abs().max()))
    print(f"check lif_step n={n}: spk/refrac exact, v/c max {du} ulp, "
          f"{n_diff} of {2 * n} values differ, max_abs_err={err}")
    return {"max_abs_err": err, "ulp_diffs": n_diff}


def check_delivery(tabs, spec, gen, label: str) -> float:
    import torch
    from repro_torch.core.synapses import deliver_events
    from repro_torch.kernels.synaptic_accum import event_delivery_banded
    cap = spec.active_cap_local
    n = spec.n_local
    err = 0.0
    for dens in (0.01, 0.05, 0.9):
        spk = (torch.rand(n, device="cuda", generator=gen) < dens).float()
        ring0 = torch.randint(-200, 200, (8, n), device="cuda",
                              generator=gen).float() * 2.0 ** -9
        rk, ek, dk = event_delivery_banded([(tabs.local, spk, cap)],
                                           ring0.clone(), 3, 8)
        rp, ep, dp = deliver_events(tabs.local, spk, ring0.clone(), 3, 8,
                                    cap)
        torch.cuda.synchronize()
        n_spk = int(spk.sum())
        require(torch.equal(rk, rp),
                f"delivery kernel {label} density {dens}: ring differs")
        require(int(ek) == int(ep) and int(dk) == int(dp),
                f"delivery kernel {label} density {dens}: counts "
                f"{int(ek)}/{int(dk)} vs plain {int(ep)}/{int(dp)}")
        require(int(dk) == max(n_spk - cap, 0),
                f"delivery kernel {label}: dropped {int(dk)} != "
                f"max({n_spk} - {cap}, 0)")
        err = max(err, float((rk - rp).abs().max()))
        print(f"check event_delivery {label} ({tabs.storage.tgt_dtype} ids)"
              f" density {dens}: {n_spk} spikes, active_cap {cap}, "
              f"{int(ek)} events, {int(dk)} dropped, ring exact")
    return err


def check_spike_compact(n: int, cap: int, gen) -> float:
    import torch
    from repro_torch.kernels.ref import compact_events
    from repro_torch.kernels.spike_compact import spike_compact_cuda
    for dens in (0.01, 0.05, 0.9):
        spk = (torch.rand(n, device="cuda", generator=gen) < dens).float()
        idx, cnt = spike_compact_cuda(spk, n, cap)
        ridx, rcnt = compact_events(spk, n, cap)
        torch.cuda.synchronize()
        require(torch.equal(idx, ridx) and int(cnt) == int(rcnt),
                f"spike_compact density {dens}: differs from plain")
        print(f"check spike_compact n={n} cap={cap} density {dens}: "
              f"{int(cnt)} spikes, indices and count exact")
    return 0.0


# ---------------------------------------------------------------------------
# phase 3: the static path
# ---------------------------------------------------------------------------

def run_law(law: str, tabs, build_s: float) -> dict:
    import torch
    from repro_torch.configs.snn import reduced_case
    from repro_torch.core import engine
    cfg = reduced_case(law, GRID, N_PER_COLUMN).engine_config(1, 1)
    plain = dataclasses.replace(cfg, use_kernels=False)

    fin_k, raster_k = engine.simulate(engine.init_sim_state(cfg), tabs, cfg,
                                      PARITY_STEPS, record_spikes=True)
    fin_p, raster_p = engine.simulate(engine.init_sim_state(plain), tabs,
                                      plain, PARITY_STEPS,
                                      record_spikes=True)
    torch.cuda.synchronize()
    require(torch.equal(raster_k, raster_p),
            f"{law}: kernel-path raster differs from the plain path "
            f"({int((raster_k != raster_p).sum())} entries)")
    require(torch.equal(fin_k["i_ring"], fin_p["i_ring"]),
            f"{law}: kernel-path ring differs from the plain path")
    for k in ("spikes", "events", "dropped"):
        require(float(fin_k["metrics"][k]) == float(fin_p["metrics"][k]),
                f"{law}: metric {k} differs between paths")
    v_diff = int((fin_k["neuron"]["v"] != fin_p["neuron"]["v"]).sum())

    state = engine.init_sim_state(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fin, counts = engine.simulate(state, tabs, cfg, TIMED_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    v = fin["neuron"]["v"]
    require(counts.shape == (TIMED_STEPS,)
            and v.shape == (cfg.spec().n_local,),
            f"{law}: unexpected output shapes")
    require(bool(torch.isfinite(v).all() & torch.isfinite(fin["neuron"]["c"])
                 .all()), f"{law}: non-finite state")
    rate = engine.firing_rate_hz(fin, cfg)
    events = float(fin["metrics"]["events"])
    # a neuron fires at most once per refractory period plus one step
    max_rate = 1e3 / (cfg.lif.dt_ms * (cfg.lif.refrac_steps + 1))
    require(0.0 < rate <= max_rate, f"{law}: firing rate {rate} Hz")
    res = {
        "law": law, "grid": f"{GRID}x{GRID}x{N_PER_COLUMN}",
        "host_build_s": build_s, "n_synapses": tabs.stats["n_synapses"],
        "steps": TIMED_STEPS, "rate_hz": rate,
        "events_per_step": events / TIMED_STEPS,
        "dropped": float(fin["metrics"]["dropped"]),
        "ms_per_step": 1e3 * wall / TIMED_STEPS,
        "s_per_synaptic_event": wall / max(events, 1.0),
        "parity_steps": PARITY_STEPS,
        "parity_spikes": float(raster_k.sum()),
        "parity_v_values_differing": v_diff,
    }
    print("static path " + json.dumps(res))
    profile_steps(fin, tabs, cfg, law)
    # a mid-run spike vector: the delivery kernel's main-path input
    steps = raster_k[PARITY_STEPS // 2:]
    med = int(steps.sum(1).argsort()[steps.shape[0] // 2])
    return {"cfg": cfg, "state": fin_k, "spikes": steps[med].clone()}


def profile_steps(state, tabs, cfg, law: str, n_steps: int = 50,
                  plasticity=None) -> None:
    """Device time by kernel over ``n_steps`` more kernel-path steps
    (torch.profiler), and the device's idle share of that window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import engine
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.simulate(state, tabs, cfg, n_steps, plasticity=plasticity)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_kernel = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.name] = (by_kernel.get(e.name, 0.0)
                                 + e.time_range.elapsed_us())
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    print("profile " + json.dumps({
        "path": "plastic" if plasticity else "static",
        "law": law, "steps": n_steps,
        "wall_ms_per_step": wall_us / n_steps / 1e3,
        "device_busy_ms_per_step": busy / n_steps / 1e3,
        "device_idle_share": 1.0 - busy / wall_us if wall_us else None,
        # summed by full name; printed as pairs so cut names cannot merge
        "top_kernels_ms_per_step": [[k[:100], v / n_steps / 1e3]
                                    for k, v in top]}))


# ---------------------------------------------------------------------------
# phase 4: the plastic path
# ---------------------------------------------------------------------------

def plastic_cfg(law: str, grid: int):
    from repro_torch.configs.snn import reduced_case
    from repro_torch.core.stdp import STDPParams
    return reduced_case(law, grid, N_PER_COLUMN).engine_config(
        1, 1, stdp=STDPParams())


def bits_equal(a, b) -> bool:
    import torch
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def plastic_raster(state, tabs, aux, cfg, drive, device):
    """The plastic run one ``simulate`` call per step; each step's raster
    row is read from the refractory counters, which a spike sets to
    ``refrac_steps`` (and nothing else does)."""
    import torch
    from repro_torch.core import engine
    rows = []
    for k in range(drive.shape[0]):
        (state, tabs, traces), _ = engine.simulate(
            state, tabs, cfg, 1, drive=drive[k:k + 1], device=device,
            plasticity=aux)
        aux = dict(aux, traces=traces)
        rows.append((state["neuron"]["refrac"] == cfg.lif.refrac_steps)
                    .float())
    return state, tabs, aux["traces"], torch.stack(rows)


def plastic_parity(law: str) -> dict:
    """30 kernel-path steps on the card against 30 plain-path steps on
    the CPU at 4x4x1240, the card's drive injected into both."""
    import torch
    from repro_torch.core import engine
    cfg = plastic_cfg(law, PARITY_GRID)
    plain = dataclasses.replace(cfg, use_kernels=False)
    require(cfg.lif.refrac_steps > 0, "refrac_steps must be > 0")
    t0 = time.perf_counter()
    cpu_tabs = engine.build_shard_tables(cfg, device="cpu")
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda")
    gen.manual_seed(99)
    n = cfg.spec().n_local
    drive = torch.stack([engine.external_drive(gen, n, cfg)
                         for _ in range(PLASTIC_PARITY_STEPS)])
    tabs = cpu_tabs.to("cuda")
    sk, tk, rk, rast_k = plastic_raster(
        engine.init_sim_state(cfg), tabs, engine.init_plasticity(tabs, cfg),
        cfg, drive, "cuda")
    sp, tp, rp, rast_p = plastic_raster(
        engine.init_sim_state(plain, device="cpu"), cpu_tabs,
        engine.init_plasticity(cpu_tabs, plain), plain, drive.cpu(), "cpu")
    torch.cuda.synchronize()
    label = f"plastic {law} {PARITY_GRID}x{PARITY_GRID}x{N_PER_COLUMN}"
    require(bits_equal(rast_k, rast_p), f"{label}: raster differs "
            f"({int((rast_k.cpu() != rast_p).sum())} entries)")
    for what, a, b in (("w", tk["local"]["w"], tp["local"]["w"]),
                       ("ring", sk["i_ring"], sp["i_ring"]),
                       ("x_post", rk["x_post"], rp["x_post"]),
                       ("x_pre", rk["x_pre"][0], rp["x_pre"][0]),
                       ("v", sk["neuron"]["v"], sp["neuron"]["v"]),
                       ("c", sk["neuron"]["c"], sp["neuron"]["c"])):
        require(bits_equal(a, b), f"{label}: {what} differs between the "
                "card's kernel path and the CPU plain path")
    for k in ("spikes", "events", "dropped"):
        require(float(sk["metrics"][k]) == float(sp["metrics"][k]),
                f"{label}: metric {k} differs")
    changed = int((tk["local"]["w"].cpu() != cpu_tabs.local["w"]).sum())
    require(changed > 0, f"{label}: no weight changed")
    res = {"law": law, "grid": f"{PARITY_GRID}x{PARITY_GRID}x{N_PER_COLUMN}",
           "steps": PLASTIC_PARITY_STEPS, "spikes": float(rast_k.sum()),
           "weights_changed": changed, "host_build_s": build_s}
    print("plastic parity (card kernel path == CPU plain path: raster, w, "
          "ring, traces, v, c, metrics) " + json.dumps(res))
    return res


def run_plastic(law: str, tabs, build_s: float) -> dict:
    """The timed plastic path at 8x8x1240 (launch counts are read by the
    caller around this call)."""
    import torch
    from repro_torch.core import engine
    cfg = plastic_cfg(law, GRID)
    t0 = time.perf_counter()
    aux = engine.init_plasticity(tabs, cfg)
    torch.cuda.synchronize()
    inv_s = time.perf_counter() - t0
    inv = aux["inv"]
    inv_bytes = (inv["slots"].numel() * inv["slots"].element_size()
                 + inv["n_in"].numel() * inv["n_in"].element_size())
    state = engine.init_sim_state(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (fin, tabs1, traces), counts = engine.simulate(
        state, tabs, cfg, PLASTIC_STEPS, plasticity=aux)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    w0, w1 = tabs.local["w"], tabs1.local["w"]
    mask = aux["masks"][0] > 0
    require(bool(torch.isfinite(w1).all()) and bool(
        torch.isfinite(fin["neuron"]["v"]).all()),
        f"plastic {law}: non-finite weights or state")
    require(bool((w1[mask] >= 0).all() & (w1[mask] <= cfg.stdp.w_max)
                 .all()), f"plastic {law}: weights outside [0, w_max]")
    require(torch.equal(w0[~mask], w1[~mask]),
            f"plastic {law}: a non-plastic weight changed")
    dw = (w1 - w0).abs()[mask]
    rate = engine.firing_rate_hz(fin, cfg)
    events = float(fin["metrics"]["events"])
    require(0.0 < rate and counts.shape == (PLASTIC_STEPS,),
            f"plastic {law}: rate {rate} Hz")
    res = {
        "law": law, "grid": f"{GRID}x{GRID}x{N_PER_COLUMN}",
        "steps": PLASTIC_STEPS, "host_build_s": build_s,
        "n_synapses": tabs.stats["n_synapses"],
        "inverse_index_host_s": inv_s, "inverse_index_bytes": inv_bytes,
        "inverse_index_k_in": int(inv["slots"].shape[1]),
        "rate_hz": rate, "events_per_step": events / PLASTIC_STEPS,
        "dropped": float(fin["metrics"]["dropped"]),
        "ms_per_step": 1e3 * wall / PLASTIC_STEPS,
        "s_per_synaptic_event": wall / max(events, 1.0),
        "mean_abs_dw": float(dw.mean()),
        "weights_changed": int((dw > 0).sum()),
    }
    print("plastic path " + json.dumps(res))
    profile_steps(dict(fin, i_ring=fin["i_ring"].clone()), tabs1, cfg, law,
                  n_steps=20, plasticity=dict(aux, traces=traces))
    return {"cfg": cfg, "aux": aux, "state": fin, "tables": tabs1,
            "traces": traces}


def plastic_step_inputs(run: dict):
    """One plastic step's kernel inputs from a mid-run state: the last
    step's spikes (read from the refractory counters), the decayed post
    trace, the ring and the learned weights."""
    cfg, st = run["cfg"], run["state"]
    spikes = (st["neuron"]["refrac"] == cfg.lif.refrac_steps).float()
    x_post_d = run["traces"]["x_post"] * cfg.stdp.decay_minus
    return spikes, x_post_d, st["i_ring"], run["tables"].local


def check_plastic_kernel(run: dict, law: str) -> float:
    """One step of the fixed-order delivery + LTD kernel on the card
    against its plain version on CPU copies of the same inputs."""
    import torch
    from repro_torch.kernels.plastic_step import plastic_delivery_ltd
    cfg, aux = run["cfg"], run["aux"]
    spec = cfg.spec()
    spikes, x_post_d, ring, local = plastic_step_inputs(run)
    slot = run["state"]["t"] % cfg.d_ring

    def one(dev):
        tier = {k: v.clone().to(dev) for k, v in local.items()}
        inv = dict(aux["inv"], slots=aux["inv"]["slots"].to(dev),
                   n_in=aux["inv"]["n_in"].to(dev))
        r, w, ev, dr = plastic_delivery_ltd(
            [(tier, spikes.to(dev), spec.active_cap_local)],
            [aux["masks"][0].to(dev)], x_post_d.to(dev), ring.clone().to(dev),
            slot, cfg.d_ring, -cfg.stdp.a_minus, inv=inv)
        return r.cpu(), w[0].cpu(), int(ev), int(dr)

    rk, wk, ek, dk = one("cuda")
    torch.cuda.synchronize()
    rp, wp, ep, dp = one("cpu")
    require(bits_equal(rk, rp), f"plastic kernel {law}: ring differs from "
            "the CPU plain version")
    require(bits_equal(wk, wp), f"plastic kernel {law}: w' differs from "
            "the CPU plain version")
    require((ek, dk) == (ep, dp), f"plastic kernel {law}: counts {ek}/{dk}"
            f" vs plain {ep}/{dp}")
    changed = int((wk != local["w"].cpu()).sum())
    print(f"check plastic_delivery_ltd {law} {GRID}x{GRID}x{N_PER_COLUMN}: "
          f"{int(spikes.sum())} spikes, {ek} events, {dk} dropped, "
          f"{changed} weights depressed; ring, w' and counts exact")
    return float(max((rk - rp).abs().max(), (wk - wp).abs().max()))


# ---------------------------------------------------------------------------
# phase 5: the recorded path
# ---------------------------------------------------------------------------

def run_recorded(law: str, tabs) -> dict:
    import numpy as np
    import torch
    from repro_torch.configs.snn import reduced_case
    from repro_torch.core import engine
    from repro_torch.obs.record import recorder_spec, tile_gid_map
    cfg = reduced_case(law, GRID, N_PER_COLUMN).engine_config(1, 1)
    state = engine.init_sim_state(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.simulate(state, tabs, cfg, RECORD_STEPS, record_spikes=True)
    torch.cuda.synchronize()
    out = {"off": {"ms_per_step":
                   1e3 * (time.perf_counter() - t0) / RECORD_STEPS}}
    for label, capacity in (("default", None), ("small", SMALL_CAPACITY)):
        rspec = recorder_spec(cfg, RECORD_STEPS, capacity=capacity)
        state = engine.init_sim_state(cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fin, raster, rec = engine.simulate(
            state, tabs, cfg, RECORD_STEPS, record_spikes=True,
            recorder=rspec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_spk = int(raster.sum())
        count, dropped = int(rec["count"]), int(rec["dropped"])
        require(count + dropped == n_spk,
                f"recorder {label}: count {count} + dropped {dropped} != "
                f"{n_spk} spikes")
        if capacity is None:
            require(dropped == 0, f"recorder default capacity dropped "
                    f"{dropped}")
            gids = torch.from_numpy(tile_gid_map(cfg.decomp, 0, 0)).cuda()
            t_idx, n_idx = torch.nonzero(raster, as_tuple=True)
            want = t_idx * (1 << 32) + gids[n_idx].long()
            got = (rec["step"][:count].long() * (1 << 32)
                   + rec["gid"][:count].long())
            require(torch.equal(want, got), "recorder: events differ from "
                    "the raster's spikes")
        else:
            require(count == capacity and dropped > 0,
                    f"recorder small capacity: count {count}, dropped "
                    f"{dropped}")
        out[label] = {"capacity": rspec.capacity, "count": count,
                      "dropped": dropped, "spikes": n_spk,
                      "buffer_bytes": int(np.int64(rspec.capacity) * 8),
                      "ms_per_step": 1e3 * wall / RECORD_STEPS}
    print(f"recorded path {law} {GRID}x{GRID}x{N_PER_COLUMN} "
          f"{RECORD_STEPS} steps " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 6: timing at the paths' shapes
# ---------------------------------------------------------------------------

def time_lif(state, cfg, launches: int, err: float) -> dict:
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.lif_step import lif_step_cuda
    nrn = state["neuron"]
    n = nrn["v"].shape[0]
    args = (nrn["v"], nrn["c"], nrn["refrac"], state["i_ring"][0].clone(),
            state["active"])
    kw = cfg.lif.kernel_args()
    ms = device_ms(lambda: lif_step_cuda(*args, **kw), 200)
    per_call = call_ms(lambda: lif_step_cuda(*args, **kw), 200)
    plain_ms = device_ms(lambda: ref.lif_step_ref(*args, **kw), 50)
    nbytes = n * (4 + 4 + 4 + 4 + 1) + n * (4 + 4 + 4 + 4)
    ops = 6 * n
    bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    return {"name": "lif_step", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/lif_step.cu",
            "replaces": "src/repro/kernels/lif_step.py:47",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": None, "call_ms": per_call, "shape": f"n={n}"}


def time_delivery(tabs, spec, spikes, launches: int, err: float,
                  label: str) -> dict:
    import torch
    from repro_torch.kernels.ref import deliver_rows_ref
    from repro_torch.kernels.synaptic_accum import (compact_events,
                                                    deliver_rows_cuda)
    local = tabs.local
    n, cap = spec.n_local, spec.active_cap_local
    idx, n_spk = compact_events(spikes, n, cap)
    ring = torch.zeros((spec.d_ring, n), device="cuda")
    ev = torch.zeros((1,), dtype=torch.int32, device="cuda")
    ms = device_ms(lambda: deliver_rows_cuda(local, idx, ring, 3, ev), 100)
    per_call = call_ms(lambda: deliver_rows_cuda(local, idx, ring, 3, ev),
                       100)
    plain_ms = device_ms(lambda: deliver_rows_ref(local, idx, ring, 3, ev),
                         5)
    # the gathered stream of the real events, for the one-call yardstick
    rows = idx[:int(n_spk)].long()
    nnz = local["nnz"][rows].long()
    keep = (torch.arange(local["tgt"].shape[1], device="cuda")[None, :]
            < nnz[:, None])
    tgt = local["tgt"][rows].long()[keep]
    slot = (3 + local["dslot"][rows].long()[keep]) % spec.d_ring
    flat = slot * n + tgt
    w = local["w"][rows].float()[keep]
    library_ms = device_ms(lambda: ring.view(-1).index_add_(0, flat, w), 20)
    events = int(flat.numel())
    touched = int(torch.unique(flat).numel())
    entry_b = local["tgt"].element_size() + local["w"].element_size() + 1
    nbytes = (events * entry_b + rows.numel() * 4 + cap * 4
              + touched * 8)
    bound = max(nbytes / HBM_BYTES_PER_S, events / F32_OPS_PER_S) * 1e3
    return {"name": "event_delivery", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/event_delivery.cu",
            "replaces": "src/repro/kernels/synaptic_accum.py:164",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": library_ms, "call_ms": per_call,
            "shape": f"{label}: {int(n_spk)} spiking rows, {events} events,"
                     f" active_cap {cap}"}


def time_spike_compact(spikes, n: int, cap: int, launches: int,
                       err: float) -> dict:
    import torch
    from repro_torch.kernels.ref import spike_compact_ref
    from repro_torch.kernels.spike_compact import spike_compact_cuda
    ms = device_ms(lambda: spike_compact_cuda(spikes, n, cap), 200)
    per_call = call_ms(lambda: spike_compact_cuda(spikes, n, cap), 200)
    plain_ms = device_ms(lambda: spike_compact_ref(spikes, n, cap), 50)
    live = spikes[:n] > 0
    library_ms = device_ms(lambda: torch.nonzero(live), 50)
    nbytes = n * 4 + cap * 4 + 4
    bound = max(nbytes / HBM_BYTES_PER_S, n / F32_OPS_PER_S) * 1e3
    return {"name": "spike_compact", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/spike_compact.cu",
            "replaces": "src/repro/kernels/spike_compact.py:102",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": library_ms, "call_ms": per_call,
            "shape": f"n={n}, cap={cap}, {int(live.sum())} spikes"}


def time_plastic(run: dict, launches: int, err: float, law: str) -> dict:
    import torch
    from repro_torch.kernels.plastic_step import (delivered_flags,
                                                  plastic_delivery_ltd_cuda)
    from repro_torch.kernels.ref import plastic_delivery_ltd_ref
    cfg, aux = run["cfg"], run["aux"]
    spec = cfg.spec()
    cap = spec.active_cap_local
    spikes, x_post_d, ring0, local = plastic_step_inputs(run)
    tier = {k: v.clone() for k, v in local.items()}
    ring = ring0.clone()
    mask = aux["masks"][0]
    inv = aux["inv"]
    slot = run["state"]["t"] % cfg.d_ring
    neg_a = -cfg.stdp.a_minus
    flag, _ = delivered_flags(spikes, spec.n_local, cap)

    def kernel():
        plastic_delivery_ltd_cuda(tier, flag, inv, 0, ring, slot, mask,
                                  x_post_d, neg_a)

    ms = device_ms(kernel, 20)
    per_call = call_ms(kernel, 20)
    plain_ms = device_ms(lambda: plastic_delivery_ltd_ref(
        tier, spikes, cap, ring, slot, mask, x_post_d, neg_a), 3, warmup=1)
    # the work of this step: every slot of the index is read; the
    # delivered synapses' weight, delay and mask are gathered and the
    # plastic ones written back; the ring is read and written once
    rows = flag.bool()
    delivered = int(local["nnz"][rows].sum())
    plastic = int(mask[rows].sum())
    n, d = spec.n_local, cfg.d_ring
    slots_read = int(inv["n_in"].sum())
    nbytes = (slots_read * 4 + n * 4 + flag.numel() + delivered * 9
              + plastic * 4 + 2 * d * n * 4 + n * 4)
    ops = delivered + 3 * plastic
    bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    return {"name": "plastic_delivery_ltd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/plastic_delivery.cu",
            "replaces": "src/repro/kernels/plastic_step.py:172",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": None, "call_ms": per_call,
            "shape": f"{law} {GRID}x{GRID}x{N_PER_COLUMN}: "
                     f"{int(rows.sum())} delivered rows, {delivered} "
                     f"events, {plastic} plastic, {slots_read} index "
                     "slots"}


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.configs.snn import reduced_case
        from repro_torch.core import engine
        from repro_torch.kernels import _build
    except ImportError as e:
        fail(f"the port is not next to this script ({e})")
    t_start = time.perf_counter()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # 1. build
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for name, log in sorted(_build.BUILD_LOG.items()):
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"build {name}: " + " | ".join(regs))

    # host builds of every static table set (numpy, the reference's draws)
    tables, builds = {}, {}
    for law, grid in [("gaussian", 4)] + [(law, GRID) for law in LAWS]:
        cfg = reduced_case(law, grid, N_PER_COLUMN).engine_config(1, 1)
        t0 = time.perf_counter()
        tables[(law, grid)] = engine.build_shard_tables(cfg, device="cuda")
        builds[(law, grid)] = time.perf_counter() - t0
        st = tables[(law, grid)].storage
        print(f"host build {law} {grid}x{grid}x{N_PER_COLUMN}: "
              f"{builds[(law, grid)]:.1f} s, "
              f"{tables[(law, grid)].stats['n_synapses']} synapses, "
              f"cap {st.cap_local}, {st.tgt_dtype} ids")

    # 2. kernels against their plain versions
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    n_main = GRID * GRID * N_PER_COLUMN
    lif = check_lif(n_main, gen)
    deliv_err = 0.0
    for (law, grid), tabs in tables.items():
        spec = reduced_case(law, grid, N_PER_COLUMN).engine_config(
            1, 1).spec()
        deliv_err = max(deliv_err, check_delivery(
            tabs, spec, gen, f"{law} {grid}x{grid}x{N_PER_COLUMN}"))
    cap_main = reduced_case("gaussian", GRID, N_PER_COLUMN).engine_config(
        1, 1).spec().active_cap_local
    compact_err = check_spike_compact(n_main, cap_main, gen)

    # 3. the static path
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    runs = {law: run_law(law, tables[(law, GRID)], builds[(law, GRID)])
            for law in LAWS}
    launches = _build.launch_counts()
    print(f"static path launches: {json.dumps(launches)}; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} B")
    for name in ("lif_step", "event_delivery"):
        require(launches.get(name, 0) > 0,
                f"kernel {name} was not launched on the static path")

    # 4. the plastic path: CPU parity at 4x4, then timed at 8x8
    for law in LAWS:
        plastic_parity(law)
    plastic_tabs = {}
    for law in LAWS:
        t0 = time.perf_counter()
        plastic_tabs[law] = engine.build_shard_tables(plastic_cfg(law, GRID))
        builds[("plastic", law)] = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    pruns = {law: run_plastic(law, plastic_tabs[law],
                              builds[("plastic", law)]) for law in LAWS}
    p_launches = _build.launch_counts()
    print(f"plastic path launches: {json.dumps(p_launches)}; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} B")
    for name in ("lif_step", "plastic_delivery_ltd"):
        require(p_launches.get(name, 0) > 0,
                f"kernel {name} was not launched on the plastic path")
    require("event_delivery" not in p_launches,
            "float32 weights reached the atomic delivery kernel")
    plastic_err = max(check_plastic_kernel(pruns[law], law) for law in LAWS)

    # 5. the recorded path
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    run_recorded("gaussian", tables[("gaussian", GRID)])
    r_launches = _build.launch_counts()
    print(f"recorded path launches: {json.dumps(r_launches)}; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} B")
    for name in ("lif_step", "event_delivery", "spike_compact"):
        require(r_launches.get(name, 0) > 0,
                f"kernel {name} was not launched on the recorded path")

    # 6. timing at the paths' shapes (not counted as launches)
    last = LAWS[-1]
    kernels = [time_lif(runs[last]["state"], runs[last]["cfg"],
                        launches["lif_step"], lif["max_abs_err"])]
    for law in LAWS:
        spec = runs[law]["cfg"].spec()
        k = time_delivery(tables[(law, GRID)], spec, runs[law]["spikes"],
                          launches["event_delivery"], deliv_err,
                          f"{law} {GRID}x{GRID}x{N_PER_COLUMN}")
        print(f"timing {json.dumps(k)}")
    kernels.append(k)
    for law in LAWS:
        k = time_plastic(pruns[law], p_launches["plastic_delivery_ltd"],
                         plastic_err, law)
        print(f"timing {json.dumps(k)}")
    kernels.append(k)
    k = time_spike_compact(runs["gaussian"]["spikes"], n_main, cap_main,
                           r_launches["spike_compact"], compact_err)
    print(f"timing {json.dumps(k)}")
    kernels.append(k)
    print(f"timing {json.dumps(kernels[0])}")
    require("jax" not in sys.modules and not any(
        m == "repro" or m.startswith("repro.") for m in sys.modules),
        "the port pulled in jax or the JAX package")
    print(json.dumps({"kernels": kernels}))
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
