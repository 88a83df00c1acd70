#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. build: ``nvcc`` compiles every CUDA source of the port (one process
   per source, in parallel) into ``build/torch_kernels/``;
2. kernel checks on the card, each kernel against its plain PyTorch
   version on the same inputs: the LIF update on random state
   (``spk``/``refrac`` exact, ``v``/``c`` within 1 ulp), and event
   delivery on real tables -- 4x4x1240 (int16 ids) and 8x8x1240 (int32
   ids) -- at three spike densities, one above ``active_cap`` (ring
   exact, event and drop counts equal);
3. the main path, through the library API (``build_shard_tables`` ->
   ``init_sim_state`` -> ``simulate``), single shard, 8x8 columns of
   the paper's 1240 neurons, both connectivity laws: 200 kernel-path
   steps against 200 plain-path steps from the same seed (rasters and
   rings identical), then 1000 timed kernel-path steps.  Launch counts
   are zeroed just before this phase and read just after it;
4. timing of each kernel at the main path's shapes: the device time of
   the kernel (torch.profiler), of its plain version and of one PyTorch
   library call where there is one; the wrapper's time per call (CUDA
   events, host launch cost included); and the least time the card
   could take (bytes over 3.35 TB/s).

It prints the metrics, a ``{"kernels": [...]}`` line, the card's name
and power limit, and as its last line
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
PARITY_STEPS, TIMED_STEPS = 200, 1000
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
    kernels (and memsets) it runs, from torch.profiler's CUDA trace."""
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
    require(us > 0, "the profiler saw no device time")
    return us / iters / 1e3


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


# ---------------------------------------------------------------------------
# phase 3: the main path
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
    print("main path " + json.dumps(res))
    profile_steps(fin, tabs, cfg, law)
    # a mid-run spike vector: the delivery kernel's main-path input
    steps = raster_k[PARITY_STEPS // 2:]
    med = int(steps.sum(1).argsort()[steps.shape[0] // 2])
    return {"cfg": cfg, "state": fin_k, "spikes": steps[med].clone()}


def profile_steps(state, tabs, cfg, law: str, n_steps: int = 50) -> None:
    """Device time by kernel over ``n_steps`` more kernel-path steps
    (torch.profiler), and the device's idle share of that window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import engine
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.simulate(state, tabs, cfg, n_steps)
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
        "law": law, "steps": n_steps,
        "wall_ms_per_step": wall_us / n_steps / 1e3,
        "device_busy_ms_per_step": busy / n_steps / 1e3,
        "device_idle_share": 1.0 - busy / wall_us if wall_us else None,
        "top_kernels_ms_per_step": {k[:60]: v / n_steps / 1e3
                                    for k, v in top}}))


# ---------------------------------------------------------------------------
# phase 4: timing at the main path's shapes
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

    # host builds of every table set (numpy, the reference's draws)
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

    # 3. the main path
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    runs = {law: run_law(law, tables[(law, GRID)], builds[(law, GRID)])
            for law in LAWS}
    launches = _build.launch_counts()
    print(f"main path launches: {json.dumps(launches)}; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} B")
    for name in ("lif_step", "event_delivery"):
        require(launches.get(name, 0) > 0,
                f"kernel {name} was not launched on the main path")

    # 4. timing at the main path's shapes (not counted as launches)
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
