"""Fault-tolerant host-side driver loops.

The port of ``repro.runtime.driver``.  What a long distributed run
needs from the host-side loop:

  * **checkpoint/restart** -- periodic async checkpoints; on start, the
    driver resumes from the latest verified step (data pipeline is
    stateless-counter-based, so the stream realigns for free);
  * **failure retry** -- a failing step (device OOM, interconnect error,
    injected test fault) triggers restore-from-last-good and replay;
    bounded retries, exponential backoff;
  * **straggler watchdog** -- a per-step deadline derived from a moving
    median of step times; overruns are logged with the step fingerprint
    (on real pods this feeds the scheduler's hot-spare swap; here it is
    surfaced in driver metrics and tested by injection);
  * **preemption** -- SIGTERM flips a flag; the loop checkpoints at the
    next step boundary and exits cleanly (maintenance-event protocol);
  * **elastic restart** -- the sim driver restores a checkpoint onto
    another tiling (``core.retile``).

All of that machinery lives in ``FaultTolerantLoop`` and is shared by
the two concrete drivers: ``TrainDriver`` (generic over a
``step_fn``, unit = one step) and ``runtime.sim_driver.SimDriver``
(long-run SNN simulation, unit = one fixed-size segment).  Where the
reference blocks on the step's outputs (``jax.block_until_ready``),
the port synchronizes the devices their tensors live on.
"""

from __future__ import annotations

import dataclasses
import logging
import signal
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..checkpoint.store import (AsyncCheckpointer, latest_step,
                                restore_checkpoint)
from ..obs.telemetry import NULL, Telemetry
from ..tree import tree_flatten

log = logging.getLogger("repro_torch.runtime")


def block_until_ready(tree) -> None:
    """Wait for the work queued on every CUDA device that ``tree``'s
    tensors live on (the port's ``jax.block_until_ready``)."""
    devs = {x.device for x in tree_flatten(tree)[0]
            if isinstance(x, torch.Tensor) and x.device.type == "cuda"}
    for dev in devs:
        torch.cuda.synchronize(dev)


def _scalar(v) -> Optional[float]:
    """``v`` as a float when it holds one value, else None."""
    if isinstance(v, torch.Tensor):
        return float(v) if v.numel() == 1 else None
    a = np.asarray(v)
    return float(a) if a.size == 1 else None


@dataclasses.dataclass
class DriverConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    max_retries: int = 3
    backoff_s: float = 1.0
    straggler_factor: float = 3.0    # deadline = factor * median step
    straggler_window: int = 20
    handle_sigterm: bool = True


class StragglerWatchdog:
    """Moving-median deadline; flags steps that exceed it.  Stalls are
    structured telemetry events (kind ``straggler``), so they land in
    the JSONL stream alongside the spans of the step that overran."""

    def __init__(self, factor: float, window: int,
                 telemetry: Telemetry = NULL):
        self.factor = factor
        self.window = window
        self.tel = telemetry
        self.times: list = []
        self.flagged: list = []

    def observe(self, step: int, dt: float) -> bool:
        is_straggler = False
        if len(self.times) >= 5:
            deadline = self.factor * float(np.median(self.times))
            if dt > deadline:
                is_straggler = True
                self.flagged.append((step, dt, deadline))
                self.tel.event(
                    "straggler", level="warning", logger=log,
                    msg=f"straggler: step {step} took {dt:.3f}s "
                        f"(deadline {deadline:.3f}s)",
                    step=step, dt_s=dt, deadline_s=deadline)
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return is_straggler


class FaultTolerantLoop:
    """Shared retry / watchdog / preemption / checkpoint machinery.

    Subclasses implement ``_restore_or_init() -> (start_step, state)``
    and ``_step_once(state, step) -> (state, metrics)`` and may override
    ``_save``.  ``step_size`` is the amount ``step`` advances per
    ``_step_once`` call (1 for training steps, ``segment_steps`` for the
    segmented sim driver, whose step counter is the sim time ``t``).
    """

    step_size: int = 1
    # False where a failed step cannot be replayed alone (a rank of a
    # process group: its peers are mid-step): the failure ends the run
    retry_failures: bool = True

    def __init__(self, cfg: DriverConfig, telemetry: Telemetry = NULL):
        self.cfg = cfg
        self.tel = telemetry
        self.watchdog = StragglerWatchdog(cfg.straggler_factor,
                                          cfg.straggler_window,
                                          telemetry=telemetry)
        self.ckpt = AsyncCheckpointer(cfg.ckpt_dir, keep=cfg.keep,
                                      telemetry=telemetry)
        self.preempted = False
        self.metrics_log: list = []
        if cfg.handle_sigterm:
            try:
                signal.signal(signal.SIGTERM, self._on_sigterm)
            except ValueError:
                pass                           # non-main thread (tests)

    def _on_sigterm(self, *_):
        self.tel.event(
            "preempt", level="warning", logger=log,
            msg="SIGTERM: checkpoint at next step boundary, then exit")
        self.preempted = True

    # ---- subclass API -------------------------------------------------
    def _restore_or_init(self):
        raise NotImplementedError

    def _step_once(self, state, step):
        raise NotImplementedError

    def _save(self, step: int, state):
        # AsyncCheckpointer.save snapshots the state with a device-side
        # copy before returning, so the next step (which updates the
        # state in place) cannot change what gets written; the
        # device->host copy itself overlaps that next step on the
        # writer thread.
        self.ckpt.save(step, state)

    def _on_rewind(self, step: int):
        """Drop per-step records from the abandoned timeline after a
        failure restore: replayed steps must appear exactly once in the
        logs (``metrics_log`` is exported as a machine-readable
        artifact)."""
        self.metrics_log = [m for m in self.metrics_log
                            if m["step"] < step]

    # ---- the loop -----------------------------------------------------
    def run(self, n_steps: int) -> Dict[str, Any]:
        start, state = self._restore_or_init()
        step = start
        retries = 0
        last_fail = -1
        while step < n_steps and not self.preempted:
            t0 = time.perf_counter()
            try:
                with self.tel.span("segment", step=step):
                    state, metrics = self._step_once(state, step)
                    block_until_ready(metrics)
            except Exception as e:            # noqa: BLE001 - retry path
                # retries count consecutive failures of the SAME step
                # (replay successes must not reset the counter, or a
                # deterministic fault would retry forever)
                retries = retries + 1 if step == last_fail else 1
                last_fail = step
                self.tel.event(
                    "step_failure", level="warning", logger=log,
                    msg=f"step {step} failed ({e}); retry "
                        f"{retries}/{self.cfg.max_retries}",
                    step=step, retry=retries,
                    max_retries=self.cfg.max_retries, error=str(e))
                if retries > self.cfg.max_retries \
                        or not self.retry_failures:
                    self.ckpt.wait()
                    raise
                time.sleep(self.cfg.backoff_s * 2 ** (retries - 1))
                try:
                    # drain in-flight async writes so the restore sees
                    # the newest checkpoint, not a mid-write directory
                    self.ckpt.wait()
                except Exception as ce:        # noqa: BLE001
                    # a failing writer must not abort the retry; the
                    # error stays set and surfaces at the final wait()
                    self.tel.event(
                        "ckpt_writer_error", level="warning", logger=log,
                        msg=f"checkpoint writer error during retry: {ce}",
                        step=step, error=str(ce))
                step, state = self._restore_or_init()
                self._on_rewind(step)
                continue
            dt = time.perf_counter() - t0
            self.watchdog.observe(step, dt)
            self.metrics_log.append(
                {"step": step, "dt": dt,
                 **{k: x for k, x in ((k, _scalar(v))
                                      for k, v in metrics.items())
                    if x is not None}})
            step += self.step_size
            if (step // self.step_size) % self.cfg.ckpt_every == 0 \
                    or self.preempted or step >= n_steps:
                self._save(step, state)
        self.ckpt.wait()
        return {"final_step": step, "state": state,
                "stragglers": self.watchdog.flagged,
                "metrics": self.metrics_log,
                "preempted": self.preempted}


class TrainDriver(FaultTolerantLoop):
    """Runs ``step_fn(state, batch) -> (state, metrics)`` with fault
    tolerance.  ``state`` is any tree of tensors (``checkpoint.store``
    trees); ``batch_fn(step) -> batch`` must be deterministic in
    ``step``.

    ``abstract_state``: optional tree of ``checkpoint.store.LeafSpec``
    matching the state.  When restoring, the ``like`` tree only needs
    shapes and dtypes -- materializing a throwaway ``init_state_fn()``
    state first would double peak memory right at restart.  Without it
    the restore reads the shapes from ``init_state_fn()`` (torch has no
    ``jax.eval_shape``).  ``device``: where restored tensors go.

    ``rank_layout``: on the ranks of a process group, ``(whole, block)``
    -- ``whole(state)`` gathers a state of blocks into the whole tree on
    every rank (every rank calls it), ``block(tree)`` cuts a whole tree
    to this rank's blocks.  Checkpoints then hold the whole tree, the
    single-device format, written by rank 0; every rank restores the
    whole tree (``abstract_state`` its shapes) and keeps its blocks, and
    a failed step ends the run (its peers are mid-step).
    """

    def __init__(self, cfg: DriverConfig, step_fn: Callable,
                 batch_fn: Callable, init_state_fn: Callable,
                 device="cuda",
                 fault_hook: Optional[Callable] = None,
                 abstract_state=None, rank_layout=None):
        super().__init__(cfg)
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.init_state_fn = init_state_fn
        self.device = resolve_device(device)
        self.fault_hook = fault_hook          # tests inject failures here
        self.abstract_state = abstract_state
        self.rank_layout = rank_layout
        self.retry_failures = rank_layout is None

    # ------------------------------------------------------------------
    def _agreed_latest(self):
        last = latest_step(self.cfg.ckpt_dir)
        if self.rank_layout is None:
            return last
        import torch.distributed as dist
        box = [last]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def _restore_or_init(self):
        last = self._agreed_latest()
        if last is None:
            return 0, self.init_state_fn()
        log.info("restoring from step %d", last)
        like = self.abstract_state
        if like is None:
            like = self.init_state_fn()
        state = restore_checkpoint(self.cfg.ckpt_dir, last, like,
                                   device=self.device)
        if self.rank_layout is not None:
            state = self.rank_layout[1](state)
        return last, state

    def _save(self, step: int, state):
        if self.rank_layout is None:
            return super()._save(step, state)
        import torch.distributed as dist
        tree = self.rank_layout[0](state)
        if dist.get_rank() == 0:
            self.ckpt.save(step, tree)

    def _step_once(self, state, step):
        if self.fault_hook:
            self.fault_hook(step)
        batch = self.batch_fn(step)
        return self.step_fn(state, batch)
