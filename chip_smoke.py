#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. build: ``nvcc`` compiles every CUDA source of the port (one process
   per source, in parallel) into ``build/torch_kernels/``;
2. kernel checks on the card, each kernel against its plain PyTorch
   version on the same inputs: the LIF update on random state
   (``spk``/``refrac`` exact, ``v``/``c`` within 1 ulp), event delivery
   (the column kernel, through the tables' run descriptors, which are
   built first and reported in bytes per synapse and build seconds, and
   reckoned at one 24x24x1240 shard) on real tables -- 4x4x1240 (int16
   ids) and 8x8x1240 (int32 ids) -- at three spike densities, one above
   ``active_cap`` (ring exact, event and drop counts equal), spike
   compaction at densities 0 to 1 at the
   main path's 79,360 rows and at one shard of the paper's 24x24x1240
   grid (714,240 rows): exact, one launch per call; the fused step
   head (``neuron_step``) at the same two sizes, at spike densities 0,
   mid-run and above ``active_cap``, in place and not (v, c, refrac,
   spk, ring, bitmap and count exact); the two flash-
   attention kernels and the TF32 route's pre-pass (see 7); and
   dict-form tables (``{"local", "halo"}``) at 4x4x1240: delivered on
   the card exactly as ``SynapseTables`` and the plain path deliver,
   through the same run descriptors, and with ``dict(tier, w=2 w)``
   exactly as the plain version (the descriptor rebound, not rebuilt);
   the four table sets it checks (the dict check's uncompressed one
   too) are built on the host in threads started beside phase 1's nvcc
   processes, with the host work of phases 4 and 5b (their table builds
   and 5b's inverse indexes; six threads in all), and all of it is done
   before phase 3 (only phase 2's sets are on the card then; each
   build's seconds are its wall time beside the others, flagged
   ``host_build_concurrent`` / ``build_concurrent`` in the result
   lines);
3. the static path, through the library API (``build_shard_tables`` ->
   ``init_sim_state`` -> ``simulate``), single shard, 8x8 columns of the
   paper's 1240 neurons, both connectivity laws: kernel-path steps
   (the fused step head, replays of the captured ``d_ring``-step CUDA
   graph after 8 eager steps, an eager tail: 100 steps) against
   plain-path steps from the same seed (rasters, rings and metrics
   identical), then timed kernel-path steps (500, which must show
   ``(500 - 8) // 8`` graph replays) and a profile of 200 more;
4. the plastic path (``init_plasticity`` -> ``simulate(plasticity=)``),
   both laws: 30 kernel-path steps on the card against 30 plain-path
   steps on the CPU at 4x4x1240 with the card's drive injected (rasters,
   weights, traces and ring identical; the host tables built in phase
   1-2's threads, their card copies and inverse indexes made here, in
   turn; the CPU legs run in 5b beside 5b's own, one thread each), then
   timed kernel-path steps on the parity leg's card copy (its inverse
   index cached) of its 4x4x1240 tables; from its mid-run
   state, one step of
   the fixed-order
   delivery + LTD kernel against its plain version on CPU copies (ring,
   weights and counts exact);
5. the recorded path (``simulate(recorder=)``), static 8x8x1240,
   captured (the recorder's appends inside the graph, which must show
   ``(100 - 8) // 8`` replays): the default capacity (no drops; the
   events are the raster's spikes) and a small one (drops counted),
   each equal to the eager steps recorded one at a time (raster, state,
   recorder bit for bit) and timed beside them and beside the same
   steps with the recorder off; then one 1000-step recorded call, its
   capture amortized;
5b. the multi-shard path (``dist_engine.build_dist_tables`` ->
   ``init_dist_state`` -> ``make_sim_fn``) in 2x2 tiles on the card,
   both laws: at 4x4x1240, 48 captured steps (one CUDA graph of
   ``d_ring`` steps of all four tiles) against 48 eager one-step calls
   and 48 plain-path steps from the same seed (per-step spikes, every
   tile's state, ring and metrics identical, no derived structure
   rebuilt after the first step), a recorded kernel-path run (captured)
   against the plain path and against 32 one-step eager calls (the
   global raster as (step, gid) events, identical); then at 8x8x1240
   (both laws' tables built on the host in phase 1-2's threads, moved
   to the card at 5b's start, shared with 5c and 5d) 500 timed steps
   (which must show ``(500 - 8) // 8`` replays and fire within
   ``rel=0.35`` of the single shard's rate), a profile of 200 more and of the graph's
   replays alone (device operations per step, the exchange's gathers),
   and the device bytes per shard beside
   ``metrics.shard_memory_bytes``; then the plastic multi-shard path at
   4x4x1240 in 2x2 tiles (the host builds done in phase 1-2's threads):
   30 recorded kernel-path steps on the card against 30 plain-path
   steps on the CPU (both laws' at once, beside phase 4's CPU legs) with
   the card's drive injected (raster, every tier's weights, traces,
   ring and state identical; every halo band with a source inside the
   slab must have learned);
5c. the segmented driver (``runtime.SimDriver``, the path of
   ``python -m repro_torch.launch.sim``), 8x8x1240 in 2x2 tiles,
   gaussian, 400 steps in segments of 50, a checkpoint after every
   segment: a straight captured run against 4 segments + preempt + a
   fresh driver's resume (every tensor, ``t`` and each generator's
   state identical, totals equal, one CUDA graph capture per driver),
   timed beside ``make_sim_fn`` alone on the same tables (a fresh
   400-step call, a second call, 8 calls of 50 steps), with its steady
   state (from the second segment on) split into segment compute, the
   gaps between segments and the last checkpoint's wait; the same
   recorded and captured (spool files byte for byte, no recorder drops,
   one event per spike, one capture per driver), against an eager
   recorded driver of 10-step segments (state and spool logs
   identical); the preempted run resumed on 1x2 tiles with a retile
   (totals carried, rate within ``rel=0.35`` of the single shard's);
   the plastic driver at 4x4x1240 in 2x2 tiles, one 60-step segment
   against 30 + preempt + resume + 30 (weights, traces, state and
   generators identical); it prints the checkpoint's snapshot, copy
   and write times, the restore time, the spool drain per segment and
   how the writer's device-to-host copies overlap segment compute (a
   Chrome trace of the straight run goes to
   ``build/segmented/straight_trace.json``);
5d. ensembles and the job service: the same 2x2 8x8x1240 gaussian slab
   as a 3-member ensemble (``DistConfig.ensemble_seeds``; member 0 is
   phase 5c's solo state seed), recorded and captured, 400 steps in
   segments of 50, a checkpoint a segment, on phase 5c's table build:
   straight against 4 segments + preempt + resume (every member's
   tensors, ``t``, generator states and spool files identical, one
   capture per driver), member 0's spool logs byte for byte phase 5c's
   solo recorded driver's, a retile of the ensemble refused, the
   steady ms per step beside the solo recorded driver's times 3, and
   the captured ensemble step's graph nodes (a profile of its replays);
   the plastic ensemble at 4x4x1240 in 2x2 tiles, 2 members, 60 steps,
   member 0's weight digest equal to phase 5c's plastic driver's; then
   the job service (``examples/ensemble_service.py``) at 4x4x1240 in
   2x2 tiles, exponential: a solo reference driver, a ``SimJobServer``
   on loopback, two 3-member jobs of different seeds (one sim function
   in the cache, one capture per job), two HTTP clients streaming the
   first at different paces (each sees every event once), the members'
   ``launch.analyze`` reports, member 0's spool against the solo's, and
   each job's wall time split into build, run and drain;
6. timing of each kernel at its path's shapes: its device time per
   call (``ms``: CUDA events around back-to-back calls enqueued while
   the stream is held, ``queued_ms``), beside torch.profiler's figure
   (which misses some device events), the time per call with the
   host's launch cost (CUDA events, ``call_ms``), the plain version's
   device time (profiler) and one PyTorch library call's where there
   is one; ptxas's registers and spills; and the least time the card
   could take (bytes over 3.35 TB/s, or operations over the card's
   peak rate where they take longer).  The step-head kernel is timed
   beside the LIF kernel it replaced on the engine's path
   (``replaced_kernel_ms``, the same state).  The column delivery kernel is
   timed beside the warp-per-row kernel it replaced on the static path
   (``replaced_kernel_ms``, the same inputs); both delivery kernels
   report the bytes they actually move (``kernel_bytes``), and the
   fixed-order one also the bound with its index walk counted
   (``design_bound_ms``);
7. the LM serving path (``init_model`` -> ``init_decode_state`` ->
   ``make_prefill`` -> ``make_serve_step``): qwen2-1.5b at its full
   width in bf16 with seeded random weights, a 4 x 2048-token prefill
   through the tensor-core flash kernel (one launch per layer) and 32
   greedy decode steps (no launch: decode attention is plain, as in the
   reference),
   held against the plain path (``attn_impl="naive"``) on the same
   weights and prompts, teacher-forced, beside a control (the chunked
   plain path against the plain path), then a float32 prefill of both
   paths (the 3xTF32 tensor-core kernel and its pre-pass, one launch
   each per layer); prefill and decode times (bf16 and float32), the
   decode loop's device idle share and peak memory; then the flash
   kernels' timing at the prefill shape, and again with the head
   narrowed to 32 and 16 (bf16 and float32, the narrow heads' own kernel
   instances) beside the library call.  Phase 2 holds every flash kernel
   against its plain version at the reference's kernel-test shapes, the
   tensor-core kernels' edge cases in bf16 and float32 at head_dim
   64/128/256 and at 16/32 (``NARROW_CASES``), fully masked rows,
   qwen2's prefill shape and a head_dim-256 window, each also with the
   row statistic
   (``return_lse``: the same output, L = m + log l against the plain
   logsumexp, +1e30 on fully masked rows); the TF32 pre-pass bit for
   bit, and the tf32 fragment layout the TF32 kernel assumes;
8. LM training (``models.model.make_train_step``, ``optim.adamw``,
   ``data.LMBatchPipeline``): qwen2-1.5b at full width in bf16 with
   per-layer checkpointing, ``attn_impl="pallas"``, batch 4 x 2048:
   one step's loss and per-leaf gradients through the flash kernel's
   forward (``models.attention._Flash``) against the plain chunked
   route, with the plain naive route as the control; 5 steps (two
   flash launches per layer and step: the forward and its recompute),
   finite and falling losses; s per step, tokens/s, 6 N T over the step
   time against the bf16 peak, peak memory and a profiled sixth step's
   shares (flash forward, plain attention backward, optimizer); then
   ``launch.train.build_trainer`` at qwen2-1.5b and qwen3-8b reduced,
   40 steps straight against 25 + preempt + resume, bit for bit under
   ``torch.use_deterministic_algorithms(True)`` (in a child process,
   with ``CUBLAS_WORKSPACE_CONFIG`` set).  Phase 5 also times
   the copy a recorded call hands back (``obs.record.copy_recorder``);
9. the MoE, mamba and RG-LRU families at their published full widths
   in bf16 with seeded random weights, each freed before the next:
   granite-moe-1b-a400m (batch 4, 2048-token prompts), recurrentgemma-9b
   (batch 2, 3072-token prompts: past its 2048 window, so the mask
   bites in prefill and the ring cache wraps in decode) and
   falcon-mamba-7b (batch 4, 2048); each with its parameter count
   (``param_count()`` + ``param_count_gap()``), the kernel path's
   prefill (one tensor-core flash launch per attention layer: 24 / 12 /
   0) and 32 greedy decode steps (no launch), the plain path's prefill
   and decode teacher-forced on the kernel path's tokens (logits within
   ``FAMILY_TOL`` of the largest; granite's prefill also reports the
   share of assignments its MoE capacity dropped; MoE routes are
   teacher-forced too), for the recurrent two a prefill in two parts
   (1024 tokens, then the rest from that state) against the one-shot
   prefill (the same bound), prefill s and tokens/s, decode ms
   per token and the decode loop's idle share, peak memory; then
   reduced kimi-k2 and internvl (head_dim 8), qwen2.5-3b and whisper
   (12) in float32 on the card (the 3xTF32 kernel, heads padded to 16)
   against the same run on the CPU (whisper and internvl with their
   frames or patches), and reduced qwen2.5-3b in bf16 (the bf16
   tensor-core kernel, 12 padded to 16) against the plain path on the
   card;
10. whisper-small and internvl2-26b at their published full widths, as
   phase 9's models are served (``serve_family``): whisper with 16 clips
   of 1500 stub frames and a 224-token prompt (12 encoder layers,
   non-causal over the 1500 frames; 12 decoder layers, each causal
   self-attention and cross-attention over the encoder's 1500 keys: 36
   flash launches a prefill), internvl with 2 x (256 stub patches +
   2048 tokens) (48 launches); each with its parameter count, prefill
   and decode times, idle share, peak memory, kernel against plain
   logits (a chunked control beside) and a two-part prefill (whisper:
   the frames with the first 112 tokens, the rest over the cross
   caches; internvl: the patches with the first 1024 tokens, the rest
   at 256 + 1024) against the one-shot prefill;
11. the cost models (``launch.dryrun``, ``perf.op_analysis``,
   ``perf.roofline``, ``core.metrics.step_time_model``), on ``"meta"``
   and the host, beside the figures the phases above measured: the
   abstract trees must equal the card's real ones leaf for leaf, in
   shape, dtype and bytes (qwen2-1.5b's 1,543,910,912 parameters and
   its 4 x (2048 + 32) decode state from phase 7, AdamW's state from
   phase 8, both laws' 8x8x1240 2x2 state and tables from phase 5b,
   with their built storage); the dry run of phase 7's and 8's
   qwen2-1.5b shapes runs on ``"meta"`` (chunked attention) and the
   prefill's counted products must lie within 5 % of their count (2 N T
   less the embedding lookup, the LM head at the last position, the
   live chunk pairs' attention products); then one ``{"cost_model":
   {...}}`` line: the roofline terms (H100 SXM constants) of prefill,
   decode and train beside the measured seconds and peak bytes,
   ``step_time_model`` of the static and 2x2 steps at their measured
   rates beside their ms per step, and ``strong_scaling_curve`` of the
   paper's six cases on 1, 2, 4 and 8 cards (a model: no multi-card
   run exists).  No kernel launches there;
12. training the families (``make_train_step`` through the flash
   kernel's forward, ``TRAIN_FAMILIES``): granite-moe-1b-a400m (4 x
   2048), whisper-small (8 x (1500 frames + 448 tokens)), falcon-mamba-7b
   (8 of 64 layers, 4 x 2048), recurrentgemma-9b (6 of 38, 2 x 4096, past
   its window) and internvl2-26b (4 of 48, 2 x (256 patches + 2048),
   Adafactor over its stack group) at published width in bf16 with
   seeded random weights, each freed before the next: its parameter
   count, one step's loss and per-leaf gradients on the kernel route
   against the plain chunked route (naive against chunked the control,
   phase 8's gates; granite's plain routes teacher-forced on the kernel
   route's experts, the backward's recompute included), 3 timed steps
   (finite losses and grad norms, the last below the first, two flash
   launches a step per self-attention, encoder and cross-attention
   layer), a profiled fourth (the shares of the flash forward, the
   plain attention backward and the optimizer, from its Chrome trace),
   s per step, tokens/s and peak memory (granite's dropped share too);
   the bytes the recurrent scans' per-chunk checkpoint saves at
   falcon-mamba's shape (one step through a copy of the port without
   it); then the five families' reduced configs in float32 on the card
   (the 3xTF32 kernel) for 3 steps against the same steps on the CPU;
13. the SNN on ranks (``launch.mesh.spawn_ranks``): four rank processes
   on the one card, a 2x2 mesh over ``torch.distributed`` (gloo), one
   tile each, the halo strips staged through pinned host memory
   (``core.halo.Transport("gloo", "cuda")``).  Each rank builds its own
   tile's tables and runs phase 5b's 4x4x1240 parity legs, both laws:
   static 48 steps and recorded 32 on its own drive, plastic 30 (recorded)
   on its block of 5b's injected drive; every leaf of its state, per-step
   spikes, plastic weights and traces, and recorder must be bit for bit
   its tile of 5b's stacked run (sha-256 of each leaf's bytes).  Then it
   builds its tile of the exponential 8x8x1240 tables (every leaf's
   digest that of 5b's stacked build's slice, and the same storage
   descriptor) and times 200 steps of it: ms per step (slowest rank),
   the exchange's ms per step (staging and gloo), the bytes each rank
   sent and received per step (received equal to ``halo_import_bytes``
   of its tile), beside 5b's stacked 2x2 step; then 50 more steps with
   rank 0 under the profiler (its device busy ms per step and top
   kernels).  The parent built every kernel before it spawns; each
   rank's launches (counted before the profiled steps) are summed;
14. the LM on ranks (``parallel.sharding.MeshRules``,
   ``parallel.collectives``, ``models.model.make_train_step(rules=)`` /
   ``make_compressed_pod_train_step``, through ``launch.train``'s
   ``--nproc`` code: ``rules_for``, ``rank_model``): four rank processes
   on the one card, mesh (pod 2, data 1, model 2), gloo with CUDA
   tensors staged through pinned host memory.  Each rank runs two
   float32 parity legs, reduced granite-moe (expert-parallel, capacity
   factor 8 so that nothing drops) and reduced qwen2-1.5b (tensor-
   parallel), with the 3xTF32 flash kernel: one exact rank step held
   against the single-process step on the card (loss and grad norm to
   1e-5, every leaf to 2e-5), then six compressed pod steps (the first
   loss the exact step's to 1e-5, its parameters within 5e-3, the last
   loss below the first).  Then granite-moe-1b-a400m whole (24 layers,
   d_model 1024, 16 / 8 heads, 32 experts top-8, bf16, AdamW): its
   blocks (heads, experts and the vocabulary split over ``model``), a
   global batch of 4 x 2048 from ``LMBatchPipeline(seed=0)`` (two
   sequences a pod), one ``make_eval_step`` loss (within 2e-3 of the
   single-process eval on the card, run before the spawn and freed),
   three compressed pod steps (the first loss the eval loss, finite
   losses, each rank's pod wire bytes a step ``wire_bytes`` of its
   gradient elements, 48 flash launches a rank a step): s per step
   (slowest rank), tokens/s, bytes, seconds and calls per collective
   channel a step, peak GB per rank beside the dry run's bytes per rank
   (``launch.dryrun.rank_bytes``) and the dropped share;
15. the launch geometry and the last three examples:
   ``analysis.hopper_geometry.check_built()`` over the seven built
   libraries (each kernel's ptxas registers, static shared memory,
   spills and stack against its source's launch bounds and ``Cfg<D>``
   and its wrapper's declared static shared memory: a line a kernel),
   then ``repro_torch.examples.quickstart`` (6x6x50 both laws, 200
   steps each through the captured static path; one AdamW step and one
   decode step of reduced qwen3-8b), ``serve_lm`` at gemma-2b's full
   width (batch 4, 32-token prompts, 16 greedy tokens: tokens in the
   vocabulary, flash launches in prefill and none in decode) and
   ``snn_simulation`` (8x8x60 in 2x2 stacked tiles, both laws, 300 + 300
   steps: ``neuron_step``, ``event_delivery`` and ``step_graph``
   launched for each law, finite rates, then the 4x4x40 STDP demo, which
   must move synapses).

Launch counts are zeroed just before each of phases 3-5, 5b, 5c (after
its ``make_sim_fn`` baselines), 5d, 7, 8, each model of 9, 10 and 12
and each example of 15, and in each rank of 13 and 14 (before its
full-width steps), and read
just after it (phase 11 launches nothing; the ``{"kernels"}`` line
gives each kernel's launches on phase 3's or its own path, on 5b's,
5c's and 5d's, the flash rows per model of phases 9 and 10, with the
bf16 kernel's times at phase 10's shapes, per config of phase 12, the
ranks' sums on 13 and 14, and per example of 15); a replay of a
captured static or recorded step
counts as ``step_graph`` and as one launch of each kernel the graph
holds.  It prints the metrics, the ``{"cost_model": {...}}`` line, each
phase's seconds, a ``{"kernels": [...]}`` line, the card's name and
power limit, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It needs one CUDA card and the repository checkout around it.

    python3 chip_smoke.py --ab OTHER_SRC [--steps N]

runs only an A/B of the static path's ms per step against another
checkout's port (``OTHER_SRC``: its ``src`` directory, for example the
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists).  The trees run in turns, other, this, this,
other, each in a process of its own that builds its kernels and the
8x8x1240 tables of both laws, runs 20 warm-up steps and times ``N``
steps (default 500) of ``engine.simulate`` on the host clock,
CUDA-synchronised, then profiles ``N`` more for the device's idle
share; then it builds phase 5b's exponential 8x8x1240 tables in 2x2
tiles and times three fresh ``make_sim_fn`` calls of 500 steps as phase
5b's timed run does (8 eager steps, a capture, replays), and profiles a
fourth of 200 steps for the idle share; then phase 5c's gaussian 2x2
driver, unrecorded and recorded, each 400 steps in segments of 50 with
a checkpoint a segment: its steady ms per step and captures.  One ``ab {...}`` line per run
(with the metrics, which must not differ between trees), then the
card's name and power limit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
F32_OPS_PER_S = 67e12              # H100 SXM float32 rate outside the MXU
GRID, N_PER_COLUMN = 8, 1240       # the main path's network
PARITY_STEPS, TIMED_STEPS = 100, 500       # static path
PROFILE_STEPS = 200        # static profile: 8 eager steps, 24 replays
PLASTIC_PARITY_STEPS, PLASTIC_STEPS = 30, 200
PARITY_GRID = 4                            # CPU parity of the plastic path
# the timed plastic path runs on its parity leg's 4x4x1240 tables, both
# laws (an 8x8x1240 float32 host build and its inverse index, ~80 s, a
# law fewer)
RECORD_STEPS, SMALL_CAPACITY = 100, 1000
# a recorded call captures its graph: 1000 steps amortize the capture
RECORD_LONG_STEPS = 1000
MS_TILES = 2                       # the multi-shard path: 2x2 tiles
# the parity legs (captured / eager / plain, recorded) run at 4x4x1240,
# the timed and profiled runs at 8x8x1240
MS_PARITY_STEPS, MS_TIMED_STEPS, MS_PROFILE_STEPS = 48, 500, 200
# the plastic leg at 4x4x1240 in 2x2 tiles: the slab first fires in
# bulk after step 20 (20 steps changed 9 weights, none in a halo tier);
# its CPU plain paths (both laws side by side) are most of its time
MS_PROFILE_REPLAYS, MS_RECORD_STEPS, MS_PLASTIC_STEPS = 20, 32, 30
# the segmented driver: 400 steps in segments of 50 (each a ring phase 2
# slots on from the last), preempted after 4; its plastic leg 60 steps
SEG_TOTAL, SEG_STEPS, SEG_PREEMPT, SEG_PLASTIC_STEPS = 400, 50, 4, 60
SEG_EAGER_STEPS = 10       # below 2 * d_ring: a driver that steps eagerly
# phase 5d: ensembles.  Member 0 of each is phase 5c's solo state seed,
# so its spool and weight digest must be 5c's; the service leg runs the
# example (two 3-member jobs) at 4x4x1240 in 2x2 tiles, segments of 20
ENS_SEEDS, ENS_PLASTIC_SEEDS = (0, 1, 2), (0, 1)
SERVICE_STEPS, SERVICE_SEG = 60, 20
# phase 13: four ranks (2x2) on the one card; the timed leg's steps, the
# phase's time limit
RANKS, RANK_TIMED_STEPS, RANK_PROFILE_STEPS, RANK_TIMEOUT_S = 4, 200, 50, 300
# phase 14: the LM on four ranks (pod 2, data 1, model 2) on the one card:
# the float32 parity legs (reduced configs, global batch x seq), then
# granite-moe-1b-a400m at full width; the gates
LM_RANK_MESH = ((2, 1, 2), ("pod", "data", "model"))
LM_RANK_PARITY = ("granite-moe-1b-a400m", "qwen2-1.5b")
LM_RANK_PARITY_BATCH, LM_RANK_PARITY_SEQ, LM_RANK_POD_STEPS = 4, 64, 6
LM_RANK_ARCH, LM_RANK_BATCH, LM_RANK_SEQ, LM_RANK_STEPS = \
    "granite-moe-1b-a400m", 4, 2048, 3
LM_RANK_LOSS_TOL, LM_RANK_LEAF_TOL = 1e-5, 2e-5   # exact step vs one card
LM_RANK_POD_PARAM_TOL = 5e-3     # the compressed step's first parameters
LM_RANK_EVAL_TOL = 2e-3          # bf16 eval on ranks vs one card, relative
# (against the one-card eval of each pod's own sequences: the MoE's
# capacity is per shard on ranks, as the reference's EP has it, so with
# drops the whole batch on one card drops other assignments)
LM_RANK_FLAT_GRAD = 1e-6         # 100 x AdamW's eps (see lm_rank_parity)
LM_RANK_LR, LM_RANK_TIMEOUT_S = 1e-3, 900
LM_RANK_FULL_LR = 1e-4           # AdamW's rate at full width
LAWS = ("gaussian", "exponential")
BF16_OPS_PER_S = 989e12            # H100 SXM bf16 dense tensor-core rate
TF32_OPS_PER_S = 495e12            # H100 SXM TF32 dense tensor-core rate
LM_ARCH = "qwen2-1.5b"             # served at full width, bf16
LM_BATCH, LM_PROMPT, LM_GEN = 4, 2048, 32
# kernel path vs plain path: each logit's |difference| over (|plain
# logit| + the logits' std).  In bf16 each path rounds its attention
# output to bf16 on its own (one step is 2^-8 of the value) and 28
# layers carry the difference on: two plain versions that differ only in
# float32 summation order ("naive", "chunked") differ by 0.08 on an
# H100, so bf16 is held to 0.2 and to at most twice that control's
# difference (+0.01).  In float32 the same two differ by 2e-5.
LM_BF16_TOL, LM_F32_TOL = 0.2, 1e-4
# phase 8, training at full width: 5 steps of 4 x 2048 tokens; the
# kernel route's loss and per-leaf gradients against the plain chunked
# route's, targets 2e-3 and 3e-2 (the kernel rounds P to bf16 before
# P V, the plain route does not: about one bf16 step of each layer's
# attention output, carried through 28 layers and their backward); a
# miss fails only beyond twice the plain routes' own difference + 0.01
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 5
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 2e-3, 3e-2
# the train driver at reduced width: straight against preempt + resume
DRIVER_ARCHS = ("qwen2-1.5b", "qwen3-8b")
DRIVER_BATCH, DRIVER_SEQ, DRIVER_STEPS, DRIVER_PREEMPT = 8, 128, 40, 25
# phase 9: full-width models of the new families, each served in turn:
# (arch, batch, prompt, greedy steps, the split of the two-part prefill;
# None for MoE, whose routed batch sets its capacity ranks).
# recurrentgemma's 3072-token prompts pass its 2048 window: the mask
# bites in prefill, the ring cache wraps in decode, and its two-part
# prefill (1024 + 2048) attends across the parts
FAMILIES = [("granite-moe-1b-a400m", 4, 2048, 32, None),
            ("recurrentgemma-9b", 2, 3072, 32, 1024),
            ("falcon-mamba-7b", 4, 2048, 32, 1024)]
# kernel path vs plain path (teacher-forced), and the two-part prefill vs
# the one-shot one: max |diff| over the largest |logit|, bf16
FAMILY_TOL = 2e-2
# decode steps profiled for the idle share (device events only)
FAMILY_PROFILE_STEPS = 8
# phase 10: the encoder-decoder and VLM families at full width, as phase
# 9's (arch, batch, prompt, greedy steps, split).  whisper-small: 16
# clips of 30 s (1500 stub frames each, Whisper's window) and a 224-token
# decoder prompt (at most half of its 448-token text context is
# conditioning), split 112 + 112 (frames with the first part only);
# internvl2-26b: 256 patches + 2048 tokens, split at 1024 (patches and
# the first half, then the rest at 256 + 1024)
ENCDEC_FAMILIES = [("whisper-small", 16, 224, 32, 112),
                   ("internvl2-26b", 2, 2048, 32, 1024)]
# reduced configs on the card (float32, the 3xTF32 flash kernel; the 8-
# and 12-wide heads padded to 16) against the same run on the CPU
REDUCED_ON_CARD = ("kimi-k2-1t-a32b", "qwen2.5-3b", "whisper-small",
                   "internvl2-26b")
REDUCED_TOL = 1e-4
# and one in bf16 (the bf16 tensor-core kernel, 12 padded to 16) against
# the plain path on the card, within FAMILY_TOL
REDUCED_BF16 = "qwen2.5-3b"
# phase 12: training the families, one at a time: (arch, layers (None:
# all), batch, tokens a row, optimizer).  Widths are the published ones;
# depth is cut only where one 80 GB card cannot hold bf16 parameters and
# gradients and AdamW's float32 moments (about 12 B a parameter).
# whisper: 30 s clips (1500 frames) and its whole 448-token text context;
# falcon-mamba: 16 chunks of 128 a layer; recurrentgemma: two whole
# periods, past its 2048 window; internvl: 256 patches + 2048 tokens under
# the dry run's optimizer for the full model, its 4 layers one stack group
TRAIN_FAMILIES = [("granite-moe-1b-a400m", None, 4, 2048, "adamw"),
                  ("whisper-small", None, 8, 448, "adamw"),
                  ("falcon-mamba-7b", 8, 4, 2048, "adamw"),
                  ("recurrentgemma-9b", 6, 2, 4096, "adamw"),
                  ("internvl2-26b", 4, 2, 2048, "adafactor")]
TRAIN_FAMILY_STEPS = 3
# the flash kernel against its plain version (tests/test_kernels.py)
FLASH_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# its row statistic L = m + log l against the plain logsumexp, times
# |L| + 1: float32 scores in another order and base-2 exponents (1e-5),
# bf16 operands on the sm90 route (2e-3)
LSE_TOL = {"float32": 1e-5, "bfloat16": 2e-3}
FLASH_CASES = [                    # (bh, bh_kv, sq, sk, d, causal, window,
    (4, 2, 64, 64, 32, True, None, 0),          # q_offset, dtype)
    (8, 2, 100, 100, 64, True, 48, 0),
    (2, 2, 37, 129, 16, False, None, 0),
    (2, 1, 1, 77, 32, True, None, 76),
    (3, 3, 48, 16, 8, True, None, 0),
]
SM90_CASES = [                     # the tensor-core kernel's edges (bf16)
    (2, 1, 1, 77, 128, True, None, 76),
    (12, 2, 1, 300, 128, False, None, 0),
    (3, 3, 48, 16, 64, True, None, 0),
    (2, 2, 37, 129, 128, False, None, 0),
    (6, 1, 200, 200, 128, True, None, 0),
    (4, 4, 129, 1000, 128, True, None, 871),
    (2, 1, 513, 513, 64, True, 200, 0),
    (8, 1, 130, 300, 256, True, 40, 0),
    (2, 2, 300, 257, 256, False, None, 0),
    # non-causal at D 64 over a ragged key edge (1500 = 11 x 128 + 92):
    # whisper's encoder and its cross-attention (Sq != Sk)
    (24, 24, 1500, 1500, 64, False, None, 0),
    (24, 24, 224, 1500, 64, False, None, 0),
]
# the narrow heads' kernel instances (head_dim 16 and 32; bf16 on the
# sm90 route, float32 on the TF32 one): Sq = 1, ragged Sq/Sk, Sk
# below one key tile, q_offset, windows, GQA groups 1, 6 and 8, rows that
# see no key (the window-5 q_offset-18 case leaves rows 6+ without one)
NARROW_CASES = [
    (2, 1, 1, 77, 32, True, None, 76),
    (12, 2, 1, 300, 16, False, None, 0),
    (3, 3, 48, 16, 32, True, None, 0),
    (2, 2, 37, 129, 16, False, None, 0),
    (6, 1, 200, 200, 32, True, None, 0),
    (4, 4, 129, 1000, 16, True, None, 871),
    (2, 1, 513, 513, 32, True, 200, 0),
    (8, 1, 130, 300, 16, True, 40, 0),
    (4, 4, 12, 20, 32, True, 5, 18),
    (48, 8, 300, 300, 32, True, None, 0),
]
PAD_CASES = [                      # head widths the wrapper pads: kimi-k2's
    (8, 1, 300, 300, 112, True, None, 0),       # 112 (-> 128) and reduced
    (4, 2, 129, 257, 112, True, 40, 128),       # qwen2.5-3b's 12 (-> 16)
    (6, 2, 200, 200, 12, True, None, 0),       # (-> 16 bf16, 32 float32)
    (2, 2, 37, 77, 12, False, None, 0),
]


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


def queued_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time per call of ``fn()`` with no host gap between
    calls: the stream is held by a sleeping kernel while the host
    enqueues ``iters`` calls between two CUDA events, so the calls run
    back to back once it wakes.  ``fn`` must not wait for the device."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # sleep for twice the enqueue time at up to 2 GHz (longer if slower)
    torch.cuda._sleep(int(2 * host_s * 2e9) + 1_000_000)
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
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    us = sum(e.time_range.elapsed_us() for e in events)
    if 0 < len(events) < iters:
        print(f"device_ms: the profiler saw {len(events)} device events "
              f"in {iters} calls of {getattr(fn, '__name__', fn)}")
    if us > 0:
        return us / iters / 1e3
    print(f"device_ms: the profiler saw no device time for "
          f"{getattr(fn, '__name__', fn)}; timed with CUDA events instead")
    return call_ms(fn, iters, warmup=0)


def ulps(x, y):
    """Elementwise distance in float32 ulps (same-sign values)."""
    import torch
    return (x.view(torch.int32).long() - y.view(torch.int32).long()).abs()


def ptxas(source: str) -> list:
    """ptxas's figures of each kernel entry built from
    ``csrc/<source>.cu``: registers, static shared memory, spill stores
    and loads, stack (the log kept beside its library)."""
    from repro_torch.analysis.hopper_geometry import parse_ptxas
    from repro_torch.kernels import _build
    return parse_ptxas(_build.log_path(source).read_text())


# phase 2's host table builds: (law, grid, compressed); the last is the
# dict-form check's uncompressed set
STATIC_BUILDS = [("gaussian", 4, True), ("gaussian", GRID, True),
                 ("exponential", GRID, True), ("gaussian", 4, False)]


def host_table_build(key) -> tuple:
    """One single-shard table set on the card, built on the host (numpy,
    the reference's draws), and its seconds.  numpy releases the
    interpreter lock for most of a build, so builds in threads overlap;
    each one's seconds are then its own wall time beside the others."""
    from repro_torch.configs.snn import reduced_case
    from repro_torch.core import engine
    law, grid, compress = key
    cfg = reduced_case(law, grid, N_PER_COLUMN).engine_config(1, 1)
    t0 = time.perf_counter()
    tabs = engine.build_shard_tables(cfg, compress=compress, device="cuda")
    return tabs, time.perf_counter() - t0


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


def check_neuron_step(sizes, gen) -> float:
    """The step-head kernel against its plain version at each (n, cap)
    of ``sizes``: spike densities 0, mid-run and above ``active_cap``,
    in place (as the engine calls it) and into new tensors, with
    neurons exactly at threshold as in ``check_lif``; v, c, refrac,
    spk, the ring, the bitmap and the count exact, one launch a call."""
    import torch
    from repro_torch.core.neuron import LIFParams
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.neuron_step import neuron_step_cuda
    kw = LIFParams().kernel_args()
    for n, cap in sizes:
        v0 = torch.rand(n, device="cuda", generator=gen) * 35.0 - 10.0
        c = torch.rand(n, device="cuda", generator=gen) * 5.0
        a = torch.rand(n, device="cuda", generator=gen) < 0.95
        drive = torch.poisson(torch.full((n,), 1.62, device="cuda"),
                              generator=gen) * 0.5
        # (label, ring offset mV, refractory share)
        for label, shift, refr in (("zero", -80.0, 0.67),
                                   ("mid-run", 3.0, 0.67),
                                   ("above cap", 40.0, 0.0)):
            ring = torch.randint(-4000, 4000, (8, n), device="cuda",
                                 generator=gen).float() * 2.0 ** -9 + shift
            r = ((torch.rand(n, device="cuda", generator=gen) < refr)
                 .int() * torch.randint(1, 3, (n,), device="cuda",
                                        generator=gen, dtype=torch.int32))
            v = v0.clone()
            if label != "zero":     # v_int == theta exactly must spike
                v[:64], c[:64], r[:64], a[:64] = 0.0, 0.0, 0, True
                ring[6, :64], drive[:64] = kw["theta"], 0.0
            for inplace in (True, False):
                rk, rp = ring.clone(), ring.clone()
                st = (v.clone(), c.clone(), r.clone())
                before = _build.launch_counts().get("neuron_step", 0)
                got = neuron_step_cuda(rk, 6, drive, *st, a,
                                       active_cap=cap,
                                       out=st if inplace else None, **kw)
                want = ref.neuron_step_ref(rp, 6, drive, v, c, r, a,
                                           active_cap=cap, **kw)
                torch.cuda.synchronize()
                require(_build.launch_counts()["neuron_step"] == before + 1,
                        "neuron_step: not one launch per call")
                for what, x, y in zip(("v", "c", "refrac", "spk", "bits",
                                       "count"), got, want):
                    require(x.dtype == y.dtype and torch.equal(x, y),
                            f"neuron_step n={n} {label}: {what} differs "
                            "from plain")
                require(torch.equal(rk, rp) and not bool(rk[6].any()),
                        f"neuron_step n={n} {label}: ring differs")
            count = int(want[5])
            require((count == 0) == (label == "zero")
                    and (count > cap) == (label == "above cap"),
                    f"neuron_step n={n} {label}: {count} spikes, cap {cap}")
            print(f"check neuron_step n={n} cap={cap} {label}: {count} "
                  f"spikes, v/c/refrac/spk/ring/bitmap/count exact, in "
                  "place and not")
    return 0.0


def column_runs(tabs, spec, label: str) -> dict:
    """Build the tables' run descriptors (the column kernel's static
    input) and report their bytes per synapse beside the tables' own,
    and the build time."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runs = tabs.column_runs(spec.n_per_col, spec.n_exc_per_col, spec.d_ring)
    torch.cuda.synchronize()
    n_syn = tabs.stats["n_synapses"]
    nbytes = sum(r["nbytes"] for r in runs)
    res = {"tables": label, "build_s": time.perf_counter() - t0,
           "build_concurrent": True, "bytes": nbytes,
           "bytes_per_synapse": nbytes / n_syn,
           "table_bytes_per_synapse": tabs.stats["bytes_per_synapse"],
           "pairs": [int(r["pair_src"].numel()) for r in runs],
           "max_pairs_per_column": [r["max_pairs"] for r in runs],
           "permuted": [r["perm"] is not None for r in runs]}
    require(not any(res["permuted"]), f"{label}: build_tables output needed "
            "the permuted descriptor")
    print("column runs " + json.dumps(res))
    return res


def reckon_runs_bytes(law: str, grid: int) -> dict:
    """The run descriptor's size at one shard of ``grid`` x ``grid`` x
    1240, reckoned from shapes (no build): one pair per (target column,
    stencil offset that lands in the grid) plus the local one, each
    ``n_per_col`` int64 words; synapses from the connection
    probabilities."""
    from repro_torch.configs.snn import reduced_case
    spec = reduced_case(law, grid, N_PER_COLUMN).engine_config(1, 1).spec()
    n, n_exc = spec.n_per_col, spec.n_exc_per_col
    pairs, syn = grid * grid, grid * grid * n * n * spec.p_local
    for (dy, dx), p in zip(spec.law.stencil_offsets(),
                           spec.law.offset_probs()):
        inside = max(grid - abs(int(dy)), 0) * max(grid - abs(int(dx)), 0)
        pairs += inside
        syn += inside * n_exc * n * float(p)
    nbytes = pairs * (n * 8 + 8)
    return {"law": law, "grid": f"{grid}x{grid}x{N_PER_COLUMN}",
            "pairs": pairs, "synapses": syn, "bytes": nbytes,
            "bytes_per_synapse": nbytes / syn}


def check_delivery(tabs, spec, gen, label: str) -> float:
    import torch
    from repro_torch.core.synapses import deliver_events
    from repro_torch.kernels import _build
    from repro_torch.kernels.synaptic_accum import event_delivery_banded
    cap = spec.active_cap_local
    n = spec.n_local
    runs = tabs.column_runs(spec.n_per_col, spec.n_exc_per_col, spec.d_ring)
    err = 0.0
    for dens in (0.01, 0.05, 0.9):
        spk = (torch.rand(n, device="cuda", generator=gen) < dens).float()
        ring0 = torch.randint(-200, 200, (8, n), device="cuda",
                              generator=gen).float() * 2.0 ** -9
        before = _build.launch_counts().get("event_delivery", 0)
        rk, ek, dk = event_delivery_banded([(tabs.local, spk, cap)],
                                           ring0.clone(), 3, 8,
                                           runs=runs[:1])
        require(_build.launch_counts()["event_delivery"] == before + 1,
                "event_delivery: not one launch of the column kernel")
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


def check_spike_compact(sizes, gen) -> float:
    """The compaction kernel against its plain version at each (n, cap)
    of ``sizes``, densities 0 to 1: indices and count exact, one launch
    per call."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.ref import compact_events
    from repro_torch.kernels.spike_compact import spike_compact_cuda
    for n, cap in sizes:
        for dens in (0.0, 0.01, 0.05, 0.9, 1.0):
            spk = (torch.rand(n, device="cuda", generator=gen) < dens).float()
            before = _build.launch_counts().get("spike_compact", 0)
            idx, cnt = spike_compact_cuda(spk, n, cap)
            ridx, rcnt = compact_events(spk, n, cap)
            torch.cuda.synchronize()
            require(torch.equal(idx, ridx) and int(cnt) == int(rcnt),
                    f"spike_compact n={n} density {dens}: differs from "
                    "plain")
            require(_build.launch_counts()["spike_compact"] == before + 1,
                    "spike_compact: not one launch per call")
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
    from repro_torch.kernels import _build
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
    before = _build.launch_counts().get("step_graph", 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fin, counts = engine.simulate(state, tabs, cfg, TIMED_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    replays = _build.launch_counts().get("step_graph", 0) - before
    require(replays == (TIMED_STEPS - cfg.d_ring) // cfg.d_ring,
            f"{law}: {replays} replays of the captured step in "
            f"{TIMED_STEPS} steps")
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
        "host_build_s": build_s, "host_build_concurrent": True,
        "n_synapses": tabs.stats["n_synapses"],
        "steps": TIMED_STEPS, "rate_hz": rate,
        "events_per_step": events / TIMED_STEPS,
        "dropped": float(fin["metrics"]["dropped"]),
        "ms_per_step": 1e3 * wall / TIMED_STEPS,
        "s_per_synaptic_event": wall / max(events, 1.0),
        "step_graph_replays": replays,
        "parity_steps": PARITY_STEPS,
        "parity_spikes": float(raster_k.sum()),
        "parity_v_values_differing": v_diff,
    }
    print("static path " + json.dumps(res))
    profile_steps(fin, tabs, cfg, law, n_steps=PROFILE_STEPS)
    # a mid-run spike vector: the delivery kernel's main-path input
    steps = raster_k[PARITY_STEPS // 2:]
    med = int(steps.sum(1).argsort()[steps.shape[0] // 2])
    return {"cfg": cfg, "state": fin_k, "spikes": steps[med].clone(),
            "rate_hz": rate, "ms_per_step": res["ms_per_step"],
            "events_per_step": res["events_per_step"]}


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
    busy, top = device_breakdown(prof, n_steps)
    print("profile " + json.dumps({
        "path": "plastic" if plasticity else "static",
        "law": law, "steps": n_steps,
        "wall_ms_per_step": wall_us / n_steps / 1e3,
        "device_busy_ms_per_step": busy / n_steps / 1e3,
        "device_idle_share": 1.0 - busy / wall_us if wall_us else None,
        "top_kernels_ms_per_step": top}))


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


def plastic_parity_host(law: str) -> dict:
    """The host build of the plastic parity's 4x4x1240 tables (one
    thread a law; its seconds are wall time beside the other host
    work)."""
    from repro_torch.core import engine
    cfg = plastic_cfg(law, PARITY_GRID)
    require(cfg.lif.refrac_steps > 0, "refrac_steps must be > 0")
    t0 = time.perf_counter()
    cpu_tabs = engine.build_shard_tables(cfg, device="cpu")
    return {"law": law, "cfg": cfg, "cpu_tabs": cpu_tabs,
            "build_s": time.perf_counter() - t0}


def plastic_parity_card(ctx: dict) -> None:
    """The card's leg: the tables' card copy and its plasticity (the
    inverse index, built on the host in turn and cached on the tier
    tensors, so the timed run on the same copy finds it), a drive drawn
    on the card, and 30 kernel-path steps (which leave the tables
    unchanged: a plastic run clones the weights it updates), kept on
    the host for the comparison in 5b.  The leg's masks and traces go
    with it: the timed run makes its own."""
    import torch
    from repro_torch.core import engine
    from repro_torch.tree import tree_flatten, tree_unflatten
    cfg = ctx["cfg"]
    ctx["tabs"] = ctx["cpu_tabs"].to("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aux = engine.init_plasticity(ctx["tabs"], cfg)
    torch.cuda.synchronize()
    ctx["inv_s"] = time.perf_counter() - t0
    gen = torch.Generator(device="cuda")
    gen.manual_seed(99)
    n = cfg.spec().n_local
    drive = torch.stack([engine.external_drive(gen, n, cfg)
                         for _ in range(PLASTIC_PARITY_STEPS)])
    sk, tk, rk, rast = plastic_raster(engine.init_sim_state(cfg),
                                      ctx["tabs"], aux, cfg, drive,
                                      "cuda")
    leaves, treedef = tree_flatten((sk, rk))
    sk, rk = tree_unflatten(treedef, [x.cpu() if torch.is_tensor(x) else x
                                      for x in leaves])
    # of the tables the comparison reads the updated weights only
    ctx["card"] = (sk, {"local": {"w": tk["local"]["w"].cpu()}}, rk,
                   rast.cpu())
    ctx["drive"] = drive.cpu()


def plastic_parity_cpu(ctx: dict) -> tuple:
    """The plain path of ``plastic_parity_card``'s run on the CPU."""
    from repro_torch.core import engine
    plain = dataclasses.replace(ctx["cfg"], use_kernels=False)
    tabs = ctx["cpu_tabs"]
    return plastic_raster(engine.init_sim_state(plain, device="cpu"), tabs,
                          engine.init_plasticity(tabs, plain), plain,
                          ctx["drive"], "cpu")


def plastic_parity_check(ctxs: list, cpu: list) -> None:
    """Each law's card leg against its CPU plain leg, bit for bit."""
    for ctx, (sp, tp, rp, rast_p) in zip(ctxs, cpu):
        law, cpu_tabs = ctx["law"], ctx["cpu_tabs"]
        sk, tk, rk, rast_k = ctx["card"]
        label = f"plastic {law} {PARITY_GRID}x{PARITY_GRID}x{N_PER_COLUMN}"
        require(bits_equal(rast_k, rast_p), f"{label}: raster differs "
                f"({int((rast_k.cpu() != rast_p).sum())} entries)")
        for what, a, b in (("w", tk["local"]["w"], tp["local"]["w"]),
                           ("ring", sk["i_ring"], sp["i_ring"]),
                           ("x_post", rk["x_post"], rp["x_post"]),
                           ("x_pre", rk["x_pre"][0], rp["x_pre"][0]),
                           ("v", sk["neuron"]["v"], sp["neuron"]["v"]),
                           ("c", sk["neuron"]["c"], sp["neuron"]["c"])):
            require(bits_equal(a, b), f"{label}: {what} differs between "
                    "the card's kernel path and the CPU plain path")
        for k in ("spikes", "events", "dropped"):
            require(float(sk["metrics"][k]) == float(sp["metrics"][k]),
                    f"{label}: metric {k} differs")
        changed = int((tk["local"]["w"].cpu() != cpu_tabs.local["w"]).sum())
        require(changed > 0, f"{label}: no weight changed")
        res = {"law": law,
               "grid": f"{PARITY_GRID}x{PARITY_GRID}x{N_PER_COLUMN}",
               "steps": PLASTIC_PARITY_STEPS, "spikes": float(rast_k.sum()),
               "weights_changed": changed, "host_build_s": ctx["build_s"],
               "host_build_concurrent": True,
               "inverse_index_host_s": ctx["inv_s"]}
        print("plastic parity (card kernel path == CPU plain path: raster, "
              "w, ring, traces, v, c, metrics) " + json.dumps(res))


def run_plastic(law: str, tabs, build_s: float, inv_s: float,
                grid: int) -> dict:
    """The timed plastic path at ``grid`` x ``grid`` x 1240 on ``tabs``
    (their inverse index built in ``inv_s`` and cached on them; launch
    counts are read by the caller around this call)."""
    import torch
    from repro_torch.core import engine
    cfg = plastic_cfg(law, grid)
    aux = engine.init_plasticity(tabs, cfg)
    inv = aux["inv"]
    tm_bytes = inv["tm"].numel() * inv["tm"].element_size()
    inv_bytes = (inv["slots"].numel() * inv["slots"].element_size()
                 + inv["n_in"].numel() * inv["n_in"].element_size()
                 + tm_bytes)
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
    label = f"{grid}x{grid}x{N_PER_COLUMN}"
    res = {
        "law": law, "grid": label,
        "steps": PLASTIC_STEPS, "host_build_s": build_s,
        "host_build_concurrent": True,
        "n_synapses": tabs.stats["n_synapses"],
        "inverse_index_host_s": inv_s, "inverse_index_bytes": inv_bytes,
        "target_major_bytes": tm_bytes,
        "inverse_index_bytes_per_synapse":
            inv_bytes / tabs.stats["n_synapses"],
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
            "traces": traces, "grid": label}


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
                   n_in=aux["inv"]["n_in"].to(dev),
                   tm=aux["inv"]["tm"].to(dev))
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
    print(f"check plastic_delivery_ltd {law} {run['grid']}: "
          f"{int(spikes.sum())} spikes, {ek} events, {dk} dropped, "
          f"{changed} weights depressed; ring, w' and counts exact")
    return float(max((rk - rp).abs().max(), (wk - wp).abs().max()))


# ---------------------------------------------------------------------------
# phase 5: the recorded path
# ---------------------------------------------------------------------------

def eager_recorded(cfg, tabs, rspec, steps: int) -> tuple:
    """``steps`` eager ``engine.step`` calls from ``cfg``'s seed, each
    step's spikes appended to a fresh recorder with the host step (the
    recorded path as it ran before its capture): the final state, the
    raster, the recorder and the host seconds."""
    import torch
    from repro_torch.core import engine
    from repro_torch.obs.record import (init_recorder_state, record_step,
                                        tile_gid_map)
    gids = torch.from_numpy(tile_gid_map(cfg.decomp, 0, 0)).cuda()
    rec = init_recorder_state(rspec)
    state, rows = engine.init_sim_state(cfg), []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(steps):
        state, spk = engine.step(state, tabs, cfg)
        record_step(rec, spk, gids, k, rspec)
        rows.append(spk)
    torch.cuda.synchronize()
    return state, torch.stack(rows), rec, time.perf_counter() - t0


def run_recorded(law: str, tabs) -> dict:
    import numpy as np
    import torch
    from repro_torch.configs.snn import reduced_case
    from repro_torch.core import engine
    from repro_torch.kernels import _build
    from repro_torch.obs.record import recorder_spec, tile_gid_map
    cfg = reduced_case(law, GRID, N_PER_COLUMN).engine_config(1, 1)
    state = engine.init_sim_state(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.simulate(state, tabs, cfg, RECORD_STEPS, record_spikes=True)
    torch.cuda.synchronize()
    out = {"off": {"ms_per_step":
                   1e3 * (time.perf_counter() - t0) / RECORD_STEPS}}
    d = cfg.d_ring
    for label, capacity in (("default", None), ("small", SMALL_CAPACITY)):
        rspec = recorder_spec(cfg, RECORD_STEPS, capacity=capacity)
        state = engine.init_sim_state(cfg)
        replays = _build.launch_counts().get("step_graph", 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fin, raster, rec = engine.simulate(
            state, tabs, cfg, RECORD_STEPS, record_spikes=True,
            recorder=rspec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_replays = _build.launch_counts().get("step_graph", 0) - replays
        require(n_replays == (RECORD_STEPS - d) // d,
                f"recorder {label}: {n_replays} replays in {RECORD_STEPS} "
                "recorded steps")
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
        # the captured run against the eager steps, bit for bit
        est, eraster, erec, ewall = eager_recorded(cfg, tabs, rspec,
                                                   RECORD_STEPS)
        require(torch.equal(eraster, raster) and all(
            torch.equal(est["neuron"][k], fin["neuron"][k])
            for k in fin["neuron"]) and torch.equal(
            est["i_ring"], fin["i_ring"]) and all(
            torch.equal(erec[k], rec[k]) for k in rec),
            f"recorder {label}: the captured run differs from the eager "
            "steps (raster, state or recorder)")
        out[label] = {"capacity": rspec.capacity, "count": count,
                      "dropped": dropped, "spikes": n_spk,
                      "buffer_bytes": int(np.int64(rspec.capacity) * 8),
                      "step_graph_replays": n_replays,
                      "ms_per_step": 1e3 * wall / RECORD_STEPS,
                      "eager_ms_per_step": 1e3 * ewall / RECORD_STEPS}
    # a long captured call: its capture amortized over 1000 steps
    rspec = recorder_spec(cfg, RECORD_LONG_STEPS)
    replays = _build.launch_counts().get("step_graph", 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fin, per, rec = engine.simulate(engine.init_sim_state(cfg), tabs, cfg,
                                    RECORD_LONG_STEPS, recorder=rspec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_replays = _build.launch_counts().get("step_graph", 0) - replays
    require(n_replays == (RECORD_LONG_STEPS - d) // d
            and int(rec["count"]) == int(per.sum())
            and int(rec["dropped"]) == 0,
            f"recorder long: {n_replays} replays, {int(rec['count'])} "
            f"events for {int(per.sum())} spikes")
    out["long"] = {"steps": RECORD_LONG_STEPS, "step_graph_replays":
                   n_replays, "events": int(rec["count"]),
                   "ms_per_step": 1e3 * wall / RECORD_LONG_STEPS}
    # a recorded call hands back a copy of its resident recorder, made
    # after the run, outside the graph (obs.record.copy_recorder): its
    # device time for this call's buffer and for a segment of phase
    # 5c's recorded driver (2x2 tiles, SEG_STEPS steps), which drains
    # the resident buffers itself and makes no copy
    from repro_torch.obs.record import copy_recorder, init_recorder_state
    seg_spec = recorder_spec(ms_cfg("gaussian", GRID).engine, SEG_STEPS)
    seg_rec = init_recorder_state(seg_spec, tiles=(MS_TILES, MS_TILES))
    out["copy"] = {
        "ms": queued_ms(lambda: copy_recorder(rec), 20),
        "bytes": sum(x.numel() * 4 for x in rec.values()),
        "segment_2x2_ms": queued_ms(lambda: copy_recorder(seg_rec), 20),
        "segment_2x2_bytes": sum(x.numel() * 4 for x in seg_rec.values()),
        "segment_steps": SEG_STEPS}
    out["copy"]["share_of_long_call"] = out["copy"]["ms"] / (1e3 * wall)
    print(f"recorded path {law} {GRID}x{GRID}x{N_PER_COLUMN} "
          f"{RECORD_STEPS} steps " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 5b: the multi-shard path (2x2 tiles on one card)
# ---------------------------------------------------------------------------

def ms_cfg(law: str, grid: int, **kw):
    from repro_torch.configs.snn import reduced_case
    from repro_torch.core.dist_engine import DistConfig
    return DistConfig(engine=reduced_case(law, grid, N_PER_COLUMN)
                      .engine_config(MS_TILES, MS_TILES, **kw))


def ms_diff(a: dict, b: dict) -> list:
    """The fields of two stacked states that differ (bits), each with
    the tiles (row-major) where it differs."""
    pairs = [(k, a["neuron"][k], b["neuron"][k]) for k in a["neuron"]]
    pairs += [("i_ring", a["i_ring"], b["i_ring"])]
    pairs += [(k, a["metrics"][k], b["metrics"][k]) for k in a["metrics"]]
    if "plastic" in a:
        pa, pb = a["plastic"], b["plastic"]
        pairs += [(f"w{i}", x, y) for i, (x, y) in enumerate(zip(pa["w"],
                                                                 pb["w"]))]
        pairs += [("x_pre", pa["x_pre"][0], pb["x_pre"][0]),
                  ("x_post", pa["x_post"], pb["x_post"])]
    out = []
    for name, x, y in pairs:
        if not bits_equal(x, y):
            x, y = x.cpu(), y.cpu()
            tiles = [i for i in range(MS_TILES ** 2)
                     if not bits_equal(x.flatten(0, 1)[i],
                                       y.flatten(0, 1)[i])]
            out.append(f"{name} (tiles {tiles})")
    if not (a["t"] == b["t"]).all():
        out.append("t")
    return out


def ms_recorded(cfg, tables, steps: int, device: str, drive=None,
                plastic=None, mesh=None) -> tuple:
    """A recorded multi-shard run (eager) at the default capacity: the
    global raster as (step, gid) events.  ``plastic``: (carry, inverse
    index slots, folded tables).  ``mesh``: this rank's tile (phase
    13), its blocks of everything."""
    import torch
    from repro_torch.core import dist_engine as de
    from repro_torch.obs.record import recorder_spec, stacked_gid_maps
    state = de.init_dist_state(cfg, device=device, mesh=mesh)
    gids = stacked_gid_maps(cfg.engine.decomp)
    if mesh is not None:
        gids = de.rank_block(cfg, gids, mesh)
    inputs = de.SimInputs(tables=tables, drive=drive, gids=torch.from_numpy(
        gids).to(device))
    if plastic is not None:
        state["plastic"], inputs.inv_slots, inputs.tables = plastic
    sim = de.make_sim_fn(cfg, steps, recorder=recorder_spec(cfg.engine,
                                                            steps),
                         storage=tables.storage, device=device, mesh=mesh)
    state, per, rec = sim(state, inputs)
    return state, per, rec, sim


def ms_events(rec) -> list:
    """Each tile's recorded events as ``step << 32 | gid`` (int64),
    row-major."""
    steps = rec["step"].flatten(0, 1).long()
    gids = rec["gid"].flatten(0, 1).long()
    counts = rec["count"].reshape(-1).tolist()
    return [(s[:c] << 32) | g[:c] for s, g, c in zip(steps, gids, counts)]


def ms_memory(cfg, tables, stats: dict) -> dict:
    """Device bytes per shard the static multi-shard run holds: the
    stacked tables, the run descriptors, the state; beside the port's
    ``shard_memory_bytes`` (the reference's count)."""
    from repro_torch.core import metrics
    from repro_torch.core.dist_engine import tile_tables
    from repro_torch.core.synapses import column_runs, tier_list
    spec = cfg.engine.spec()
    n = MS_TILES ** 2
    runs = sum(r["nbytes"] for v in tile_tables(tables)
               for r in column_runs(tier_list(v), spec.n_per_col,
                                    spec.n_exc_per_col, spec.d_ring)) / n
    tab = sum(x.numel() * x.element_size() for t in tables.tiers()
              for x in t.values()) / n
    state = spec.n_local * (12 + 1 + 4 * spec.d_ring)
    syn = stats["n_synapses"] / n
    model = metrics.shard_memory_bytes(spec, tables.storage)
    return {"tables_bytes_per_shard": tab, "run_descriptor_bytes_per_shard":
            runs, "state_bytes_per_shard": state,
            "synapses_per_shard": syn,
            "bytes_per_synapse_with_descriptor": (tab + runs + state) / syn,
            "shard_memory_bytes": model,
            "shard_memory_bytes_per_realized_synapse": model["total"] / syn,
            "bytes_per_synapse_model": metrics.bytes_per_synapse(
                spec, tables.storage),
            "expected_synapses_interior_shard": spec.expected_synapses()}


def timed_dist_build(law: str) -> tuple:
    """``law``'s 8x8x1240 2x2 tables on the host (each tile's build in a
    thread of its own; phase 5b moves them to the card), and their
    seconds, wall time beside the other host work."""
    from repro_torch.core import dist_engine as de
    t0 = time.perf_counter()
    built = de.build_dist_tables(ms_cfg(law, GRID), device="cpu")
    return built, time.perf_counter() - t0


def run_multishard(law: str, single: dict, build_s: float) -> dict:
    """The static multi-shard path in 2x2 tiles: captured, eager and
    plain runs from the same seed and recorded kernel and plain runs
    (the global raster) at 4x4x1240 (the parity legs), then at 8x8x1240
    the timed run, its profile and the exchange's device time.  The
    8x8x1240 tables come from ``runtime.sim_driver.build_dist_tables``
    inside ``seg_shared_builds``, which holds them built ahead
    (``timed_dist_build``, whose seconds ``build_s`` gives) for this
    call and for phase 5c's gaussian drivers."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import dist_engine as de
    from repro_torch.core import synapses
    from repro_torch.kernels import _build
    from repro_torch.runtime import sim_driver as sd
    label = (f"multi-shard {law} {GRID}x{GRID}x{N_PER_COLUMN} "
             f"{MS_TILES}x{MS_TILES}")
    stage = {}
    t_stage = time.perf_counter()

    def lap(name):
        nonlocal t_stage
        torch.cuda.synchronize()
        now = time.perf_counter()
        stage[name] = now - t_stage
        t_stage = now

    def replays():
        return _build.launch_counts().get("step_graph", 0)

    # the parity legs at 4x4x1240
    cfg = ms_cfg(law, PARITY_GRID)
    plabel = (f"multi-shard {law} {PARITY_GRID}x{PARITY_GRID}x"
              f"{N_PER_COLUMN} {MS_TILES}x{MS_TILES}")
    tables, _ = de.build_dist_tables(cfg)
    lap("parity_host_build")
    inputs = de.SimInputs(tables=tables)
    steps, d = MS_PARITY_STEPS, cfg.engine.d_ring

    # captured, eager (one step a call) and plain, from the same seed
    r0 = replays()
    sim = de.make_sim_fn(cfg, steps, storage=tables.storage)
    cap_state, cap_per = sim(de.init_dist_state(cfg), inputs)
    require(replays() - r0 == (steps - d) // d,
            f"{plabel}: {replays() - r0} replays in {steps} steps")
    builds = dict(synapses.BUILD_COUNTS)
    one = de.make_sim_fn(cfg, 1, storage=tables.storage)
    eag_state = de.init_dist_state(cfg)
    eag_per = torch.cat([one(eag_state, inputs)[1] for _ in range(steps)],
                        dim=2)
    require(one.graph_loop is None and replays() - r0 == (steps - d) // d,
            f"{plabel}: the one-step calls replayed a graph")
    plain = de.DistConfig(engine=dataclasses.replace(cfg.engine,
                                                     use_kernels=False))
    pl_state, pl_per = de.make_sim_fn(plain, steps, storage=tables.storage)(
        de.init_dist_state(plain), inputs)
    torch.cuda.synchronize()
    for other, st, per in (("eager", eag_state, eag_per),
                           ("plain", pl_state, pl_per)):
        require(torch.equal(cap_per, per), f"{plabel}: per-step spikes of "
                f"the captured run differ from the {other} run")
        diff = ms_diff(cap_state, st)
        require(not diff, f"{plabel}: the captured run differs from the "
                f"{other} run in {diff}")
    require(dict(synapses.BUILD_COUNTS) == builds, f"{plabel}: derived "
            f"structures rebuilt after the first step: {builds} -> "
            f"{dict(synapses.BUILD_COUNTS)}")
    lap("captured_eager_plain")
    # the global raster: the recorded kernel path (captured) against the
    # plain path and against one-step eager calls (events concatenated)
    r0 = replays()
    rk_state, rk_per, rec_k, rsim = ms_recorded(cfg, tables,
                                                MS_RECORD_STEPS, "cuda")
    rec_replays = replays() - r0
    require(rsim.captures == 1 and rec_replays == (MS_RECORD_STEPS - d)
            // d, f"{plabel}: the recorded run replayed {rec_replays} times")
    _, _, rec_p, _ = ms_recorded(plain, tables, MS_RECORD_STEPS, "cuda")
    for k in rec_k:
        require(torch.equal(rec_k[k], rec_p[k]), f"{plabel}: recorder {k} "
                "differs between the kernel and plain paths")
    from repro_torch.obs.record import recorder_spec, stacked_gid_maps
    one_rec = de.make_sim_fn(cfg, 1, recorder=recorder_spec(cfg.engine, 1),
                             storage=tables.storage)
    rin = de.SimInputs(tables=tables, gids=torch.from_numpy(
        stacked_gid_maps(cfg.engine.decomp)).cuda())
    re_state = de.init_dist_state(cfg)
    parts = [ms_events(one_rec(re_state, rin)[2])
             for _ in range(MS_RECORD_STEPS)]
    eager_events = [torch.cat(p) for p in zip(*parts)]
    require(all(torch.equal(a, b) for a, b in zip(ms_events(rec_k),
                                                   eager_events))
            and not ms_diff(rk_state, re_state),
            f"{plabel}: the captured recorded run differs from the eager "
            "one-step calls")
    n_spk = rk_state["metrics"]["spikes"].to(torch.int32)
    require(torch.equal(rec_k["dropped"], torch.zeros_like(n_spk))
            and torch.equal(rec_k["count"], n_spk),
            f"{plabel}: the recorder missed spikes at its default capacity")
    require(torch.equal(rk_per, cap_per[..., :MS_RECORD_STEPS]),
            f"{plabel}: recording changed the spikes")
    require(float(cap_per.sum()) > 0, f"{plabel}: no spike in the parity "
            "legs")
    parity_spikes, recorded_events = float(cap_per.sum()), int(
        rec_k["count"].sum())
    lap("recorded")

    # the timed run at 8x8x1240
    cfg = ms_cfg(law, GRID)
    d = cfg.engine.d_ring
    tables, stats = sd.build_dist_tables(cfg, device="cuda")
    inputs = de.SimInputs(tables=tables)
    lap("host_build")
    # a short run first: the tables' run descriptors are built on first
    # use, and the timed run must not carry them
    de.make_sim_fn(cfg, 2 * d, storage=tables.storage)(
        de.init_dist_state(cfg), inputs)
    lap("warm_up")
    state = de.init_dist_state(cfg)
    timed = de.make_sim_fn(cfg, MS_TIMED_STEPS, storage=tables.storage)
    c0 = _build.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, per = timed(state, inputs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c1 = _build.launch_counts()
    per_step = {k: (v - c0.get(k, 0)) / MS_TIMED_STEPS
                for k, v in c1.items() if v != c0.get(k, 0)}
    n_replays = c1.get("step_graph", 0) - c0.get("step_graph", 0)
    require(n_replays == (MS_TIMED_STEPS - d) // d,
            f"{label}: {n_replays} replays in {MS_TIMED_STEPS} steps")
    v = state["neuron"]["v"]
    require(per.shape == (MS_TILES, MS_TILES, MS_TIMED_STEPS) and bool(
        torch.isfinite(v).all() & torch.isfinite(state["neuron"]["c"])
        .all()), f"{label}: unexpected shapes or non-finite state")
    n_active = float(state["active"].sum())
    spikes = float(state["metrics"]["spikes"].sum())
    events = float(state["metrics"]["events"].sum())
    rate = spikes / max(n_active, 1.0) / (MS_TIMED_STEPS * 1e-3)
    rel = abs(rate - single["rate_hz"]) / single["rate_hz"]
    require(rel <= 0.35, f"{label}: rate {rate} Hz against the single "
            f"shard's {single['rate_hz']} Hz (rel {rel:.3f} > 0.35)")
    lap("timed")

    # profile: the idle share of a 400-step run, then the graph's replays
    # alone (device operations per step = graph nodes; the gathers)
    prof_sim = de.make_sim_fn(cfg, MS_PROFILE_STEPS, storage=tables.storage)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prof_sim(state, inputs)
        torch.cuda.synchronize()
        prof_wall_us = (time.perf_counter() - t0) * 1e6
    busy, top = device_breakdown(prof, MS_PROFILE_STEPS)
    graph = prof_sim.graph_loop.graph
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(MS_PROFILE_REPLAYS):
            graph.replay()
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    n_graph_steps = MS_PROFILE_REPLAYS * d
    # the exchange: the bands' gathers (the step's only index kernels)
    gather_us = sum(e.time_range.elapsed_us() for e in dev_events
                    if "index" in e.name or "gather" in e.name.lower())
    replay_busy_us = sum(e.time_range.elapsed_us() for e in dev_events)
    res = {
        "law": law, "grid": f"{GRID}x{GRID}x{N_PER_COLUMN}",
        "tiles": f"{MS_TILES}x{MS_TILES}", "halo_bands": len(tables.halo),
        "host_build_s": build_s, "host_build_concurrent": True,
        "n_synapses": stats["n_synapses"], "steps": MS_TIMED_STEPS,
        "rate_hz": rate, "single_shard_rate_hz": single["rate_hz"],
        "rate_rel_diff": rel, "events_per_step": events / MS_TIMED_STEPS,
        "dropped": float(state["metrics"]["dropped"].sum()),
        "ms_per_step": 1e3 * wall / MS_TIMED_STEPS,
        "single_shard_ms_per_step": single["ms_per_step"],
        "s_per_synaptic_event": wall / max(events, 1.0),
        "step_graph_replays": n_replays, "launches_per_step": per_step,
        "profile_steps": MS_PROFILE_STEPS,
        "profiled_wall_ms_per_step": prof_wall_us / MS_PROFILE_STEPS / 1e3,
        "device_busy_ms_per_step": busy / MS_PROFILE_STEPS / 1e3,
        "device_idle_share": 1.0 - busy / prof_wall_us,
        "idle_share_unprofiled_wall": 1.0 - busy / MS_PROFILE_STEPS / 1e3
        / (1e3 * wall / MS_TIMED_STEPS),
        "top_kernels_ms_per_step": top,
        "graph_device_ops_per_step": len(dev_events) / n_graph_steps,
        "graph_busy_ms_per_step": replay_busy_us / n_graph_steps / 1e3,
        "exchange_gathers_ms_per_step": gather_us / n_graph_steps / 1e3,
        "parity_grid": f"{PARITY_GRID}x{PARITY_GRID}x{N_PER_COLUMN}",
        "parity_steps": steps, "parity_spikes": parity_spikes,
        "recorded_steps": MS_RECORD_STEPS,
        "recorded_events": recorded_events,
        "recorded_step_graph_replays": rec_replays,
    }
    lap("profile_and_exchange_timing")
    # what phase 13's ranks hold their tiles to: every leaf's digest of
    # the parity legs' runs and, for the exponential law, of this build
    res["rank_digests"] = {
        "static": rank_leaf_digests(cap_state, cap_per),
        "recorded": rank_leaf_digests(rk_state, rk_per, rec_k)}
    if law == "exponential":
        res["rank_tables"] = rank_table_digests(tables)
    lap("rank_digests")
    res["stage_s"] = stage
    print(f"{label} path " + json.dumps(res))
    mem = ms_memory(cfg, tables, stats)
    print(f"{label} memory " + json.dumps(mem))
    res["memory"] = mem
    # the state and tables as phase 11 holds them against their abstract
    # counterparts (every leaf's path, shape, dtype and bytes)
    from repro_torch.tree import tree_signature
    res["dist"] = {"cfg": cfg, "storage": tables.storage,
                   "signature": tree_signature((state, tables))}
    return res


def ms_plastic_host(law: str) -> dict:
    """The plastic multi-shard leg's host work at 4x4x1240 in 2x2 tiles
    (one thread a law, each building its tiles in threads of its own):
    the tables and the inverse index."""
    from repro_torch.core import dist_engine as de
    from repro_torch.core.stdp import STDPParams
    cfg = ms_cfg(law, PARITY_GRID, stdp=STDPParams())
    t0 = time.perf_counter()
    cpu_tabs, stats = de.build_dist_tables(cfg, device="cpu")
    slots, aux = de.build_dist_inverse_index(cfg, cpu_tabs)
    return {"law": law, "cfg": cfg, "cpu_tabs": cpu_tabs, "stats": stats,
            "slots": slots, "clipped": aux["clipped"],
            "build_s": time.perf_counter() - t0}


def ms_plastic_card(ctx: dict) -> dict:
    """A drive drawn on the card, and the kernel-path run on the card
    (recorded: the global raster) on ``ms_plastic_host``'s tables."""
    import torch
    from repro_torch.core import engine
    cfg, cpu_tabs, slots = ctx["cfg"], ctx["cpu_tabs"], ctx["slots"]
    n = cfg.engine.spec().n_local
    gen = torch.Generator(device="cuda")
    gen.manual_seed(77)
    drive = torch.stack([torch.stack([engine.external_drive(
        gen, n, cfg.engine) for _ in range(MS_TILES ** 2)])
        for _ in range(MS_PLASTIC_STEPS)]).view(
            MS_PLASTIC_STEPS, MS_TILES, MS_TILES, n)
    tabs = cpu_tabs.to("cuda")
    t0 = time.perf_counter()
    card = ms_recorded(cfg, tabs, MS_PLASTIC_STEPS, "cuda", drive,
                       ms_carry(cfg, tabs, slots.cuda()))
    torch.cuda.synchronize()
    return dict(ctx, drive=drive.cpu(), card=card,
                card_s=time.perf_counter() - t0)


def ms_carry(cfg, tables, slots) -> tuple:
    from repro_torch.core import dist_engine as de
    return (de.init_dist_plastic_state(cfg, tables), slots,
            de.fold_plastic_tables(tables))


def ms_plastic_cpu(ctx: dict) -> tuple:
    """The plain path of ``ms_plastic_card``'s run on the CPU."""
    from repro_torch.core import dist_engine as de
    cfg = ctx["cfg"]
    plain = de.DistConfig(engine=dataclasses.replace(cfg.engine,
                                                     use_kernels=False))
    t0 = time.perf_counter()
    run = ms_recorded(plain, ctx["cpu_tabs"], MS_PLASTIC_STEPS, "cpu",
                      ctx["drive"], ms_carry(plain, ctx["cpu_tabs"],
                                             ctx["slots"]))
    return run, time.perf_counter() - t0


def ms_plastic_check(ctx: dict, cpu_run: tuple, cpu_s: float) -> dict:
    """The card's kernel path against the CPU plain path, bit for bit."""
    import torch
    law, stats, slots = ctx["law"], ctx["stats"], ctx["slots"]
    label = (f"multi-shard plastic {law} {PARITY_GRID}x{PARITY_GRID}x"
             f"{N_PER_COLUMN} {MS_TILES}x{MS_TILES}")
    require(ctx["clipped"] == 0, f"{label}: the inverse index clipped")
    sk, pk, rk, sim = ctx["card"]
    sp, pp, rp, _ = cpu_run
    require(torch.equal(pk.cpu(), pp), f"{label}: per-step spikes differ")
    for k in rk:
        require(torch.equal(rk[k].cpu(), rp[k]),
                f"{label}: raster ({k}) differs")
    diff = ms_diff(sk, sp)
    require(not diff, f"{label}: the card's kernel path differs from the "
            f"CPU plain path in {diff}")
    changed = [int((w.cpu() != t["w"]).sum()) for w, t in
               zip(sk["plastic"]["w"], ctx["cpu_tabs"].tiers())]
    # a band whose sources all lie outside the 4x4 slab (the exponential
    # law's bands beyond two columns) reads only the sink: it cannot learn
    sink = MS_TILES ** 2 * sim.n_local
    sources = [int((m != sink).sum()) for m in sim.maps]
    require(changed[0] > 0 and all(c > 0 for c, n in zip(changed[1:], sources)
                                   if n), f"{label}: weights changed per "
            f"tier {changed}, in-slab sources per band {sources}")
    n_tiles = MS_TILES ** 2
    pl = sk["plastic"]
    carry_bytes = sum(x.numel() * x.element_size()
                      for x in pl["w"] + pl["x_pre"] + [pl["x_post"]])
    slot_bytes = slots.numel() * slots.element_size()
    tm_bytes = sum(i["tm"].numel() for i in sim.tiles.inv)
    mask_bytes = sum(x.numel() * x.element_size()
                     for t in sim.tiles.masks for x in t)
    res = {"law": law, "grid": f"{PARITY_GRID}x{PARITY_GRID}x{N_PER_COLUMN}",
           "tiles": f"{MS_TILES}x{MS_TILES}", "steps": MS_PLASTIC_STEPS,
           "spikes": float(pk.sum()), "weights_changed_per_tier": changed,
           "in_slab_sources_per_band": sources,
           "host_build_s": ctx["build_s"], "host_build_concurrent": True,
           "card_s": ctx["card_s"],
           "cpu_plain_s": cpu_s, "n_synapses": stats["n_synapses"],
           "carry_bytes_per_shard": carry_bytes / n_tiles,
           "inverse_index_slots_bytes_per_shard": slot_bytes / n_tiles,
           "target_major_bytes_per_shard": tm_bytes / n_tiles,
           "float32_mask_bytes_per_shard": mask_bytes / n_tiles,
           "bytes_per_synapse_carry_index_tm_masks": (
               carry_bytes + slot_bytes + tm_bytes + mask_bytes)
               / stats["n_synapses"]}
    print(f"{label} parity (card kernel path == CPU plain path: raster, "
          "every tier's w, traces, ring, v, c, refrac, metrics) "
          + json.dumps(res))
    res["rank_digests"] = {"plastic": rank_leaf_digests(sk, pk, rk)}
    res["drive"] = ctx["drive"]
    return res


# ---------------------------------------------------------------------------
# phase 13: the SNN on ranks (four processes, one tile each, one card)
# ---------------------------------------------------------------------------

def leaf_digest(x) -> str:
    """sha-256 of a tensor's (or array's) shape, dtype and bytes."""
    import hashlib
    import numpy as np
    import torch
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous().cpu()
        head = f"{tuple(t.shape)} {t.dtype}"
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
    else:
        a = np.ascontiguousarray(x)
        head, raw = f"{a.shape} {a.dtype}", a.tobytes()
    return hashlib.sha256(head.encode() + raw).hexdigest()


def tile_blocks(n_y: int, n_x: int):
    return [(y, x) for y in range(n_y) for x in range(n_x)]


def run_leaves(state, per, rec=None) -> dict:
    """A multi-shard run's leaves by name (stacked or a rank's block)."""
    out = {"per_step": per, "i_ring": state["i_ring"], "t": state["t"]}
    out.update({f"neuron_{k}": v for k, v in state["neuron"].items()})
    out.update({f"metrics_{k}": v for k, v in state["metrics"].items()})
    if "plastic" in state:
        pl = state["plastic"]
        out.update({f"w_{i}": w for i, w in enumerate(pl["w"])})
        out["x_pre"], out["x_post"] = pl["x_pre"][0], pl["x_post"]
    if rec is not None:
        out.update({f"rec_{k}": v for k, v in rec.items()})
    return out


def rank_leaf_digests(state, per, rec=None) -> dict:
    """Per tile ``"y,x"``: the digest of each leaf's ``[y:y+1, x:x+1]``
    block of a stacked run (a rank's own block hashes the same)."""
    leaves = run_leaves(state, per, rec)
    return {f"{y},{x}": {k: leaf_digest(v[y:y + 1, x:x + 1])
                         for k, v in leaves.items()}
            for y, x in tile_blocks(MS_TILES, MS_TILES)}


def rank_table_digests(tables) -> dict:
    """Per tile: each tier leaf's digest of its block, and the storage
    descriptor."""
    out = {}
    for y, x in tile_blocks(MS_TILES, MS_TILES):
        d = {f"t{i}_{k}": leaf_digest(v[y:y + 1, x:x + 1])
             for i, tier in enumerate(tables.tiers())
             for k, v in tier.items()}
        d["storage"] = json.dumps(tables.storage.meta(), sort_keys=True)
        out[f"{y},{x}"] = d
    return out


def rank_diff(want: dict, got: dict) -> list:
    return sorted(k for k in set(want) | set(got) if want.get(k) != got.get(k))


def ranks_rank(rank: int, world: int, job_path: str) -> None:
    """One rank of phase 13 (``launch.mesh.spawn_ranks`` runs it): the
    parity legs, the construction and the timed leg on this rank's tile;
    it writes its verdicts, times and launch counts to
    ``build/ranks/rank_<r>.json``."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import dist_engine as de
    from repro_torch.core import halo
    from repro_torch.core.stdp import STDPParams
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_host_mesh
    job = torch.load(job_path, weights_only=False)
    torch.cuda.set_device(0)
    mesh = make_host_mesh((MS_TILES, MS_TILES))
    out = {"rank": rank, "errors": [], "build_s": {}}
    _build.reset_launch_counts()
    t_rank = time.perf_counter()
    for law in LAWS:
        cfg = ms_cfg(law, PARITY_GRID)
        y, x = de.rank_tile(cfg, mesh)
        tile = f"{y},{x}"
        out["tile"] = [y, x]
        want = job[law]
        t0 = time.perf_counter()
        tables, _ = de.build_dist_tables(cfg, mesh=mesh)
        out["build_s"][f"{law}_parity"] = time.perf_counter() - t0
        sim = de.make_sim_fn(cfg, MS_PARITY_STEPS, storage=tables.storage,
                             mesh=mesh)
        state, per = sim(de.init_dist_state(cfg, mesh=mesh),
                         de.SimInputs(tables=tables))
        got = {k: leaf_digest(v) for k, v in run_leaves(state, per).items()}
        bad = rank_diff(want["static"][tile], got)
        if bad:
            out["errors"].append(f"{law} static {MS_PARITY_STEPS} steps: "
                                 f"{bad}")
        st, per, rec, _ = ms_recorded(cfg, tables, MS_RECORD_STEPS, "cuda",
                                      mesh=mesh)
        got = {k: leaf_digest(v)
               for k, v in run_leaves(st, per, rec).items()}
        bad = rank_diff(want["recorded"][tile], got)
        if bad:
            out["errors"].append(f"{law} recorded {MS_RECORD_STEPS} steps: "
                                 f"{bad}")
        del tables, sim, state, st, rec
        pcfg = ms_cfg(law, PARITY_GRID, stdp=STDPParams())
        t0 = time.perf_counter()
        cpu_tabs, _ = de.build_dist_tables(pcfg, device="cpu", mesh=mesh)
        slots, _ = de.build_dist_inverse_index(pcfg, cpu_tabs, mesh=mesh)
        out["build_s"][f"{law}_plastic"] = time.perf_counter() - t0
        tabs = cpu_tabs.to("cuda")
        drive = want["drive"][:, y:y + 1, x:x + 1].cuda()
        st, per, rec, _ = ms_recorded(pcfg, tabs, MS_PLASTIC_STEPS, "cuda",
                                      drive, ms_carry(pcfg, tabs,
                                                      slots.cuda()),
                                      mesh=mesh)
        got = {k: leaf_digest(v)
               for k, v in run_leaves(st, per, rec).items()}
        bad = rank_diff(want["plastic"][tile], got)
        if bad:
            out["errors"].append(f"{law} plastic {MS_PLASTIC_STEPS} steps: "
                                 f"{bad}")
        del cpu_tabs, tabs, st, rec
    # construction: this rank's tile of the exponential 8x8x1240 tables
    cfg = ms_cfg("exponential", GRID)
    y, x = de.rank_tile(cfg, mesh)
    dist.barrier()
    t0 = time.perf_counter()
    tables, stats = de.build_dist_tables(cfg, mesh=mesh)
    torch.cuda.synchronize()
    out["build_s"]["exponential_8x8"] = time.perf_counter() - t0
    got = {f"t{i}_{k}": leaf_digest(v) for i, tier in enumerate(
        tables.tiers()) for k, v in tier.items()}
    got["storage"] = json.dumps(tables.storage.meta(), sort_keys=True)
    bad = rank_diff(job["tables"][f"{y},{x}"], got)
    if bad:
        out["errors"].append(f"exponential 8x8 tables differ: {bad}")
    out["n_synapses"] = stats["n_synapses"]
    # the timed leg: a warm-up (the column descriptors are built at
    # first use), then RANK_TIMED_STEPS steps after a barrier
    inputs = de.SimInputs(tables=tables)
    state = de.init_dist_state(cfg, mesh=mesh)
    de.make_sim_fn(cfg, 2 * cfg.engine.d_ring, storage=tables.storage,
                   mesh=mesh)(state, inputs)
    timed = de.make_sim_fn(cfg, RANK_TIMED_STEPS, storage=tables.storage,
                           mesh=mesh)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    state, per = timed(state, inputs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tr = timed.transport
    spec, d = cfg.engine.spec(), cfg.engine.decomp
    per_col = halo.packed_width(spec.n_exc_per_col)
    out.update({
        "ms_per_step": 1e3 * wall / RANK_TIMED_STEPS,
        "exchange_ms_per_step": 1e3 * tr.seconds / RANK_TIMED_STEPS,
        "bytes_sent_per_step": tr.bytes_sent / RANK_TIMED_STEPS,
        "bytes_received_per_step": tr.bytes_received / RANK_TIMED_STEPS,
        "halo_import_bytes": halo.halo_import_bytes(
            d.tile_h, d.tile_w, d.radius, per_col, cfg.halo_mode,
            tiles=cfg.tiles, at=(y, x)),
        "spikes": float(state["metrics"]["spikes"].sum()),
        "finite": bool(torch.isfinite(state["neuron"]["v"]).all()),
        "per_step_shape": list(per.shape),
        "launches": _build.launch_counts()})
    # where a rank's step goes: RANK_PROFILE_STEPS more steps, rank 0's
    # under the profiler (its own process's kernels), its peers' plain
    prof_sim = de.make_sim_fn(cfg, RANK_PROFILE_STEPS,
                              storage=tables.storage, mesh=mesh)
    dist.barrier()
    if rank == 0:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            prof_sim(state, inputs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy, top = device_breakdown(prof, RANK_PROFILE_STEPS)
        out["profile"] = {
            "steps": RANK_PROFILE_STEPS,
            "wall_ms_per_step": 1e3 * wall / RANK_PROFILE_STEPS,
            "device_busy_ms_per_step": busy / RANK_PROFILE_STEPS / 1e3,
            "exchange_ms_per_step": 1e3 * prof_sim.transport.seconds
            / RANK_PROFILE_STEPS,
            "top_kernels_ms_per_step": top}
    else:
        prof_sim(state, inputs)
        torch.cuda.synchronize()
    out["rank_s"] = time.perf_counter() - t_rank
    Path(job_path).with_name(f"rank_{rank}.json").write_text(
        json.dumps(out))


def run_ranks(ms_runs: dict, ms_plastic: list) -> dict:
    """Phase 13: four ranks on the one card against phase 5b's stacked
    runs.  Returns the ranks' summed launches."""
    import torch
    from repro_torch.launch.mesh import RankFailure, spawn_ranks
    work = ROOT / "build" / "ranks"
    work.mkdir(parents=True, exist_ok=True)
    for f in work.glob("rank_*.json"):
        f.unlink()
    job = {law: {**ms_runs[law]["rank_digests"]} for law in LAWS}
    for res in ms_plastic:
        job[res["law"]].update(res["rank_digests"])
        job[res["law"]]["drive"] = res["drive"]
    job["tables"] = ms_runs["exponential"]["rank_tables"]
    job_path = work / "job.pt"
    torch.save(job, job_path)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        spawn_ranks(ranks_rank, RANKS, args=(str(job_path),),
                    backend="gloo", timeout_s=RANK_TIMEOUT_S,
                    store_dir=str(work))
    except RankFailure as e:
        fail(f"phase 13: a rank failed: {e}")
    wall = time.perf_counter() - t0
    ranks = [json.loads((work / f"rank_{r}.json").read_text())
             for r in range(RANKS)]
    errors = [(r["rank"], e) for r in ranks for e in r["errors"]]
    require(not errors, f"phase 13: a rank's tile differs from phase 5b's "
            f"stacked run: {errors}")
    for r in ranks:
        require(r["bytes_received_per_step"] == r["halo_import_bytes"],
                f"phase 13: rank {r['rank']} received "
                f"{r['bytes_received_per_step']} B a step, "
                f"halo_import_bytes {r['halo_import_bytes']}")
        require(r["finite"] and r["per_step_shape"] == [1, 1,
                                                        RANK_TIMED_STEPS]
                and r["spikes"] > 0, f"phase 13: rank {r['rank']}'s timed "
                "run is not finite, of the wrong shape or silent")
    require(sum(r["bytes_sent_per_step"] for r in ranks)
            == sum(r["bytes_received_per_step"] for r in ranks),
            "phase 13: bytes sent and received differ")
    require(all(r["n_synapses"] == ms_runs["exponential"]["n_synapses"]
                for r in ranks),
            "phase 13: the ranks' synapse count is not the stacked build's")
    launches = {}
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    for name in ("neuron_step", "event_delivery", "plastic_delivery_ltd",
                 "spike_compact"):
        require(launches.get(name, 0) > 0,
                f"kernel {name} was not launched on the ranks")
    require("step_graph" not in launches,
            "a rank replayed a graph (a host-staged exchange is eager)")
    stacked = ms_runs["exponential"]
    res = {
        "ranks": RANKS, "mesh": f"{MS_TILES}x{MS_TILES}",
        "transport": "gloo (CUDA strips staged through pinned host "
                     "memory)",
        "parity": f"{PARITY_GRID}x{PARITY_GRID}x{N_PER_COLUMN}: static "
                  f"{MS_PARITY_STEPS}, recorded {MS_RECORD_STEPS}, plastic "
                  f"{MS_PLASTIC_STEPS} steps, both laws == phase 5b's "
                  "stacked runs (every leaf's sha-256)",
        "timed": f"exponential {GRID}x{GRID}x{N_PER_COLUMN}, "
                 f"{RANK_TIMED_STEPS} steps a rank, eager",
        "ms_per_step_slowest_rank": max(r["ms_per_step"] for r in ranks),
        "ms_per_step_by_rank": [r["ms_per_step"] for r in ranks],
        "exchange_ms_per_step_by_rank": [r["exchange_ms_per_step"]
                                         for r in ranks],
        "bytes_sent_per_step_by_rank": [r["bytes_sent_per_step"]
                                        for r in ranks],
        "bytes_received_per_step_by_rank": [r["bytes_received_per_step"]
                                            for r in ranks],
        "halo_import_bytes_by_rank": [r["halo_import_bytes"] for r in ranks],
        "stacked_2x2_ms_per_step_phase_5b": stacked["ms_per_step"],
        "stacked_2x2_host_build_s_phase_5b": stacked["host_build_s"],
        "rank0_profile": ranks[0]["profile"],
        "rank_build_s": [r["build_s"] for r in ranks],
        "rank_s": [r["rank_s"] for r in ranks],
        "spawn_to_join_s": wall, "launches": launches}
    print("ranks " + json.dumps(res))
    return launches


# ---------------------------------------------------------------------------
# phase 14: the LM on ranks (four processes on one card, pod 2 x model 2)
# ---------------------------------------------------------------------------

def lm_rank_mesh():
    """This rank's (pod 2, data 1, model 2) mesh with its collectives
    (gloo: CUDA tensors staged through pinned host memory)."""
    from repro_torch.core.halo import Transport
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.collectives import attach
    return attach(make_host_mesh(*LM_RANK_MESH), Transport("gloo", "cuda"))


def lm_rank_parity(arch: str, mesh) -> dict:
    """One float32 parity leg of phase 14 on this rank, through the
    ``--nproc`` train code (``launch.train.rules_for`` / ``rank_model``,
    ``data.pipeline.rank_batch``): the reduced ``arch`` (a MoE at
    capacity factor 8, so that nothing drops: EP and one card agree
    only then) with ``attn_impl="pallas"`` (the 3xTF32 flash kernel).
    The single-process step on the card from the same seed and batch is
    the reference: the exact rank step's loss and grad norm within
    ``LM_RANK_LOSS_TOL`` and every leaf block within ``LM_RANK_LEAF_TOL``
    (error norm over norm; the elements whose one-card gradient lies
    within ``LM_RANK_FLAT_GRAD`` of zero, which AdamW's first update
    ``g / (|g| + 1e-8)`` moves by up to lr on rounding, within lr).
    Then ``LM_RANK_POD_STEPS`` compressed pod steps: the first loss the
    exact step's (``LM_RANK_LOSS_TOL``), its parameters within
    ``LM_RANK_POD_PARAM_TOL`` of the exact step's, the last loss below
    the first.  Returns the verdicts and figures."""
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import LMBatchPipeline, rank_batch
    from repro_torch.launch.train import rank_model, rules_for
    from repro_torch.models import model as M
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.transformer import init_model
    from repro_torch.optim import adamw, constant
    from repro_torch.optim.compression import init_residuals
    from repro_torch.parallel import sharding as S
    from repro_torch.tree import tree_flatten
    cfg = dataclasses.replace(get_reduced(arch), attn_impl="pallas")
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    rules = rules_for(cfg, mesh)
    pipe = LMBatchPipeline(cfg, ShapeConfig(
        "train", LM_RANK_PARITY_SEQ, LM_RANK_PARITY_BATCH, "train"), seed=0)
    whole_batch = {k: torch.from_numpy(v).cuda()
                   for k, v in pipe.batch(0).items()}
    batch = rank_batch(whole_batch, rules)
    opt = adamw(constant(LM_RANK_LR))
    # one card
    one = init_model(cfg, 0, device="cuda")
    _, _, g_one = M._grads_of(one, cfg, whole_batch)
    one, _, out_one = M.make_train_step(cfg, opt)(one, opt.init(one),
                                                 whole_batch)
    # the exact rank step
    blocks, specs = rank_model(cfg, rules, 0, "cuda")
    exact, _, out = M.make_train_step(cfg, opt, rules=rules)(
        blocks, opt.init(blocks), batch)
    names = S.spec_leaves(specs)
    errors, worst, flat_n = [], 0.0, 0
    for key in ("loss", "grad_norm"):
        gap = abs(float(out[key]) / float(out_one[key]) - 1.0)
        if not gap <= LM_RANK_LOSS_TOL:
            errors.append(f"{arch} exact {key}: {float(out[key])} vs one "
                          f"card {float(out_one[key])}")
    for w, g, grad, n in zip(tree_flatten(one)[0], tree_flatten(exact)[0],
                             tree_flatten(g_one)[0], names):
        w = S.block(w, n, rules).float()
        g = g.float()
        flat = S.block(grad, n, rules).abs() < LM_RANK_FLAT_GRAD
        flat_n += int(flat.sum())
        if flat.any() and float((g - w).abs()[flat].max()) > LM_RANK_LR:
            errors.append(f"{arch} exact {n}: a flat element past lr")
        g = torch.where(flat, w, g)
        err = float((g - w).norm() / w.norm().clamp_min(1e-30))
        worst = max(worst, err)
        if not err <= LM_RANK_LEAF_TOL:
            errors.append(f"{arch} exact leaf {n}: {err:.3g}")
    # the compressed pod step
    blocks, _ = rank_model(cfg, rules, 0, "cuda")
    state, resid = opt.init(blocks), init_residuals(blocks)
    step = M.make_compressed_pod_train_step(cfg, rules, opt)
    losses, diff = [], None
    for i in range(LM_RANK_POD_STEPS):
        blocks, state, resid, o = step(blocks, state, resid, batch)
        losses.append(float(o["loss"]))
        if i == 0:
            diff = max(float((a - b).abs().max()) for a, b in zip(
                tree_flatten(exact)[0], tree_flatten(blocks)[0]))
    if not abs(losses[0] / float(out["loss"]) - 1.0) <= LM_RANK_LOSS_TOL:
        errors.append(f"{arch} compressed loss {losses[0]} vs exact "
                      f"{float(out['loss'])}")
    if not diff <= LM_RANK_POD_PARAM_TOL:
        errors.append(f"{arch} compressed parameters {diff} from exact")
    if not losses[-1] < losses[0]:
        errors.append(f"{arch} compressed losses do not fall: {losses}")
    return {"errors": errors, "loss_one_card": float(out_one["loss"]),
            "loss_exact": float(out["loss"]),
            "grad_norm_one_card": float(out_one["grad_norm"]),
            "grad_norm_exact": float(out["grad_norm"]),
            "worst_leaf_rel_err": worst, "flat_elements": flat_n,
            "compressed_losses": losses, "compressed_param_diff": diff}


def lm_ranks_rank(rank: int, world: int, job_path: str) -> None:
    """One rank of phase 14 (``launch.mesh.spawn_ranks`` runs it): the
    parity legs, then granite-moe-1b-a400m at full width (bf16,
    ``attn_impl="pallas"``): its blocks under ``launch.train.rules_for``
    (heads, experts and the vocabulary split over ``model``, the batch
    over ``pod``), one ``make_eval_step`` loss, ``LM_RANK_STEPS``
    compressed pod steps (AdamW) with the launch counts zeroed just
    before and read just after.  It writes ``build/lm_ranks/rank_<r>
    .json``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import LMBatchPipeline, rank_batch
    from repro_torch.kernels import _build
    from repro_torch.launch.train import rank_model, rules_for
    from repro_torch.models import model as M
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw, constant
    from repro_torch.optim.compression import (CompressedAllReduce,
                                               init_residuals)
    from repro_torch.parallel.collectives import stats
    from repro_torch.tree import tree_flatten
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    t_rank = time.perf_counter()
    mesh = lm_rank_mesh()
    out = {"rank": rank, "coordinate": list(mesh.coordinate()),
           "parity": {a: lm_rank_parity(a, mesh) for a in LM_RANK_PARITY}}
    out["parity_s"] = time.perf_counter() - t_rank
    # full width
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(LM_RANK_ARCH), attn_impl="pallas")
    rules = rules_for(cfg, mesh)
    t0 = time.perf_counter()
    blocks, _ = rank_model(cfg, rules, 0, "cuda")
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["params_per_rank"] = sum(x.numel() for x in tree_flatten(blocks)[0])
    out["param_bytes"] = sum(x.numel() * x.element_size()
                             for x in tree_flatten(blocks)[0])
    pipe = LMBatchPipeline(cfg, ShapeConfig("train", LM_RANK_SEQ,
                                            LM_RANK_BATCH, "train"), seed=0)
    batch = {k: v.cuda() for k, v in rank_batch(pipe.batch(0),
                                                rules).items()}
    loss_e, metrics_e = M.make_eval_step(cfg, rules)(blocks, batch)
    out["eval_loss"] = float(loss_e)
    out["eval_frac_dropped"] = float(metrics_e["frac_dropped"]) \
        / cfg.layer_kinds.count("moe")
    opt = adamw(constant(LM_RANK_FULL_LR))
    state, resid = opt.init(blocks), init_residuals(blocks)
    step = M.make_compressed_pod_train_step(cfg, rules, opt)
    car = CompressedAllReduce()
    out["wire_bytes"] = sum(car.wire_bytes(x.numel())
                            for x in tree_flatten(blocks)[0])
    _build.reset_launch_counts()
    mesh.comm.reset_stats()
    steps = []
    for _ in range(LM_RANK_STEPS):
        dist.barrier()
        torch.cuda.synchronize()
        before = stats(mesh)
        t0 = time.perf_counter()
        blocks, state, resid, o = step(blocks, state, resid, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        after = stats(mesh)
        steps.append({
            "s": dt, "loss": float(o["loss"]),
            "grad_norm": float(o["grad_norm"]),
            "frac_dropped": float(o["frac_dropped"])
            / cfg.layer_kinds.count("moe"),
            "channels": {k: {f: v[f] - before.get(k, {}).get(f, 0)
                             for f in v} for k, v in after.items()}})
    out["launches"] = _build.launch_counts()
    out["steps"] = steps
    out["finite"] = bool(all(np.isfinite([s["loss"], s["grad_norm"]]).all()
                             for s in steps))
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["rank_s"] = time.perf_counter() - t_rank
    Path(job_path).with_name(f"rank_{rank}.json").write_text(
        json.dumps(out))


def one_card_evals(cfg, params, batch: dict) -> dict:
    """The single-process eval on the card of ``batch`` whole, and of
    each pod's own sequences (the pod-major halves the ranks take),
    combined as the ranks' loss is: ``sum nll / sum n`` plus the pods'
    mean router terms.  The MoE's capacity follows the token count, so
    only the per-pod evals drop what the ranks drop (the reference's EP
    takes its capacity per shard too); the load-balance term on ranks
    is over the global means, within ~1e-5 of the pods' mean here."""
    from repro_torch.models import model as M
    step = M.make_eval_step(cfg)
    n_moe = cfg.layer_kinds.count("moe")
    loss, m = step(params, batch)
    out = {"eval_loss_whole_batch": float(loss),
           "frac_dropped_whole_batch": float(m["frac_dropped"]) / n_moe}
    pods = LM_RANK_MESH[0][0]
    rows = LM_RANK_BATCH // pods
    nll = n = router = dropped = 0.0
    for p in range(pods):
        part = {k: v[p * rows:(p + 1) * rows] for k, v in batch.items()}
        _, m = step(params, part)
        nll += float(m["nll"])
        n += float(m["tokens"])
        router += (cfg.router_aux_coef * float(m["load_balance"])
                   + 1e-4 * float(m["router_z"])) / pods
        dropped += float(m["frac_dropped"]) / n_moe / pods
    out.update(eval_loss=nll / n + router, frac_dropped=dropped)
    return out


def run_lm_ranks() -> dict:
    """Phase 14: the single-process eval losses of granite-moe-1b-a400m
    at full width on the card (``one_card_evals``; freed before the
    spawn), the dry run's bytes per rank, then four rank processes
    (``lm_ranks_rank``), their figures, and the gates.  Returns the
    ranks' summed launches."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import LMBatchPipeline
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import RankFailure, RankMesh, spawn_ranks
    from repro_torch.launch.train import rules_for
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.transformer import init_model
    from repro_torch.optim import adamw, constant
    work = ROOT / "build" / "lm_ranks"
    work.mkdir(parents=True, exist_ok=True)
    for f in work.glob("rank_*.json"):
        f.unlink()
    cfg = dataclasses.replace(get_config(LM_RANK_ARCH), attn_impl="pallas")
    gc.collect()
    torch.cuda.empty_cache()
    pipe = LMBatchPipeline(cfg, ShapeConfig("train", LM_RANK_SEQ,
                                            LM_RANK_BATCH, "train"), seed=0)
    params = init_model(cfg, 0, device="cuda")
    batch = {k: torch.from_numpy(v).cuda() for k, v in pipe.batch(0).items()}
    one = one_card_evals(cfg, params, batch)
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    rules = rules_for(cfg, RankMesh(*LM_RANK_MESH))
    planned = dryrun.rank_bytes(cfg, rules, adamw(constant(1.0)),
                                residuals=True)
    print(f"lm ranks: parent holds {torch.cuda.memory_allocated()} B "
          f"({torch.cuda.memory_reserved()} B reserved) before the spawn",
          flush=True)
    job_path = work / "job.json"
    job_path.write_text(json.dumps(one))
    t0 = time.perf_counter()
    try:
        spawn_ranks(lm_ranks_rank, RANKS, args=(str(job_path),),
                    backend="gloo", timeout_s=LM_RANK_TIMEOUT_S,
                    store_dir=str(work))
    except RankFailure as e:
        fail(f"phase 14: a rank failed: {e}")
    wall = time.perf_counter() - t0
    ranks = [json.loads((work / f"rank_{r}.json").read_text())
             for r in range(RANKS)]
    launches = {}
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    timed = range(1, LM_RANK_STEPS)       # the first step warms the caches
    s_step = max(sum(r["steps"][i]["s"] for i in timed) / len(timed)
                 for r in ranks)

    def per_step_of(r, channel, field):
        return sum(r["steps"][i]["channels"].get(channel, {}).get(field, 0)
                   for i in timed) / len(timed)
    channels = sorted({c for r in ranks for st in r["steps"]
                       for c in st["channels"]})
    res = {
        "ranks": RANKS, "mesh": dict(zip(LM_RANK_MESH[1], LM_RANK_MESH[0])),
        "transport": "gloo (CUDA tensors staged through pinned host "
                     "memory)",
        "parity": {a: {k: v for k, v in ranks[0]["parity"][a].items()
                       if k != "errors"} for a in LM_RANK_PARITY},
        "parity_rank_losses": {a: [r["parity"][a]["loss_exact"]
                                   for r in ranks] for a in LM_RANK_PARITY},
        "full_width": f"{LM_RANK_ARCH} {cfg.n_layers} layers, d_model "
                      f"{cfg.d_model}, {cfg.n_experts} experts top-"
                      f"{cfg.moe_top_k}, bf16, {LM_RANK_BATCH} x "
                      f"{LM_RANK_SEQ}, AdamW",
        "params_per_rank": [r["params_per_rank"] for r in ranks],
        "one_card": one,
        "eval_loss_ranks": [r["eval_loss"] for r in ranks],
        "frac_dropped_ranks_eval": [r["eval_frac_dropped"] for r in ranks],
        "losses": [[st["loss"] for st in r["steps"]] for r in ranks],
        "grad_norms": [st["grad_norm"] for st in ranks[0]["steps"]],
        "frac_dropped_steps": [st["frac_dropped"] for st in
                               ranks[0]["steps"]],
        "s_per_step_slowest_rank": s_step,
        "s_per_step_by_rank": [[st["s"] for st in r["steps"]]
                               for r in ranks],
        "tokens_per_s": LM_RANK_BATCH * LM_RANK_SEQ / s_step,
        "wire_bytes_per_rank": [r["wire_bytes"] for r in ranks],
        "per_step_rank0": {c: {f: per_step_of(ranks[0], c, f) for f in (
            "calls", "bytes_sent", "bytes_received", "seconds")}
            for c in channels},
        "collectives_per_step": [sum(per_step_of(r, c, "calls")
                                     for c in channels) for r in ranks],
        "collective_s_per_step": [sum(per_step_of(r, c, "seconds")
                                      for c in channels) for r in ranks],
        "peak_gb_by_rank": [r["peak_bytes"] / 1e9 for r in ranks],
        "dryrun_gb_per_rank": {k: v / 1e9 for k, v in planned.items()},
        "flash_launches_per_rank_per_step": [
            r["launches"].get("flash_attention", 0) / LM_RANK_STEPS
            for r in ranks],
        "init_s": [r["init_s"] for r in ranks],
        "parity_s": [r["parity_s"] for r in ranks],
        "rank_s": [r["rank_s"] for r in ranks],
        "spawn_to_join_s": wall, "launches": launches,
        "card": gpu_line()}
    print("lm ranks " + json.dumps(res), flush=True)
    errors = [(r["rank"], e) for r in ranks for leg in r["parity"].values()
              for e in leg["errors"]]
    require(not errors, f"phase 14: parity legs failed: {errors}")
    per_step = 2 * cfg.layer_kinds.count("moe") \
        + 2 * cfg.layer_kinds.count("attn")
    for r in ranks:
        gap = abs(r["eval_loss"] / one["eval_loss"] - 1.0)
        require(gap <= LM_RANK_EVAL_TOL, f"phase 14: rank {r['rank']}'s "
                f"eval loss {r['eval_loss']} vs one card's "
                f"{one['eval_loss']} ({gap:.3g} > {LM_RANK_EVAL_TOL})")
        first = r["steps"][0]["loss"]
        require(abs(first / r["eval_loss"] - 1.0) <= LM_RANK_LOSS_TOL,
                f"phase 14: rank {r['rank']}'s first step loss {first}, "
                f"its eval loss {r['eval_loss']}")
        require(r["finite"], f"phase 14: rank {r['rank']}: a loss or "
                "grad norm is not finite")
        for i, st in enumerate(r["steps"]):
            sent = st["channels"]["pod"]["bytes_sent"]
            require(sent == r["wire_bytes"], f"phase 14: rank {r['rank']} "
                    f"step {i} put {sent} B on the pod wire, wire_bytes "
                    f"{r['wire_bytes']}")
        flash = r["launches"].get("flash_attention", 0)
        require(flash == LM_RANK_STEPS * per_step,
                f"phase 14: rank {r['rank']} launched flash {flash} times "
                f"in {LM_RANK_STEPS} steps, not {per_step} a step")
    return launches


# ---------------------------------------------------------------------------
# phase 5c: the segmented driver (checkpoints, resume, spool, retile)
# ---------------------------------------------------------------------------

def seg_leaves(state) -> list:
    """Every leaf of a stacked state as the checkpoint store sees it
    (tensors, ``t``, each generator's state bytes), on the host."""
    from repro_torch.tree import tree_flatten
    from repro_torch.core.dist_engine import state_tree
    import numpy as np
    out = []
    for x in tree_flatten(state_tree(state))[0]:
        x = x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)
        out.append(x.view(np.uint8) if x.dtype.kind in "fiub" and x.ndim
                   else x)
    return out


def seg_same(a, b, label: str) -> None:
    la, lb = seg_leaves(a), seg_leaves(b)
    same = len(la) == len(lb) and all(
        x.shape == y.shape and (x == y).all() for x, y in zip(la, lb))
    require(same, f"{label}: the states differ (tensors, t or generator "
            "states)")


def seg_spool(run: Path, spk_only: bool = False) -> dict:
    """Every file of a run's spool (member streams included) by relative
    path; only the ``.spk`` logs with ``spk_only``."""
    d = run / "spool"
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()
            and (not spk_only or p.suffix == ".spk")}


def seg_overlap(tel) -> dict:
    """How the writer thread's device-to-host copies overlap the main
    thread's segment compute: spans that overlap and the overlapped
    seconds."""
    comp = [(s["t0"], s["t0"] + s["dur"]) for s in
            tel.spans("segment.compute")]
    n, secs = 0, 0.0
    for s in tel.spans("ckpt.d2h"):
        a, b = s["t0"], s["t0"] + s["dur"]
        ov = sum(max(0.0, min(b, y) - max(a, x)) for x, y in comp)
        n += ov > 0
        secs += ov
    return {"d2h_spans": len(tel.spans("ckpt.d2h")),
            "d2h_overlapping_compute": n, "overlap_s": secs}


def seg_steady(tel, t_end: float) -> dict:
    """The driver's steady state: the run from the second segment's
    start to ``t_end`` (the run's return, after its last checkpoint's
    write) per step, and that window split into the segments (their
    compute alone, then with the totals' reads), the gaps between them
    (a checkpoint's snapshot and meta) and the end (the last
    checkpoint, its wait)."""
    segs = tel.spans("segment")[1:]
    comp = tel.spans("segment.compute")[1:]
    n = len(segs) * SEG_STEPS
    ends = [sp["t0"] + sp["dur"] for sp in segs]
    gaps = [b["t0"] - a for a, b in zip(ends, segs[1:])]
    return {
        "driver_steady_ms_per_step": 1e3 * (t_end - segs[0]["t0"]) / n,
        "steady_compute_ms_per_step": 1e3 * sum(
            sp["dur"] for sp in comp) / n,
        "steady_segment_ms_per_step": 1e3 * sum(
            sp["dur"] for sp in segs) / n,
        "steady_between_segments_ms": 1e3 * sum(gaps) / len(gaps),
        "steady_end_ms": 1e3 * (t_end - ends[-1]),
    }


def seg_mean(tel, name: str) -> float:
    spans = tel.spans(name)
    return sum(s["dur"] for s in spans) / max(len(spans), 1)


@contextlib.contextmanager
def seg_shared_builds(prebuilt: dict):
    """While open, the drivers of this process build each table set and
    plastic inverse index once: ``SimDriver``'s builds are memoised by
    config and device (every driver of phase 5c builds the same model,
    and the host build costs about 0.3 us a synapse).  ``prebuilt``:
    law -> its 8x8x1240 2x2 tables on the card, already built."""
    from unittest import mock
    from repro_torch.runtime import sim_driver as sd
    tables, slots = {}, {}
    build_tables, build_index = sd.build_dist_tables, \
        sd.build_dist_inverse_index

    def model(cfg) -> str:          # an ensemble's tables are its solo's
        return repr(dataclasses.replace(cfg, ensemble_seeds=None))

    for law, built in prebuilt.items():
        tables[(model(ms_cfg(law, GRID)), "cuda", None)] = built

    def shared_tables(cfg, device="cuda", mesh=None):
        key = (model(cfg), str(device), mesh)
        if key not in tables:
            tables[key] = build_tables(cfg, device=device, mesh=mesh)
        return tables[key]

    def shared_index(cfg, host, mesh=None):
        key = (model(cfg), id(host), mesh)
        if key not in slots:
            slots[key] = (host, build_index(cfg, host, mesh=mesh))
        return slots[key][1]

    with mock.patch.object(sd, "build_dist_tables", shared_tables), \
            mock.patch.object(sd, "build_dist_inverse_index", shared_index):
        yield


def run_segmented(single_rate_hz: float) -> dict:
    """Phase 5c: the segmented driver (``runtime.SimDriver``) at
    8x8x1240 in 2x2 tiles, gaussian, 400 steps in segments of 50, a
    checkpoint after every segment: a straight captured run against 4
    segments + preempt + a fresh driver's resume (one capture each,
    identical state), the same recorded (identical spool files), a
    retile of the preempted run onto 1x2 tiles, and the plastic driver
    at 4x4x1240 in 2x2 tiles (one 60-step segment against 30 + preempt +
    resume + 30).  ``make_sim_fn`` alone is timed first on the same
    tables; the launch counts are zeroed after it, so the counts read
    after this phase are the drivers' alone.  The recorded drivers
    capture too (the recorder's appends inside the graph): their spool
    equals an eager driver's (segments of 10 steps, too short to
    capture), whose steady state is timed beside theirs.  Run it inside
    ``seg_shared_builds``."""
    import shutil
    import torch
    from repro_torch.checkpoint.store import checkpoint_meta
    from repro_torch.core import dist_engine as de
    from repro_torch.core.stdp import STDPParams
    from repro_torch.kernels import _build
    from repro_torch.obs.telemetry import Telemetry
    from repro_torch.perf.trace import write_chrome_trace
    from repro_torch.runtime import DriverConfig, SimDriver
    t_phase = time.perf_counter()
    stage = {}
    t_stage = t_phase

    def lap(name):
        nonlocal t_stage
        torch.cuda.synchronize()
        now = time.perf_counter()
        stage[name] = now - t_stage
        t_stage = now

    root = ROOT / "build" / "segmented"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    cfg = ms_cfg("gaussian", GRID)
    label = (f"segmented gaussian {GRID}x{GRID}x{N_PER_COLUMN} "
             f"{MS_TILES}x{MS_TILES}")

    def driver(name, dist=None, seg=SEG_STEPS, tel=None, **kw):
        return SimDriver(DriverConfig(ckpt_dir=str(root / name),
                                      ckpt_every=1, keep=2,
                                      handle_sigterm=False),
                         dist or cfg, "cuda", segment_steps=seg,
                         **({"telemetry": tel} if tel else {}), **kw)

    def timed_run(drv, steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = drv.run(steps)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    t0 = time.perf_counter()
    straight = driver("straight", tel=Telemetry())
    build_s = time.perf_counter() - t0
    # make_sim_fn alone on the same tables: one fresh 400-step call
    # (8 eager steps, a capture, replays), a second on the same sim, and
    # 8 calls of a 50-step sim on one state after its first (the
    # driver's segments without the driver: replays, the ring's phase
    # rolls and 2 eager steps a call)
    sim = de.make_sim_fn(cfg, SEG_TOTAL, record_rate=False,
                         storage=straight.storage)
    inputs = de.SimInputs(tables=straight.tables)
    st = de.init_dist_state(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim(st, inputs)
    torch.cuda.synchronize()
    sim_first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim(st, inputs)
    torch.cuda.synchronize()
    sim_again_s = time.perf_counter() - t0
    require(sim.captures == 1, f"{label}: make_sim_fn captured "
            f"{sim.captures} times in two calls")
    sim = de.make_sim_fn(cfg, SEG_STEPS, record_rate=False,
                         storage=straight.storage)
    sim(st, inputs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SEG_TOTAL // SEG_STEPS):
        sim(st, inputs)
    torch.cuda.synchronize()
    sim_segments_s = time.perf_counter() - t0
    require(sim.captures == 1, f"{label}: the 50-step sim captured "
            f"{sim.captures} times")
    del st, sim
    lap("build_and_make_sim_fn")
    _build.reset_launch_counts()    # from here on, the drivers' launches


    # captured: straight against 4 segments + preempt + resume
    out_a, wall_a = timed_run(straight, SEG_TOTAL)
    tel = straight.tel
    t_end = tel.now()
    first = driver("resumed", preempt_after_segments=SEG_PREEMPT)
    out_b = first.run(SEG_TOTAL)
    require(out_b["preempted"] and out_b["final_step"] == SEG_STEPS
            * SEG_PREEMPT, f"{label}: the preempted driver stopped at "
            f"{out_b['final_step']}")
    shutil.copytree(root / "resumed", root / "retiled")
    tel_c = Telemetry()
    resumed = driver("resumed", tel=tel_c)
    out_c, wall_c = timed_run(resumed, SEG_TOTAL)
    seg_same(out_a["state"], out_c["state"], f"{label} straight vs resumed")
    totals = straight.metric_totals(out_a["state"])
    require(totals == resumed.metric_totals(out_c["state"]),
            f"{label}: metric totals differ after the resume")
    caps = [straight.captures(), first.captures(), resumed.captures()]
    require(caps == [1, 1, 1], f"{label}: captures per driver {caps}")
    trace = write_chrome_trace(tel, str(root / "straight_trace.json"))
    overlap = seg_overlap(tel)
    steady = seg_steady(tel, t_end)
    lap("captured")

    # recorded (captured): the spool files byte for byte
    rec_a = driver("rec_straight", record_events=True, tel=Telemetry())
    out_ra, wall_ra = timed_run(rec_a, SEG_TOTAL)
    rec_steady = seg_steady(rec_a.tel, rec_a.tel.now())
    rec_b = driver("rec_resumed", record_events=True,
                   preempt_after_segments=SEG_PREEMPT)
    rec_b.run(SEG_TOTAL)
    rec_c = driver("rec_resumed", record_events=True)
    out_rc = rec_c.run(SEG_TOTAL)
    rec_caps = [rec_a.captures(), rec_b.captures(), rec_c.captures()]
    require(rec_caps == [1, 1, 1], f"{label}: recorded captures per "
            f"driver {rec_caps}")
    seg_same(out_ra["state"], out_rc["state"],
             f"{label} recorded straight vs resumed")
    seg_same(out_a["state"], out_ra["state"],
             f"{label} recorded vs captured")
    spool_a, spool_c = (seg_spool(root / n) for n in ("rec_straight",
                                                      "rec_resumed"))
    require(spool_a == spool_c, f"{label}: the spool files differ")
    require(rec_a.recorder_dropped == rec_c.recorder_dropped == 0,
            f"{label}: the recorder dropped {rec_a.recorder_dropped} / "
            f"{rec_c.recorder_dropped} events at its default capacity")
    n_events = sum(len(v) for k, v in spool_a.items()
                   if k.endswith(".spk")) // 8
    require(n_events == totals["spikes"] == rec_c.spike_counts(
        SEG_TOTAL).sum(), f"{label}: {n_events} spooled events against "
        f"{totals['spikes']} spikes")
    # the same recorded run stepped eagerly: segments too short to capture
    rec_e = driver("rec_eager", record_events=True, seg=SEG_EAGER_STEPS,
                   tel=Telemetry())
    out_re, wall_re = timed_run(rec_e, SEG_TOTAL)
    require(rec_e.captures() == 0, f"{label}: the eager recorded driver "
            "captured a graph")
    diff = ms_diff(out_ra["state"], out_re["state"])
    require(not diff, f"{label}: the captured recorded driver's state "
            f"differs from the eager one's in {diff}")
    require(seg_spool(root / "rec_straight", True) == seg_spool(
        root / "rec_eager", True), f"{label}: the captured recorded "
            "driver's spool logs differ from the eager one's")
    lap("recorded")

    # retile: the preempted run resumed on 1x2 tiles
    cfg12 = de.DistConfig(engine=dataclasses.replace(
        cfg.engine, decomp=dataclasses.replace(cfg.engine.decomp,
                                               tiles_y=1, tiles_x=2)))
    t0 = time.perf_counter()
    tel_r = Telemetry()
    retiled = driver("retiled", dist=cfg12, allow_retile=True, tel=tel_r)
    retile_build_s = time.perf_counter() - t0
    out_r = retiled.run(SEG_TOTAL)
    rt = retiled.metric_totals(out_r["state"])
    rate = retiled.firing_rate_hz(out_r["state"])
    rel = abs(rate - single_rate_hz) / single_rate_hz
    base = checkpoint_meta(str(root / "retiled"), SEG_TOTAL)["metric_base"]
    require(out_r["final_step"] == SEG_TOTAL and base["spikes"] > 0
            and rt["spikes"] > base["spikes"] and rel <= 0.35,
            f"{label}: the 1x2 retile reached {out_r['final_step']}, "
            f"base {base}, totals {rt}, rate {rate} Hz against the single "
            f"shard's {single_rate_hz} Hz (rel {rel:.3f})")
    lap("retile")

    # plastic: one 60-step segment against 30 + preempt + resume + 30
    pcfg = ms_cfg("gaussian", PARITY_GRID, stdp=STDPParams())
    t0 = time.perf_counter()
    p_one = driver("plastic_one", dist=pcfg, seg=SEG_PLASTIC_STEPS)
    plastic_build_s = time.perf_counter() - t0
    out_p1 = p_one.run(SEG_PLASTIC_STEPS)
    driver("plastic_two", dist=pcfg, seg=SEG_PLASTIC_STEPS // 2,
           preempt_after_segments=1).run(SEG_PLASTIC_STEPS)
    p_two = driver("plastic_two", dist=pcfg, seg=SEG_PLASTIC_STEPS // 2)
    out_p2 = p_two.run(SEG_PLASTIC_STEPS)
    seg_same(out_p1["state"], out_p2["state"], f"{label} plastic "
             f"{PARITY_GRID}x{PARITY_GRID}: one segment vs resumed")
    summary = p_one.plastic_summary(out_p1["state"])
    require(summary["w_l1_delta"] > 0, f"{label}: the plastic run learned "
            f"nothing ({summary})")
    lap("plastic")

    res = {
        "card": gpu_line(),
        "law": "gaussian", "grid": f"{GRID}x{GRID}x{N_PER_COLUMN}",
        "tiles": f"{MS_TILES}x{MS_TILES}", "steps": SEG_TOTAL,
        "segment_steps": SEG_STEPS, "checkpoint_every_segments": 1,
        "driver_build_s": build_s,
        "driver_ms_per_step": 1e3 * wall_a / SEG_TOTAL,
        "make_sim_fn_ms_per_step": 1e3 * sim_first_s / SEG_TOTAL,
        "make_sim_fn_second_call_ms_per_step": 1e3 * sim_again_s
        / SEG_TOTAL,
        "make_sim_fn_50_step_calls_ms_per_step": 1e3 * sim_segments_s
        / SEG_TOTAL,
        **steady,
        "segment_ms": [1e3 * sp["dur"] for sp in tel.spans("segment")],
        "resumed_driver_ms_per_step": 1e3 * wall_c / (SEG_TOTAL - SEG_STEPS
                                                      * SEG_PREEMPT),
        "captures_per_driver": caps,
        "ckpt_snapshot_ms": 1e3 * seg_mean(tel, "ckpt.snapshot"),
        "ckpt_d2h_s": seg_mean(tel, "ckpt.d2h"),
        "ckpt_write_s": seg_mean(tel, "ckpt.write"),
        "ckpt_d2h_plus_write_s": seg_mean(tel, "ckpt.d2h")
        + seg_mean(tel, "ckpt.write"),
        "checkpoint_bytes": sum(
            p.stat().st_size for p in (root / "straight").glob(
                f"step_{SEG_TOTAL:08d}/leaf_*.npy")),
        "restore_s": seg_mean(tel_c, "restore.load"),
        "retile_restore_s": seg_mean(tel_r, "restore.retile"),
        "spool_drain_ms_per_segment": 1e3 * seg_mean(
            rec_a.tel, "segment.spool_drain"),
        "recorded_captures_per_driver": rec_caps,
        "recorded_driver_ms_per_step": 1e3 * wall_ra / SEG_TOTAL,
        "recorded_driver_steady_ms_per_step":
            rec_steady["driver_steady_ms_per_step"],
        "recorded_eager_driver_ms_per_step": 1e3 * wall_re / SEG_TOTAL,
        "recorded_eager_segment_steps": SEG_EAGER_STEPS,
        "recorded_driver_steady": rec_steady,
        "d2h_overlap": overlap, "chrome_trace": str(Path(trace).relative_to(
            ROOT)),
        "totals": totals, "spooled_events": n_events,
        "recorder_dropped": rec_a.recorder_dropped,
        "retile": {"tiles": "1x2", "build_s": retile_build_s,
                   "metric_base": base, "totals": rt, "rate_hz": rate,
                   "single_shard_rate_hz": single_rate_hz,
                   "rate_rel_diff": rel},
        "plastic": {"grid": f"{PARITY_GRID}x{PARITY_GRID}x{N_PER_COLUMN}",
                    "steps": SEG_PLASTIC_STEPS, "build_s": plastic_build_s,
                    **summary},
    }
    res["stage_s"] = stage
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"{label} driver " + json.dumps(res))
    shutil.rmtree(root / "retiled", ignore_errors=True)
    return res


# ---------------------------------------------------------------------------
# phase 5d: ensembles and the job service
# ---------------------------------------------------------------------------

def ens_graph_profile(sim, members: int) -> dict:
    """A profile of ``MS_PROFILE_REPLAYS`` replays of a sim's captured
    graph alone: device operations (graph nodes) and busy ms per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    graph, d = sim.graph_loop.graph, sim.e.d_ring
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(MS_PROFILE_REPLAYS):
            graph.replay()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    n = MS_PROFILE_REPLAYS * d
    return {"graph_device_ops_per_step": len(dev) / n,
            "graph_device_ops_per_step_per_member": len(dev) / n / members,
            "graph_busy_ms_per_step": sum(e.time_range.elapsed_us()
                                          for e in dev) / n / 1e3}


def run_ensembles(seg: dict) -> dict:
    """Phase 5d's drivers (inside ``seg_shared_builds``, after phase 5c,
    whose builds and runs they reuse): the 8x8x1240 gaussian slab in 2x2
    tiles as a 3-member ensemble, recorded and captured, 400 steps in
    segments of 50 with a checkpoint a segment, straight against 4
    segments + preempt + resume (every member's tensors, ``t``,
    generator states and spool files identical; one capture per
    driver); member 0's spool logs against phase 5c's solo recorded
    driver's, byte for byte; a retile of the ensemble refused; the
    captured ensemble step's graph nodes; then the plastic ensemble at
    4x4x1240 in 2x2 tiles, 2 members, 60 steps, member 0's weight
    digest against phase 5c's plastic driver's."""
    import shutil
    import torch
    from repro_torch.core.stdp import STDPParams
    from repro_torch.obs.telemetry import Telemetry
    from repro_torch.runtime import DriverConfig, SimDriver
    t_phase = time.perf_counter()
    root = ROOT / "build" / "segmented"
    cfg = ms_cfg("gaussian", GRID)
    require(cfg.engine.state_seed_value == ENS_SEEDS[0],
            "phase 5d: member 0 must carry phase 5c's state seed")
    ecfg = dataclasses.replace(cfg, ensemble_seeds=ENS_SEEDS)
    m = len(ENS_SEEDS)
    label = (f"ensemble gaussian {GRID}x{GRID}x{N_PER_COLUMN} "
             f"{MS_TILES}x{MS_TILES} M={m}")

    def driver(name, dist, seg=SEG_STEPS, tel=None, **kw):
        return SimDriver(DriverConfig(ckpt_dir=str(root / name),
                                      ckpt_every=1, keep=2,
                                      handle_sigterm=False),
                         dist, "cuda", segment_steps=seg,
                         **({"telemetry": tel} if tel else {}), **kw)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    straight = driver("ens_straight", ecfg, record_events=True,
                      tel=Telemetry())
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_a = straight.run(SEG_TOTAL)
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    steady = seg_steady(straight.tel, straight.tel.now())
    first = driver("ens_resumed", ecfg, record_events=True,
                   preempt_after_segments=SEG_PREEMPT)
    out_b = first.run(SEG_TOTAL)
    require(out_b["preempted"] and out_b["final_step"] == SEG_STEPS
            * SEG_PREEMPT, f"{label}: the preempted driver stopped at "
            f"{out_b['final_step']}")
    shutil.copytree(root / "ens_resumed", root / "ens_retile")
    resumed = driver("ens_resumed", ecfg, record_events=True)
    out_c = resumed.run(SEG_TOTAL)
    seg_same(out_a["state"], out_c["state"], f"{label} straight vs resumed")
    caps = [straight.captures(), first.captures(), resumed.captures()]
    require(caps == [1, 1, 1], f"{label}: captures per driver {caps}")
    spool_a = seg_spool(root / "ens_straight")
    require(spool_a == seg_spool(root / "ens_resumed"),
            f"{label}: the member spools differ after the resume")
    require(straight.recorder_dropped == resumed.recorder_dropped == 0,
            f"{label}: the recorder dropped events")
    totals = straight.metric_totals(out_a["state"])
    n_events = sum(len(v) for k, v in spool_a.items()
                   if k.endswith(".spk")) // 8
    require(n_events == totals["spikes"], f"{label}: {n_events} spooled "
            f"events against {totals['spikes']} spikes")
    # member 0 is phase 5c's solo run: its spool logs byte for byte
    solo = seg_spool(root / "rec_straight", True)
    member = [{k.split("/", 1)[1]: v for k, v in spool_a.items()
               if k.startswith(f"member_{i:03d}/") and k.endswith(".spk")}
              for i in range(m)]
    require(member[0] == solo and member[1] != solo,
            f"{label}: member 0's spool is not phase 5c's solo spool (or "
            "member 1's is)")
    counts = [straight.spike_counts(SEG_TOTAL, member=i) for i in range(m)]
    # a retile of the ensemble is refused
    cfg12 = dataclasses.replace(ecfg, engine=dataclasses.replace(
        cfg.engine, decomp=dataclasses.replace(cfg.engine.decomp,
                                               tiles_y=1, tiles_x=2)))
    refused = None
    try:        # unrecorded: a spool refuses another tiling's capacity
        driver("ens_retile", cfg12, allow_retile=True).run(SEG_TOTAL)
    except ValueError as e:
        refused = str(e)
    require(refused is not None and "member axis" in refused,
            f"{label}: the retile of the ensemble was not refused "
            f"({refused})")
    shutil.rmtree(root / "ens_retile", ignore_errors=True)
    prof = ens_graph_profile(straight._sim, m)

    # the plastic ensemble: member 0 learns what phase 5c's driver did
    pcfg = ms_cfg("gaussian", PARITY_GRID, stdp=STDPParams())
    require(pcfg.engine.state_seed_value == ENS_PLASTIC_SEEDS[0],
            "phase 5d: plastic member 0 must carry phase 5c's seed")
    t0 = time.perf_counter()
    pe = driver("ens_plastic", dataclasses.replace(
        pcfg, ensemble_seeds=ENS_PLASTIC_SEEDS), seg=SEG_PLASTIC_STEPS)
    out_p = pe.run(SEG_PLASTIC_STEPS)
    torch.cuda.synchronize()
    plastic_s = time.perf_counter() - t0
    sums = [pe.plastic_summary(out_p["state"], member=i)
            for i in range(len(ENS_PLASTIC_SEEDS))]
    require(sums[0]["weight_checksum"] == seg["plastic"]["weight_checksum"]
            and sums[1]["weight_checksum"] != sums[0]["weight_checksum"],
            f"{label}: plastic member 0's digest {sums[0]} is not phase "
            f"5c's {seg['plastic']['weight_checksum']} (or member 1's is)")

    solo_steady = seg["recorded_driver_steady_ms_per_step"]
    res = {
        "card": gpu_line(), "members": m, "seeds": list(ENS_SEEDS),
        "grid": f"{GRID}x{GRID}x{N_PER_COLUMN}",
        "tiles": f"{MS_TILES}x{MS_TILES}", "steps": SEG_TOTAL,
        "segment_steps": SEG_STEPS, "recorded": True,
        "driver_build_s": build_s,
        "driver_ms_per_step": 1e3 * wall_a / SEG_TOTAL,
        "driver_steady_ms_per_step": steady["driver_steady_ms_per_step"],
        "steady_compute_ms_per_step": steady["steady_compute_ms_per_step"],
        "solo_recorded_driver_steady_ms_per_step": solo_steady,
        "solo_recorded_driver_steady_times_members": solo_steady * m,
        "solo_driver_steady_ms_per_step": seg["driver_steady_ms_per_step"],
        "captures_per_driver": caps, **prof,
        "spooled_events": n_events, "totals": totals,
        "member_spikes": [float(c.sum()) for c in counts],
        "member0_spool_is_solo": True, "retile_refused": refused,
        "plastic": {"grid": f"{PARITY_GRID}x{PARITY_GRID}x{N_PER_COLUMN}",
                    "members": len(ENS_PLASTIC_SEEDS),
                    "steps": SEG_PLASTIC_STEPS, "s": plastic_s,
                    "member_checksums": [s["weight_checksum"][:16]
                                         for s in sums],
                    "member0_is_solo": True},
        "phase_s": time.perf_counter() - t_phase,
    }
    print(f"{label} driver " + json.dumps(res))
    return res


def run_service() -> dict:
    """Phase 5d's service leg: ``examples/ensemble_service.run`` on the
    card at 4x4x1240 in 2x2 tiles, exponential (a solo reference driver,
    then a ``SimJobServer`` on loopback with two 3-member jobs of
    different seeds, two HTTP clients streaming the first at different
    paces, ``launch.analyze`` of its members, member 0's spool against
    the solo's), 60 steps in segments of 20: the sim cache holds one
    function and each job captures once.  Its table builds are its own
    (not phase 5c's memo), so each job's wall time splits into a real
    build, the run and the spool drain."""
    import shutil
    from repro_torch.examples import ensemble_service
    work = ROOT / "build" / "service"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    label = (f"service exponential {PARITY_GRID}x{PARITY_GRID}x"
             f"{N_PER_COLUMN} {MS_TILES}x{MS_TILES}")
    t0 = time.perf_counter()
    out = ensemble_service.run(str(work), device="cuda", grid=PARITY_GRID,
                               npc=N_PER_COLUMN, tiles=(MS_TILES, MS_TILES),
                               t_steps=SERVICE_STEPS, seg=SERVICE_SEG,
                               report_path=str(work / "analysis.json"))
    caps = [j["captures"] for j in out["jobs"]]
    require(caps == [1, 1] and out["server_compiled_steps_after_2_jobs"]
            == 1, f"{label}: captures per job {caps}, sim cache "
            f"{out['server_compiled_steps_after_2_jobs']}")
    res = {"card": gpu_line(), "steps": SERVICE_STEPS,
           "segment_steps": SERVICE_SEG, "members": len(out["seeds"]),
           "captures_per_job": caps,
           "sim_cache_after_2_jobs": out["server_compiled_steps_after_2_jobs"],
           "spooled_events": out["spooled_events"],
           "clients": {k: {"total": v["total"], "polls": v["polls"]}
                       for k, v in out["clients"].items()},
           "member_reports": out["member_reports"],
           "job_wall_s": [j["wall"] for j in out["jobs"]],
           "job_rate_hz": [j["rate_hz"] for j in out["jobs"]],
           "member0_spool_is_solo": out["member0_matches_solo"],
           "phase_s": time.perf_counter() - t0}
    print(f"{label} job server " + json.dumps(res))
    return res


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
    queued = queued_ms(lambda: lif_step_cuda(*args, **kw), 200)
    plain_ms = device_ms(lambda: ref.lif_step_ref(*args, **kw), 50)
    nbytes = n * (4 + 4 + 4 + 4 + 1) + n * (4 + 4 + 4 + 4)
    ops = 6 * n
    bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    return {"name": "lif_step", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/lif_step.cu",
            "replaces": "src/repro/kernels/lif_step.py:47",
            "launches": launches, "max_abs_err": err, "ms": queued,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": None, "call_ms": per_call, "profiler_ms": ms,
            "shape": f"n={n}", "ptxas": ptxas("lif_step"),
            "path_note": "on no main path since neuron_step took the "
                         "engine's step head; the counterpart of the "
                         "reference's kops.lif_step, checked in phase 2"}


def time_neuron_step(state, cfg, launches: int, err: float) -> dict:
    """The step-head kernel on a mid-run state of the static path, as
    the engine calls it (in place, with the local tier's bitmap), beside
    the LIF kernel it replaced there (``replaced_kernel_ms``: the same
    state, its input ``ring[slot] + drive`` made once) and the plain
    version."""
    import torch
    from repro_torch.core import engine
    from repro_torch.kernels import ref
    from repro_torch.kernels.lif_step import lif_step_cuda
    from repro_torch.kernels.neuron_step import n_words, neuron_step_cuda
    nrn = state["neuron"]
    n = nrn["v"].shape[0]
    cap = cfg.spec().active_cap_local
    kw = cfg.lif.kernel_args()
    st = tuple(nrn[k].clone() for k in ("v", "c", "refrac"))
    ring = state["i_ring"].clone()
    drive = engine.external_drive(state["rng"], n, cfg)
    active = state["active"]
    kern = lambda: neuron_step_cuda(ring, 3, drive, *st, active,
                                    active_cap=cap, out=st, **kw)
    i_total = state["i_ring"][3] + drive
    old = lambda: lif_step_cuda(*st, i_total, active, **kw)
    # read: ring word, drive, v, c (f32), refrac (i32), active (1 B);
    # written: v, c, refrac, spk, the zeroed ring word, the bitmap words
    # and the count
    nbytes = n * 21 + n * 20 + n_words(n) * 4 + 4
    ops = 8 * n
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = ops / F32_OPS_PER_S * 1e3
    return {"name": "neuron_step", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/neuron_step.cu",
            "replaces": "src/repro/kernels/lif_step.py:47",
            "launches": launches, "max_abs_err": err,
            "ms": queued_ms(kern, 200), "plain_ms": device_ms(
                lambda: ref.neuron_step_ref(ring, 3, drive, *st, active,
                                            active_cap=cap, **kw), 50),
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops
            else "operations",
            "library_ms": None, "call_ms": call_ms(kern, 200),
            "profiler_ms": device_ms(kern, 200), "bytes": nbytes,
            "replaced_kernel": "lif_step",
            "replaced_kernel_ms": queued_ms(old, 200),
            "replaced_kernel_call_ms": call_ms(old, 200),
            "ptxas": ptxas("neuron_step"),
            "shape": f"n={n}, active_cap {cap}, "
                     f"{int(nrn['refrac'].eq(cfg.lif.refrac_steps).sum())}"
                     " spikes in the state's last step"}


def time_delivery(tabs, spec, spikes, launches: int, err: float,
                  label: str) -> dict:
    """The column kernel on one mid-run spike vector of the static path,
    beside the warp-per-row kernel it replaced there (the legacy entry's
    kernel) on the same rows, the plain version and ``index_add_``."""
    import torch
    from repro_torch.kernels.ref import delivered_bits, deliver_rows_ref
    from repro_torch.kernels.synaptic_accum import (compact_events,
                                                    deliver_columns_cuda,
                                                    deliver_rows_cuda)
    local = tabs.local
    n, cap = spec.n_local, spec.active_cap_local
    runs = tabs.column_runs(spec.n_per_col, spec.n_exc_per_col,
                            spec.d_ring)[0]
    idx, n_spk = compact_events(spikes, n, cap)
    bits, _ = delivered_bits(spikes, n, cap)
    ring = torch.zeros((spec.d_ring, n), device="cuda")
    ev = torch.zeros((1,), dtype=torch.int32, device="cuda")
    kern = lambda: deliver_columns_cuda(local, runs, bits, ring, 3, ev)
    old = lambda: deliver_rows_cuda(local, idx, ring, 3, ev)
    ms = device_ms(kern, 100)
    per_call = call_ms(kern, 100)
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
    library_call = call_ms(lambda: ring.view(-1).index_add_(0, flat, w), 20)
    queued = queued_ms(kern, 100)
    old_queued = queued_ms(old, 100)
    library_queued = queued_ms(lambda: ring.view(-1).index_add_(0, flat, w),
                               20)
    events = int(flat.numel())
    touched = int(torch.unique(flat).numel())
    tgt_b, w_b = local["tgt"].element_size(), local["w"].element_size()
    entry_b = tgt_b + w_b + 1
    nbytes = (events * entry_b + rows.numel() * 4 + cap * 4
              + touched * 8)
    bound = max(nbytes / HBM_BYTES_PER_S, events / F32_OPS_PER_S) * 1e3
    # what the column kernel reads: the delivered rows' ids and weights
    # (no delay byte), one 8-byte run word per delivered row of each pair,
    # the bitmap words of each pair's group, the delivered rows' nnz; and
    # the touched ring words, read and written once per split at most
    g = runs["row_group"]
    on_per_group = torch.bincount(rows // g, minlength=-(-n // g))
    run_words = int(on_per_group[runs["pair_src"].long()].sum())
    n_pairs = int(runs["pair_src"].numel())
    kernel_bytes = (events * (tgt_b + w_b) + run_words * 8
                    + n_pairs * (-(-g // 32)) * 4 + rows.numel() * 4
                    + touched * 8)
    return {"name": "event_delivery", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/event_delivery.cu",
            "replaces": "src/repro/kernels/synaptic_accum.py:164",
            "launches": launches, "max_abs_err": err, "ms": queued,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": library_queued, "call_ms": per_call,
            "library_call_ms": library_call, "profiler_ms": ms,
            "library_profiler_ms": library_ms,
            "replaced_kernel_ms": old_queued,
            "replaced_kernel_call_ms": call_ms(old, 100),
            "replaced_kernel_profiler_ms": device_ms(old, 100),
            "kernel_bytes": kernel_bytes,
            "kernel_bytes_ms": kernel_bytes / HBM_BYTES_PER_S * 1e3,
            "ptxas": ptxas("event_delivery"),
            "shape": f"{label}: {int(n_spk)} spiking rows, {events} events,"
                     f" active_cap {cap}, {n_pairs} pairs, "
                     f"{run_words} run words read"}


def time_spike_compact(spikes, n: int, cap: int, launches: int,
                       err: float, big=None) -> dict:
    """The compaction kernel at the recorded path's shape (a mid-run
    spike vector), and at ``big`` = (spikes, n, cap) when given: device
    time per call (``queued_ms``), per call with the wrapper's host work
    (``call_ms``) and the profiler's figure, beside ``torch.nonzero``
    (device time, and per call: it waits for the device on every call to
    size its output) and the plain version."""
    import torch
    from repro_torch.kernels.ref import spike_compact_ref
    from repro_torch.kernels.spike_compact import spike_compact_cuda

    def one(spikes, n, cap):
        kern = lambda: spike_compact_cuda(spikes, n, cap)
        live = spikes[:n] > 0
        lib = lambda: torch.nonzero(live)
        nbytes = n * 4 + cap * 4 + 4
        return {
            "ms": queued_ms(kern, 200), "call_ms": call_ms(kern, 200),
            "profiler_ms": device_ms(kern, 200),
            "plain_ms": device_ms(lambda: spike_compact_ref(spikes, n, cap),
                                  50),
            "library_ms": device_ms(lib, 50),
            "library_call_ms": call_ms(lib, 50),
            "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                            n / F32_OPS_PER_S) * 1e3,
            "shape": f"n={n}, cap={cap}, {int(live.sum())} spikes"}

    res = {"name": "spike_compact", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/spike_compact.cu",
           "replaces": "src/repro/kernels/spike_compact.py:102",
           "launches": launches, "max_abs_err": err, "bound_by": "bytes",
           **one(spikes, n, cap), "ptxas": ptxas("spike_compact")}
    if big is not None:
        res["at_24x24x1240"] = one(*big)
    return res


def time_plastic(run: dict, launches: int, err: float, law: str) -> dict:
    import torch
    from repro_torch.kernels.plastic_step import plastic_delivery_ltd_cuda
    from repro_torch.kernels.ref import (delivered_bits,
                                         plastic_delivery_ltd_ref)
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
    bits, _ = delivered_bits(spikes, spec.n_local, cap)
    ev = torch.zeros((1,), dtype=torch.int32, device="cuda")
    n, d = spec.n_local, cfg.d_ring

    def kernel():
        plastic_delivery_ltd_cuda(tier, bits, inv, 0, ring, slot, x_post_d,
                                  neg_a, ev)

    ms = device_ms(kernel, 20)
    per_call = call_ms(kernel, 20)
    queued = queued_ms(kernel, 20)
    plain_ms = device_ms(lambda: plastic_delivery_ltd_ref(
        tier, spikes, cap, ring, slot, mask, x_post_d, neg_a), 3, warmup=1)
    # the function's own work in this step: the spikes and x_post read,
    # the delivered synapses' entries (target, weight, delay, mask) read,
    # the plastic ones' new weights written, the ring read and written
    rows = torch.zeros(n + 1, dtype=torch.bool, device="cuda")
    rows[:n] = ((bits[:, None] >> torch.arange(32, device="cuda")) & 1
                ).view(-1)[:n] > 0
    delivered = int(local["nnz"][rows].sum())
    plastic = int(mask[rows].sum())
    slots_read = int(inv["n_in"].sum())
    entry_b = local["tgt"].element_size() + 4 + 1 + 4
    nbytes = (2 * n * 4 + delivered * entry_b + plastic * 4
              + 2 * d * n * 4)
    ops = delivered + 3 * plastic
    bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    # PR 14's yardstick, which also counts the pull design's index walk:
    # every slot of the index read, byte flags, the delivered weight,
    # delay and mask gathered
    design_bytes = (slots_read * 4 + n * 4 + (n + 1) + delivered * 9
                    + plastic * 4 + 2 * d * n * 4 + n * 4)
    # what the kernel moves: each slot and its tm byte, the delivered
    # weights, the plastic ones written, the bitmap, ring, x_post, nnz
    kernel_bytes = (slots_read * 5 + n * 4 + bits.numel() * 4
                    + delivered * 4 + plastic * 4 + 2 * d * n * 4 + n * 4
                    + int(rows.sum()) * 4)
    return {"name": "plastic_delivery_ltd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/plastic_delivery.cu",
            "replaces": "src/repro/kernels/plastic_step.py:172",
            "launches": launches, "max_abs_err": err, "ms": queued,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": None, "call_ms": per_call, "profiler_ms": ms,
            "design_bound_ms": max(design_bytes / HBM_BYTES_PER_S,
                                   ops / F32_OPS_PER_S) * 1e3,
            "kernel_bytes": kernel_bytes,
            "kernel_bytes_ms": kernel_bytes / HBM_BYTES_PER_S * 1e3,
            "target_major_bytes": inv["tm"].numel(),
            "ptxas": ptxas("plastic_delivery"),
            "shape": f"{law} {run['grid']}: "
                     f"{int(rows.sum())} delivered rows, {delivered} "
                     f"events, {plastic} plastic, {slots_read} index "
                     "slots"}


# ---------------------------------------------------------------------------
# the flash-attention kernel (phase 2) and the LM serving path (phase 7)
# ---------------------------------------------------------------------------

def qwen2_prefill_qkv(gen):
    """Random q (B*H, S, D) and k, v (B*Kv, S, D) at qwen2-1.5b's prefill
    shape: B = 4, S = 2048, H = 12, Kv = 2, D = 128 (bf16)."""
    import torch
    from repro_torch.configs import get_config
    cfg = get_config(LM_ARCH)
    d = cfg.resolved_head_dim
    shapes = ((LM_BATCH * cfg.n_heads, LM_PROMPT, d),
              (LM_BATCH * cfg.n_kv_heads, LM_PROMPT, d),
              (LM_BATCH * cfg.n_kv_heads, LM_PROMPT, d))
    return [torch.randn(s, device="cuda", generator=gen).to(torch.bfloat16)
            for s in shapes]


def check_flash(gen) -> dict:
    """The two flash routes against their plain version on the card
    (TF32 off in the plain version): the reference's kernel-test shapes
    in both dtypes (head_dim 8-64; 8 padded to 16), the tensor-core
    kernels' edge cases in bf16 and in float32
    at head_dim 64/128/256 and at 16/32 (``NARROW_CASES``: Sq = 1,
    ragged Sq/Sk, Sk below a tile, q_offset, windows, GQA groups 1, 6,
    8, rows with no key), padded widths, fully masked rows (exactly 0)
    at every built width, qwen2-1.5b's prefill shape in both dtypes and
    a head_dim-256 sliding window over 4096 keys (gemma's head dim,
    recurrentgemma's local attention).  The TF32 route's pre-pass is
    held to its plain version bit for bit, and its fragment probe to the
    layout the kernel assumes.  Returns the largest difference seen on
    each route (its tolerance's scale is |plain| + 1), and the
    pre-pass's ("tf32_split", 0.0)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_ref, tf32_split_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    worst = {r: 0.0 for r in fa.ROUTE_KERNELS}
    worst_lse = {r: 0.0 for r in fa.ROUTE_KERNELS}

    def check_lse(q, k, v, out, label, **kw):
        """The route's row statistic (``return_lse``): the same output,
        L within LSE_TOL of |L| + 1, +1e30 exactly on dead rows."""
        route = fa._route(q.dtype, q.shape[2])
        got_o, got_l = fa.flash_attention_cuda(q, k, v, return_lse=True,
                                               **kw)
        _, want_l = attention_ref(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        require(torch.equal(got_o, out), f"flash {label}: the output with "
                "the row statistic differs from the one without")
        dead = want_l == 1e30
        require(torch.equal(got_l == 1e30, dead),
                f"flash {label} ({route}): dead rows' statistic not +1e30")
        tol = LSE_TOL[str(q.dtype).removeprefix("torch.")]
        err = (got_l - want_l).abs()[~dead]
        bad = int((err > tol * (1 + want_l[~dead].abs())).sum())
        require(bad == 0, f"flash {label} ({route}): {bad} row statistics "
                f"beyond {tol}")
        e = float(err.max()) if err.numel() else 0.0
        worst_lse[route] = max(worst_lse[route], e)
        print(f"check flash_attention[{route}] lse {label}: max_abs_err "
              f"{e:.3g} (tol {tol} x (|L| + 1)), {int(dead.sum())} dead "
              "rows at +1e30")

    def one(q, k, v, label, **kw):
        route = fa._route(q.dtype, q.shape[2])
        before = _build.launch_counts()
        got = fa.flash_attention_cuda(q, k, v, **kw)
        want = attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        after = _build.launch_counts()
        names = [fa.ROUTE_KERNELS[route]] + (
            [fa.SPLIT_KERNEL] if route == "tf32" else [])
        require(all(after.get(n, 0) == before.get(n, 0) + 1 for n in names)
                and sum(after.values()) == sum(before.values())
                + len(names), f"flash {label}: not one launch of each of "
                f"{names}")
        tol = FLASH_TOL[str(q.dtype).removeprefix("torch.")]
        err = (got.float() - want.float()).abs()
        bad = int((err > tol + tol * want.float().abs()).sum())
        require(got.dtype == q.dtype and got.shape == q.shape,
                f"flash {label}: dtype/shape")
        require(bad == 0, f"flash {label} ({route}): {bad} values beyond "
                f"{tol}")
        worst[route] = max(worst[route], float(err.max()))
        print(f"check flash_attention[{route}] {label}: max_abs_err "
              f"{float(err.max()):.3g} (tol {tol}), max |plain| "
              f"{float(want.float().abs().max()):.3g}")
        check_lse(q, k, v, got, label, **kw)

    def rand(*shape):
        return torch.randn(shape, device="cuda", generator=gen)

    layout = fa.tf32_fragment_layout()
    torch.cuda.synchronize()
    bad = fa.tf32_fragment_errors(layout.cpu())
    require(bad == 0, f"the tf32 A fragment differs from the TF32 kernel's "
            f"assumption at {bad} of 512 elements: {layout.tolist()}")
    print("check tf32 fragment probe: the kernel's key order and register "
          "map hold (0 of 512 elements differ)")
    for shape in ((3, 77, 16), (3, 77, 32), (8, LM_PROMPT, 32), (3, 77, 64),
                  (8, LM_PROMPT, 128), (2, 130, 256)):
        k, v = rand(*shape) * 10, rand(*shape)
        got, want = fa.tf32_split_cuda(k, v), tf32_split_ref(k, v)
        torch.cuda.synchronize()
        require(all(a.shape == b.shape and torch.equal(
            a.view(torch.int32), b.view(torch.int32))
            for a, b in zip(got, want)),
            f"tf32_split {shape}: not bit-equal to its plain version")
        print(f"check tf32_split k/v {shape}: bit-equal to tf32_split_ref")

    for bh, bhkv, sq, sk, d, causal, win, qoff in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = rand(bh, sq, d), rand(bhkv, sk, d), rand(bhkv, sk, d)
            one(q.to(dtype), k.to(dtype), v.to(dtype),
                f"{(bh, bhkv, sq, sk, d)} causal={causal} window={win} "
                f"q_offset={qoff} {dtype}", causal=causal, window=win,
                q_offset=qoff)
    for bh, bhkv, sq, sk, d, causal, win, qoff in SM90_CASES + NARROW_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = rand(bh, sq, d), rand(bhkv, sk, d), rand(bhkv, sk, d)
            one(q.to(dtype), k.to(dtype), v.to(dtype),
                f"{(bh, bhkv, sq, sk, d)} causal={causal} window={win} "
                f"q_offset={qoff} {dtype}", causal=causal, window=win,
                q_offset=qoff)
    for bh, bhkv, sq, sk, d, causal, win, qoff in PAD_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = rand(bh, sq, d), rand(bhkv, sk, d), rand(bhkv, sk, d)
            one(q.to(dtype), k.to(dtype), v.to(dtype),
                f"{(bh, bhkv, sq, sk, d)} causal={causal} window={win} "
                f"q_offset={qoff} {dtype} (padded to "
                f"{fa.padded_head_dim(fa._route(dtype, d), d)})",
                causal=causal, window=win, q_offset=qoff)
    for dtype, d in ((torch.float32, 8), (torch.bfloat16, 16),
                     (torch.bfloat16, 32), (torch.bfloat16, 64),
                     (torch.bfloat16, 128), (torch.bfloat16, 256),
                     (torch.float32, 16), (torch.float32, 32),
                     (torch.float32, 64),
                     (torch.float32, 128), (torch.float32, 256)):
        q = rand(2, 8, d).to(dtype)
        out = fa.flash_attention_cuda(q, q, q, causal=False, window=2,
                                      q_offset=100)
        torch.cuda.synchronize()
        require(torch.equal(out, torch.zeros_like(out)),
                f"flash[{fa._route(dtype, d)}]: fully masked rows are not "
                "exactly 0")
        print(f"check flash_attention[{fa._route(dtype, d)}] fully masked "
              f"(window=2, q_offset=100) {dtype} D={d}: exactly 0")
        check_lse(q, q, q, out, f"fully masked {dtype} D={d}",
                  causal=False, window=2, q_offset=100)
    q, k, v = qwen2_prefill_qkv(gen)
    for dtype in (torch.bfloat16, torch.float32):
        one(q.to(dtype), k.to(dtype), v.to(dtype),
            f"qwen2-1.5b prefill q {tuple(q.shape)} k/v {tuple(k.shape)} "
            f"{dtype} causal", causal=True)
    q, k, v = rand(8, 4096, 256), rand(1, 4096, 256), rand(1, 4096, 256)
    one(q.bfloat16(), k.bfloat16(), v.bfloat16(),
        "(8, 1, 4096, 4096, 256) bf16 causal window=2048", causal=True,
        window=2048)
    return dict(worst, tf32_split=0.0,
                lse={r: worst_lse[r] for r in fa.ROUTE_KERNELS})


def check_dict_tables(gen, tabs, build_s: float) -> None:
    """Dict-form tables and new weights on the card: 4x4x1240 gaussian
    bf16 tables, uncompressed (``tabs``, built on the host in
    ``build_s``; a dict's delivery plan comes from the spec, as in the
    reference), delivered on a CUDA ring through
    ``engine.deliver_event_tiers`` as ``SynapseTables`` and as a
    ``{"local", "halo"}`` dict: rings, events and drops bit-equal to
    each other and to the plain path, through the same run descriptors
    (found on the tier tensors, none rebuilt).  Then the dict with
    ``dict(tier, w=2 w)``: the descriptor is rebound to the new weights
    (not rebuilt) and the ring equals the plain version's, its delivered
    part twice the first one's."""
    import torch
    from repro_torch.configs.snn import reduced_case
    from repro_torch.core import engine, synapses
    cfg = reduced_case("gaussian", 4, N_PER_COLUMN).engine_config(1, 1)
    spec, d_ring = cfg.spec(), cfg.d_ring
    as_dict = {"local": tabs.local, "halo": list(tabs.halo)}
    runs = tabs.column_runs(spec.n_per_col, spec.n_exc_per_col, d_ring)
    builds = dict(synapses.BUILD_COUNTS)
    spk = (torch.rand(spec.n_local, device="cuda", generator=gen)
           < 0.1).float()
    ring0 = (torch.randint(-300, 300, (d_ring, spec.n_local), device="cuda",
                           generator=gen).float() * 2.0 ** -9)

    def deliver(tables, kernels: bool):
        ring, ev, dr = engine.deliver_event_tiers(
            tables, spk, [], spec, ring0.clone(), 3, d_ring, kernels)
        torch.cuda.synchronize()
        return ring, float(ev), float(dr)

    def same(a, b) -> bool:
        return torch.equal(a[0].view(torch.int32),
                           b[0].view(torch.int32)) and a[1:] == b[1:]

    a, b, plain = deliver(tabs, True), deliver(as_dict, True), \
        deliver(as_dict, False)
    require(same(a, b) and same(a, plain) and a[1] > 0,
            "dict-form tables deliver otherwise than SynapseTables or the "
            "plain path on the card")
    require(synapses.BUILD_COUNTS == builds and synapses.column_runs(
        synapses.tier_list(as_dict), spec.n_per_col, spec.n_exc_per_col,
        d_ring) is runs, "the dict form rebuilt the run descriptors")
    w2 = tabs.local["w"] * 2
    doubled = {"local": dict(tabs.local, w=w2), "halo": list(tabs.halo)}
    c, c_plain = deliver(doubled, True), deliver(doubled, False)
    require(same(c, c_plain) and torch.equal(c[0] - ring0,
                                             2 * (a[0] - ring0)),
            "dict(tier, w=2 w) delivered otherwise than the plain version")
    require(synapses.BUILD_COUNTS == builds and runs[0]["w"] is w2,
            "new weights rebuilt the descriptor instead of rebinding it")
    print(f"check dict-form tables gaussian 4x4x{N_PER_COLUMN} "
          f"(uncompressed, host build {build_s:.1f} s): SynapseTables, "
          f"dict and plain path bit-equal ({int(a[1])} events); "
          f"dict(tier, w=2 w) equals the plain version; descriptor reused "
          f"and rebound, none rebuilt")


def lm_compare(a, b) -> dict:
    """Max |a - b| of two logit tensors, beside the scale of ``b``;
    ``ratio`` is max |a - b| / (|b| + std(b))."""
    a, b = a.float(), b.float()
    d, std = (a - b).abs(), float(b.std())
    return {"max_abs_diff": float(d.max()), "logit_std": std,
            "max_abs_logit": float(b.abs().max()),
            "ratio": float((d / (b.abs() + std)).max())}


def decode(params, cfg, state, first_tok, steps: int, forced=None,
           start: int = LM_PROMPT):
    """``steps`` greedy decode steps from ``first_tok`` at ``start`` (or
    teacher-forced on ``forced``: (B, steps) tokens).  Returns the tokens
    fed, the logits of every step and the state."""
    import torch
    from repro_torch.models.model import make_serve_step
    step = make_serve_step(cfg)
    tok, toks, lgs = first_tok, [], []
    for i in range(steps):
        if forced is not None:
            tok = forced[:, i:i + 1]
        toks.append(tok)
        lg, state = step(params, state, tok, start + i)
        lgs.append(lg)
        tok = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)
    return torch.cat(toks, dim=1), lgs, state


def run_lm() -> dict:
    """qwen2-1.5b at full width (bf16, random weights from a seed): a
    4 x 2048-token prefill through the flash kernel and 32 greedy decode
    steps, held against the plain path (attn_impl "naive") on the same
    weights and prompts, teacher-forced on the kernel path's tokens, with
    the chunked plain path as a control; then a float32 prefill of both
    paths.  The plain and control prefills run first (they also warm
    cuBLAS and the allocator); launch counts are zeroed just before the
    kernel path's prefill + decode and read just after.  Peak memory is
    counted above what the earlier phases still hold."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.model import make_prefill
    from repro_torch.models.transformer import init_decode_state, init_model
    from repro_torch.tree import tree_signature
    torch.backends.cuda.matmul.allow_tf32 = False
    base_bytes = torch.cuda.memory_allocated()
    cfg = dataclasses.replace(get_config(LM_ARCH), attn_impl="pallas")
    require((cfg.n_layers, cfg.d_model, cfg.dtype) == (28, 1536, "bfloat16"),
            "qwen2-1.5b is not at its full width")
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _tensors(params))
    require(n_params == cfg.param_count(), f"{n_params} parameters, the "
            f"config counts {cfg.param_count()}")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT)).astype(np.int32)
    tokens = torch.from_numpy(prompts).cuda()
    max_len = LM_PROMPT + LM_GEN

    # the plain path's and the control's prefills
    refs = {}
    for impl in ("naive", "chunked"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        st = init_decode_state(c, LM_BATCH, max_len)
        lg, st = make_prefill(c)(params, {"tokens": tokens}, st)
        refs[impl] = (c, st, [lg])

    # the kernel path: prefill, then greedy decode (counted, timed)
    state = init_decode_state(cfg, LM_BATCH, max_len)
    signatures = {"params": tree_signature(params),
                  "decode_state": tree_signature(state)}
    prefill = make_prefill(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    lg_k, state = prefill(params, {"tokens": tokens}, state)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    n_prefill = _build.launch_counts().get("flash_attention", 0)
    saved = [(c.k.clone(), c.v.clone()) for c in state["layers"]]
    first = torch.argmax(lg_k[:, -1:], dim=-1).to(torch.int32)
    t0 = time.perf_counter()
    toks, lgs_k, state = decode(params, cfg, state, first, LM_GEN)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    require(n_prefill == cfg.n_layers,
            f"prefill launched the flash kernel {n_prefill} times, not "
            f"{cfg.n_layers}")
    require(launches.get("flash_attention", 0) == n_prefill,
            "the decode steps launched a flash kernel")
    require(toks.shape == (LM_BATCH, LM_GEN) and bool(
        ((toks >= 0) & (toks < cfg.padded_vocab)).all()), "bad tokens")
    for lg in [lg_k] + lgs_k:
        require(lg.shape == (LM_BATCH, 1, cfg.padded_vocab)
                and bool(torch.isfinite(lg).all()),
                "non-finite or misshapen logits")

    # device idle share over the same decode loop, from the same caches
    for c, (k, v) in zip(state["layers"], saved):
        c.k.copy_(k)
        c.v.copy_(v)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, lgs_prof, _ = decode(params, cfg, state, first, LM_GEN,
                                forced=toks)
        torch.cuda.synchronize()
        prof_us = (time.perf_counter() - t0) * 1e6
    busy_us, decode_top = device_breakdown(prof, LM_GEN)
    require(all(torch.equal(a, b) for a, b in zip(lgs_prof, lgs_k)),
            "a repeated decode from the same caches gave other logits")
    # device time by kernel of one more kernel-path prefill
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prefill(params, {"tokens": tokens},
                init_decode_state(cfg, LM_BATCH, max_len))
        torch.cuda.synchronize()
    prefill_busy_us, prefill_top = device_breakdown(prof, 1)

    # the plain path's and the control's decodes, teacher-forced on the
    # kernel path's tokens
    for c, st, lgs in refs.values():
        lgs += decode(params, c, st, first, LM_GEN, forced=toks)[1]
    torch.cuda.synchronize()
    naive = refs["naive"][2]
    kern = [lm_compare(a, b) for a, b in zip([lg_k] + lgs_k, naive)]
    ctrl = [lm_compare(a, b) for a, b in zip(refs["chunked"][2], naive)]
    k_worst = max(kern, key=lambda r: r["ratio"])
    c_worst = max(ctrl, key=lambda r: r["ratio"])
    require(k_worst["ratio"] <= min(LM_BF16_TOL,
                                    2 * c_worst["ratio"] + 0.01),
            f"kernel path vs plain path logits: {k_worst} (control, "
            f"chunked vs plain: {c_worst})")
    agree = float((torch.cat([torch.argmax(a, -1) for a in lgs_k], 1)
                   == torch.cat([torch.argmax(b, -1) for b in naive[1:]],
                                1)).float().mean())
    del params, refs, state, saved
    torch.cuda.empty_cache()

    # float32 at the same width: kernel path vs plain path, prefill (the
    # plain one first: it warms cuBLAS's float32 GEMMs)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = init_model(cfg32, seed=0, device="cuda")
    lg32, secs32 = {}, {}
    for impl in ("naive", "pallas"):
        c = dataclasses.replace(cfg32, attn_impl=impl)
        st = init_decode_state(c, LM_BATCH, max_len)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start_bytes = torch.cuda.memory_allocated()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        lg32[impl], _ = make_prefill(c)(params32, {"tokens": tokens}, st)
        torch.cuda.synchronize()
        secs32[impl] = time.perf_counter() - t0
        if impl == "pallas":
            f32_launches = _build.launch_counts()
            f32_peak = torch.cuda.max_memory_allocated() - start_bytes
        del st
    require(f32_launches == {"flash_attention_tf32": cfg.n_layers,
                             "tf32_split": cfg.n_layers},
            f"the float32 prefill's launches: {f32_launches}")
    f32 = lm_compare(lg32["pallas"], lg32["naive"])
    require(f32["ratio"] <= LM_F32_TOL,
            f"float32 kernel path vs plain path prefill logits: {f32}")
    # the TF32 route's split K and V^T (hi, lo), made and freed per layer
    f32_scratch = (4 * LM_BATCH * cfg.n_kv_heads * LM_PROMPT
                   * cfg.resolved_head_dim * 4)
    del params32, lg32
    torch.cuda.empty_cache()

    res = {
        "arch": LM_ARCH, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "dtype": cfg.dtype, "params": n_params, "init_s": init_s,
        "batch": LM_BATCH, "prompt_len": LM_PROMPT, "gen": LM_GEN,
        "prefill_s": prefill_s,
        "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / prefill_s,
        "decode_ms_per_token": 1e3 * decode_s / LM_GEN,
        "decode_device_idle_share": 1.0 - busy_us / prof_us,
        "decode_profiled_ms_per_token": prof_us / LM_GEN / 1e3,
        "decode_device_busy_ms_per_token": busy_us / LM_GEN / 1e3,
        "decode_top_kernels_ms_per_token": decode_top,
        "prefill_device_busy_ms": prefill_busy_us / 1e3,
        "prefill_top_kernels_ms": prefill_top,
        "decode_weight_bound_ms_per_token":
            1e3 * 2 * n_params / HBM_BYTES_PER_S,
        "peak_device_bytes_above_earlier_phases": peak - base_bytes,
        "flash_launches_prefill": n_prefill,
        "flash_tf32_launches_f32_prefill":
            f32_launches["flash_attention_tf32"],
        "tf32_split_launches_f32_prefill": f32_launches["tf32_split"],
        "f32_prefill_s": secs32["pallas"],
        "f32_plain_prefill_s": secs32["naive"],
        "f32_prefill_peak_bytes_above_caches": f32_peak,
        "f32_prefill_split_scratch_bytes_per_layer": f32_scratch,
        "flash_launches_decode": launches.get("flash_attention", 0)
        - n_prefill,
        "prefill_logits_vs_plain": kern[0],
        "decode_logits_vs_plain_worst": max(kern[1:],
                                            key=lambda r: r["ratio"]),
        "control_chunked_vs_plain_worst": c_worst,
        "f32_prefill_logits_vs_plain": f32,
        "tolerance": f"ratio = |diff| / (|plain logit| + std) <= "
                     f"{LM_BF16_TOL} and <= 2 x control + 0.01 (bf16), "
                     f"<= {LM_F32_TOL} (float32)",
        "decode_argmax_agreement_vs_plain": agree,
    }
    print("lm serving path " + json.dumps(res))
    print(f"lm prefill seconds, 4 x {LM_PROMPT} tokens: bf16 {prefill_s:.4f}"
          f" (flash_attention), float32 {secs32['pallas']:.4f} "
          f"(flash_attention_tf32), float32 plain {secs32['naive']:.4f}")
    return {"res": res, "signatures": signatures, "launches": {
        "sm90": n_prefill, "tf32": f32_launches["flash_attention_tf32"],
        "tf32_split": f32_launches["tf32_split"]}}


# ---------------------------------------------------------------------------
# phase 8: LM training (qwen2-1.5b at full width, then the train driver)
# ---------------------------------------------------------------------------

def trace_profile(prof) -> dict:
    """Where a profiled train step's device time went, from the
    profile's Chrome trace (kineto writes it, ``json`` reads it; the
    profiler's Python event tree took about 50 s for one step of a
    recurrent model): ``busy_us`` (every kernel, copy and memset),
    ``top`` (as ``device_breakdown``), ``flash_ms`` (the flash kernel),
    ``ranges`` (the device ms of the ``torch.profiler`` ranges of the
    flash forward, the plain attention backward and the optimizer) and
    ``unlinked_ms`` (device work whose launch the trace lacks, so that
    no range can hold it).  A range's device ms: the kernels whose launch
    lies inside one of its spans on the launching thread, the
    ctypes-launched flash kernel included."""
    import bisect
    import os
    import tempfile
    names = ("flash_attention_forward", "flash_attention_backward",
             "optimizer_update")
    (ROOT / "build").mkdir(exist_ok=True)
    fd, path = tempfile.mkstemp(suffix=".json", dir=ROOT / "build")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    spans, launch, kernels, by_kernel = {}, {}, [], {}
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X":
            continue
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            by_kernel[e["name"]] = by_kernel.get(e["name"], 0.0) + e["dur"]
            kernels.append((e.get("args", {}).get("correlation"), e["dur"]))
        elif cat in ("cuda_runtime", "cuda_driver"):
            launch[e.get("args", {}).get("correlation")] = (e["tid"], e["ts"])
        elif cat == "user_annotation" and e["name"] in names:
            spans.setdefault((e["name"], e["tid"]), []).append(
                (e["ts"], e["ts"] + e["dur"]))
    require(bool(by_kernel), "the profile's trace holds no kernel")
    for v in spans.values():
        v.sort()
    ranges = dict.fromkeys(names, 0.0)
    unlinked_us = 0.0
    for corr, dur in kernels:
        if corr not in launch:
            unlinked_us += dur
            continue
        tid, ts = launch[corr]
        for name in names:
            iv = spans.get((name, tid), ())
            i = bisect.bisect_right(iv, (ts, float("inf"))) - 1
            if i >= 0 and iv[i][0] <= ts <= iv[i][1]:
                ranges[name] += dur / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    flash_ms = sum(v for k, v in by_kernel.items()
                   if "flash_attention_sm90" in k) / 1e3
    return {"busy_us": sum(by_kernel.values()),
            "top": [[k[:100], v / 1e3] for k, v in top],
            "flash_ms": flash_ms, "ranges": ranges,
            "unlinked_ms": unlinked_us / 1e3}


def grad_gap(a: tuple, b: tuple) -> dict:
    """Loss and per-leaf gradient gaps of route ``a`` against ``b`` (each
    ``(loss, [grad leaves])``): each leaf's error norm over its norm."""
    import numpy as np
    errs = [float((x.float() - y.float()).norm()
                  / y.float().norm().clamp_min(1e-30))
            for x, y in zip(a[1], b[1])]
    return {"loss_rel_diff": abs(a[0] / b[0] - 1.0),
            "worst_leaf_rel_norm_err": max(errs),
            "median_leaf_rel_norm_err": float(np.median(errs))}


def run_train() -> dict:
    """qwen2-1.5b at its full published width in bf16 (``cfg.remat`` as
    configured: each layer checkpointed), ``attn_impl="pallas"``: params
    from ``init_model(seed=0)``, batch 4 x 2048 from the port's
    ``LMBatchPipeline``, AdamW under ``warmup_cosine(3e-4, 2, 5)``.
    First one step's loss and per-leaf gradients on the kernel route
    against the plain chunked route (same params, same batch), then 5
    steps of ``make_train_step`` (launch counts zeroed just before,
    read just after; finite losses and grad norms, step 5's loss below
    step 1's), then a 6th step under ``torch.profiler`` for the shares
    of the flash forward, the plain attention backward and the
    optimizer."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import LMBatchPipeline
    from repro_torch.kernels import _build
    from repro_torch.models import model as M
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.transformer import init_model
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.tree import tree_flatten, tree_signature
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(LM_ARCH), attn_impl="pallas")
    require((cfg.n_layers, cfg.d_model, cfg.dtype, cfg.remat)
            == (28, 1536, "bfloat16", True),
            "qwen2-1.5b is not at its full width with remat")
    base_bytes = torch.cuda.memory_allocated()
    params = init_model(cfg, seed=0, device="cuda")
    n_params = sum(t.numel() for t in tree_flatten(params)[0])
    pipe = LMBatchPipeline(cfg, ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH,
                                            "train"), seed=0)

    def batch(i):
        return {k: torch.from_numpy(v).cuda()
                for k, v in pipe.batch(i).items()}

    # the kernel route against the plain chunked route: one step's loss
    # and per-leaf gradients, same params and batch; the plain naive
    # route against the chunked one is the control (two plain versions
    # that differ in summation order and in where they round to bf16)
    b0 = batch(0)
    grads = {}
    for impl in ("pallas", "chunked", "naive"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        loss_i, _, g_i = M._grads_of(params, c, b0)
        grads[impl] = (float(loss_i), tree_flatten(g_i)[0])
        torch.cuda.synchronize()

    kern_cmp = grad_gap(grads["pallas"], grads["chunked"])
    ctrl_cmp = grad_gap(grads["naive"], grads["chunked"])
    kern_cmp["losses"] = [grads["pallas"][0], grads["chunked"][0]]
    kern_cmp["targets_met"] = (
        kern_cmp["loss_rel_diff"] <= TRAIN_LOSS_TOL
        and kern_cmp["worst_leaf_rel_norm_err"] <= TRAIN_GRAD_TOL)
    del grads
    torch.cuda.empty_cache()
    print(f"train kernel vs plain route, one step: {json.dumps(kern_cmp)}"
          f" (targets: loss <= {TRAIN_LOSS_TOL}, worst leaf <= "
          f"{TRAIN_GRAD_TOL}); control, naive vs chunked: "
          f"{json.dumps(ctrl_cmp)}")
    for key, target in (("loss_rel_diff", TRAIN_LOSS_TOL),
                        ("worst_leaf_rel_norm_err", TRAIN_GRAD_TOL)):
        require(kern_cmp[key] <= max(target, 2 * ctrl_cmp[key] + 0.01),
                f"the kernel route's {key} {kern_cmp[key]} misses both "
                f"its target {target} and twice the control's "
                f"{ctrl_cmp[key]} + 0.01")

    # five steps of the train step, counted and timed
    opt = adamw(warmup_cosine(3e-4, 2, 5))
    opt_state = opt.init(params)
    signatures = {"params": tree_signature(params),
                  "opt_state": tree_signature(opt_state)}
    step = M.make_train_step(cfg, opt)
    batches = [batch(i) for i in range(TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    outs, secs = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt_state, out = step(params, opt_state, batches[i])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        outs.append({k: float(v) for k, v in out.items()})
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    per_step = 2 * cfg.n_layers       # forward + the recompute
    require(launches == {"flash_attention": TRAIN_STEPS * per_step},
            f"training launches {launches}, expected flash_attention "
            f"{TRAIN_STEPS * per_step} (forward and recompute per layer)")
    require(all(np.isfinite(o["loss"]) and np.isfinite(o["grad_norm"])
                for o in outs), f"non-finite loss or grad norm: {outs}")
    require(outs[-1]["loss"] < outs[0]["loss"],
            f"step {TRAIN_STEPS}'s loss is not below step 1's: {outs}")

    # a sixth step under the profiler: where the step's time goes
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, opt_state, batches[TRAIN_STEPS])
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    tr = trace_profile(prof)
    busy_us, top = tr["busy_us"], tr["top"]
    flash_fwd_kernel_ms, ranges = tr["flash_ms"], tr["ranges"]
    steady = float(np.mean(secs[1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = 6 * n_params * tokens
    res = {
        "arch": LM_ARCH, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "dtype": cfg.dtype, "params": n_params, "remat": cfg.remat,
        "attn_impl": cfg.attn_impl, "batch": TRAIN_BATCH,
        "seq": TRAIN_SEQ, "optimizer": "adamw(warmup_cosine(3e-4, 2, 5))",
        "losses": [o["loss"] for o in outs],
        "grad_norms": [o["grad_norm"] for o in outs],
        "tokens_per_step": tokens, "step_s": secs,
        "first_step_s": secs[0], "steady_s_per_step": steady,
        "tokens_per_s": tokens / steady,
        "peak_device_bytes": peak,
        "peak_device_bytes_above_earlier_phases": peak - base_bytes,
        "flash_launches": launches.get("flash_attention", 0),
        "flash_launches_per_step": per_step,
        "six_n_t_flops_per_step": flops,
        "model_flops_per_s": flops / steady,
        "mfu_6nt_vs_bf16_peak": flops / steady / BF16_OPS_PER_S,
        "profiled_step_ms": prof_ms,
        "profiled_device_busy_ms": busy_us / 1e3,
        "profiled_device_idle_share": 1.0 - busy_us / 1e3 / prof_ms,
        "flash_forward_kernel_ms": flash_fwd_kernel_ms,
        "range_device_ms": ranges, "unlinked_device_ms": tr["unlinked_ms"],
        # shares of the profiled step's wall time and of its device busy
        # time: the flash kernels (by name), the rest of the forward
        # range (the heads' layout copies), the plain attention backward
        # and the optimizer (by range)
        "share_of_step": {
            basis: {"flash_forward_kernels": flash_fwd_kernel_ms / total,
                    "flash_forward_layout_ops":
                        (ranges["flash_attention_forward"]
                         - flash_fwd_kernel_ms) / total,
                    "plain_attention_backward":
                        ranges["flash_attention_backward"] / total,
                    "optimizer": ranges["optimizer_update"] / total}
            for basis, total in (("wall", prof_ms),
                                 ("device_busy", max(busy_us / 1e3, 1e-9)))},
        "top_kernels_ms": top,
        "kernel_vs_plain_route": kern_cmp,
        "control_naive_vs_chunked": ctrl_cmp,
    }
    print("lm training path " + json.dumps(res))
    print(f"lm training: {steady:.4f} s per step, "
          f"{tokens / steady:.0f} tokens/s, 6NT/step-time "
          f"{flops / steady / 1e12:.1f} TFLOP/s = "
          f"{100 * flops / steady / BF16_OPS_PER_S:.2f} % of the bf16 "
          f"dense peak, peak {peak / 2 ** 30:.2f} GiB ({gpu_line()})")
    del params, opt_state, batches
    torch.cuda.empty_cache()
    return {"res": res, "launches": launches, "signatures": signatures}


def run_train_driver() -> dict:
    """The train driver's resume on the card (``train_driver_checks``),
    in a child process of this script: deterministic algorithms need
    ``CUBLAS_WORKSPACE_CONFIG`` before the first cuBLAS call, and a
    small fixed cuBLAS workspace would slow this process's other
    phases."""
    import os
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()),
         "--train-driver-child"], env=env, capture_output=True, text=True,
        timeout=600)
    print(proc.stdout, end="")
    require(proc.returncode == 0, f"the train driver check failed "
            f"(rc {proc.returncode}): {proc.stderr[-3000:]}")
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("lm train driver ")]
    require(len(line) == 1, "the train driver check printed no result")
    return json.loads(line[0].removeprefix("lm train driver "))


def train_driver_checks() -> dict:
    """``launch.train.build_trainer`` on the card at qwen2-1.5b and
    qwen3-8b reduced (their configs' plain chunked attention, as the
    reference's launcher): 40 steps with a checkpoint every 10, straight,
    and preempted after step 25 then resumed by a fresh driver: the
    final parameters, AdamW state and the 40 losses equal bit for bit.
    Runs under ``torch.use_deterministic_algorithms(True)`` (the caller
    sets ``CUBLAS_WORKSPACE_CONFIG``): the embedding gather's backward
    accumulates with atomics otherwise."""
    import tempfile
    import torch
    from repro_torch.launch.train import build_trainer
    from repro_torch.tree import tree_flatten
    torch.use_deterministic_algorithms(True)
    out = {}
    try:
        for arch in DRIVER_ARCHS:
            with tempfile.TemporaryDirectory() as tmp:
                t0 = time.perf_counter()
                straight = build_trainer(
                    arch, DRIVER_BATCH, DRIVER_SEQ, DRIVER_STEPS,
                    f"{tmp}/straight", ckpt_every=10)[0].run(DRIVER_STEPS)
                straight_s = time.perf_counter() - t0
                holder = {}

                def preempt(step):
                    if step == DRIVER_PREEMPT - 1:
                        holder["driver"].preempted = True
                holder["driver"] = build_trainer(
                    arch, DRIVER_BATCH, DRIVER_SEQ, DRIVER_STEPS,
                    f"{tmp}/resumed", ckpt_every=10, fault_hook=preempt)[0]
                first = holder["driver"].run(DRIVER_STEPS)
                second = build_trainer(
                    arch, DRIVER_BATCH, DRIVER_SEQ, DRIVER_STEPS,
                    f"{tmp}/resumed", ckpt_every=10)[0].run(DRIVER_STEPS)
            torch.cuda.synchronize()
            losses = [m["loss"] for m in straight["metrics"]]
            resumed = [m["loss"] for m in first["metrics"]
                       + second["metrics"]]
            same = all(torch.equal(a, b) for a, b in zip(
                tree_flatten(straight["state"])[0],
                tree_flatten(second["state"])[0]))
            require(first["preempted"]
                    and first["final_step"] == DRIVER_PREEMPT
                    and second["final_step"] == DRIVER_STEPS,
                    f"{arch}: preempted at {first['final_step']}, resumed "
                    f"to {second['final_step']}")
            require(same and losses == resumed,
                    f"{arch}: the resumed run differs from the straight "
                    "one")
            require(losses[-1] < losses[0], f"{arch}: the loss did not "
                    f"decrease: {losses[0]} -> {losses[-1]}")
            out[arch] = {"steps": DRIVER_STEPS, "preempt_at": DRIVER_PREEMPT,
                         "batch": DRIVER_BATCH, "seq": DRIVER_SEQ,
                         "bit_identical": True, "loss_first": losses[0],
                         "loss_last": losses[-1],
                         "straight_s": straight_s,
                         "median_step_s": sorted(
                             m["dt"] for m in straight["metrics"])[
                             DRIVER_STEPS // 2]}
    finally:
        torch.use_deterministic_algorithms(False)
    print("lm train driver " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 9: the MoE, mamba and RG-LRU families at full width, and the
# padded head widths on reduced configs
# ---------------------------------------------------------------------------

def clone_state(state):
    """A copy of a decode state (KV caches and recurrent states)."""
    if isinstance(state, dict):
        return {k: clone_state(v) for k, v in state.items()}
    if isinstance(state, list):
        return [clone_state(v) for v in state]
    if dataclasses.is_dataclass(state):
        return dataclasses.replace(state, k=state.k.clone(),
                                   v=state.v.clone())
    return state.clone()


def logit_gap(a, b) -> float:
    """max |a - b| over the largest |b| (b the reference)."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / float(b.abs().max())


@contextlib.contextmanager
def route_tape(tape: list, replay: bool):
    """MoE routing on a tape: record each ``moe._route`` call's experts
    (``replay=False``), or route each call to the next recorded experts,
    their weights the caller's own probabilities there, renormalised
    (``replay=True``; the plain path teacher-forced on the kernel path's
    routes as on its tokens)."""
    from unittest import mock
    from repro_torch.models import moe
    route, pos = moe._route, [0]

    def record(probs, k):
        top_w, top_e = route(probs, k)
        tape.append(top_e)
        return top_w, top_e

    def forced(probs, k):
        require(pos[0] < len(tape), "the route tape ran out")
        top_e = tape[pos[0]]
        pos[0] += 1
        require(top_e.shape == (probs.shape[0], k), "the route tape's "
                f"experts {tuple(top_e.shape)} do not fit {probs.shape}")
        top_w = probs.gather(-1, top_e)
        return top_w / top_w.sum(dim=-1, keepdim=True), top_e

    with mock.patch.object(moe, "_route", forced if replay else record):
        yield
    require(not replay or pos[0] == len(tape), f"the plain path routed "
            f"{pos[0]} times, the kernel path {len(tape)}")


def serve_family(arch: str, batch: int, prompt: int, gen: int,
                 split) -> dict:
    """One full-width model of a new family in bf16 (seeded random
    weights from ``init_model``): its parameter count; the kernel path's
    prefill (after one warm-up prefill) and ``gen`` greedy decode steps,
    counted and timed (the counts zeroed just before and read just
    after), the decode loop's idle share (profiled, from a copy of the
    prefill's state); with attention, the plain path (``attn_impl=
    "naive"``, through ``forward``, which also returns the MoE aux
    values) teacher-forced on the kernel path's tokens, beside a control
    (the chunked plain path's gap to it); then, unless ``split``
    is None, a prefill of the first ``split`` tokens and one of the rest
    from its state (``cache_pos=split``) against the one-shot prefill.
    Every logit gap is a share of the largest reference logit.

    Whisper's frames (batch, 1500, STUB_WIDTH) and a VLM's patch
    embeddings (batch, n_patches, STUB_WIDTH) are drawn after the
    prompts from the same numpy generator, as ``serve_batch`` draws
    them; they go with the first part of a two-part prefill only (the
    second part's cross-attention reads the cross caches), and a VLM's
    patches prefix the prompt, so its decode starts at ``n_patches +
    prompt`` and its second part at ``n_patches + split``.  The prefill
    launches flash once per self-attention layer, once per encoder layer
    (non-causal, 1500 keys) and once per cross-attention layer (the
    decoder's queries over the 1500 encoder keys).

    MoE routing is discrete: a difference of one bf16 rounding in a
    token's router input can change its top-k experts, and the changes
    compound over the layers (the share of the prefill's tokens that
    reach another expert set, first and last layer, is reported), as
    they do between two plain paths.  So for a MoE model the plain path
    is teacher-forced on the kernel path's routes too (``route_tape``),
    and that gap is the one held to ``FAMILY_TOL``; the unforced gap,
    and a control of two plain paths (chunked against naive), are
    reported beside it."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import transformer as tt
    from repro_torch.models.frontends import STUB_WIDTH
    from repro_torch.models.layers import torch_dtype
    from repro_torch.models.model import make_prefill
    torch.backends.cuda.matmul.allow_tf32 = False
    t_model = time.perf_counter()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(arch), attn_impl="pallas")
    require(cfg.dtype == "bfloat16", f"{arch} is not bf16")
    n_attn = sum(k in ("attn", "moe") for k in cfg.layer_kinds)
    n_flash = n_attn + cfg.encoder_layers + (cfg.n_layers if cfg.cross_attn
                                             else 0)
    t0 = time.perf_counter()
    params = tt.init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _tensors(params))
    gap = tt.param_count_gap(cfg)
    require(n_params == cfg.param_count() + gap, f"{arch}: {n_params} "
            f"parameters, the config counts {cfg.param_count()} + "
            f"{gap} (param_count_gap)")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (batch, prompt)).astype(
        np.int32)
    tokens = torch.from_numpy(prompts).cuda()
    extra = {}
    for key, n in (("frames", cfg.encoder_seq),
                   ("patch_embeds", cfg.n_patches)):
        if n:
            extra[key] = torch.from_numpy(rng.standard_normal(
                (batch, n, STUB_WIDTH))).to("cuda", torch_dtype(cfg.dtype))
    inputs = {"tokens": tokens, **extra}
    start = cfg.n_patches + prompt
    max_len = start + gen
    res = {"arch": arch, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "kinds": {k: cfg.layer_kinds.count(k)
                     for k in sorted(set(cfg.layer_kinds))},
           "head_dim": cfg.resolved_head_dim, "window": cfg.window,
           "dtype": cfg.dtype, "params": n_params,
           "param_count": cfg.param_count(), "param_count_gap": gap,
           "init_s": init_s, "batch": batch, "prompt_len": prompt,
           "gen": gen, "encoder_layers": cfg.encoder_layers,
           "encoder_frames": cfg.encoder_seq, "patches": cfg.n_patches,
           "prefill_positions": start}

    stage, stage_peak = {}, {}
    t_stage = [time.perf_counter()]

    def lap(name):
        """Seconds and peak bytes (above the phase's base) of a stage."""
        torch.cuda.synchronize()
        now = time.perf_counter()
        stage[name] = now - t_stage[0]
        stage_peak[name] = torch.cuda.max_memory_allocated() - base_bytes
        torch.cuda.reset_peak_memory_stats()
        t_stage[0] = now

    # the kernel path: a warm-up prefill, then prefill and greedy decode
    # (counted, timed; a MoE model's routes recorded)
    prefill = make_prefill(cfg)
    prefill(params, inputs, tt.init_decode_state(cfg, batch, max_len))
    lap("warm_up_prefill")
    state = tt.init_decode_state(cfg, batch, max_len)
    tape = []
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    with route_tape(tape, replay=False):
        t0 = time.perf_counter()
        lg_k, state = prefill(params, inputs, state)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        pre_counts = _build.launch_counts()
        saved = clone_state(state)
        first = torch.argmax(lg_k[:, -1:], dim=-1).to(torch.int32)
        t0 = time.perf_counter()
        toks, lgs_k, _ = decode(params, cfg, state, first, gen,
                                start=start)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    require(pre_counts == ({"flash_attention": n_flash} if n_flash else {}),
            f"{arch}: the prefill's launches {pre_counts}, not one "
            f"flash_attention per attention layer, encoder layer and "
            f"cross-attention ({n_flash})")
    require(counts == pre_counts, f"{arch}: the decode steps launched "
            f"{counts} after the prefill's {pre_counts}")
    require(toks.shape == (batch, gen) and bool(
        ((toks >= 0) & (toks < cfg.padded_vocab)).all()), f"{arch}: bad "
        "tokens")
    kern = [lg_k] + lgs_k
    for lg in kern:
        require(lg.shape == (batch, 1, cfg.padded_vocab)
                and bool(torch.isfinite(lg).all()),
                f"{arch}: non-finite or misshapen logits")

    lap("kernel_path")

    # the decode loop's device idle share over its first steps, from the
    # prefill's state (device events only: the host's op events would
    # cost more to collect than the loop itself)
    n_prof = min(FAMILY_PROFILE_STEPS, gen)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, lgs_prof, _ = decode(params, cfg, clone_state(saved), first,
                                n_prof, forced=toks, start=start)
        torch.cuda.synchronize()
        prof_us = (time.perf_counter() - t0) * 1e6
    busy_us, decode_top = device_breakdown(prof, n_prof)
    require(all(torch.equal(a, b) for a, b in zip(lgs_prof, lgs_k)),
            f"{arch}: a repeated decode from the same state gave other "
            "logits")
    del lgs_prof, prof, saved
    lap("decode_profile")

    def plain(impl: str, forced_routes: bool, routes=None):
        """The plain path's prefill and decode logits, teacher-forced on
        the kernel path's tokens (and routes), and its prefill's aux;
        ``routes``: a list that records the plain path's own routes."""
        c = dataclasses.replace(cfg, attn_impl=impl)
        st = tt.init_decode_state(c, batch, max_len)
        with route_tape(tape, replay=True) if forced_routes \
                else route_tape(routes if routes is not None else [],
                                replay=False):
            x, st, aux = tt.forward(params, c, inputs, state=st,
                                    cache_pos=0)
            lgs = [tt.logits(params, x[:, -1:])]
            lgs += decode(params, c, st, first, gen, forced=toks,
                          start=start)[1]
        return lgs, aux

    if n_attn:
        ref, aux = plain("naive", forced_routes=cfg.is_moe)
        gaps = [logit_gap(a, b) for a, b in zip(kern, ref)]
        tag = "_routes_forced" if cfg.is_moe else ""
        res[f"prefill_logit_gap_vs_plain{tag}"] = gaps[0]
        res[f"decode_logit_gap_vs_plain{tag}_worst"] = max(gaps[1:])
        require(max(gaps) <= FAMILY_TOL, f"{arch}: kernel path vs plain "
                f"path logits differ by {max(gaps)} of the largest logit "
                f"(> {FAMILY_TOL})")
        res["decode_argmax_agreement_vs_plain"] = float(
            (torch.cat([torch.argmax(a, -1) for a in lgs_k], 1)
             == torch.cat([torch.argmax(b, -1) for b in ref[1:]], 1))
            .float().mean())
        if not cfg.is_moe:
            ctrl, _ = plain("chunked", forced_routes=False)
            res["control_chunked_vs_plain_worst"] = max(
                logit_gap(a, b) for a, b in zip(ctrl, ref))
            del ctrl
        if cfg.is_moe:
            res["prefill_frac_dropped_mean_over_layers"] = float(
                aux["frac_dropped"]) / cfg.n_layers
            res["prefill_load_balance_mean_over_layers"] = float(
                aux["load_balance"]) / cfg.n_layers
            own = []
            free, _ = plain("naive", forced_routes=False, routes=own)
            ctrl, _ = plain("chunked", forced_routes=False)
            res["logit_gap_vs_plain_unforced_worst"] = max(
                logit_gap(a, b) for a, b in zip(kern, free))
            res["control_chunked_vs_plain_unforced_worst"] = max(
                logit_gap(a, b) for a, b in zip(ctrl, free))
            # the prefill's tokens (share) whose expert set differs
            # between the kernel path and the unforced plain path, by layer
            moved = [float((a.sort(-1).values != b.sort(-1).values)
                           .any(-1).float().mean())
                     for a, b in zip(tape[:cfg.n_layers], own)]
            res["prefill_tokens_rerouted_unforced_first_last_layer"] = [
                moved[0], moved[-1]]
            del free, ctrl, own
        del ref, aux
    del tape
    lap("plain_paths")

    # the prefill in two parts against the one-shot prefill (not for
    # MoE: each routed batch has its own capacity ranks, so the parts
    # drop other assignments than the whole)
    if split:
        st2 = tt.init_decode_state(cfg, batch, max_len)
        _, st2 = prefill(params, dict(extra, tokens=tokens[:, :split]), st2)
        x, st2, _ = tt.forward(params, cfg, {"tokens": tokens[:, split:]},
                               state=st2, cache_pos=cfg.n_patches + split)
        res["split_prefill"] = [split, prompt - split]
        res["split_prefill_logit_gap"] = logit_gap(
            tt.logits(params, x[:, -1:]), lg_k)
        require(res["split_prefill_logit_gap"] <= FAMILY_TOL,
                f"{arch}: the prefill in two parts ({split} + "
                f"{prompt - split}) differs from the one-shot prefill by "
                f"{res['split_prefill_logit_gap']} of the largest logit")
        del st2, x
        lap("split_prefill")
    peak = max(stage_peak.values())
    res.update({
        "prefill_s": prefill_s,
        "prefill_tokens_per_s": batch * start / prefill_s,
        "decode_ms_per_token": 1e3 * decode_s / gen,
        "decode_device_idle_share": 1.0 - busy_us / prof_us,
        "decode_profiled_steps": n_prof,
        "decode_profiled_ms_per_token": prof_us / n_prof / 1e3,
        "decode_device_busy_ms_per_token": busy_us / n_prof / 1e3,
        "decode_top_kernels_ms_per_token": decode_top,
        "decode_weight_bound_ms_per_token":
            1e3 * 2 * n_params / HBM_BYTES_PER_S,
        "peak_device_bytes_above_earlier_phases": peak,
        "flash_launches_prefill": n_flash,
        "flash_launches_decode": counts.get("flash_attention", 0) - n_flash,
        "flash_launches_prefill_encoder_self_cross": [
            cfg.encoder_layers, n_attn, cfg.n_layers if cfg.cross_attn
            else 0],
        "tolerance": f"max |diff| <= {FAMILY_TOL} x max |reference logit|",
        "stage_s": stage, "stage_peak_bytes": stage_peak,
        "model_s": time.perf_counter() - t_model,
    })
    del params, state, lg_k, lgs_k, kern, inputs, extra
    torch.cuda.empty_cache()
    print(f"lm family {arch} " + json.dumps(res), flush=True)
    print(f"lm family {arch}: prefill {batch} x {start} {prefill_s:.4f} s "
          f"({batch * start / prefill_s:.0f} tok/s), decode "
          f"{1e3 * decode_s / gen:.2f} ms/token, idle "
          f"{1.0 - busy_us / prof_us:.3f} ({n_prof} steps profiled), "
          f"flash {n_flash} per prefill, "
          f"peak {peak / 2 ** 30:.2f} GiB", flush=True)
    return res


def run_families() -> dict:
    """Phase 9: each full-width model of ``FAMILIES`` in turn (each freed
    before the next), then ``run_reduced_on_card``.  Returns the flash
    launches per model and route."""
    out = {}
    for arch, batch, prompt, gen, split in FAMILIES:
        out[arch] = serve_family(arch, batch, prompt, gen, split)
    reduced = run_reduced_on_card()
    return {"sm90": {**{a: r["flash_launches_prefill"]
                        for a, r in out.items()}, **reduced["sm90"]},
            "tf32": reduced["tf32"]}


def run_encdec() -> dict:
    """Phase 10: whisper-small and internvl2-26b at full width, each in
    turn through ``serve_family`` (each freed before the next; the
    memory earlier phases left cached is returned first).  Returns the
    flash launches per prefill per model."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    print(f"lm encdec: {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
          "allocated before phase 10", flush=True)
    out = {}
    for arch, batch, prompt, gen, split in ENCDEC_FAMILIES:
        out[arch] = serve_family(arch, batch, prompt, gen, split)
    return {a: r["flash_launches_prefill"] for a, r in out.items()}


def run_reduced_on_card() -> dict:
    """Reduced configs whose heads the kernels are not built for
    (``REDUCED_ON_CARD``: kimi-k2's and internvl's 8, qwen2.5-3b's and
    whisper's 12, padded to 16), in float32 through the kernel path on
    the card (the 3xTF32 kernel and its pre-pass) against the same
    weights, tokens (and frames or patches) on the CPU (where the
    wrapper is the plain version): a prefill and 8 greedy decode steps,
    the CPU teacher-forced on the card's tokens.  Then ``REDUCED_BF16``
    in bf16 (12 padded to 16, the bf16 tensor-core kernel), its kernel
    path against the plain path (``"naive"``) on the card, teacher-forced,
    within ``FAMILY_TOL`` of the largest logit.  Returns each config's
    flash launches by route ({"tf32": ..., "sm90": ...}): one per
    self-attention, encoder and cross-attention layer in the prefill."""
    import numpy as np
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import _build
    from repro_torch.models import transformer as tt
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.frontends import STUB_WIDTH
    from repro_torch.models.model import make_prefill, make_serve_step
    from repro_torch.tree import tree_flatten, tree_unflatten
    torch.backends.cuda.matmul.allow_tf32 = False
    launches = {}
    for arch in REDUCED_ON_CARD:
        cfg = dataclasses.replace(get_reduced(arch), attn_impl="pallas")
        n_attn = sum(k in ("attn", "moe") for k in cfg.layer_kinds) \
            + cfg.encoder_layers + (cfg.n_layers if cfg.cross_attn else 0)
        leaves, treedef = tree_flatten(tt.init_model(cfg, seed=0,
                                                     device="cpu"))
        rng = np.random.default_rng(1)
        host = {"tokens": rng.integers(0, cfg.vocab_size, (2, 40)).astype(
            np.int32)}
        for key, n in (("frames", cfg.encoder_seq),
                       ("patch_embeds", cfg.n_patches)):
            if n:
                host[key] = rng.standard_normal(
                    (2, n, STUB_WIDTH)).astype(np.float32)
        start = cfg.n_patches + 40
        runs = {}
        for dev in ("cuda", "cpu"):
            params = tree_unflatten(treedef, [t.to(dev) for t in leaves])
            batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
            state = tt.init_decode_state(cfg, 2, start + 8, device=dev)
            _build.reset_launch_counts()
            lg, state = make_prefill(cfg)(params, batch, state)
            n_pre = _build.launch_counts()
            step = make_serve_step(cfg)
            lgs, toks = [lg], runs.get("cuda", {}).get("toks")
            fed = []
            for i in range(8):
                t = (toks[i].to(dev) if toks is not None else
                     torch.argmax(lgs[-1][:, -1:], -1).to(torch.int32))
                fed.append(t)
                lg, state = step(params, state, t, start + i)
                lgs.append(lg)
            runs[dev] = {"lgs": [x.cpu() for x in lgs], "toks": fed,
                         "prefill": n_pre, "all": _build.launch_counts()}
        card, cpu = runs["cuda"], runs["cpu"]
        want = {"flash_attention_tf32": n_attn, "tf32_split": n_attn}
        require(card["prefill"] == want and card["all"] == want,
                f"{arch} reduced: the card's launches {card['all']} "
                f"(prefill {card['prefill']}), not {want}")
        require(cpu["all"] == {}, f"{arch} reduced: the CPU launched "
                f"{cpu['all']}")
        gap = max(logit_gap(a, b) for a, b in zip(card["lgs"], cpu["lgs"]))
        require(gap <= REDUCED_TOL, f"{arch} reduced: card vs CPU logits "
                f"differ by {gap} of the largest logit")
        launches[cfg.name] = n_attn
        print(f"lm reduced on card {cfg.name} " + json.dumps({
            "head_dim": cfg.resolved_head_dim, "dtype": cfg.dtype,
            "padded_head_dim": fa.padded_head_dim(
                "tf32", cfg.resolved_head_dim),
            "flash_tf32_launches_prefill": n_attn,
            "tf32_split_launches_prefill": n_attn,
            "flash_launches_decode": 0,
            "logit_gap_card_vs_cpu_worst": gap,
            "tolerance": f"<= {REDUCED_TOL} x max |CPU logit|"}))
    return {"tf32": launches, "sm90": reduced_bf16()}


def reduced_bf16() -> dict:
    """``REDUCED_BF16`` in bf16 on the card: the kernel path (the bf16
    tensor-core kernel, its 12-wide heads padded to 16) against the
    plain path on the same weights and tokens, a prefill and 8 greedy
    decode steps, the plain path teacher-forced on the kernel path's
    tokens; each step's logits within ``FAMILY_TOL`` of the largest.
    Returns its flash launches per prefill."""
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as tt
    from repro_torch.models.model import make_prefill, make_serve_step
    base = dataclasses.replace(get_reduced(REDUCED_BF16), dtype="bfloat16")
    params = tt.init_model(base, seed=0, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    tok = torch.randint(0, base.vocab_size, (2, 40), device="cuda",
                        generator=gen, dtype=torch.int32)
    n_attn = sum(k in ("attn", "moe") for k in base.layer_kinds)
    runs = {}
    for impl in ("pallas", "naive"):
        cfg = dataclasses.replace(base, attn_impl=impl)
        state = tt.init_decode_state(cfg, 2, 48, device="cuda")
        _build.reset_launch_counts()
        lg, state = make_prefill(cfg)(params, {"tokens": tok}, state)
        n_pre = _build.launch_counts()
        step = make_serve_step(cfg)
        lgs, fed = [lg], runs.get("pallas", {}).get("toks")
        toks = []
        for i in range(8):
            t = (fed[i] if fed is not None else
                 torch.argmax(lgs[-1][:, -1:], -1).to(torch.int32))
            toks.append(t)
            lg, state = step(params, state, t, 40 + i)
            lgs.append(lg)
        torch.cuda.synchronize()
        runs[impl] = {"lgs": lgs, "toks": toks, "prefill": n_pre,
                      "all": _build.launch_counts()}
    kern, plain = runs["pallas"], runs["naive"]
    want = {"flash_attention": n_attn}
    require(kern["prefill"] == want and kern["all"] == want
            and plain["all"] == {}, f"{REDUCED_BF16} reduced bf16: "
            f"launches {kern['all']} (prefill {kern['prefill']}), plain "
            f"{plain['all']}, not {want}")
    require(all(bool(torch.isfinite(x).all()) for x in kern["lgs"]),
            f"{REDUCED_BF16} reduced bf16: non-finite logits")
    gap = max(logit_gap(a, b) for a, b in zip(kern["lgs"], plain["lgs"]))
    require(gap <= FAMILY_TOL, f"{REDUCED_BF16} reduced bf16: kernel vs "
            f"plain logits differ by {gap} of the largest logit")
    print(f"lm reduced on card {base.name} bf16 " + json.dumps({
        "head_dim": base.resolved_head_dim, "dtype": base.dtype,
        "padded_head_dim": fa.padded_head_dim(
            "sm90", base.resolved_head_dim),
        "flash_launches_prefill": n_attn, "flash_launches_decode": 0,
        "logit_gap_kernel_vs_plain_worst": gap,
        "tolerance": f"<= {FAMILY_TOL} x max |plain logit|"}))
    return {f"{base.name} bf16": n_attn}


# ---------------------------------------------------------------------------
# phase 12: training the MoE, mamba, RG-LRU, whisper and internvl families
# ---------------------------------------------------------------------------

def family_flash_per_step(cfg) -> int:
    """Flash launches of one remat train step: the forward and the
    backward's recompute of every self-attention, encoder and
    cross-attention layer."""
    n_attn = sum(k in ("attn", "moe") for k in cfg.layer_kinds)
    return 2 * (n_attn + cfg.encoder_layers
                + (cfg.n_layers if cfg.cross_attn else 0))


def train_family(arch: str, layers, batch: int, seq: int,
                 opt_name: str) -> dict:
    """One family's train step on the card at its published width (depth
    cut to ``layers`` where given), bf16, ``attn_impl="pallas"``, seeded
    random weights, batches of ``LMBatchPipeline`` (``seq`` tokens, a
    VLM's patches on top, whisper's frames beside): one step's loss and
    per-leaf gradients on the kernel route against the plain chunked
    route, with naive against chunked as the control (phase 8's
    targets; a MoE model's plain routes teacher-forced on the kernel
    route's experts, the backward's recompute included); then
    ``TRAIN_FAMILY_STEPS`` steps of ``make_train_step`` (launch counts
    zeroed just before and read just after; finite losses and grad
    norms, the last loss below the first) and one more under the
    profiler for the shares of the flash forward, the plain attention
    backward and the optimizer.  A MoE model also gives the dropped share
    of one forward over the first batch and over serving's uniform
    prompts of the same shape."""
    import gc
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import LMBatchPipeline
    from repro_torch.kernels import _build
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tt
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adafactor, adamw, warmup_cosine
    from repro_torch.tree import tree_flatten
    torch.backends.cuda.matmul.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    full = get_config(arch)
    cfg = dataclasses.replace(full, attn_impl="pallas",
                              n_layers=layers or full.n_layers)
    require(cfg.dtype == "bfloat16" and cfg.remat, f"{arch}: not bf16 "
            "with remat")
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    stage_s, t_stage = {}, [time.perf_counter()]

    def lap(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        stage_s[name] = now - t_stage[0]
        t_stage[0] = now
    params = tt.init_model(cfg, seed=0, device="cuda")
    lap("init")
    n_params = sum(t.numel() for t in tree_flatten(params)[0])
    require(n_params == cfg.param_count() + tt.param_count_gap(cfg),
            f"{arch}: {n_params} parameters, the config counts "
            f"{cfg.param_count()} + {tt.param_count_gap(cfg)}")
    n_full = full.param_count() + tt.param_count_gap(full)
    print(f"lm train family {arch}: {cfg.n_layers} of {full.n_layers} "
          f"layers at d_model {cfg.d_model}, {n_params:,} parameters "
          f"(the full model {n_full:,})", flush=True)
    pipe = LMBatchPipeline(cfg, ShapeConfig("train", seq + cfg.n_patches,
                                            batch, "train"), seed=0)

    def batch_of(i):
        return {k: torch.from_numpy(v).cuda()
                for k, v in pipe.batch(i).items()}

    # the kernel route against the plain chunked route, naive against
    # chunked the control; the plain routes replay the kernel route's MoE
    # experts, forward and recompute, in call order
    b0 = batch_of(0)
    tape, grads = [], {}
    for impl in ("pallas", "chunked", "naive"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        with route_tape(tape, replay=impl != "pallas"):
            loss_i, _, g_i = M._grads_of(params, c, b0)
        grads[impl] = (float(loss_i), tree_flatten(g_i)[0])
        torch.cuda.synchronize()
    kern_cmp = grad_gap(grads["pallas"], grads["chunked"])
    ctrl_cmp = grad_gap(grads["naive"], grads["chunked"])
    kern_cmp["losses"] = [grads["pallas"][0], grads["chunked"][0]]
    kern_cmp["routes_taped"] = len(tape)
    drops = {}
    if cfg.is_moe:
        # the first batch's dropped share against serving's prompts (as
        # phase 9 draws them) at the same shape: the router's skew from
        # the pipeline's Zipf tokens, or from training
        uniform = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, tuple(b0["tokens"].shape)).astype(
                np.int32)).cuda()
        with torch.no_grad():
            for src, toks in (("pipeline_tokens", b0["tokens"]),
                              ("serving_prompts", uniform)):
                aux = tt.forward(params, cfg, {"tokens": toks})[2]
                drops[src] = float(aux["frac_dropped"]) \
                    / cfg.layer_kinds.count("moe")
        del uniform, aux
    del grads, tape, b0
    torch.cuda.empty_cache()
    for key, target in (("loss_rel_diff", TRAIN_LOSS_TOL),
                        ("worst_leaf_rel_norm_err", TRAIN_GRAD_TOL)):
        require(kern_cmp[key] <= max(target, 2 * ctrl_cmp[key] + 0.01),
                f"{arch}: the kernel route's {key} {kern_cmp[key]} misses "
                f"both its target {target} and twice the control's "
                f"{ctrl_cmp[key]} + 0.01")
    kern_cmp["targets_met"] = (
        kern_cmp["loss_rel_diff"] <= TRAIN_LOSS_TOL
        and kern_cmp["worst_leaf_rel_norm_err"] <= TRAIN_GRAD_TOL)
    lap("routes")

    lr = warmup_cosine(3e-4, 2, 5)
    opt = (adafactor(lr, stacks=tt.stack_groups(cfg))
           if opt_name == "adafactor" else adamw(lr))
    opt_state = opt.init(params)
    step = M.make_train_step(cfg, opt)
    batches = [batch_of(i) for i in range(TRAIN_FAMILY_STEPS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    outs, secs = [], []
    for i in range(TRAIN_FAMILY_STEPS):
        t0 = time.perf_counter()
        params, opt_state, out = step(params, opt_state, batches[i])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        outs.append({k: float(v) for k, v in out.items()})
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    per_step = family_flash_per_step(cfg)
    want = {"flash_attention": TRAIN_FAMILY_STEPS * per_step} \
        if per_step else {}
    require(launches == want, f"{arch}: training launched {launches}, "
            f"not {want}")
    require(all(np.isfinite(o["loss"]) and np.isfinite(o["grad_norm"])
                for o in outs), f"{arch}: non-finite loss or grad norm: "
            f"{outs}")
    require(outs[-1]["loss"] < outs[0]["loss"], f"{arch}: step "
            f"{TRAIN_FAMILY_STEPS}'s loss is not below step 1's: {outs}")
    lap("steps")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, opt_state, batches[TRAIN_FAMILY_STEPS])
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    tr = trace_profile(prof)
    busy_us, top, flash_ms, ranges = (tr["busy_us"], tr["top"],
                                      tr["flash_ms"], tr["ranges"])
    lap("profile")
    steady = float(np.mean(secs[1:]))
    tokens = batch * seq
    positions = batch * (seq + cfg.n_patches + cfg.encoder_seq)
    res = {
        "arch": arch, "layers": cfg.n_layers, "published_layers":
        full.n_layers, "encoder_layers": cfg.encoder_layers,
        "d_model": cfg.d_model, "head_dim": cfg.resolved_head_dim,
        "window": cfg.window, "dtype": cfg.dtype, "params": n_params,
        "stage_s": stage_s, "optimizer": f"{opt_name}(warmup_cosine(3e-4, "
        "2, 5))" + (", stacks=stack_groups(cfg)"
                     if opt_name == "adafactor" else ""),
        "batch": batch, "seq": seq, "patches": cfg.n_patches,
        "encoder_frames": cfg.encoder_seq,
        "losses": [o["loss"] for o in outs],
        "grad_norms": [o["grad_norm"] for o in outs],
        "step_s": secs, "steady_s_per_step": steady,
        "tokens_per_s": tokens / steady,
        "positions_per_s": positions / steady,
        "peak_device_bytes_above_phase": peak - base_bytes,
        "flash_launches": launches.get("flash_attention", 0),
        "flash_launches_per_step": per_step,
        "profiled_step_ms": prof_ms,
        "profiled_device_busy_ms": busy_us / 1e3,
        "profiled_device_idle_share": 1.0 - busy_us / 1e3 / prof_ms,
        "flash_forward_kernel_ms": flash_ms, "range_device_ms": ranges,
        "unlinked_device_ms": tr["unlinked_ms"],
        "share_of_device_busy": {
            "flash_forward_kernels": flash_ms / max(busy_us / 1e3, 1e-9),
            "plain_attention_backward":
                ranges["flash_attention_backward"] / max(busy_us / 1e3,
                                                         1e-9),
            "optimizer": ranges["optimizer_update"] / max(busy_us / 1e3,
                                                          1e-9)},
        "top_kernels_ms": top,
        "kernel_vs_plain_route": kern_cmp,
        "control_naive_vs_chunked": ctrl_cmp,
    }
    if cfg.is_moe:
        n_moe = cfg.layer_kinds.count("moe")
        res["moe_frac_dropped_per_layer"] = [o["frac_dropped"] / n_moe
                                             for o in outs]
        res["moe_frac_dropped_first_batch_forward"] = drops
    print("lm train family " + json.dumps(res), flush=True)
    print(f"lm train family {arch}: {steady:.4f} s per step, "
          f"{tokens / steady:.0f} tokens/s, peak "
          f"{(peak - base_bytes) / 2 ** 30:.2f} GiB ({gpu_line()})",
          flush=True)
    del params, opt_state, batches
    gc.collect()
    torch.cuda.empty_cache()
    return res


def train_reduced_on_card() -> dict:
    """The reduced configs of ``TRAIN_FAMILIES`` in float32 with
    ``attn_impl="pallas"``: ``TRAIN_FAMILY_STEPS`` train steps on the
    card (the 3xTF32 flash kernel and its pre-pass, heads padded to 16)
    against the same steps on the CPU (the plain version), same weights
    and batches (internvl under Adafactor over its stack group): losses
    and grad norms within ``REDUCED_TOL`` of the CPU's, every parameter
    leaf's error norm within ``REDUCED_TOL`` of its norm.  Returns the
    card's flash launches per config."""
    import numpy as np
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import LMBatchPipeline
    from repro_torch.kernels import _build
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tt
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adafactor, adamw, warmup_cosine
    from repro_torch.tree import tree_flatten, tree_unflatten
    torch.backends.cuda.matmul.allow_tf32 = False
    launches = {}
    for arch, _, _, _, opt_name in TRAIN_FAMILIES:
        cfg = dataclasses.replace(get_reduced(arch), attn_impl="pallas")
        leaves, treedef = tree_flatten(tt.init_model(cfg, seed=0,
                                                     device="cpu"))
        pipe = LMBatchPipeline(cfg, ShapeConfig("train", 48 + cfg.n_patches,
                                                2, "train"), seed=0)
        runs = {}
        for dev in ("cuda", "cpu"):
            params = tree_unflatten(treedef, [t.to(dev, copy=True)
                                              for t in leaves])
            lr = warmup_cosine(3e-4, 2, 5)
            opt = (adafactor(lr, stacks=tt.stack_groups(cfg))
                   if opt_name == "adafactor" else adamw(lr))
            state = opt.init(params)
            step = M.make_train_step(cfg, opt)
            _build.reset_launch_counts()
            outs = []
            for i in range(TRAIN_FAMILY_STEPS):
                b = {k: torch.from_numpy(v).to(dev)
                     for k, v in pipe.batch(i).items()}
                params, state, out = step(params, state, b)
                outs.append({k: float(v) for k, v in out.items()})
            runs[dev] = (outs, [t.cpu() for t in tree_flatten(params)[0]],
                         _build.launch_counts())
        (card, card_p, card_n), (cpu, cpu_p, cpu_n) = runs["cuda"], \
            runs["cpu"]
        per = family_flash_per_step(cfg)
        want = ({"flash_attention_tf32": TRAIN_FAMILY_STEPS * per,
                 "tf32_split": TRAIN_FAMILY_STEPS * per} if per else {})
        require(card_n == want and cpu_n == {}, f"{arch} reduced: the "
                f"card launched {card_n} (not {want}), the CPU {cpu_n}")
        gaps = {key: max(abs(a[key] / b[key] - 1.0)
                         for a, b in zip(card, cpu))
                for key in ("loss", "grad_norm")}
        gaps["worst_leaf_rel_norm_err"] = max(
            float((a - b).norm() / b.norm().clamp_min(1e-30))
            for a, b in zip(card_p, cpu_p))
        require(all(np.isfinite(o["loss"]) for o in card)
                and max(gaps.values()) <= REDUCED_TOL,
                f"{arch} reduced: card vs CPU training gaps {gaps} beyond "
                f"{REDUCED_TOL}")
        launches[cfg.name] = card_n.get("flash_attention_tf32", 0)
        print(f"lm train reduced on card {cfg.name} " + json.dumps({
            "dtype": cfg.dtype, "optimizer": opt_name,
            "head_dim": cfg.resolved_head_dim, "steps": TRAIN_FAMILY_STEPS,
            "card_losses": [o["loss"] for o in card],
            "cpu_losses": [o["loss"] for o in cpu],
            "card_vs_cpu": gaps, "flash_tf32_launches": launches[cfg.name],
            "tolerance": f"<= {REDUCED_TOL} relative"}), flush=True)
    return launches


def train_steps_peak(pkg: str, arch: str, layers: int, batch: int,
                     seq: int) -> dict:
    """Two AdamW train steps of ``arch`` (bf16, ``layers`` deep,
    published width) on one batch of ``batch`` x ``seq`` tokens through
    the package ``pkg``: each step's seconds and loss (``step_s`` the
    last step's: the first also warms the allocator), and the peak
    device bytes above those allocated before the model's init
    (parameters, AdamW's state, the batch, gradients and activations)."""
    import gc
    import importlib
    import torch

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(mod("configs").get_config(arch),
                              n_layers=layers)
    base = torch.cuda.memory_allocated()
    params = mod("models.transformer").init_model(cfg, seed=0,
                                                  device="cuda")
    optim = mod("optim")
    opt = optim.adamw(optim.warmup_cosine(3e-4, 2, 5))
    state = opt.init(params)
    shape = mod("models.config").ShapeConfig("train", seq, batch, "train")
    b = {k: torch.from_numpy(v).cuda() for k, v in mod(
        "data.pipeline").LMBatchPipeline(cfg, shape).batch(0).items()}
    step = mod("models.model").make_train_step(cfg, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {"package": pkg, "arch": arch, "layers": layers, "batch": batch,
           "seq": seq, "steps_s": [], "losses": []}
    try:
        for _ in range(2):
            t0 = time.perf_counter()
            params, state, res = step(params, state, b)
            torch.cuda.synchronize()
            out["steps_s"].append(time.perf_counter() - t0)
            out["losses"].append(float(res["loss"]))
        out.update(step_s=out["steps_s"][-1], out_of_memory=False)
    except torch.cuda.OutOfMemoryError:
        out.update(out_of_memory=True)
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated() - base
    del params, state, b
    gc.collect()
    torch.cuda.empty_cache()
    return out


def scan_remat_saving() -> dict:
    """What the recurrent scans' per-chunk checkpoint saves and costs at
    phase 12's falcon-mamba and recurrentgemma shapes: ``train_steps_peak``
    through the port, then through a copy of it (``build/scan_remat_off/
    repro_torch_scan_remat_off``, imported under that name) whose scans
    keep every chunk's tensors for the backward: the checkpoint taken
    out of ``models/ssm.py`` and ``models/rglru.py`` by text
    replacement.  The same loss from both."""
    import shutil
    name = "repro_torch_scan_remat_off"
    root = ROOT / "build" / "scan_remat_off"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", root / name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    old = "remat = state is None and torch.is_grad_enabled()"
    for f in ("ssm.py", "rglru.py"):
        path = root / name / "models" / f
        text = path.read_text()
        require(text.count(old) == 1, f"{f}: the chunk checkpoint's "
                "switch is not where the copy expects it")
        path.write_text(text.replace(old, "remat = False"))
    sys.path.insert(0, str(root))
    res = {}
    for arch, layers, batch, seq, _ in TRAIN_FAMILIES:
        if arch not in ("falcon-mamba-7b", "recurrentgemma-9b"):
            continue
        on = train_steps_peak("repro_torch", arch, layers, batch, seq)
        off = train_steps_peak(name, arch, layers, batch, seq)
        require(not on["out_of_memory"], f"{arch}: the step ran out of "
                "memory")
        require(off["out_of_memory"] or off["losses"] == on["losses"],
                f"{arch}: the copy without the chunk checkpoint computes "
                f"other losses ({off['losses']} against {on['losses']})")
        res[arch] = {
            "with_chunk_checkpoint": on, "without_chunk_checkpoint": off,
            "saved_bytes": None if off["out_of_memory"]
            else off["peak_device_bytes"] - on["peak_device_bytes"],
            "added_step_s": None if off["out_of_memory"]
            else on["step_s"] - off["step_s"]}
    print("scan remat saving " + json.dumps(res), flush=True)
    return res


def run_train_families() -> dict:
    """Phase 12: each config of ``TRAIN_FAMILIES`` in turn (each freed
    before the next), the chunk checkpoint's saving and cost at the
    recurrent configs' shapes (``scan_remat_saving``), then
    ``train_reduced_on_card``.
    Returns the flash launches by route and config."""
    out = {}
    for arch, layers, batch, seq, opt_name in TRAIN_FAMILIES:
        out[arch] = train_family(arch, layers, batch, seq, opt_name)
    saving = scan_remat_saving()
    reduced = train_reduced_on_card()
    return {"res": out, "scan_remat": saving,
            "launches": {"sm90": {a: r["flash_launches"]
                                  for a, r in out.items()},
                         "tf32": reduced}}


# ---------------------------------------------------------------------------
# phase 11: the cost models against the card
# ---------------------------------------------------------------------------

def same_tree(abstract, signature: list, label: str) -> int:
    """Require ``tree_signature(abstract)`` (a ``"meta"`` tree) to equal
    ``signature`` (a real tree's, taken on the card) leaf for leaf:
    path, shape, dtype and bytes; returns the total bytes."""
    from repro_torch.tree import tree_signature
    ours = tree_signature(abstract)
    diff = [(a, b) for a, b in zip(ours, signature) if a != b]
    require(len(ours) == len(signature) and not diff,
            f"{label}: the abstract tree differs from the card's "
            f"({len(ours)} against {len(signature)} leaves; first "
            f"differences {diff[:3]})")
    return sum(e[3] for e in ours)


def lm_expected_prefill_flops(cfg, batch: int, seq: int) -> dict:
    """The products a prefill of ``batch`` x ``seq`` tokens computes on
    the chunked route: 2 N T for every parameter but the embedding
    table, the tied LM head at the last position only (2 V d B), and
    the attention products of the live chunk pairs (QK^T and PV, 2 B H
    cq ck D each); 2 N T beside it."""
    from repro_torch.perf.attention_credit import live_chunk_pairs
    n = cfg.param_count()
    vd = cfg.padded_vocab * cfg.d_model
    cq, ck = min(cfg.attn_chunk_q, seq), min(cfg.attn_chunk_k, seq)
    pairs = live_chunk_pairs(seq, seq, cq, ck)
    attn = cfg.n_layers * pairs * 2 * (2 * batch * cfg.n_heads * cq * ck
                                       * cfg.resolved_head_dim)
    tokens = batch * seq
    return {"expected": 2 * (n - vd) * tokens + 2 * vd * batch + attn,
            "two_n_t": 2 * n * tokens, "attention": attn,
            "live_chunk_pairs_per_layer": pairs}


def run_cost_models(runs: dict, ms_runs: dict, lm: dict,
                    train: dict) -> dict:
    """Phase 11: the cost models held against the card.

    Gates: the abstract (``"meta"``) trees equal the real ones the
    earlier phases held on the card, leaf for leaf and in bytes
    (qwen2-1.5b's parameters and its 4 x (2048 + 32) decode state from
    phase 7, AdamW's state from phase 8, phase 5b's 8x8x1240 2x2 state
    and tables with their built storage); the dry run of the same
    qwen2-1.5b shapes completes on ``"meta"`` and its prefill's counted
    products are within 5 % of ``lm_expected_prefill_flops``.  Printed:
    one ``{"cost_model": {...}}`` line, each model figure beside the
    measured one (the static and 2x2 steps against ``step_time_model``
    at the measured rate; prefill, decode and train against the
    roofline terms; the peaks), and ``strong_scaling_curve`` for the
    paper's grids on 1-8 cards (a model: no multi-card run exists)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.snn import CASES
    from repro_torch.core import dist_engine as de
    from repro_torch.core import metrics
    from repro_torch.models import model as M
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.perf.attention_credit import flash_credit_bytes
    from repro_torch.perf.op_analysis import analyze
    from repro_torch.perf.roofline import HW, model_flops, roofline_terms
    from repro_torch.tree import tree_flatten
    t0 = time.perf_counter()
    card = gpu_line()
    hw, snn_hw = HW(), metrics.HardwareModel()

    # gates: the abstract trees against the card's
    cfg = dataclasses.replace(get_config(LM_ARCH), attn_impl="chunked")
    params, _ = M.abstract_params(cfg)
    n_params = sum(t.numel() for t in tree_flatten(params)[0])
    require(n_params == 1_543_910_912, f"abstract qwen2-1.5b holds "
            f"{n_params} parameters")
    gates = {"params_bytes": same_tree(params, lm["signatures"]["params"],
                                       "qwen2-1.5b parameters")}
    require(train["signatures"]["params"] == lm["signatures"]["params"],
            "phases 7 and 8 hold different qwen2-1.5b trees")
    max_len = LM_PROMPT + LM_GEN
    dshape = ShapeConfig("lm_decode", max_len, LM_BATCH, "decode")
    state = M.abstract_decode_state(cfg, dshape)
    gates["decode_state_bytes"] = same_tree(
        state, lm["signatures"]["decode_state"], "qwen2-1.5b decode state")
    opt = adamw(warmup_cosine(3e-4, 2, 5))
    opt_state = opt.abstract_state(params)
    gates["adamw_state_bytes"] = same_tree(
        opt_state, train["signatures"]["opt_state"], "AdamW state")
    for law in LAWS:
        dist = ms_runs[law]["dist"]
        gates[f"dist_2x2_{law}_bytes"] = same_tree(
            de.abstract_dist_inputs(dist["cfg"], storage=dist["storage"],
                                    device="cuda"),
            dist["signature"], f"{law} 2x2 state and tables")

    # the dry run of qwen2-1.5b's measured shapes on "meta"
    pshape = ShapeConfig("lm_prefill", LM_PROMPT, LM_BATCH, "prefill")
    tshape = ShapeConfig("lm_train", TRAIN_SEQ, TRAIN_BATCH, "train")
    t_trace = time.perf_counter()
    costs = {
        "prefill": analyze(M.make_prefill(cfg), params,
                           M.input_specs(cfg, pshape), state),
        "decode": analyze(M.make_serve_step(cfg), params, state,
                          M.input_specs(cfg, dshape)["token"], LM_PROMPT),
        "train": analyze(M.make_train_step(cfg, opt), params, opt_state,
                         M.input_specs(cfg, tshape))}
    trace_s = time.perf_counter() - t_trace
    want = lm_expected_prefill_flops(cfg, LM_BATCH, LM_PROMPT)
    got = costs["prefill"].dot_flops
    require(abs(got / want["expected"] - 1.0) <= 0.05,
            f"the prefill's counted products {got:.6g} against the "
            f"expected {want['expected']:.6g}")
    inputs = {"prefill": gates["params_bytes"] + gates["decode_state_bytes"]
              + LM_BATCH * LM_PROMPT * 4,
              "decode": gates["params_bytes"] + gates["decode_state_bytes"]
              + LM_BATCH * 4,
              "train": gates["params_bytes"] + gates["adamw_state_bytes"]
              + 2 * TRAIN_BATCH * TRAIN_SEQ * 4}
    measured = {
        "prefill": (lm["res"]["prefill_s"], "phase 7: bf16 4 x 2048 "
                    "prefill through the flash kernel"),
        "decode": (lm["res"]["decode_ms_per_token"] / 1e3,
                   "phase 7: one greedy decode step, batch 4"),
        "train": (train["res"]["steady_s_per_step"],
                  "phase 8: steady train step, 4 x 2048, flash forward")}
    shapes = {"prefill": pshape, "decode": dshape, "train": tshape}
    lm_rows = {}
    for kind, c in costs.items():
        rep = roofline_terms(LM_ARCH, kind, "1xh100", 1, c,
                             model_flops(cfg, shapes[kind]), hw=hw)
        credit = flash_credit_bytes(cfg, shapes[kind])
        secs, what = measured[kind]
        bound = rep.step_time_s
        lm_rows[kind] = {
            "measured_s": secs, "measured": what,
            "model_flops": rep.model_flops, "counted_flops": c.flops,
            "counted_dot_flops": c.dot_flops, "counted_bytes": c.bytes,
            "compute_s": rep.compute_s, "memory_s": rep.memory_s,
            "memory_s_flash": max(c.bytes - credit, 0.0) / hw.hbm_bw,
            "dominant": rep.dominant, "roofline_step_s": bound,
            "measured_over_roofline": secs / bound,
            "model_flops_s": rep.model_flops / hw.peak_flops,
            "measured_over_model_flops_s":
                secs / (rep.model_flops / hw.peak_flops),
            "dry_run_peak_bytes": inputs[kind] + c.peak_bytes,
            "dry_run_input_bytes": inputs[kind],
            "ops": c.n_ops, "top_ops_by_bytes": c.top(4)}
    lm_rows["prefill"]["expected_dot_flops"] = want
    lm_rows["prefill"]["measured_peak_bytes_above_earlier_phases"] = \
        lm["res"]["peak_device_bytes_above_earlier_phases"]
    lm_rows["train"]["measured_peak_bytes"] = \
        train["res"]["peak_device_bytes"]
    lm_rows["train"]["measured_peak_bytes_above_earlier_phases"] = \
        train["res"]["peak_device_bytes_above_earlier_phases"]

    # the SNN steps: step_time_model at the measured rate
    snn = {}
    for law in LAWS:
        for label, run, spec in (
                ("static_8x8x1240", runs[law], runs[law]["cfg"].spec()),
                ("dist_8x8x1240_2x2", ms_runs[law],
                 ms_runs[law]["dist"]["cfg"].engine.spec())):
            m = metrics.step_time_model(spec, run["rate_hz"], snn_hw)
            n = 1 if label.startswith("static") else MS_TILES ** 2
            snn[f"{label}_{law}"] = {
                "rate_hz": run["rate_hz"],
                "measured_ms_per_step": run["ms_per_step"],
                "model_step_ms": 1e3 * m["step_s"],
                "model_memory_ms": 1e3 * m["memory_s"],
                "model_compute_ms": 1e3 * m["compute_s"],
                "model_collective_ms": 1e3 * m["collective_s"],
                "measured_over_model": run["ms_per_step"]
                / (1e3 * m["step_s"]),
                "model_events_per_step_all_shards":
                    m["events_per_step"] * n,
                "measured_events_per_step": run["events_per_step"]}
    curves = {}
    for name, case in CASES.items():
        rows = metrics.strong_scaling_curve(
            case.grid[0], case.grid[1], case.connectivity(), [1, 2, 4, 8],
            38.0, case.n_per_column, snn_hw)
        curves[name] = [{"cards": r["shards"], "tiles": r["tiles"],
                         "step_ms": 1e3 * r["step_s"],
                         "s_per_event": r["cost_per_event"]}
                        for r in rows]
    out = {"card": card, "hw": dataclasses.asdict(hw),
           "snn_hw": dataclasses.asdict(snn_hw), "gates": gates,
           "lm_dry_run_trace_s": trace_s, "lm": lm_rows, "snn": snn,
           "strong_scaling_model_38hz": curves,
           "strong_scaling_note": "a model: no multi-card run exists",
           "phase_s": time.perf_counter() - t0}
    print(json.dumps({"cost_model": out}), flush=True)
    return out


def device_breakdown(prof, n: int):
    """(device busy us, top kernels [[name, ms per unit]]) of a profile
    over ``n`` units of work, summed by full kernel name (printed as
    pairs, so names cut to 100 characters cannot merge)."""
    import torch
    by_kernel = {}
    for e in prof.events():
        # a record_function range also shows as a device-side span
        # (gpu_user_annotation): not a kernel, so not busy time
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and not getattr(e, "is_user_annotation", False):
            by_kernel[e.name] = (by_kernel.get(e.name, 0.0)
                                 + e.time_range.elapsed_us())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return (sum(by_kernel.values()),
            [[k[:100], v / n / 1e3] for k, v in top])


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _tensors(v)
    else:
        yield tree


def _sdpa(q, k, v, b: int = LM_BATCH, causal: bool = True):
    """One F.scaled_dot_product_attention call on (B*H, Sq, D) q and
    (B*Kv, Sk, D) k, v (GQA), the yardstick the port never calls, and
    its name."""
    import torch.nn.functional as F
    q4, k4, v4 = (x.view(b, x.shape[0] // b, *x.shape[1:])
                  for x in (q, k, v))
    try:
        F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal,
                                       enable_gqa=True)
        return (lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal, enable_gqa=True),
            f"F.scaled_dot_product_attention(is_causal={causal}, "
            "enable_gqa)")
    except TypeError:
        k4r, v4r = (x.repeat_interleave(q.shape[0] // k.shape[0], 1)
                    for x in (k4, v4))
        return (lambda: F.scaled_dot_product_attention(q4, k4r, v4r,
                                                       is_causal=causal),
                f"F.scaled_dot_product_attention(is_causal={causal}), KV "
                "repeated")


def time_flash(launches: dict, err: dict, train: dict,
               families: dict) -> list:
    """The flash kernels at qwen2-1.5b's prefill shape (one layer of the
    4 x 2048 prefill): the bf16 tensor-core kernel (the serving path),
    the 3xTF32 kernel in float32 (the float32 prefill's route) and its
    pre-pass, with ``time_flash_small``'s narrow heads and
    ``time_flash_encdec``'s shapes under the bf16 row.  Kernels and the
    yardstick F.scaled_dot_product_attention (never called by the port)
    are timed as in ``queued_ms``, with per-call and profiler figures
    beside.  The
    TF32 kernel is timed on a split made once (``ms``), and with its
    pre-pass (``route_ms``).  Each route is also timed writing the row
    statistic (``ms_with_lse``, the training forward's call), beside its
    launches in phase 8's five training steps (``train_launches``;
    ``train``: phase 8's counts) and in phase 9's prefills
    (``family_launches``: ``families``' counts per route and model)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_ref, tf32_split_ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    q, k, v = qwen2_prefill_qkv(gen)
    bh, s, d = q.shape
    # live (q, k) pairs of causal attention, 4 D flops each (QK^T, PV)
    flops = 4 * bh * d * s * (s + 1) / 2
    src = "src/repro_torch/kernels/csrc/"
    sources = {"sm90": "flash_attention_sm90", "tf32": "flash_attention_tf32"}
    rows = []
    # (route, dtype, tensor-core products per flop, peak rate)
    for route, dtype, products, rate in (
            ("sm90", torch.bfloat16, 1, BF16_OPS_PER_S),
            ("tf32", torch.float32, 3, TF32_OPS_PER_S)):
        x = [t.to(dtype) for t in (q, k, v)]
        split = fa.tf32_split_cuda(x[1], x[2]) if route == "tf32" else None
        kern = lambda: fa._launch(route, *x, causal=True, split=split)
        with_lse = lambda: fa._launch(route, *x, causal=True, split=split,
                                      return_lse=True)
        lib, library = _sdpa(*x)
        # q, k, v read once, o written once
        nbytes = sum(t.numel() * t.element_size() for t in (x[0], *x))
        bound_ops = products * flops / rate * 1e3
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        lib_err = float((lib().reshape(q.shape).float()
                         - kern().float()).abs().max())
        require(lib_err <= FLASH_TOL[str(dtype).removeprefix("torch.")] * 4,
                f"the yardstick computes another function: {lib_err}")
        row = {
            "name": fa.ROUTE_KERNELS[route], "route": "cuda",
            "source": src + sources[route] + ".cu",
            "replaces": "src/repro/kernels/flash_attention.py:94",
            "launches": launches[route], "max_abs_err": err[route],
            "lse_max_abs_err": err["lse"][route],
            "train_launches": train.get(fa.ROUTE_KERNELS[route], 0),
            "family_launches": families.get(route, {}),
            "ms": queued_ms(kern, 20), "call_ms": call_ms(kern, 20),
            "ms_with_lse": queued_ms(with_lse, 20),
            "profiler_ms": device_ms(kern, 20),
            "plain_ms": device_ms(lambda: attention_ref(*x, causal=True), 5),
            "bound_ms": max(bound_ops, bound_bytes),
            "bound_by": "operations" if bound_ops >= bound_bytes
            else "bytes",
            "library_ms": queued_ms(lib, 20),
            "library_call_ms": call_ms(lib, 20),
            "library_profiler_ms": device_ms(lib, 20),
            "library_vs_kernel_max_abs_diff": lib_err,
            "bound_bytes_ms": bound_bytes, "flops": flops,
            "library": library,
            "ptxas": [e for e in ptxas(sources[route])
                      if "tf32_split" not in e["entry"]
                      and "fragment_probe" not in e["entry"]],
            "shape": f"q {tuple(q.shape)}, k/v {tuple(k.shape)} "
                     f"{str(dtype).removeprefix('torch.')} causal "
                     "(qwen2-1.5b prefill, one layer)"}
        if route == "tf32":
            whole = lambda: fa._launch("tf32", *x, causal=True)
            row["bound_3xtf32_ms"] = bound_ops
            row["route_ms"] = queued_ms(whole, 20)
            row["route_call_ms"] = call_ms(whole, 20)
            rows.append(row)
            # the pre-pass: k, v read once, the four split planes written
            one = lambda: fa.tf32_split_cuda(x[1], x[2])
            split_bytes = (x[1].numel() + x[2].numel()) * 4 + sum(
                t.numel() * 4 for t in split)
            rows.append({
                "name": fa.SPLIT_KERNEL, "route": "cuda",
                "source": src + "flash_attention_tf32.cu",
                "replaces": "src/repro/kernels/flash_attention.py:94",
                "launches": launches["tf32_split"],
                "max_abs_err": err["tf32_split"],
                "train_launches": train.get(fa.SPLIT_KERNEL, 0),
                "family_launches": {},
                "ms": queued_ms(one, 20), "call_ms": call_ms(one, 20),
                "profiler_ms": device_ms(one, 20),
                "plain_ms": device_ms(lambda: tf32_split_ref(x[1], x[2]), 5),
                "bound_ms": split_bytes / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes", "library_ms": None,
                "bytes": split_bytes,
                "ptxas": [e for e in ptxas(sources[route])
                          if "tf32_split" in e["entry"]],
                "shape": f"k/v {tuple(k.shape)} float32 -> split K and "
                         f"V^T {tuple(split[0].shape)}, "
                         f"{tuple(split[1].shape)}"})
            continue
        if route == "sm90":
            row["at_small_head_dims"] = time_flash_small(gen)
            row["at_encdec_shapes"] = time_flash_encdec(gen)
        rows.append(row)
    return rows


# phase 10's flash calls, one layer each: (label, batch, q heads, kv heads,
# Sq, Sk, head_dim, causal)
ENCDEC_FLASH_SHAPES = [
    ("whisper-small encoder", 16, 12, 12, 1500, 1500, 64, False),
    ("whisper-small cross", 16, 12, 12, 224, 1500, 64, False),
    ("internvl2-26b prefill", 2, 48, 8, 2304, 2304, 128, True),
]


def time_flash_encdec(gen) -> list:
    """The bf16 tensor-core kernel at phase 10's shapes (whisper's
    encoder self-attention and its cross-attention, non-causal over 1500
    keys; internvl's causal GQA prefill over 256 + 2048 positions),
    each beside F.scaled_dot_product_attention on the same inputs, the
    plain version (profiler) and the bound; device time as in
    ``queued_ms``.  Each call is also held against the plain version."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_ref
    out = []
    for label, b, h, kvh, sq, sk, d, causal in ENCDEC_FLASH_SHAPES:
        q, k, v = (torch.randn((b * n, s, d), device="cuda", generator=gen)
                   .to(torch.bfloat16)
                   for n, s in ((h, sq), (kvh, sk), (kvh, sk)))
        require(fa._route(torch.bfloat16, d) == "sm90",
                f"{label}: head_dim {d} bf16 is not on the sm90 route")
        kern = lambda: fa._launch("sm90", q, k, v, causal=causal)
        err = float((kern().float() - attention_ref(
            q, k, v, causal=causal).float()).abs().max())
        require(err <= FLASH_TOL["bfloat16"], f"{label}: the kernel differs "
                f"from its plain version by {err}")
        lib, library = _sdpa(q, k, v, b=b, causal=causal)
        diff = float((lib().reshape(q.shape).float()
                      - kern().float()).abs().max())
        require(diff <= FLASH_TOL["bfloat16"] * 4, f"{label}: the "
                f"yardstick computes another function: {diff}")
        pairs = sq * (sk + 1) / 2 if causal else sq * sk
        flops = 4 * b * h * d * pairs
        nbytes = sum(t.numel() * t.element_size() for t in (q, q, k, v))
        bound_ops = flops / BF16_OPS_PER_S * 1e3
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        out.append({
            "shape": f"{label}: q {tuple(q.shape)}, k/v {tuple(k.shape)} "
                     f"bf16 {'causal' if causal else 'non-causal'}",
            "max_abs_err": err,
            "ms": queued_ms(kern, 20), "call_ms": call_ms(kern, 20),
            "plain_ms": device_ms(lambda: attention_ref(
                q, k, v, causal=causal), 3),
            "bound_ms": max(bound_ops, bound_bytes),
            "bound_by": "operations" if bound_ops >= bound_bytes
            else "bytes", "flops": flops,
            "library_ms": queued_ms(lib, 20), "library": library,
            "library_vs_kernel_max_abs_diff": diff})
        print(f"timing flash at {json.dumps(out[-1])}", flush=True)
    return out


# the special-function units' ex2 rate of an H100 SXM (16 a clock on each
# of 132 SMs; the FlashAttention-3 paper's 3.9 TFLOP/s): one exponent a
# live score, the floor of a softmax that is not on the tensor cores
EXP_PER_S = 3.9e12


def time_flash_small(gen) -> list:
    """The flash routes at the narrow heads: qwen2-1.5b's prefill shape
    with the head narrowed
    (q 48 x 2048 x D, k/v 8 x 2048 x D, causal), D 32 and 16, bf16 (the
    sm90 kernel's D-32 and D-16 instances) and float32 (the TF32
    kernel's), each through ``flash_attention_cuda`` (the TF32 route's
    pre-pass included; ``kernel_ms``: the attention kernel alone on the
    split it is handed) beside F.scaled_dot_product_attention and the
    plain version (profiler) on the same inputs, with ptxas's registers
    and spills of the kernel's instances.  At D 16 the call and the
    kernel alone are also timed on the inputs zero-padded to 32
    (the D-32 instance; ``ms_padded_to_32`` with the padding, the
    output's slice and the wider pre-pass, ``kernel_ms_padded_to_32``
    the kernel alone): what padding instead of a D-16 build would cost.
    Device time as in ``queued_ms``.  The
    bound is the card's: the bytes of q, k, v and o over 3.35 TB/s, or
    the tensor-core operations (3 TF32 products a flop in float32) over
    the type's peak; the exp floor, one ex2 a live score over
    ``EXP_PER_S``, stands beside it.  Each call is held against the
    plain version."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_ref
    out = []
    for d in (32, 16):
        q, k, v = (torch.randn((bh, 2048, d), device="cuda", generator=gen)
                   for bh in (48, 8, 8))
        scores = 48 * 2048 * 2049 / 2
        flops = 4 * d * scores
        for dtype in (torch.bfloat16, torch.float32):
            x = [t.to(dtype) for t in (q, k, v)]
            route = fa._route(dtype, d)
            require(route == ("sm90" if dtype == torch.bfloat16 else "tf32")
                    and d in fa.ROUTE_HEAD_DIMS[route], f"head_dim {d} "
                    f"{dtype} is not on a tensor-core kernel built for it")
            new = lambda: fa.flash_attention_cuda(*x, causal=True)
            dt = str(dtype).removeprefix("torch.")
            tol = FLASH_TOL[dt]
            want = attention_ref(*x, causal=True).float()
            err = float((new().float() - want).abs().max())
            require(err <= tol * (1 + float(want.abs().max())),
                    f"head_dim {d} {dtype}: the kernel differs from the "
                    f"plain version by {err}")
            lib, library = _sdpa(*x)
            diff = float((lib().reshape(q.shape).float()
                          - new().float()).abs().max())
            require(diff <= tol * 4, f"head_dim {d}: the yardstick computes "
                    f"another function: {diff}")
            split = (fa.tf32_split_cuda(x[1], x[2]) if route == "tf32"
                     else None)
            alone = lambda: fa._launch(route, *x, causal=True, split=split)
            products, rate = ((3, TF32_OPS_PER_S) if route == "tf32"
                              else (1, BF16_OPS_PER_S))
            nbytes = sum(t.numel() * t.element_size() for t in (x[0], *x))
            bound_ops = products * flops / rate * 1e3
            bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            source = {"sm90": "flash_attention_sm90",
                      "tf32": "flash_attention_tf32"}[route]
            row = {
                "head_dim": d, "dtype": dt, "kernel": fa.ROUTE_KERNELS[route],
                "route": route, "ms": queued_ms(new, 20),
                "kernel_ms": queued_ms(alone, 20),
                "library_ms": queued_ms(lib, 20), "library": library,
                "library_vs_kernel_max_abs_diff": diff,
                "plain_ms": device_ms(lambda: attention_ref(*x, causal=True),
                                      3),
                "bound_ms": max(bound_ops, bound_bytes),
                "bound_by": "operations" if bound_ops >= bound_bytes
                else "bytes", "flops": flops, "bytes": nbytes,
                "exp_floor_ms": scores / EXP_PER_S * 1e3,
                "ptxas": [e for e in ptxas(source)
                          if f"_kernelILi{d}E" in e["entry"]],
                "shape": f"q (48, 2048, {d}), k/v (8, 2048, {d}) causal"}
            if d == 16:
                def padded():
                    xp = [torch.nn.functional.pad(t, (0, 16)) for t in x]
                    return fa.flash_attention_cuda(
                        *xp, causal=True, scale=d ** -0.5)[..., :d].contiguous()
                x32 = [torch.nn.functional.pad(t, (0, 16)) for t in x]
                split32 = (fa.tf32_split_cuda(x32[1], x32[2])
                           if route == "tf32" else None)
                row["ms_padded_to_32"] = queued_ms(padded, 20)
                row["kernel_ms_padded_to_32"] = queued_ms(
                    lambda: fa._launch(route, *x32, causal=True,
                                       split=split32, scale=d ** -0.5), 20)
            out.append(row)
            print(f"timing flash narrow {json.dumps(row)}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 15: the launch-geometry check and the last three examples
# ---------------------------------------------------------------------------

def run_examples() -> dict:
    """Phase 15: ``hopper-geometry``'s card half over every built
    library (ptxas's figures against the sources' and wrappers'
    declarations; a line a kernel), then the three examples through
    their ``main``: quickstart (6x6x50 both laws, reduced qwen3-8b),
    serve_lm at gemma-2b's full width (prefill through the flash kernel,
    none in decode) and snn_simulation (8x8x60 in 2x2 tiles, both laws,
    then the STDP demo).  Returns each example's launches (counts zeroed
    just before it and read just after)."""
    import math
    from repro_torch.analysis import hopper_geometry
    from repro_torch.configs import get_config
    from repro_torch.examples import quickstart, serve_lm, snn_simulation
    from repro_torch.kernels import _build
    _build.build_all()
    t0 = time.perf_counter()
    rows = hopper_geometry.check_built()      # raises on any failure
    for r in rows:
        print("geometry " + json.dumps({k: r[k] for k in (
            "source", "kernel", "registers", "smem", "declared_smem",
            "spill_stores", "spill_loads", "stack", "launch_bounds",
            "threads", "min_blocks")}))
    require(len({r["source"] for r in rows}) == len(_build.SOURCES),
            "phase 15: a library has no checked kernel")
    geometry_s = time.perf_counter() - t0
    launches, seconds = {}, {}

    def example(name, fn, argv):
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn(argv)
        seconds[name] = time.perf_counter() - t0
        launches[name] = _build.launch_counts()
        print(f"example {name} launches: {json.dumps(launches[name])}",
              flush=True)
        return out

    qs = example("quickstart", quickstart.main, ["--device", "cuda"])
    for law, r in qs["snn"].items():
        require(math.isfinite(r["rate_hz"]) and r["events"] > 0,
                f"phase 15: quickstart {law}: rate {r['rate_hz']}, events "
                f"{r['events']}")
    require(math.isfinite(qs["lm"]["loss"])
            and math.isfinite(qs["lm"]["grad_norm"]),
            f"phase 15: quickstart's train step: {qs['lm']}")
    for name in ("neuron_step", "event_delivery", "step_graph"):
        require(launches["quickstart"].get(name, 0) > 0,
                f"phase 15: quickstart launched no {name}")

    arch = "gemma-2b"
    sv = example("serve_lm", serve_lm.main,
                 ["--arch", arch, "--full-width", "--device", "cuda"])
    vocab = get_config(arch).vocab_size
    require(sv["tokens"].shape == (4, 16) and bool(
        ((sv["tokens"] >= 0) & (sv["tokens"] < vocab)).all()),
        f"phase 15: serve_lm's tokens leave the vocabulary ({vocab})")
    require(sv["prefill_launches"].get("flash_attention", 0) > 0,
            f"phase 15: serve_lm's prefill launched no flash kernel: "
            f"{sv['prefill_launches']}")
    require(not any(k.startswith(("flash", "tf32"))
                    for k in sv["decode_launches"]),
            f"phase 15: serve_lm's decode launched {sv['decode_launches']}")

    sim = example("snn_simulation", snn_simulation.main,
                  ["--device", "cuda"])
    for law in snn_simulation.LAWS:
        r = sim["laws"][law]
        require(math.isfinite(r["rate"]) and r["events"] > 0,
                f"phase 15: snn_simulation {law}: rate {r['rate']}")
        for name in ("neuron_step", "event_delivery", "step_graph"):
            require(r["launches"].get(name, 0) > 0,
                    f"phase 15: snn_simulation {law} launched no {name}")
    require(sim["stdp"]["moved"] > 0,
            "phase 15: the STDP demo moved no synapse")
    res = {"geometry_s": geometry_s, "example_s": seconds,
           "quickstart": qs["snn"], "lm": qs["lm"],
           "serve_lm": {k: sv[k] for k in ("config", "prefill_s",
                                           "decode_s_per_token",
                                           "prefill_launches",
                                           "decode_launches")},
           "snn_simulation": {law: sim["laws"][law]
                              for law in snn_simulation.LAWS},
           "cost_ratio": sim["laws"]["cost_ratio"], "stdp": sim["stdp"]}
    print("examples " + json.dumps(res, default=str))
    return launches


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def ab_tree(src: str, label: str, steps: int) -> dict:
    """One tree's static ms per step, both laws, and phase 5b's
    multi-shard exponential timed run (in a child process)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    sys.path.insert(0, src)
    from repro_torch.configs.snn import reduced_case
    from repro_torch.core import engine
    from repro_torch.kernels import _build
    _build.build_all()
    out = {"tree": label, "src": src, "steps": steps}
    for law in LAWS:
        cfg = reduced_case(law, GRID, N_PER_COLUMN).engine_config(1, 1)
        tabs = engine.build_shard_tables(cfg)
        state, _ = engine.simulate(engine.init_sim_state(cfg), tabs, cfg, 20)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fin, _ = engine.simulate(state, tabs, cfg, steps)
        torch.cuda.synchronize()
        out[f"{law}_ms_per_step"] = 1e3 * (time.perf_counter() - t0) / steps
        for k in ("spikes", "events", "dropped"):
            out[f"{law}_{k}"] = float(fin["metrics"][k])
        # the device's idle share over as many more steps, profiled
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.simulate(fin, tabs, cfg, steps)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy, _ = device_breakdown(prof, steps)
        out[f"{law}_profiled_ms_per_step"] = wall_us / steps / 1e3
        out[f"{law}_device_busy_ms_per_step"] = busy / steps / 1e3
        out[f"{law}_device_idle_share"] = 1.0 - busy / wall_us
        del tabs, state, fin
        torch.cuda.empty_cache()
    from repro_torch.core import dist_engine as de
    cfg = ms_cfg("exponential", GRID)
    tables, _ = de.build_dist_tables(cfg)
    inputs = de.SimInputs(tables=tables)
    walls = []
    for n in (MS_TIMED_STEPS,) * 3 + (MS_PROFILE_STEPS,):
        sim = de.make_sim_fn(cfg, n, storage=tables.storage)
        st = de.init_dist_state(cfg)
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        with prof if len(walls) == 3 else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fin, _ = sim(st, inputs)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    ms = "multishard_exponential"
    out[f"{ms}_ms_per_step"] = [1e3 * w / MS_TIMED_STEPS for w in walls[:3]]
    busy, _ = device_breakdown(prof, MS_PROFILE_STEPS)
    out[f"{ms}_profiled_ms_per_step"] = 1e3 * walls[3] / MS_PROFILE_STEPS
    out[f"{ms}_device_busy_ms_per_step"] = busy / MS_PROFILE_STEPS / 1e3
    out[f"{ms}_device_idle_share"] = 1.0 - busy / (walls[3] * 1e6)
    out[f"{ms}_spikes"] = float(fin["metrics"]["spikes"].sum())
    out.update(ab_drivers(label))
    return out


def ab_drivers(label: str) -> dict:
    """Phase 5c's drivers on the tree on the path: the 2x2 8x8x1240
    gaussian slab, 400 steps in segments of 50, a checkpoint a segment,
    unrecorded and recorded: each one's steady ms per step (from its
    second segment to its return) and its captures."""
    import shutil
    from repro_torch.obs.telemetry import Telemetry
    from repro_torch.runtime import DriverConfig, SimDriver
    root = ROOT / "build" / "ab_drivers" / label
    shutil.rmtree(root, ignore_errors=True)
    cfg, out = ms_cfg("gaussian", GRID), {}
    for name, rec in (("driver", False), ("recorded_driver", True)):
        drv = SimDriver(DriverConfig(ckpt_dir=str(root / name), ckpt_every=1,
                                     keep=2, handle_sigterm=False),
                        cfg, "cuda", segment_steps=SEG_STEPS,
                        record_events=rec, telemetry=Telemetry())
        drv.run(SEG_TOTAL)
        steady = seg_steady(drv.tel, drv.tel.now())
        out[f"{name}_steady_ms_per_step"] = steady["driver_steady_ms_per_step"]
        out[f"{name}_steady_compute_ms_per_step"] = \
            steady["steady_compute_ms_per_step"]
        out[f"{name}_captures"] = drv.captures()
    shutil.rmtree(root, ignore_errors=True)
    return out


def run_ab(other_src: str, steps: int) -> None:
    for src, label in ((other_src, "other"), (str(ROOT / "src"), "this"),
                       (str(ROOT / "src"), "this"), (other_src, "other")):
        res = subprocess.run(
            [sys.executable, __file__, "--ab-child", src, label, "--steps",
             str(steps)], capture_output=True, text=True, timeout=1200)
        if res.returncode != 0:
            fail(f"A/B: the {label} run failed:\n" + res.stderr[-3000:])
        print("ab " + res.stdout.strip().splitlines()[-1], flush=True)
    print(gpu_line())


def main() -> None:
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ab", metavar="OTHER_SRC")
    ap.add_argument("--ab-child", nargs=2, metavar=("SRC", "LABEL"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--train-driver-child", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs a CUDA card")
    if args.ab_child:   # before this tree's port is on the path
        print(json.dumps(ab_tree(*args.ab_child, args.steps)), flush=True)
        return
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.configs.snn import reduced_case
        from repro_torch.core import engine
        from repro_torch.kernels import _build
    except ImportError as e:
        fail(f"the port is not next to this script ({e})")
    if args.train_driver_child:
        train_driver_checks()
        return
    if args.ab:
        run_ab(args.ab, args.steps)
        return
    t_start = time.perf_counter()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    phase_s, t_phase = {}, [t_start]

    def phase(name: str) -> None:
        """Record and print the seconds since the last phase ended."""
        now = time.perf_counter()
        phase_s[name] = now - t_phase[0]
        t_phase[0] = now
        print(f"phase {name}: {phase_s[name]:.1f} s", flush=True)

    # the host work of phases 2, 4 and 5b, started beside phase 1's nvcc
    # processes in six threads: phase 2's table sets (the dict check's
    # uncompressed one too) first, then phase 4's and 5b's table builds
    # and 5b's inverse indexes (5b's 8x8x1240 builds last, which bounds
    # the host memory held at once); all of it done before phase 3.
    # Only phase 2's sets go to the card here: the others wait on the
    # host for their phase, so each phase's peak device memory counts
    # its own tables.  A build's seconds are its wall time beside the
    # rest (``host_build_concurrent`` in the result lines)
    keys, dict_key = STATIC_BUILDS[:-1], STATIC_BUILDS[-1]
    t_builds = time.perf_counter()
    pool = ThreadPoolExecutor(6)
    pending = {key: pool.submit(host_table_build, key)
               for key in STATIC_BUILDS}
    p4_pending = [pool.submit(plastic_parity_host, law) for law in LAWS]
    msp_pending = [pool.submit(ms_plastic_host, law) for law in LAWS]
    ms_pending = {law: pool.submit(timed_dist_build, law) for law in LAWS}

    # 1. build
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s (beside the host "
          "builds)")
    for name in _build.SOURCES:
        print(f"build {name}: " + " | ".join(
            f"{e['entry']} {e['registers']} registers" for e in ptxas(name)))
    phase("1")

    built = {key: f.result() for key, f in pending.items()}
    del pending
    print(f"host builds: {time.perf_counter() - t_builds:.1f} s for "
          f"{len(built)}, one thread each, from before phase 1")
    tables, builds = {}, {}
    for (law, grid, _) in keys:
        tables[(law, grid)], builds[(law, grid)] = built[(law, grid, True)]
        st = tables[(law, grid)].storage
        print(f"host build {law} {grid}x{grid}x{N_PER_COLUMN}: "
              f"{builds[(law, grid)]:.1f} s (concurrent), "
              f"{tables[(law, grid)].stats['n_synapses']} synapses, "
              f"cap {st.cap_local}, {st.tgt_dtype} ids")
    dict_tables = built.pop(dict_key)
    del built

    # the column kernel's run descriptors, built once per table set on
    # the card, and their size reckoned at one 24x24x1240 shard
    for (law, grid), tabs in tables.items():
        column_runs(tabs, reduced_case(law, grid, N_PER_COLUMN)
                    .engine_config(1, 1).spec(),
                    f"{law} {grid}x{grid}x{N_PER_COLUMN}")
    for law in LAWS:
        print("column runs reckoned " + json.dumps(reckon_runs_bytes(law,
                                                                     24)))

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
    cap_big = reduced_case("gaussian", 24, N_PER_COLUMN).engine_config(
        1, 1).spec().active_cap_local
    n_big = 24 * 24 * N_PER_COLUMN     # one shard of the paper's 24x24
    compact_err = check_spike_compact([(n_main, cap_main), (n_big, cap_big)],
                                      gen)
    head_err = check_neuron_step([(n_main, cap_main), (n_big, cap_big)],
                                 gen)
    flash_err = check_flash(gen)
    check_dict_tables(gen, *dict_tables)
    del dict_tables
    p4_ctxs = [f.result() for f in p4_pending]
    msp_ctxs = [f.result() for f in msp_pending]
    ms_built = {law: f.result() for law, f in ms_pending.items()}
    pool.shutdown()
    print(f"host work of phases 2, 4 and 5b: "
          f"{time.perf_counter() - t_builds:.1f} s from before phase 1")
    phase("2 (with the host table builds)")

    # 3. the static path
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    runs = {law: run_law(law, tables[(law, GRID)], builds[(law, GRID)])
            for law in LAWS}
    launches = _build.launch_counts()
    print(f"static path launches: {json.dumps(launches)}; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} B")
    for name in ("neuron_step", "event_delivery", "step_graph"):
        require(launches.get(name, 0) > 0,
                f"kernel {name} was not launched on the static path")
    require("lif_step" not in launches,
            "the static path reached the unfused LIF kernel")
    require("event_delivery_rows" not in launches,
            "the static path reached the legacy warp-per-row kernel")
    phase("3")

    # 4. the plastic path: the card's parity legs at 4x4 (the tables'
    # card copies and inverse indexes; their CPU legs run in 5b, beside
    # 5b's own), then timed on the parity legs' 4x4 tables
    for ctx in p4_ctxs:
        plastic_parity_card(ctx)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    pruns = {ctx["law"]: run_plastic(ctx["law"], ctx["tabs"], ctx["build_s"],
                                     ctx["inv_s"], PARITY_GRID)
             for ctx in p4_ctxs}
    p_launches = _build.launch_counts()
    print(f"plastic path launches: {json.dumps(p_launches)}; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} B")
    for name in ("neuron_step", "plastic_delivery_ltd"):
        require(p_launches.get(name, 0) > 0,
                f"kernel {name} was not launched on the plastic path")
    require("event_delivery" not in p_launches,
            "float32 weights reached the atomic delivery kernel")
    plastic_err = max(check_plastic_kernel(pruns[law], law) for law in LAWS)
    phase("4")

    # 5. the recorded path
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    run_recorded("gaussian", tables[("gaussian", GRID)])
    r_launches = _build.launch_counts()
    print(f"recorded path launches: {json.dumps(r_launches)}; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} B")
    for name in ("neuron_step", "event_delivery", "spike_compact"):
        require(r_launches.get(name, 0) > 0,
                f"kernel {name} was not launched on the recorded path")
    require("step_graph" not in p_launches,
            "a plastic run replayed a graph")

    phase("5")

    # 5b. the multi-shard path: 2x2 tiles, static (both laws, with the
    # recorded runs) and the plastic parity at 4x4; its 8x8x1240 tables,
    # built on the host, go to the card here and are shared with 5c and
    # 5d (``seg_shared_builds``)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    ms_card = {law: ((tabs.to("cuda"), stats), build_s)
               for law, ((tabs, stats), build_s) in ms_built.items()}
    del ms_built
    with seg_shared_builds({law: b[0] for law, b in ms_card.items()}):
        ms_runs = {law: run_multishard(law, runs[law], ms_card[law][1])
                   for law in LAWS}
        del ms_card
        # the plastic legs' card runs, then every CPU plain leg, phase 4's
        # and 5b's, side by side (one thread each), then the comparisons
        ms_ctxs = [ms_plastic_card(ctx) for ctx in msp_ctxs]
        with ThreadPoolExecutor(2 * len(LAWS)) as legs:
            p4_cpu = legs.map(plastic_parity_cpu, p4_ctxs)
            ms_cpu = legs.map(ms_plastic_cpu, ms_ctxs)
            p4_cpu, ms_cpu = list(p4_cpu), list(ms_cpu)
        plastic_parity_check(p4_ctxs, p4_cpu)
        ms_plastic = [ms_plastic_check(ctx, *c)
                      for ctx, c in zip(ms_ctxs, ms_cpu)]
        del p4_ctxs, p4_cpu, msp_ctxs, ms_ctxs, ms_cpu
        ms_launches = _build.launch_counts()
        print(f"multi-shard path launches: {json.dumps(ms_launches)}; "
              f"max_memory_allocated {torch.cuda.max_memory_allocated()} B")
        for name in ("neuron_step", "event_delivery", "step_graph",
                     "spike_compact", "plastic_delivery_ltd"):
            require(ms_launches.get(name, 0) > 0,
                    f"kernel {name} was not launched on the multi-shard path")
        require("lif_step" not in ms_launches
                and "event_delivery_rows" not in ms_launches,
                "the multi-shard path reached a replaced kernel")
        phase("5b")

        # 5c. the segmented driver: checkpoints, resume, spool, retile (it
        # zeroes the counts itself, after timing make_sim_fn alone); 5d.
        # ensembles through the same drivers (their table builds shared),
        # then the job service on builds of its own
        seg = run_segmented(runs["gaussian"]["rate_hz"])
        seg_launches = _build.launch_counts()
        print(f"segmented driver launches: {json.dumps(seg_launches)}")
        for name in ("neuron_step", "event_delivery", "step_graph",
                     "spike_compact", "plastic_delivery_ltd"):
            require(seg_launches.get(name, 0) > 0,
                    f"kernel {name} was not launched on the segmented path")
        phase("5c")
        _build.reset_launch_counts()
        run_ensembles(seg)
    run_service()
    ens_launches = _build.launch_counts()
    print(f"ensemble and service launches: {json.dumps(ens_launches)}")
    phase("5d")
    for name in ("neuron_step", "event_delivery", "step_graph",
                 "spike_compact", "plastic_delivery_ltd"):
        require(ens_launches.get(name, 0) > 0,
                f"kernel {name} was not launched on the ensemble path")

    # 6. timing at the paths' shapes (not counted as launches)
    last = LAWS[-1]
    kernels = [time_lif(runs[last]["state"], runs[last]["cfg"],
                        launches.get("lif_step", 0), lif["max_abs_err"])]
    for law in LAWS:
        k = time_neuron_step(runs[law]["state"], runs[law]["cfg"],
                             launches["neuron_step"], head_err)
        print(f"timing {law} {json.dumps(k)}")
    kernels.append(k)
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
    big = (torch.rand(n_big, device="cuda", generator=gen) < float(
        runs["gaussian"]["spikes"].mean())).float()
    k = time_spike_compact(runs["gaussian"]["spikes"], n_main, cap_main,
                           r_launches["spike_compact"], compact_err,
                           big=(big, n_big, cap_big))
    print(f"timing {json.dumps(k)}")
    kernels.append(k)
    print(f"timing {json.dumps(kernels[0])}")

    phase("6")

    # 7. the LM serving path (qwen2-1.5b, full width), then the flash
    # kernel's timing at its prefill shape (not counted as launches)
    lm = run_lm()
    phase("7")

    # 8. LM training: qwen2-1.5b at full width through the flash kernel's
    # forward (counts zeroed and read inside), then the train driver at
    # reduced width (no kernel: the reduced configs' chunked attention)
    train = run_train()
    run_train_driver()
    phase("8")

    # 9. the MoE, mamba and RG-LRU families at full width (counts zeroed
    # and read inside, per model), then reduced kimi-k2 and qwen2.5-3b
    # on the card against the CPU
    families = run_families()
    phase("9")

    # 10. whisper-small and internvl2-26b at full width (counts zeroed and
    # read inside, per model)
    families["sm90"].update(run_encdec())
    phase("10")
    for k in time_flash(lm["launches"], flash_err, train["launches"],
                        families):
        print(f"timing {json.dumps(k)}")
        kernels.append(k)
    phase("flash timing")

    # 11. the cost models against the card: the abstract trees against
    # the real ones the phases above held, the dry run of qwen2-1.5b's
    # shapes on "meta", and each model figure beside its measurement
    run_cost_models(runs, ms_runs, lm, train)
    phase("11")

    # 12. training the MoE, mamba, RG-LRU, whisper and internvl families
    # (counts zeroed and read inside, per config), then their reduced
    # configs on the card against the CPU
    fam_train = run_train_families()["launches"]
    phase("12")

    # 13. the SNN on ranks: four processes on the one card (each rank
    # zeroes and reads its own counts; the sum is the ranks' launches)
    rank_launches = run_ranks(ms_runs, ms_plastic)
    phase("13")

    # 14. the LM on ranks: four processes on the one card, (pod 2, data 1,
    # model 2); the earlier phases' tensors freed first (each rank zeroes
    # and reads its own counts; the sum is the ranks' launches)
    del tables, runs, pruns, ms_runs, ms_plastic, lm, train
    del families, seg
    lm_rank_launches = run_lm_ranks()
    phase("14")

    # 15. the launch-geometry card check over the seven libraries, then
    # quickstart, serve_lm (gemma-2b at full width) and snn_simulation on
    # the card (counts zeroed and read around each example)
    example_launches = run_examples()
    phase("15")
    for k in kernels:
        if k["name"] in ("flash_attention", "flash_attention_tf32",
                         "tf32_split"):
            route = "sm90" if k["name"] == "flash_attention" else "tf32"
            k["train_family_launches"] = fam_train[route]
    require("jax" not in sys.modules and not any(
        m == "repro" or m.startswith("repro.") for m in sys.modules),
        "the port pulled in jax or the JAX package")
    for k in kernels:
        k["multi_shard_launches"] = ms_launches.get(k["name"], 0)
        k["segmented_launches"] = seg_launches.get(k["name"], 0)
        k["ensemble_launches"] = ens_launches.get(k["name"], 0)
        k["rank_launches"] = rank_launches.get(k["name"], 0)
        k["lm_rank_launches"] = lm_rank_launches.get(k["name"], 0)
        k["example_launches"] = {ex: n.get(k["name"], 0)
                                 for ex, n in example_launches.items()}
    print(json.dumps({"kernels": kernels}))
    print("phase seconds " + json.dumps(phase_s))
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
