#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``), one H100.

    python3 chip_smoke.py          # from the root of a checkout

Drives the port's main path on the card and checks it, phase by phase:

1. card check — a CUDA device is present; prints the card's name and power
   limit (``nvidia-smi``); float32 matmuls must not run in TF32;
2. build — compiles every CUDA kernel from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together) into ``build/kernels`` and
   prints each one's ``-Xptxas -v`` report;
3. kernels — each of the four kernels (batched_update, batched_geqrt,
   panel_factor, apply_factors) against its plain PyTorch version on the card
   at the main path's shapes, each output (panel_factor: each of R, V and T)
   within rel_bound() of its rms, plus an all-zero batch that must come
   back bitwise zero; batched_geqrt also on the tree schedule's own
   [pan | I] tiles, whose [0 | I] tiles must come back bitwise as they were;
   prints the layout of batched_update and batched_geqrt; times kernel,
   plain version and the library call that computes the same function (for
   apply_factors ``torch.ormqr`` with ``torch.geqrf``'s factors of the same
   panel: the same work in Householder's basis, timed only); panel_factor
   and apply_factors also run at a 65536-row frame; the f32 / f64 times are
   printed beside PERF.md's table (``TABLE_MS``).  Each kernel also runs
   with bf16 and with f16 tiles and f32 accumulation at the main path's
   shapes (``MIXED_SHAPES``) on well-conditioned data, held against the
   plain version at the same pair by its own ``REL`` entry (all-zero batch
   and [0 | I] tiles bitwise as above) and for rounding its state at every
   step: each output's error from the exact result (the plain version in
   f64) within ``kernel_check.ROUNDING`` of the plain version's, where the
   f32 plain version rounded once, run through the same comparison as a
   control, must fail; the library call timed in f32 on the same inputs.
   Each kernel also runs with f32, bf16 and f16 tiles and f64 sums at the
   same shapes (``WIDE_SHAPES``), each held on WIDE_DRAWS draws by the
   wide rule (``kernel_check.wide_held``: the share of entries bitwise
   equal to the plain version at the same pair, max|err| / rms within
   ``kernel_check.wide_bound``), where the (tile, float32) instance on the
   same inputs, the control, must fail, and timed beside the f64 instance
   at its shape (B3 / B4 run at f64 at those shapes too); ``ggr_common.cuh``'s
   casts from double run alone on tie values (``kernel_check.narrow_on_card``)
   against the plain versions' (``to_tile``); the library call is the f64
   QR (for B4 ``torch.ormqr`` with f64 ``torch.geqrf`` factors); the walls
   of the uniform, mixed and wide cases are printed.  B1 and B2 also run
   with bf16 / f16 tiles summed at their own width at the same shapes,
   held by the wide rule at ``kernel_check.NARROW_EQUAL`` with the same
   control, and timed (the library call in f32);
4. serving — ``QRServer(device="cuda")`` serves an 8192-request mix of all
   four kinds: a warm-up flush, then a timed one (req/s), cross-checked on a
   sample against the plain ``"reference"`` backend;
5. dense — ``ggr_lstsq`` on an (8192, 1024) f32 system against
   ``torch.linalg.lstsq`` in f64, through the blocked tree schedule (under
   ``degraded_mode(schedule="tree")``) and through ``"auto"``, which is the
   fused schedule on the card; ``ggr_qr_blocked`` of a 4096 x 4096 f32
   matrix with each schedule named, with ``"auto"`` and through
   ``ggr_qr_pallas`` (panel 32) against ``torch.linalg.qr``; traces of both
   schedules' QR and of the tree lstsq, and the times of every route beside
   the library calls;
6. instrumented path and sketch least squares — (a) the serving flush of
   phase 4 under an ``obs`` collector: its snapshot must hold every family
   of ``REQUIRED_SERVE_FAMILIES``, and the flush's req/s with and without
   the collector are printed; ``python -m repro_torch.launch.serve_qr
   --metrics build/smoke_metrics/serve --check --requests 512`` must exit 0
   with two CSV lines and files ``repro_torch.obs.export --validate``
   accepts (it starts after the timed flushes, beside (b)-(e), with phase
   7 (f)'s and phase 8 (e)'s CLI runs: ``start_cli``); (b) ``sketch_lstsq``
   of a (65536, 256) f64 system at cond 1e8 with b = A x0 + r0, r0
   orthogonal to range(A), ||r0|| = 0.1 (the sketch's (1024, 256) QR runs
   the fused schedule's kernels): the residual within
   1e-6 of ||r0|| in at most 50 iterations, R_s the same bits twice, timed
   beside ``torch.linalg.lstsq``; (c) a ``ConditionMonitor`` over 32
   appends to a (256, 256) RLS state, within 2x of ``torch.linalg.cond``; a
   downdate across the rank cliff under ``DowndateGuard`` ("damp": finite
   factor, one ``solvers.downdate_guard_trips``; "refuse": the state bit
   for bit) and ``state_integrity`` with and without ``max_cond``; (d) one
   ``ggr_qr_blocked`` of 4096^2 f32 under a collector: its ``blocked``
   flops (the sweep model) and the GFLOP/s they give (a reading); (e) the
   paper's baseline QRs (``core.baselines``) against ``torch.linalg.qr``;
7. resilient serving — (a) ``QRServer(resilient=True)`` and the plain server
   serve the 8192-request mix: every result bitwise equal, every provenance
   entry native after one attempt, no failure, degradation or quarantine
   counted under a collector, ``batched_update`` launched as often; the
   req/s of both over 5 alternating pairs and their medians; (b) chaos: the
   mix with 1% NaN-poisoned requests (``poison_workload(seed=11)``) at
   ``max_batch=512`` under ``FaultPlan(seed=7, transient_rate=0.2,
   poison_rate=0.05)`` beside a fault-free resilient run of it: every
   poisoned request quarantined in both, >= 99% of the rest served, native
   results bitwise equal to the fault-free run's, degraded ones within 2e-4;
   (c) every rung of ``DEFAULT_LADDER`` drilled on the mix's 4096 appends
   (provenance, ``serve.degraded_dispatches``, within 2e-4 of native,
   ``batched_update`` launches per rung: none on the reference rung) and a
   purge drill; (d) a NaN lane through ``batched_update`` with the pre-check
   off (quarantined, the other appends bitwise unchanged) and the condition
   gate (exactly the 8 ill-conditioned appends quarantined); the snapshot of
   (b)-(d) passes ``obs.export --validate --preset chaos``; (e) a (256, 256)
   ``RecursiveLS`` state on the card through ``StateVault``: restore falls
   back past a corrupted snapshot, bit-equal, and raises ``IntegrityError``
   when every snapshot is corrupted; (f) ``serve_qr --resilient --check
   --requests 512`` (started in phase 6) exits 0 with two CSV lines;
8. sharded serving over a ``BatchMesh`` of 4 shards on ``cuda:0`` — (a)
   ``QRServer(mesh=...)`` beside the plain server on the 8192-request mix:
   append and kalman bitwise, lstsq and lstsq_pivoted within rtol = atol =
   1e-6, ``batched_update`` launched 4x as often, one ``ExecutableCache``
   miss per sharded lstsq kind and hits on the next flush, the req/s of both
   over 5 alternating pairs, a trace of one sharded flush and each kind
   flushed alone on both servers; (b) the same checks on the first 8075 requests,
   whose five groups each pad to another width on the mesh than alone; (c)
   ``qr_append_rows_batched`` at B = 1, 7, 67, 8191 bitwise against
   ``mesh=None`` and a 1-shard mesh, ``kf_step_batched`` at B = 11 with
   shared models bitwise; (d) ``QRServer(resilient=True, mesh=...)`` bitwise
   equal to the plain sharded server, and phase 7's chaos run on the mesh
   (every poisoned request quarantined, native survivors bitwise equal to a
   fault-free run); (e) ``serve_qr --device cuda --mesh 4 --check``
   (started in phase 6): with
   fewer than 4 cards it must exit non-zero naming the "4-device batch mesh";
   then ``batched_update``'s time at each shape the phase launched it at;
9. distributed QR and the Orthant optimizer — (a)
   ``distributed_ggr_qr_1d`` of a seeded (8192, 4096) f32 matrix, panel 64,
   in both layouts on 4 gloo ranks sharing ``cuda:0`` and on 1 NCCL rank
   (spawned processes, ``repro_torch.testing.spawn``): |R| within 1e-3 of
   ``torch.linalg.qr``'s (relative Frobenius), P = 4 within 1e-5 of P = 1,
   the wall of each and the count of R elements whose bits differ; (b)
   ``tsqr`` and ``distributed_orthogonalize`` of a (65536, 256) f64 matrix
   on the 4 ranks: R the same bits on every rank, |R| within 1e-10 of
   ``torch.linalg.qr``'s, max|QᵀQ - I| <= 1e-6; (c) one ``orthant.update``
   over olmo-1b's parameter tree at full width (``olmo_tree``), its wall
   and peak memory, every direction's orthogonality and agreement with
   ``torch.linalg.qr``'s Q held against its direction through the kernels'
   plain versions (``direction_check``), at OLMO_DEPTH of its 16 layers
   (batch 2; phase 12 (b) runs all 16, and phase 12 (e) holds the kernels
   at the batch-16 shapes); panel_factor and apply_factors timed at the
   largest shape each sub-run launched them at (after (c)'s step, before
   its direction checks, whose plain driver also runs each B3 / B4 step on
   the kernel on the same inputs: ``plain_hold``); (d) ``restore(shardings=)``
   of a saved tree onto 2 ranks, the blocks bitwise the saved leaves,
   beside (c)'s checks;
10. every (shape, dtype) the kernels were launched at by phases 4-9, the
   spawned ranks' included, is held against the plain version once more,
   each launch phase 9 (c)'s plain driver held on its own steps excepted;
   phase 13's smoke meshes ((a), (c), (d), (f): ``mesh_smoke_start``) and
   phase 12 (d)'s CLI runs (``train_cli_start``) run beside phase 9 (c) to
   here;
11. LM serving — (a) every arch of ``repro_torch.configs`` at smoke size on
   the card: 8 decode steps at float32 and 8 at bfloat16 compute (finite
   logits, caches of ``cache_spec``'s shapes and dtypes), and for olmo-1b,
   mixtral-8x22b (capacity_factor = n_experts / top_k), zamba2-1.2b,
   xlstm-125m, phi-3-vision-4.2b (text) and seamless-m4t 24 decode steps
   against one prefill at float32 (the 16-slot window wraps), within 1e-4
   of the logits' rms; (b) olmo-1b at its published widths (16 x 2048, ff
   8192, vocab 50304) at float32: 64 decode steps against the prefill (B =
   2), and the card's first 2 steps against the port on the CPU with the
   same weights, each within 1e-4 of rms; then ``python -m
   repro_torch.launch.serve --arch A --batch 8 --tokens 32 --cache-len
   2048`` (bfloat16) for olmo-1b, zamba2-1.2b and xlstm-125m must exit 0,
   each started LM_SERVE_STAGGER s after the one before it
   (``run_staggered``); their tok/s and peak memory are printed.  The path runs no GGR kernel:
   the counts, zeroed before it, must read 0 after it;
12. LM training — (a) every arch at smoke size: the loss and every leaf's
   gradient on the card against the port on the CPU with the same weights
   and batch (float32 compute, TF32 off; within 1e-5 relative and 1e-4 of
   each gradient's rms), then one AdamW ``train_step`` on the card (params
   moved, finite; no GGR kernel launched); (b) olmo-1b at its published
   widths (16 x 2048, ff 8192, vocab 50304; float32 params, bfloat16
   compute, remat "full") through ``Trainer`` at seq 256, batch 8: 4 Orthant
   steps, then 4 AdamW steps — finite losses, each step's wall split into
   forward+backward and optimizer (CUDA events), tok/s, peak memory, a
   trace of one more step of each; Orthant must launch panel_factor and
   apply_factors and AdamW neither; the last Orthant step's momenta (the
   first and last layer of each stack) through ``momentum_check``: each R
   through the kernels within 1e-5 backward error, each column of its
   direction that float32 determines within 20 x u·cond_k of orthant's
   formula in float64 and of its sign, both planted faults (a flipped
   first column, a float16 R) failing that, the direction readings
   printed; (c) an Orthant run at olmo-1b's widths and
   RESUME_DEPTH layers saved at step 2 (``build/smoke_train_ckpt``) and
   resumed by a new ``Trainer(resume=True)`` for step 3: its loss, params
   and optimizer state bitwise those of the uninterrupted run; (d) ``python
   -m repro_torch.launch.train --arch olmo-1b --steps 4 --optimizer X`` for
   Orthant and AdamW must exit 0 (s/step, tok/s and peak memory printed),
   run one after the other beside phases 9 (c) to 10;
   (e) every (shape, dtype) phase 12 launched B3/B4 at that phase 10 did not
   hold is held against the plain version, and B3/B4 are timed at the
   largest shape each launched at (after (b));
13. LM training on a mesh (``Trainer(mesh=...)``, spawned ranks on
   cuda:0) — (a) olmo-1b (smoke) 3 Orthant steps on a 1x1 NCCL mesh: loss,
   params and optimizer state bitwise those of the one-device Trainer;
   (b) olmo-1b at its published widths on a 1x4 mesh of 4 gloo ranks
   sharing the card (f32 params, bf16 compute, remat "full", Orthant, seq
   256, batch 8, MESH_FULL_STEPS steps): step 1's update (over the columns
   the one-device float32 step's momentum determines) and momentum, leaf
   by leaf on the first and last matrix of each stack, within BF16_RATIO x
   the distance of phase 12 (b)'s one-device bf16 step to a one-device
   float32 step (two bf16 runs round apart; the 1e-4 rule holds between
   float32 runs only), replicated blocks bitwise equal across ranks after
   every step, s/step, tok/s, each rank's peak and the card's memory in
   use, B3/B4 launched on every rank every step; (c) olmo-1b, mixtral,
   phi-3-vision, zamba2 and xlstm (a family each) at smoke size, float32,
   on 2x2 and 4x1 gloo meshes, one AdamW and one Orthant step each on 512
   uniform tokens: within 1e-4 of each leaf's rms of the one-device step
   (``testing.step_check``), replicas bitwise; (d) an AdamW run saved at
   step 2 on 2x2, resumed on 2x2 (bitwise), on 1x2 and with no mesh (the
   restored leaves bitwise the saved arrays, steps 3-4 within the rule);
   (e) the shapes this phase launched B3/B4 at that earlier phases did not
   hold; (f) ``launch.train --smoke --mesh 2x2 --steps 3`` exits 0 naming
   gloo, ``--mesh 16x16`` / ``prod`` / ``prod2`` exit non-zero naming the
   ranks they need.  (a), (c), (d) and (f) run beside phases 9 (c) to 10
   (``mesh_smoke_start``), their checks here;
14. mixed precision on the main path — (a) the 8192-request mix with every
   append and kalman request's operands stored in bf16, served by
   ``QRServer(device="cuda", precision="mixed_bf16")`` (a warm-up flush,
   then a timed one, req/s beside phase 4's), then the same in f16 with
   ``"mixed_f16"``: results at the storage dtype, each kind's results
   within 8 eps(dtype) relative Frobenius of the f32 server's, B1 launched
   at the pair; then the bf16 appends through ``QRServer(resilient=True,
   precision="mixed_bf16")``: every provenance entry native after one
   attempt and every result bitwise the plain mixed server's; (b)
   ``fleet_nis(B=8, n=4, w=4, p=2, T=150, precision="bf16")`` on the card:
   each mean NIS in (0.7 p, 1.3 p); (c) ``ggr_qr_blocked`` of phase 5's
   4096^2 f32 matrix with ``precision="bf16"`` and ``"mixed_f16"`` under
   ``"fused"`` and ``"tree"``: R at the tile dtype, B3/B4 (fused) and B2/B1
   (tree) launched at the pair, ``factorization_errors`` within
   ``error_budget`` wherever ``budget_is_meaningful`` (the gram residual
   always), wall times beside phase 5's; (d) every (shape, pair) of (a)-(c)
   held against the plain version, its rounding at every step included;
   every launch of (a)-(c) at the run's
   pair, and the phase's wall printed; (e) the same 4096^2 QR under
   ``"tree"``, ``"fused"`` and ``"auto"`` at ``Precision(t, "float64", t)``
   for t = f32, bf16, f16 within the reference's budgets of t, R at t,
   each schedule launching its own two kernels at (t, float64) and no
   other, ``"auto"`` bitwise the fused run, walls beside phase 5's f32
   ones; (f) the bf16 / f16 stored appends and kalman steps served with
   f64 sums, each kind within 8 eps(t) of the same requests served in f64;
   (g) the fused schedule, ``"auto"``, B3 and B4 at (bfloat16, bfloat16)
   and (float16, float16), the pairs B3 and B4 do not take, raise
   ``NotImplementedError`` naming both dtypes with no launch; every (shape,
   pair) of (e)-(f) held against the plain version
   (``kernel_check.wide_accurate``), each pair's wall printed; (h) B1 and
   B2 at ``Precision(t, t, t)``, t = bf16 and f16 (``narrow_phase``): (i)
   the 4096^2 tree QR, R finite at t, its Gram residual at least
   NARROW_GRAM x the mixed policy's of (c) at f16 (a reading at bf16,
   where all-bf16 sums do not lose at that size) and on the reference
   test's own 96 x 80 matrix at both, the QR of the leading 1024^2 block
   within NARROW_BAND x the Gram residual of the same call on a CPU copy
   (the plain versions, in a subprocess beside phases 3-4); (ii) the mix with
   its append and kalman operands stored at t, served at (t, t) (req/s),
   each kind's distance from (f)'s f64-served results on the append and
   kalman requests among the first 512 within NARROW_BAND x the CPU
   copy's; (iii) every (shape, pair) (i)-(ii) launched, held by the wide
   rule at ``kernel_check.NARROW_EQUAL`` over WIDE_DRAWS draws, the (t,
   float32) instance the control that must fail; every launch at (t, t),
   none of B3 / B4;
15. the dry run on the card's host (``repro_torch.launch.dryrun``; no CUDA
   work; its subprocesses start at phase 11's start, at nice MESH_NICE,
   and run on the host's cores beside phases 11 to 14) — (a) ``python -m
   repro_torch.launch.dryrun --arch olmo-1b --shape train_4k``: one AdamW
   step on meta tensors over a fake 16x16 mesh of 256 ranks with the depth
   probe, the reference's result keys, 256 chips,
   a dominant roofline term, local FLOPs and collective bytes, the
   useful-FLOPs ratio within the hand count's band
   (``testing.dryrun_check``); per-device FLOPs, bytes, collective bytes by
   kind and the three roofline seconds printed; (b) the same cell with
   ``--optimizer orthant --no-probe``: B3/B4's launches and FLOPs a rank,
   counted by shape, beside phase 13 (b)'s launches, and the momenta's
   all-gather bytes beside AdamW's; (c) ``launch.specs``' olmo-1b
   parameter and Orthant-state trees on a fake 1x4 mesh: rank 0's bytes
   exactly those phase 13 (b)'s rank 0 holds; (d) the (a) cell with
   ``--seq-parallel`` under the card's torch: fewer all-reduce bytes than
   (a), reduce-scatter and all-gather present, the useful-FLOPs ratio in
   the band; (e) the long_500k cells of zamba2-1.2b and mixtral-8x22b
   (batch 1: the decode cache's sequence split over the data axes), each a
   subprocess with its own time limit; the phase's wall beside its 60 s
   budget.  A run still going WATCHDOG_S s after its start stops itself
   (``watchdog``), naming its phase;
16. a JSON line of per-kernel numbers (a row for each kernel's f32 / f64
   instance, one for each of its bf16 / f16 instances, one for each of its
   f64-summed instances and one for each of B1's and B2's narrow
   instances), then the last line ``{"ok": true, "device": {...}}``.

A kernel's f32 reading over its bound against the f32 plain version is
taken again against the plain version run in f64 on the same inputs
(``KernelCase.against_f64``): the kernel must land within the same bound of
it; where it does not, the case is read over DRAWS fresh inputs
(``KernelCase.against_draws``): the kernel's median and DRAW_Q-quantile
distance from the f64 plain version within DRAW_RATIO x the f32 plain
version's (the f32 algorithm's own errors have a heavy tail).

Launch counts are set to 0 just before the serving run, the dense run,
phase 6, phase 7, phase 8, each call of phase 9 (in the ranks too), phase
11, phase 12 (a), each training run of phase 12 (b)-(c), in the ranks
of phase 13 before each mesh run (each step in (b)), and before each run
of phase 14 (a)-(c), (e)-(f) and (h) (i)-(ii), and read just after
each; a route that does not launch its
kernels fails the run.  Any failed check exits non-zero without printing the last
line.  The script imports nothing of the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM3 3.35 TB/s,
# 67 TFLOP/s f32 and 34 TFLOP/s f64 outside the tensor cores.  A bf16 / f16
# tile's arithmetic runs in f32 (the kernels accumulate there), so its
# operations bound is the f32 rate; only its bytes halve.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12, "bfloat16": 67e12, "float16": 67e12}
# kernel vs plain version, each output on its own: its worst error over its
# rms within rel_bound(), and for a bf16 / f16 tile with f32 sums its
# distance from the exact result within kernel_check.ROUNDING of the plain
# version's (the state rounded at every step), with the f32 plain version
# rounded once as the control that must fail it: the table, the growth rule
# and the mixed cases' data are repro_torch.testing.kernel_check's, which
# the card tests share


# an f32 case over its bound against the f64 plain version too is read over
# DRAWS fresh inputs (``KernelCase.against_draws``): its median and
# DRAW_Q-quantile within DRAW_RATIO x the f32 plain version's
DRAWS, DRAW_Q, DRAW_RATIO = 32, 0.9, 2.0


def _as_outputs(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def _fmt(values) -> str:
    return ", ".join(f"{v:.2e}" for v in values)


# the rule B1, B2 and B4 were held to before: 5e-5 f32 / 1e-11 f64 x
# max(1, rows // 16) x max(1, max|out|), printed beside the new one
OLD_TOL = {"float32": 5e-5, "float64": 1e-11}
# phase 3's f32 / f64 times in PERF.md §6's kernel table (ms), printed beside
# this run's: (kernel, shape, dtype, data) -> ms
TABLE_MS = {
    ("batched_update", (8192, 40, 33), "float32", "random"): 0.1939,
    ("batched_update", (8192, 104, 65), "float32", "random"): 0.9552,
    ("batched_update", (64, 128, 192), "float32", "random"): 0.1912,
    ("batched_update", (64, 128, 192), "float64", "random"): 0.2909,
    ("batched_update", (32, 128, 192), "float32", "random"): 0.1896,
    ("batched_update", (1, 128, 192), "float32", "random"): 0.1889,
    ("batched_geqrt", (128, 64, 128), "float32", "random"): 0.1176,
    ("batched_geqrt", (128, 64, 128), "float64", "random"): 0.1624,
    ("batched_geqrt", (64, 64, 128), "float32", "random"): 0.1184,
    ("batched_geqrt", (64, 64, 128), "float32", "tree"): 0.1170,
    ("batched_geqrt", (2, 64, 128), "float32", "random"): 0.1170,
    ("batched_geqrt", (2, 64, 128), "float32", "tree"): 0.1168,
    ("panel_factor", (1, 4096, 64), "float32", "random"): 0.6441,
    ("panel_factor", (1, 8192, 64), "float32", "random"): 0.6879,
    ("panel_factor", (1, 4096, 64), "float64", "random"): 0.7079,
    ("panel_factor", (1, 4096, 32), "float32", "random"): 0.3151,
    ("panel_factor", (1, 65536, 64), "float32", "random"): 1.3030,
    ("apply_factors", (1, 4096, 4032), "float32", "random"): 0.9363,
    ("apply_factors", (1, 8192, 964), "float32", "random"): 0.8778,
    ("apply_factors", (1, 4096, 1024), "float64", "random"): 0.5748,
    ("apply_factors", (1, 4096, 2048), "float32", "random"): 0.3236,
    ("apply_factors", (1, 65536, 128), "float32", "random"): 7.1931,
}
# phase 3: (kernel, shape, param, dtype[, data]) at the main path's shapes;
# data is "random" (randn) unless named: "tree" is batched_geqrt's tiles as
# the tree schedule builds them (tree_tiles)
PHASE3 = [
    ("batched_update", (8192, 40, 33), 32, "float32"),    # serving append
    ("batched_update", (8192, 104, 65), 64, "float32"),   # serving kalman
    ("batched_update", (64, 128, 192), 64, "float32"),    # tree coupling
    ("batched_update", (64, 128, 192), 64, "float64"),
    # the first and last coupling rounds of the tree's 4096^2 QR
    ("batched_update", (32, 128, 192), 64, "float32"),
    ("batched_update", (1, 128, 192), 64, "float32"),
    ("batched_geqrt", (128, 64, 128), 64, "float32"),     # tree level 0
    ("batched_geqrt", (128, 64, 128), 64, "float64"),
    # the tree QR's level-0 launches: its first panel (64 tiles) and its last
    # (2 tiles), on random tiles and on the tree's own tiles
    ("batched_geqrt", (64, 64, 128), 64, "float32"),
    ("batched_geqrt", (64, 64, 128), 64, "float32", "tree"),
    ("batched_geqrt", (2, 64, 128), 64, "float32"),
    ("batched_geqrt", (2, 64, 128), 64, "float32", "tree"),
    ("panel_factor", (1, 4096, 64), 0, "float32"),        # fused QR frame
    ("panel_factor", (1, 8192, 64), 0, "float32"),        # fused lstsq frame
    ("panel_factor", (1, 4096, 64), 0, "float64"),
    ("panel_factor", (1, 4096, 32), 1024, "float32"),     # ggr_qr_pallas
    ("panel_factor", (1, 65536, 64), 0, "float32"),       # a 16 MiB frame
    ("apply_factors", (1, 4096, 4032), (64, 0), "float32"),  # fused QR
    ("apply_factors", (1, 8192, 964), (64, 0), "float32"),   # fused lstsq
    ("apply_factors", (1, 4096, 1024), (64, 0), "float64"),
    ("apply_factors", (1, 4096, 2048), (32, 2048), "float32"),  # ggr_qr_pallas
    # a frame too tall for one column of it in shared memory
    ("apply_factors", (1, 65536, 128), (64, 0), "float32"),
]
# phase 3's bf16 / f16 cases (f32 accumulation): the main path's shapes of
# phase 14 (serving append and kalman, tree coupling; tree level 0 on random
# and on the tree's own tiles; the fused QR and lstsq frames)
MIXED_SHAPES = [
    ("batched_update", (8192, 40, 33), 32),
    ("batched_update", (8192, 104, 65), 64),
    ("batched_update", (64, 128, 192), 64),
    ("batched_geqrt", (128, 64, 128), 64),
    ("batched_geqrt", (64, 64, 128), 64, "tree"),
    ("batched_geqrt", (2, 64, 128), 64, "tree"),
    ("panel_factor", (1, 4096, 64), 0),
    ("panel_factor", (1, 8192, 64), 0),
    ("apply_factors", (1, 4096, 4032), (64, 0)),
    ("apply_factors", (1, 8192, 964), (64, 0)),
]
MIXED = ("bfloat16", "float16")
PHASE3 += [(name, shape, param, dname, *data) for dname in MIXED
           for name, shape, param, *data in MIXED_SHAPES]
# a wide case's plain version takes up to WIDE_PLAIN_ELEMS elements of its
# draws' problems in one call (KernelCase.compare_wide)
WIDE_PLAIN_ELEMS = 2 ** 25
# phase 3's wide cases (f32 / bf16 / f16 tiles, f64 sums, every kernel) at
# the mixed cases' shapes: both schedules at each pair (phase 14 (e)) and the
# bf16 / f16 stored mix served with f64 sums (phase 14 (f)); each is timed
# beside the f64 instance at its shape, so the shapes the f64 cases above
# lack run at f64 too
WIDE = ("float32", "bfloat16", "float16")
WIDE_SHAPES = [(name, shape, param, *(data or ["random"])) for name, shape, param, *data
               in MIXED_SHAPES]
FUSED = ("panel_factor", "apply_factors")  # B3 / B4, the fused schedule's kernels
# B1 / B2's wide cases first, then B3 / B4's: each case draws its inputs from
# phase 3's one generator in this order
PHASE3 += [(name, shape, param, dname, data, "float64") for dname in WIDE
           for name, shape, param, data in WIDE_SHAPES if name not in FUSED]
PHASE3 += [(name, shape, param, dname, data, "float64") for dname in WIDE
           for name, shape, param, data in WIDE_SHAPES if name in FUSED]
PHASE3 += [(name, shape, param, "float64") for name, shape, param, _ in WIDE_SHAPES
           if name in FUSED and (name, shape, param, "float64") not in PHASE3]
# phase 3's narrow cases (B1 / B2 at bf16 / f16 tiles summed at their own
# width) at the same shapes, held by the wide rule at NARROW_EQUAL
PHASE3 += [(name, shape, param, dname, data, dname) for dname in MIXED
           for name, shape, param, data in WIDE_SHAPES if name not in FUSED]
SERVE_MAX_BATCH = 8192  # each request group of the 8192-request mix is one chunk
FAILURES: list[str] = []
# phase 6's sketch least squares: the tall system, its spectrum and the oracle
SKETCH_M, SKETCH_N, SKETCH_COND, SKETCH_R0 = 65536, 256, 1e8, 0.1
# phase 9: the distributed QR's matrix, panel and ranks; TSQR at the sketch's
# shape (f64, random, TSQR_M / 4 rows a rank)
DQR_M, DQR_N, DQR_PANEL, DQR_RANKS = 8192, 4096, 64, 4
TSQR_M, TSQR_N = SKETCH_M, SKETCH_N
# olmo-1b's widths: repro_torch.testing.orthant_check.OLMO, the port's
# configs.get_config("olmo-1b")
# layers phase 9 (c)'s Orthant step runs at olmo-1b's widths: a depth cut,
# since phase 12 (b) trains all 16 layers with Orthant through the Trainer
OLMO_DEPTH = 2
# an Orthant direction Q = M·R⁻¹ (f32, no refinement) loses u·cond(M) of
# orthogonality whichever R it takes (square Gaussian momenta reach cond
# 1e4-1e5 and more), so each matrix's two readings are held to DIR_FACTOR x
# those of its direction through the kernels' plain versions, plus DIR_FLOOR
# (tools/orthant_readings.py: the sound and the faulty ratios either side)
DIR_FACTOR, DIR_FLOOR = 3.0, 1e-7
# phase 9 (d): leaf -> (shape, dtype, placement: a dim to shard, None or
# "replicate")
CKPT_SPEC = {"wq": ((2048, 2048), "float32", 1), "w2": ((4, 1024, 512), "float32", 0),
             "norm": ((2048,), "float32", None), "step": ((), "int32", "replicate")}


def check(ok: bool, what: str, quiet: bool = False) -> None:
    if not (ok and quiet):
        print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
    if not ok:
        FAILURES.append(what)


_T0 = time.perf_counter()


_PHASE = ["startup"]


def phase(name: str) -> None:
    _PHASE[0] = name
    print(f"\n== {name} (at {time.perf_counter() - _T0:.1f} s)", flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ------------------------------- kernel models (operation counts: core.counts)
def _itemsize(dtype_name: str) -> int:
    return {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2}[dtype_name]



def tree_tiles(B: int, b: int, gen, dtype, conditioned: bool = False):
    """(B, b, 2b) tiles as the tree schedule hands them to batched_geqrt at
    a panel past its first: [pan | I], the second half [0 | I] (row tiles
    past the matrix, zero in the panel's columns); ``conditioned``: each pan
    well conditioned (``kernel_check.condition_``)."""
    import torch

    from repro_torch.testing.kernel_check import condition_

    pan = torch.randn((B, b, b), generator=gen, device="cuda", dtype=dtype)
    if conditioned:
        condition_(pan, "batched_geqrt", b)
    pan[B // 2:] = 0
    eye = torch.eye(b, device="cuda", dtype=dtype).expand(B, b, b)
    return torch.cat([pan, eye], 2).contiguous()


def ladder_adds(n: int, L: int, cols: int) -> int:
    """The adds a narrow instance's ladders do in one column step of n
    active rows beyond a serial suffix sum's n - 1 a column, in a ladder of
    length L (past the rows only zeros are added, not counted), for
    ``cols`` columns (the swept columns and the squares)."""
    ladder, d = 0, 1
    while d < min(n, L):
        ladder += n - d
        d *= 2
    return cols * max(0, ladder - (n - 1))


def bound(nbytes: float, dtype_name: str, flops: float):
    """(bound_ms, bound_by): the bytes the function must move (each input
    read once, each output written once) over HBM bandwidth, vs the
    operations over the peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


class KernelCase:
    """One kernel at one shape: inputs, kernel, plain version, library call.

    ``param`` is ``n_piv`` for batched_update / batched_geqrt, ``pivot0`` for
    panel_factor (shape (B, m, b)) and ``(b, pivot0)`` for apply_factors
    (shape of C, (B, m, w)).  ``accum``: the accumulation dtype's name
    (default the tile dtype's, ``kernel_check.ACCUM``); a bf16 / f16 case
    runs the kernel and the plain version at (tile, f32) on
    ``kernel_check.condition_``-ed data, and its library call on the same
    inputs in f32 (no library QR takes those tiles).  A wide case (``accum``
    float64 for f32 / bf16 / f16 tiles, any kernel) runs both at (tile, f64),
    bf16 / f16 tiles on conditioned data, is held by the wide rule
    (``kernel_check.wide_held``) with the (tile, float32) instance on the
    same inputs as its control (``control``), and its library call runs in
    f64 on the same inputs; its bound takes the bytes at the tile width and
    the operations at the f64 rate."""

    def __init__(self, name, shape, param, dtype, gen, data="random", accum=None):
        import torch

        from repro_torch.core.counts import apply_flops, geqrt_flops, panel_flops, update_flops
        from repro_torch.kernels import Precision, ggr_apply, ggr_panel, ggr_update
        from repro_torch.testing import kernel_check as kc

        self.name, self.shape, self.param, self.dtype = name, shape, param, dtype
        self.data = data
        self.note = ""
        self.fixed = None  # tiles that must come back bitwise as they were
        self.dname = str(dtype).removeprefix("torch.")
        self.accum = accum or kc.ACCUM[self.dname]
        self.wide = self.accum == "float64" and self.dname != "float64"
        # a bf16 / f16 tile summed at its own width (B1, B2)
        self.narrow = self.accum == self.dname and self.dname in MIXED
        self.mixed = self.accum != self.dname and not self.wide
        cond = self.dname in MIXED  # a 2-byte tile: conditioned data
        # the kernel wrappers' policy: None (the tile dtype throughout), the
        # named mixed policy of the tile dtype, whose sums are f32, the tile
        # with f64 sums, or the tile summed at its own width
        self.prec = prec = (self.dname if self.mixed else
                            Precision(self.dname, self.accum, self.dname)
                            if self.wide or self.narrow else None)
        ad = self.accum if (self.mixed or self.wide or self.narrow) else None
        # the control of a wide case: the same inputs through the (tile,
        # float32) instance, a kernel that sums in f32
        ctrl = Precision(self.dname, "float32", self.dname)
        size = _itemsize(self.dname)
        # the layout holds the sums' dtype; a narrow instance's are floats
        csize = 4 if self.narrow else _itemsize(self.accum)
        B, m, w = shape
        x = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
        if name == "batched_update":
            n_piv = param
            # the kernel's contract: the top n_piv rows are upper triangular
            x[:, :n_piv, :n_piv] = torch.triu(x[:, :n_piv, :n_piv])
            if cond:
                kc.condition_(x, name, n_piv)
            self.fn = lambda z: ggr_update.batched_update(z, n_piv, precision=prec)
            self.control = lambda: ggr_update.batched_update(x, n_piv, precision=ctrl)
            plain = lambda z, a=ad: ggr_update.batched_update_plain(z, n_piv, a)  # noqa: E731
            # R of the stacked matrix (same top n_piv rows up to signs; at the
            # tree-coupling shape it also triangularizes the riding columns)
            self.library = lambda: torch.linalg.qr(self.lib_x, mode="r")
            self.flops = update_flops(shape, n_piv) + (
                sum(ladder_adds(m - n_piv + 1, m - n_piv + 1, w - c)
                    for c in range(n_piv)) * B if self.narrow else 0)
            self.nbytes = 2.0 * B * m * w * size
            self.note = (", layout (G, PB, ws, nbuf) "
                         f"{ggr_update._update_layout(m, w, n_piv, csize, self.narrow)}")
        elif name == "batched_geqrt":
            n_piv = param
            if data == "tree":
                x = tree_tiles(B, m, gen, dtype, conditioned=cond)
                self.fixed = slice(B // 2, B)
            elif cond:
                kc.condition_(x, name, n_piv)
            self.fn = lambda z: ggr_panel.batched_geqrt(z, n_piv, precision=prec)
            self.control = lambda: ggr_panel.batched_geqrt(x, n_piv, precision=ctrl)
            plain = lambda z, a=ad: ggr_panel.batched_geqrt_plain(z, n_piv, a)  # noqa: E731
            # Q and R of the tile's pivot columns: [R | Qt] up to signs
            self.library = lambda: torch.linalg.qr(self.lib_x[:, :, :n_piv])
            self.flops = geqrt_flops(shape, n_piv) + (
                sum(ladder_adds(m - c, m, w - c) for c in range(min(n_piv, m))) * B
                if self.narrow else 0)
            self.nbytes = 2.0 * B * m * w * size
            self.note = (f", layout (G, ws) "
                         f"{ggr_panel._geqrt_layout(m, w, csize, self.narrow)}")
        elif name == "panel_factor":
            pivot0 = param
            if cond:
                kc.condition_(x, name, pivot0)
            self.fn = lambda z: ggr_panel.panel_factor(z, pivot0, precision=prec)
            self.control = lambda: ggr_panel.panel_factor(x, pivot0, precision=ctrl)
            plain = lambda z, a=ad: ggr_panel.panel_factor_plain(z, pivot0, a)  # noqa: E731
            # Householder QR of the same panel (Q and R)
            self.library = lambda: torch.linalg.qr(self.lib_x)
            self.flops = panel_flops(shape, pivot0)
            self.nbytes = 4.0 * B * m * w * size  # panel in; R, V, T out
        else:  # apply_factors
            b, pivot0 = param
            pans = torch.randn((B, m, b), generator=gen, device="cuda", dtype=dtype)
            if cond:
                kc.condition_(pans, name, param)
            # the panel's factors through B3 (held on its own), not its plain
            # version, which costs as much as B4's at a tall shape
            _, V, T = ggr_panel.panel_factor(pans, pivot0, precision=prec)
            self.factors = (V, T)
            self.fn = lambda z: ggr_apply.apply_factors(V, T, z, pivot0, precision=prec)
            self.control = lambda: ggr_apply.apply_factors(V, T, x, pivot0, precision=ctrl)
            # VT: another case's factors, stacked (KernelCase.compare_wide)
            plain = lambda z, a=ad, VT=(V, T): ggr_apply.apply_factors_plain(  # noqa: E731
                *(f.to(z.dtype) for f in VT), z, pivot0, a)
            # the same work in Householder's basis: Q^T C from geqrf's factors,
            # taken at the first call (a recheck times nothing)
            qr = []

            def library():
                if not qr:
                    qr.extend(torch.geqrf(self.lib_of(pans)))
                return torch.ormqr(*qr, self.lib_x, left=True, transpose=True)

            self.library = library
            self.flops = apply_flops(shape, b, pivot0)
            self.nbytes = (2.0 * m * w + 2.0 * m * b) * B * size  # C in/out, V, T
        self.x = x
        # the library call's inputs: f32 for a mixed or a narrow case, f64 for a
        # wide one
        self.lib_of = lambda z: (z.float() if self.mixed or self.narrow else
                                 z.double() if self.wide else z)
        self.lib_x = self.lib_of(x)
        self.kernel = lambda: self.fn(x)
        self.plain_of = plain  # the plain version of any inputs z of the case's kind
        self.plain = lambda: plain(x)
        self.plain64 = lambda: plain(x.double(), None)
        # a mixed case's f32 plain version rounded once, at the end, to the
        # tile dtype: what a kernel that kept the state in f32 would give
        self.once = lambda: tuple(o.to(dtype) for o in _as_outputs(plain(x.float(), None)))
        self.rel_tol = (kc.wide_bound(name, m, w, self.dname) if self.wide or self.narrow
                        else kc.rel_bound(name, m, w, self.dname))

    @property
    def pair(self) -> str:
        """'uniform', or the tile dtype's name and the sums' for a mixed, a
        wide or a narrow case."""
        return (f"{self.dname}/{self.accum}" if self.mixed or self.wide or self.narrow
                else "uniform")

    def label(self) -> str:
        data = "" if self.data == "random" else f" {self.data} data"
        acc = f"/{self.accum}" if self.mixed or self.wide or self.narrow else ""
        return f"{self.name} {self.shape} {self.dname}{acc} param={self.param}{data}"

    def compare(self, quiet: bool = False) -> float:
        """Kernel vs plain version on the same inputs, each output on its own
        scale; returns the worst absolute error and keeps the worst error
        over rms(out) in ``rel``.  A mixed case also holds the kernel's
        rounding (``kernel_check.per_step``) and, unless ``quiet``, runs the
        f32 plain version rounded once through the same comparison as its
        control, which must fail it."""
        import torch

        from repro_torch.testing import kernel_check as kc

        if self.wide or self.narrow:
            return self.compare_wide(quiet)
        out, ref = self.kernel(), self.plain()
        outs, refs = _as_outputs(out), _as_outputs(ref)
        err, ok, rels, olds = 0.0, True, [], []
        for o, r in zip(outs, refs):
            ok = ok and o.dtype == r.dtype == self.dtype and bool(o.isfinite().all())
            err = max(err, float((o.double() - r.double()).abs().max()) if o.numel() else 0.0)
        # an f32 / f64 case holds each output, a mixed one the parts the
        # algorithm determines at its tile dtype (kernel_check.determined)
        held = ((kc.determined(self.name, self.param, outs),
                 kc.determined(self.name, self.param, refs)) if self.mixed else (outs, refs))
        for o, r in zip(*held):
            rels.append(kc.rel_err(o, r))
            if kc.rms_of(r) > 0 and self.dname in OLD_TOL:  # the old rule on the same scale
                olds.append(OLD_TOL[self.dname] * max(1, self.shape[1] // 16)
                            * max(1.0, float(r.abs().max())) / kc.rms_of(r))
            ok = ok and rels[-1] <= self.rel_tol
        note = ""
        if self.mixed:
            lo, hi = kc.ROUNDING
            parts = lambda r: kc.parts(self.name, self.param, r)  # noqa: E731
            exact = parts(_as_outputs(self.plain64()))
            stepped, self.ratios = kc.per_step(parts(outs), parts(refs), exact)
            ok = ok and stepped
            note = ("; relative Frobenius error from the exact result over the plain "
                    f"version's, each part {_fmt(self.ratios) or '(none large enough)'}"
                    f" (within {lo:g}-{hi:g})")
            if not quiet and self.ratios:
                once = self.once()
                self.once_rel = max(kc.rel_err(o, r) for o, r in zip(
                    kc.determined(self.name, self.param, once), held[1]))
                once_stepped, self.once_ratios = kc.per_step(parts(once), parts(refs),
                                                             exact)
                fooled = once_stepped and self.once_rel <= self.rel_tol
                ok = ok and not fooled
                note += (f"; control, the f32 plain version rounded once to {self.dname}, "
                         f"must fail: max|err| / rms {self.once_rel:.2e}, error ratios "
                         f"{_fmt(self.once_ratios)} ({'passes' if fooled else 'fails'})")
        if not ok and self.dname == "float32" and all(o.isfinite().all() for o in outs):
            ok, note = self.against_f64(outs, refs)
            if not ok:
                ok, more = self.against_draws()
                note += more
        self.rel = max(rels)
        self.old = min(olds) if olds else float("inf")
        if self.fixed is not None:
            check(torch.equal(out[self.fixed], self.x[self.fixed]),
                  f"{self.label()}: the [0 | I] tiles come back bitwise as they were",
                  quiet)
        old = f" (old rule {self.old:.1e})" if olds else ""
        what = " of the determined parts" if self.mixed else "(out)"
        check(ok, f"{self.label()}: max_abs_err {err:.3e}, max|err| / rms{what} "
                  f"{', '.join(f'{q:.2e}' for q in rels)}; each within "
                  f"{self.rel_tol:.1e}{old}{note}", quiet)
        return err

    def compare_wide(self, quiet: bool = False) -> float:
        """The wide rule (``kernel_check.wide_held``) on WIDE_DRAWS draws of
        the case's shape (its own inputs, then generator seeds 1, 2, ...),
        or on its own inputs alone when ``quiet`` (the recheck of a launched
        shape, held for its accuracy, ``kernel_check.wide_accurate``: one
        draw of a few problems may hold a whole flipped one).  Unless
        ``quiet``, the control, the (tile, float32) instance on the same
        draws' inputs, must fail the rule.  The kernel and the control run
        at the case's shape, a launch a draw; the plain version runs on
        several draws' problems stacked along the batch at once, up to
        WIDE_PLAIN_ELEMS elements (each problem's result is its own).
        Returns the worst absolute error and keeps the worst max|err| / rms
        in ``rel`` and the readings in ``readings``."""
        import statistics

        import torch

        from repro_torch.testing import kernel_check as kc

        draws = 1 if quiet else kc.WIDE_DRAWS
        B, m, w = self.shape
        group = max(1, WIDE_PLAIN_ELEMS // (B * m * w))  # draws a plain call takes
        err, ok, reads, ctrl, apart = 0.0, True, [], [], []
        for i in range(draws):
            if i % group == 0:  # the next group of draws, their plain version at once
                batch = [self if j == 0 else KernelCase(
                    self.name, self.shape, self.param, self.dtype,
                    torch.Generator(device="cuda").manual_seed(j), self.data, self.accum)
                    for j in range(i, min(i + group, draws))]
                # B4's plain version takes the draws' factors stacked too
                factors = ({"VT": [torch.cat(f) for f in zip(*(c.factors for c in batch))]}
                           if self.name == "apply_factors" else {})
                refs_of = list(zip(*(o.split(B) for o in _as_outputs(
                    self.plain_of(torch.cat([c.x for c in batch]), **factors)))))
            case = batch[i % group]
            outs, refs = _as_outputs(case.kernel()), refs_of[i % group]
            ok = ok and all(o.dtype == r.dtype == self.dtype and bool(o.isfinite().all())
                            for o, r in zip(outs, refs))
            err = max(err, max(float((o.double() - r.double()).abs().max()) for o, r in
                               zip(outs, refs)))
            reads.append(kc.wide_reading(self.name, self.param, self.dname, outs, refs))
            if not quiet:
                ctrl.append(kc.wide_reading(self.name, self.param, self.dname,
                                            _as_outputs(case.control()), refs))
                if self.name == "apply_factors":
                    apart.append(unequal_where(outs[0], refs[0]))
            if case.fixed is not None:
                check(torch.equal(outs[0][case.fixed], case.x[case.fixed]),
                      f"{case.label()}: the [0 | I] tiles come back bitwise as they were",
                      quiet=True)
        # a recheck (one draw, maybe of a few problems) holds the accuracy;
        # the share is a statistic of many problems (phase 3's draws)
        held = (kc.wide_accurate(self.name, m, w, self.dname, reads) if quiet else
                kc.wide_held(self.name, m, w, self.dname, reads, self.accum))
        fooled = bool(ctrl) and kc.wide_held(self.name, m, w, self.dname, ctrl, self.accum)
        self.rel, self.old = max(r for _, r in reads), float("inf")
        self.readings = {"share": [sh for sh, _ in reads], "rel": [r for _, r in reads],
                         "control_share": [sh for sh, _ in ctrl],
                         "control_rel": [r for _, r in ctrl]}
        ok = ok and held and not fooled
        shares = self.readings["share"]
        parts = "each output" if self.dname == "float32" else "the determined parts"
        limit = "a reading" if quiet else f">= {kc.equal_limit(self.dname, self.accum):g}"
        note = (f"{draws} draw(s): share of entries bitwise equal to the plain version "
                f"{statistics.fmean(shares):.7f} ({limit}; least draw {min(shares):.7f}), "
                f"max|err| / rms of {parts} worst {self.rel:.2e} (<= {self.rel_tol:.1e})")
        if ctrl:
            cs, cr = self.readings["control_share"], self.readings["control_rel"]
            note += (f"; control, the ({self.dname}, float32) instance on the same inputs, "
                     f"must fail: share {statistics.fmean(cs):.7f} (draws {min(cs):.7f}-"
                     f"{max(cs):.7f}), max|err| / rms worst {max(cr):.2e} "
                     f"({'passes' if fooled else 'fails'})")
        check(ok, f"{self.label()}: max_abs_err {err:.3e}, {note}", quiet)
        if apart:
            rows, cols, mags, gaps = (torch.cat(v) for v in zip(*apart))
            if rows.numel():
                def qs(v):  # quantiles 0, 0.5, 1 (of every k-th value past 2^24)
                    v = v[::-(-v.numel() // 2 ** 24)]
                    return _fmt(torch.quantile(v, v.new_tensor([0.0, 0.5, 1.0])).tolist())

                print(f"    where B4 differs from its plain version, {rows.numel()} entries "
                      f"over {draws} draws: row / m at quantiles 0, 0.5, 1 {qs(rows)}; "
                      f"{int(cols.sum())} of {draws * w} columns; |plain| / rms {qs(mags)}; "
                      f"|kernel - plain| / |plain| {qs(gaps)}")
        return err

    def against_f64(self, outs, refs) -> tuple:
        """An f32 reading over its bound, taken again against the plain
        version run in f64 on the same inputs: each output of the kernel
        within the same bound of it.  Returns (ok, a note of the kernel's
        and the f32 plain version's distances from it)."""
        ref64 = self.plain64()
        ref64 = ref64 if isinstance(ref64, tuple) else (ref64,)
        ok, dists = True, []
        for o, r, r64 in zip(outs, refs, ref64):
            rms = float(r64.square().mean().sqrt())
            if rms == 0:
                ok = ok and bool((o == 0).all())
                continue
            d_kernel = float((o.double() - r64).abs().max()) / rms
            d_plain = float((r.double() - r64).abs().max()) / rms
            ok = ok and d_kernel <= self.rel_tol
            dists.append(f"{d_kernel:.2e} / {d_plain:.2e}")
        return ok, ("; over its bound, so against the f64 plain version (kernel / "
                    f"f32 plain, the kernel's within the bound): {', '.join(dists)}")

    def against_draws(self, n: int = DRAWS) -> tuple:
        """An f32 reading over its bound against the f64 plain version too,
        read again over ``n`` fresh inputs of the case's shape (generator
        seeds 1..n): the kernel's and the f32 plain version's max|err| /
        rms against the f64 plain version, output by output.  The f32
        algorithm's own errors have a heavy tail (one random (8, 256, 64)
        panel batch in about 60 takes the f32 plain version past
        panel_factor's bound, PERF.md §6), so a single draw over it is held
        by the distribution: the kernel's median and its DRAW_Q-quantile each
        within DRAW_RATIO x the f32 plain version's.  Returns (ok, a note)."""
        import torch

        kern, plain = [], []
        for i in range(1, n + 1):
            case = KernelCase(self.name, self.shape, self.param, self.dtype,
                              torch.Generator(device="cuda").manual_seed(i), self.data)
            outs, refs, ref64 = (_as_outputs(f()) for f in (case.kernel, case.plain,
                                                            case.plain64))
            rms = [float(r.square().mean().sqrt()) or 1.0 for r in ref64]
            kern.append([float((o.double() - r).abs().max()) / m
                         for o, r, m in zip(outs, ref64, rms)])
            plain.append([float((o.double() - r).abs().max()) / m
                          for o, r, m in zip(refs, ref64, rms)])
        kern, plain = torch.tensor(kern).double(), torch.tensor(plain).double()
        qs = torch.tensor([0.5, DRAW_Q], dtype=torch.float64)
        qk, qp = torch.quantile(kern, qs, dim=0), torch.quantile(plain, qs, dim=0)
        ok = bool((qk <= DRAW_RATIO * qp).all())
        return ok, (f"; over {n} fresh draws against f64, median / q{DRAW_Q:g} kernel vs "
                    "f32 plain (the kernel's within "
                    f"{DRAW_RATIO:g}x): " + ", ".join(
                        f"{qk[0, j]:.2e} / {qk[1, j]:.2e} vs {qp[0, j]:.2e} / {qp[1, j]:.2e}"
                        for j in range(kern.shape[1])))

    def zero_batch(self) -> None:
        import torch

        from repro_torch.kernels import ggr_apply

        z = torch.zeros((8,) + self.shape[1:], device="cuda", dtype=self.dtype)
        if self.name == "apply_factors":  # a zero panel's factors over zeros
            b, pivot0 = self.param
            VT = torch.zeros((8, self.shape[1], b), device="cuda", dtype=self.dtype)
            out = ggr_apply.apply_factors(VT, VT, z, pivot0, precision=self.prec)
        else:
            out = self.fn(z)
        torch.cuda.synchronize()
        outs = out if isinstance(out, tuple) else (out,)
        itype = {2: torch.int16, 4: torch.int32, 8: torch.int64}[z.element_size()]
        check(all(bool((o.view(itype) == 0).all()) for o in outs),
              f"{self.name} all-zero batch {tuple(z.shape)} {self.dname}"
              f"{'' if self.pair == 'uniform' else '/' + self.accum} comes back bitwise zero")

    def times(self) -> dict:
        ms = cuda_ms(self.kernel, reps=20, warmup=2)
        plain_ms = cuda_ms(self.plain, reps=1)  # 14 ms to 1.4 s a call: one is enough
        library_ms = cuda_ms(self.library, reps=5)
        bound_ms, bound_by = bound(self.nbytes, self.accum, self.flops)
        lib = (" (f32, the same inputs)" if self.mixed or self.narrow else
               " (f64, the same inputs)" if self.wide else "")
        print(f"  {self.label()}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {library_ms:.4f} ms{lib}, bound {bound_ms:.4f} ms ({bound_by})"
              f"{self.note}", flush=True)
        return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                    bound_ms=bound_ms, bound_by=bound_by)


def unequal_where(out, ref) -> tuple:
    """Where a (B, m, w) output's bits differ from the plain version's:
    (each unequal entry's row over m, a 0/1 per column that holds one, its
    |plain| over rms(plain), its |out - plain| over |plain|), in f64."""
    from repro_torch.testing import kernel_check as kc

    diff = (out != ref) & ~(out.isnan() & ref.isnan())
    o, r = out[diff].double(), ref[diff].double()
    rows = diff.nonzero()[:, 1].double() / out.shape[1]
    return (rows, diff.any(1).flatten().double(), r.abs() / (kc.rms_of(ref) or 1.0),
            (o - r).abs() / r.abs().clamp_min(1e-300))


def profile_top(fn, label: str, rows: int = 8, host_ops: bool = True) -> None:
    """One traced call of ``fn``: device time by kernel name (self time,
    top ``rows``), the device's busy share of the call's wall time.
    ``host_ops=False`` records the device activity only: reading back a
    trace of ~10^5 host-side ops takes the profiler about a minute."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side entries only: an operator's row repeats its kernels' time
    events = [(e.key, e.self_device_time_total, e.count)
              for e in prof.key_averages()
              if "CUDA" in str(e.device_type) and e.self_device_time_total > 0]
    busy = sum(t for _, t, _ in events)
    print(f"  trace of {label}: wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}% of wall)")
    for key, t, count in sorted(events, key=lambda e: -e[1])[:rows]:
        print(f"    {100 * t / max(busy, 1e-9):5.1f}%  {t / 1e3:9.3f} ms  "
              f"x{count:<6d} {key[:90]}")


def recheck_shapes(recorded: dict, gen) -> dict:
    """Hold every (shape, param, dtype) a kernel was launched at by the main
    path against the plain version on fresh inputs of that shape (printing
    only failures); returns each kernel's worst error.  A mixed case is
    also held for rounding its state at every step, on the parts large
    enough to read (``kernel_check.per_step``)."""
    worst, worst_rel, looser, ratios = {}, {}, [], {}
    for name, shapes in recorded.items():
        worst[name] = worst_rel[name] = 0.0
        for shape, param, dtype, accum in sorted(shapes, key=str):
            case = KernelCase(name, shape, param, dtype, gen, accum=accum)
            worst[name] = max(worst[name], case.compare(quiet=True))
            worst_rel[name] = max(worst_rel[name], case.rel)
            if case.mixed:
                ratios.setdefault(name, []).extend(case.ratios)
            if case.rel_tol > case.old:
                looser.append(f"{case.label()} ({case.rel_tol:.1e} > {case.old:.1e})")
    print(f"  worst max|err| / rms(out): {worst_rel}")
    if ratios:
        print("  error ratios from the exact result, kernel over plain (least, most, "
              "parts read): " + ", ".join(f"{k} {min(v or [0]):.3f}, {max(v or [0]):.3f}, "
                                         f"{len(v)}" for k, v in ratios.items()))
    print(f"  shapes where the bound is looser than the old rule: {looser or 'none'}")
    return worst


def graded_system(m: int, n: int, cond: float, seed: int):
    """(A, b, x0, ||r0||) in f64 numpy: A with singular values geometric from
    1 to 1/cond (orthogonal factors from QR of seeded Gaussians), b = A x0 +
    r0 with r0 orthogonal to range(A) — so x0 solves min ||Ax - b|| and
    ||r0|| is the optimal residual exactly."""
    import numpy as np

    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((m, n)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (U * np.geomspace(1.0, 1.0 / cond, n)) @ V.T
    x0 = rng.standard_normal(n)
    r0 = rng.standard_normal(m)
    r0 -= U @ (U.T @ r0)
    r0 *= SKETCH_R0 / np.linalg.norm(r0)
    return A, A @ x0 + r0, x0, float(np.linalg.norm(r0))


def wall_ms(fn) -> tuple:
    """(result, ms) of one call, synchronized on both ends."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def start_cli(name: str, argv: list, module: bool = True) -> tuple:
    """``python -m argv`` (``python argv`` unless ``module``) as a
    subprocess, its output into files under build/smoke_cli; returns the
    handle ``wait_cli`` takes."""
    import threading

    env = dict(os.environ, PYTHONPATH=str(SRC))
    CLI_DIR.mkdir(parents=True, exist_ok=True)
    with open(CLI_DIR / f"{name}.out", "w") as fo, open(CLI_DIR / f"{name}.err", "w") as fe:
        proc = subprocess.Popen([sys.executable, *(["-m"] if module else []), *argv],
                                stdout=fo, stderr=fe, env=env)
    ended = []  # when it ended, seen by a thread that waits for it

    def watch():
        proc.wait()
        ended.append(time.perf_counter())

    threading.Thread(target=watch, daemon=True).start()
    return name, time.perf_counter(), proc, ended


def wait_cli(handle: tuple, timeout_s: float) -> tuple:
    """(exit code, stdout, stderr, seconds from its start to its end) of a
    ``start_cli`` run, killed if still running ``timeout_s`` after its start."""
    name, t0, proc, ended = handle
    try:
        proc.wait(timeout=max(0.0, timeout_s - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    while not ended:  # the watching thread's reading
        time.sleep(0.01)
    return (proc.returncode, (CLI_DIR / f"{name}.out").read_text(),
            (CLI_DIR / f"{name}.err").read_text(), ended[0] - t0)


def run_staggered(cmds: dict, stagger_s: float, timeout_s: float) -> dict:
    """Run each command of ``cmds`` (name -> argv after ``python -m``), each
    started ``stagger_s`` after the one before it, so that its start-up
    (imports, the CUDA context, the weights) overlaps the run before it.
    Returns name -> ``wait_cli``'s tuple."""
    handles = {}
    for i, (name, argv) in enumerate(cmds.items()):
        if i:
            time.sleep(stagger_s)
        handles[name] = start_cli(name, argv)
    return {name: wait_cli(h, timeout_s) for name, h in handles.items()}


def instrumented_phase(server, reqs, kernels, card: str, early: dict) -> dict:
    """Phase 6 (a)-(e); returns the launches it made and its numbers.  After
    (a)'s timed flushes it starts its own CLI run and phase 7 (f)'s and
    phase 8 (e)'s (``start_cli``, into ``early``), which run beside (b)-(e);
    its own is read at the phase's end."""
    import numpy as np
    import torch

    from repro_torch import obs, ranks, solvers
    from repro_torch.core import baselines, ggr_qr_blocked
    from repro_torch.launch.serve_qr import _submit_all

    for fn in kernels.values():
        fn.launches = 0
        fn.shapes.clear()
    t_phase = time.perf_counter()
    out = {}

    # (a) the serving flush with and without a collector, in turns after
    # one untimed flush
    _submit_all(server, reqs)
    server.flush()
    server.drain()
    rates = {"without": [], "with": []}
    for mode in ("without", "with", "with", "without", "without", "with"):
        _submit_all(server, reqs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "with":
            with obs.collecting() as reg:
                served = server.flush()
                server.drain()
        else:
            served = server.flush()
            server.drain()
        rates[mode].append(served / (time.perf_counter() - t0))
    out["serve_req_s"] = rates
    print(f"  (a) 8192-request flush: without a collector "
          f"{', '.join(f'{r:.1f}' for r in rates['without'])} req/s, with one "
          f"{', '.join(f'{r:.1f}' for r in rates['with'])} req/s (turns: without, "
          f"with, with, without, without, with; {card})")
    snap = obs.snapshot(reg)
    missing = obs.missing_families(snap)
    check(not missing, f"(a) the instrumented flush's snapshot holds every "
                       f"required serving family (missing: {missing or 'none'})")
    flops = sum(m["value"] for m in snap["metrics"] if m["name"] == "serve.flops_total")
    gf = [m for m in snap["metrics"] if m["name"] == "serve.achieved_gflops"]
    print(f"  (a) {len(snap['metrics'])} series; serve.flops_total {flops:.4g}; "
          "achieved GFLOP/s p50 by kind: " + ", ".join(
              f"{m['labels']['kind']} {m['quantiles']['0.5']:.3g}" for m in gf))
    prefix = ROOT / "build" / "smoke_metrics" / "serve"
    prefix.parent.mkdir(parents=True, exist_ok=True)
    for f in (f"{prefix}.jsonl", f"{prefix}.prom"):
        if os.path.exists(f):
            os.remove(f)
    serve_qr = "repro_torch.launch.serve_qr"
    early["6"] = start_cli("serve_qr_metrics", [serve_qr, "--metrics", str(prefix), "--check",
                                                "--requests", "512"])
    early["7"] = start_cli("serve_qr_resilient", [serve_qr, "--resilient", "--check",
                                                  "--requests", "512"])
    early["8"] = start_cli("serve_qr_mesh4", [serve_qr, "--device", "cuda", "--mesh", "4",
                                              "--check"])

    # (b) sketch-preconditioned least squares at full size, f64
    t0 = time.perf_counter()
    A, b, x0, r0 = graded_system(SKETCH_M, SKETCH_N, SKETCH_COND, seed=13)
    print(f"  (b) built A ({SKETCH_M}, {SKETCH_N}) f64, cond {SKETCH_COND:g}, "
          f"in {time.perf_counter() - t0:.1f} s on the host")
    At = torch.as_tensor(A, device="cuda")
    bt = torch.as_tensor(b, device="cuda")
    before = {k: fn.launches for k, fn in kernels.items()}
    fit, ms = wall_ms(lambda: ranks.sketch_lstsq(At, bt, iters=50, tol=1e-12, seed=15))
    sk_launch = {k: fn.launches - before[k] for k, fn in kernels.items()}
    fit2, ms2 = wall_ms(lambda: ranks.sketch_lstsq(At, bt, iters=50, tol=1e-12, seed=15))
    _, lib_ms = wall_ms(lambda: torch.linalg.lstsq(At, bt[:, None]).solution)
    _, lib_ms2 = wall_ms(lambda: torch.linalg.lstsq(At, bt[:, None]).solution)
    resid, iters = float(fit.resid), int(fit.iters)
    x_err = float(np.linalg.norm(fit.x.cpu().numpy() - x0) / np.linalg.norm(x0))
    out["sketch"] = dict(ms=[ms, ms2], lstsq_ms=[lib_ms, lib_ms2], iters=iters,
                         resid_gap=abs(resid - r0) / r0)
    print(f"  (b) sketch_lstsq: {ms:.1f} / {ms2:.1f} ms, {iters} iterations, "
          f"resid {resid:.12g} vs ||r0|| {r0:.12g}, |x - x0| / |x0| {x_err:.2e}; "
          f"torch.linalg.lstsq {lib_ms:.1f} / {lib_ms2:.1f} ms; launches {sk_launch} "
          f"({card})")
    check(abs(resid - r0) <= 1e-6 * r0 and iters <= 50,
          f"(b) residual within {abs(resid - r0) / r0:.2e} of ||r0|| (<= 1e-6) "
          f"in {iters} <= 50 iterations")
    check(x_err <= 1e-2, f"(b) x within {x_err:.2e} of x0 (<= 1e-2, the "
                         "problem's tol x cond amplification)")
    check(torch.equal(fit.R, fit2.R) and torch.equal(fit.x, fit2.x),
          "(b) R_s and x are the same bits on two runs (deterministic sketch)")
    check(sk_launch["panel_factor"] > 0 and sk_launch["apply_factors"] > 0,
          "(b) the sketch QR launched panel_factor and apply_factors")
    profile_top(lambda: ranks.sketch_lstsq(At, bt, iters=50, tol=1e-12, seed=15),
                "sketch_lstsq (65536, 256) f64", rows=5, host_ops=False)
    del At, bt, fit, fit2

    # (c) monitor and guard on a (256, 256) RLS state on the card
    n = 256
    rng = np.random.default_rng(21)
    U, _ = np.linalg.qr(rng.standard_normal((2 * n, n)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    R0 = np.linalg.qr((U * np.geomspace(1.0, 1e-6, n)) @ V.T, mode="r")
    R0 *= np.sign(np.diag(R0))[:, None]
    f64 = dict(dtype=torch.float64, device="cuda")
    rls = solvers.RecursiveLS(n=n)
    state = solvers.RLSState(R=torch.as_tensor(R0, **f64),
                             d=torch.as_tensor(rng.standard_normal((n, 1)), **f64),
                             count=torch.zeros((), dtype=torch.int32, device="cuda"))
    mon = ranks.ConditionMonitor(layer="rls", iters=4)
    t0 = time.perf_counter()
    with obs.collecting() as reg:
        for _ in range(32):
            state = rls.observe(state, torch.as_tensor(1e-3 * rng.standard_normal((1, n)), **f64),
                                torch.zeros((1, 1), **f64))
            est = mon.observe(state.R)
    truth = float(torch.linalg.cond(state.R.cpu().double()))
    print(f"  (c) ConditionMonitor over 32 appends: {est:.6g} vs torch.linalg.cond "
          f"{truth:.6g} ({(time.perf_counter() - t0) * 1e3:.0f} ms)")
    check(0.5 * truth <= est <= 2.0 * truth, "(c) the monitor's last estimate is "
          f"within 2x of torch.linalg.cond ({est / truth:.3f})")
    check(reg.find("rls.cond_estimate").value == est, "(c) rls.cond_estimate gauge recorded")
    u = state.R[n // 2] + 0.0  # a direction of the window's mass
    lev = float(rls.residual_gram(state, u))
    bad = (1.5 / lev) ** 0.5 * u  # leverage 1.5: past the rank cliff
    y = bad.sum().reshape(1)
    with obs.collecting() as reg:
        damped = rls.forget(state, bad, y, guard=ranks.DowndateGuard(1e-6, "damp"))
    trips = reg.find("solvers.downdate_guard_trips")
    check(bool(damped.R.isfinite().all()) and trips is not None and trips.value == 1,
          "(c) damp: the factor stays finite, solvers.downdate_guard_trips = "
          f"{None if trips is None else trips.value}")
    kept = rls.forget(state, bad, y, guard=ranks.DowndateGuard(1e-6, "refuse"))
    check(torch.equal(kept.R, state.R) and torch.equal(kept.d, state.d),
          "(c) refuse: the state comes back bit for bit")
    ok_free, why_free = solvers.state_integrity(damped)
    ok_cap, why_cap = solvers.state_integrity(damped, max_cond=1e3)
    ok_big, _ = solvers.state_integrity(damped, max_cond=1e12)
    print(f"  (c) state_integrity: {ok_free} ({why_free}); max_cond=1e3: {ok_cap} "
          f"({why_cap}); max_cond=1e12: {ok_big}")
    check(ok_free and ok_big and not ok_cap, "(c) state_integrity passes the "
          "damped state, and refuses it only under max_cond=1e3")

    # (d) flop accounting of one dense QR (a reading, not a claim)
    g = torch.Generator(device="cuda").manual_seed(2)
    M = torch.randn((4096, 4096), generator=g, device="cuda")
    ggr_qr_blocked(M)  # warm
    qr_ms = {"without": [], "with": []}
    for mode in ("without", "with", "with", "without"):
        if mode == "with":
            with obs.collecting() as reg:
                qr_ms[mode].append(wall_ms(lambda: ggr_qr_blocked(M))[1])
        else:
            qr_ms[mode].append(wall_ms(lambda: ggr_qr_blocked(M))[1])
    out["dense_qr_ms"] = qr_ms
    print(f"  (d) ggr_qr_blocked 4096^2 f32 wall: without a collector "
          f"{', '.join(f'{t:.2f}' for t in qr_ms['without'])} ms, with one "
          f"{', '.join(f'{t:.2f}' for t in qr_ms['with'])} ms")
    sched = "fused"
    disp = reg.find("blocked.dispatch_seconds", schedule=sched, precision="float32")
    fl = reg.find("blocked.flops_total", dtype="float32", schedule=sched, precision="float32")
    model = obs.ggr_sweep_flops(4096, 4096)
    check(disp is not None and fl is not None and fl.value == model,
          "(d) blocked.flops_total equals ggr_sweep_flops(4096, 4096)")
    if disp is not None:
        sec = disp.values[-1]
        out["dense_gflops"] = model / sec / 1e9
        print(f"  (d) ggr_qr_blocked 4096^2 f32 (\"auto\", {sched}): {model:.6g} flops "
              f"by the sweep model in {sec * 1e3:.2f} ms = {model / sec / 1e9:.1f} "
              f"GFLOP/s ({card})")
    del M

    # (e) the paper's baseline QRs against torch.linalg.qr
    out["baselines_ms"] = {}
    for name, shape in (("householder_qr2", (512, 256)), ("householder_qrf", (512, 256)),
                        ("mht_qr", (512, 256)), ("mgs_qr", (512, 256)),
                        ("givens_qr", (128, 128)), ("cgr_qr", (128, 128))):
        X = torch.randn(shape, generator=g, device="cuda")
        fn = getattr(baselines, name)
        res, ms = wall_ms(lambda: fn(X))
        R = res[1] if name == "mgs_qr" else res
        R_lib = torch.linalg.qr(X, mode="r").R
        k = min(shape)
        gap = float(torch.linalg.norm(R[:k].abs() - R_lib[:k].abs()) / torch.linalg.norm(R_lib))
        out["baselines_ms"][name] = ms
        check(gap <= 1e-3, f"(e) {name} {shape} f32: |R| within {gap:.2e} of "
                           f"torch.linalg.qr's (<= 1e-3), {ms:.1f} ms")
    launches = {k: fn.launches for k, fn in kernels.items()}
    out["launches"] = launches
    out["shapes"] = {k: set(fn.shapes) for k, fn in kernels.items()}

    # (a)'s CLI run, started after the timed flushes
    rc, text, err, wall = wait_cli(early["6"], 600)
    lines = text.strip().splitlines()
    check(rc == 0 and len(lines) == 2 and len(lines[-1].split(",")) == 3,
          f"(a) serve_qr --metrics --check --requests 512 exits {rc} with {len(lines)} CSV "
          f"lines in {wall:.1f} s, beside (b)-(e): {lines[-1:]}")
    val = subprocess.run([sys.executable, "-m", "repro_torch.obs.export",
                          "--validate", f"{prefix}.jsonl"], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(SRC)), timeout=300)
    check(val.returncode == 0 and os.path.exists(f"{prefix}.prom"),
          f"(a) obs.export --validate accepts {prefix}.jsonl: "
          f"{(val.stdout or val.stderr).strip()[:120]}")
    print(f"  launches in phase 6: {launches} "
          f"({(time.perf_counter() - t_phase):.1f} s wall)")
    for k in ("batched_update", "panel_factor", "apply_factors"):
        check(launches[k] > 0, f"phase 6 launched {k}")
    return out


def same_bits(a, b) -> bool:
    """Two ticket results (a tensor or a tuple of tensors) equal bit for bit
    (float leaves compared as integers, so a NaN equals the same NaN)."""
    import torch

    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if x.is_floating_point():
            itype = {2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]
            x, y = x.contiguous().view(itype), y.contiguous().view(itype)
        if not torch.equal(x, y):
            return False
    return True


def rel_gap(a, b) -> float:
    """Worst |a - b| over max(1, |b|) across the leaves of two results (the
    serving cross-check's scale); inf where a is not finite."""
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    if not all(bool(x.isfinite().all()) for x in a):
        return float("inf")
    scale = max(1.0, max(float(y.abs().max()) for y in b))
    return max(float((x.double() - y.double()).abs().max()) for x, y in zip(a, b)) / scale


def resolve(engine, ticket):
    """A ticket's result, or the ServeError it resolved to."""
    from repro_torch.serve import ServeError

    try:
        return engine.result(ticket)
    except ServeError as e:
        return e


def counter_sum(reg, name: str, /, **labels) -> float:
    return sum(m.value for m in reg.collect() if m.name == name
               and all(dict(m.labels).get(k) == v for k, v in labels.items()))


def resilient_phase(reqs, kernels, card: str, cli: tuple) -> dict:
    """Phase 7 (a)-(f); returns the launches it made and its numbers.  ``cli``:
    (f)'s run, started in phase 6 (``start_cli``)."""
    import shutil

    import numpy as np
    import torch

    from repro_torch import obs, solvers
    from repro_torch.convert import from_numpy
    from repro_torch.launch.serve_qr import QRServer, _submit_all
    from repro_torch.obs import export
    from repro_torch.serve import (DEFAULT_LADDER, ContinuousBatcher, IntegrityError,
                                   PoisonedError, ResilientDispatcher, RetryPolicy, Rung,
                                   ServeError, StateVault)
    from repro_torch.testing.faults import (FaultPlan, ScriptedInjector, inject,
                                            poison_workload)

    b1 = kernels["batched_update"]
    for fn in kernels.values():
        fn.launches = 0
        fn.shapes.clear()
    t_phase = time.perf_counter()
    out = {"wall_s": {}}
    no_sleep = lambda s: None  # noqa: E731 — the drills do not wait out backoffs
    # the mix's operands as tensors on the card, made once (the fleet-shared
    # models stay one tensor): submits then copy nothing, and the flushes do
    # the same work as phase 4's
    reqs = from_numpy(reqs, "cuda")
    t_sub = [time.perf_counter()]

    def lap(part: str) -> None:
        now = time.perf_counter()
        out["wall_s"][part] = now - t_sub[0]
        print(f"  ({part}) took {now - t_sub[0]:.1f} s")
        t_sub[0] = now

    # (a) fault-free at full width: resilient == plain, bit for bit
    servers = {"plain": QRServer(device="cuda", max_batch=SERVE_MAX_BATCH),
               "resilient": QRServer(device="cuda", max_batch=SERVE_MAX_BATCH,
                                     resilient=True)}
    res = {}
    for name, srv in servers.items():
        before = b1.launches
        tickets = _submit_all(srv, reqs)
        srv.flush()
        srv.drain()
        res[name] = ([srv.result(t) for t in tickets], b1.launches - before)
    diff = sum(not same_bits(a, b) for a, b in zip(res["plain"][0], res["resilient"][0]))
    check(diff == 0, f"(a) fault-free resilient flush of {len(reqs)} requests: every result "
                     f"bitwise equal to the plain flush's ({diff} differ)")
    dispatcher = servers["resilient"]._engine.dispatcher
    provs = {(p.rung, p.attempts) for ps in dispatcher.provenance.values() for p in ps}
    check(provs == {("native", 1)}, f"(a) every provenance entry is (native, 1 attempt): {provs}")
    check(res["plain"][1] == res["resilient"][1] > 0,
          f"(a) batched_update launches: plain flush {res['plain'][1]}, resilient "
          f"{res['resilient'][1]}")
    _submit_all(servers["resilient"], reqs)
    with obs.collecting() as reg:
        servers["resilient"].flush()
        servers["resilient"].drain()
    faults = {f: counter_sum(reg, f) for f in
              ("serve.chunk_failures", "serve.degraded_dispatches", "serve.quarantined")}
    check(not any(faults.values()), f"(a) under a collector, no failure, degradation or "
                                    f"quarantine is counted: {faults}")
    rates = {"plain": [], "resilient": []}
    for name in ["plain", "resilient", "resilient", "plain"] * 2 + ["plain", "resilient"]:
        srv = servers[name]
        _submit_all(srv, reqs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        served = srv.flush()
        srv.drain()
        rates[name].append(served / (time.perf_counter() - t0))
    med = {k: float(np.median(v)) for k, v in rates.items()}
    out["serve_req_s"] = dict(rates, median=med)
    print(f"  (a) {len(reqs)}-request flush, 5 alternating pairs (plain, resilient, "
          f"resilient, plain, ...): plain {', '.join(f'{r:.1f}' for r in rates['plain'])}; "
          f"resilient {', '.join(f'{r:.1f}' for r in rates['resilient'])} req/s; medians "
          f"{med['plain']:.1f} / {med['resilient']:.1f}, ratio "
          f"{med['resilient'] / med['plain']:.3f} (the layer's bound >= 0.8: a reading, "
          f"not checked, as the host's spread is wider; {card})")
    del res, servers
    lap("a")

    # (b) chaos, as the JAX package's bench: a poisoned mix under a fault plan,
    # beside a fault-free resilient run of the same mix at the same max_batch
    poisoned, idx = poison_workload(reqs, rate=0.01, seed=11)
    runs = {}
    reg = obs.MetricsRegistry()
    for name in ("fault-free", "chaos"):
        srv = QRServer(device="cuda", max_batch=512, resilient=True)
        tickets = _submit_all(srv, poisoned)
        t0 = time.perf_counter()
        if name == "chaos":
            with obs.collecting(reg), inject(FaultPlan(seed=7, transient_rate=0.2,
                                                       poison_rate=0.05)) as inj:
                srv.flush()
                srv.drain()
        else:
            srv.flush()
            srv.drain()
        wall = time.perf_counter() - t0
        prov = srv._engine.dispatcher.provenance
        runs[name] = [(resolve(srv._engine, t), prov[(t.group, t.cycle)][t.index])
                      for t in tickets]
        print(f"  (b) {name} run, max_batch 512: {wall * 1e3:.1f} ms")
    counts = dict(inj.counts)
    bad = set(idx)
    for name, outs in runs.items():
        wrong = [i for i in idx if not isinstance(outs[i][0], PoisonedError)]
        check(not wrong, f"(b) {name}: all {len(idx)} poisoned requests resolve to "
                         f"PoisonedError (not: {wrong[:5]})")
    clean = [i for i in range(len(reqs)) if i not in bad]
    served = sum(not isinstance(runs["chaos"][i][0], ServeError) for i in clean)
    avail = served / len(clean)
    native = degraded = 0
    native_diff, worst = [], 0.0
    rungs: dict = {}
    for i in clean:
        got, prov = runs["chaos"][i]
        rungs[prov.rung] = rungs.get(prov.rung, 0) + 1
        want = runs["fault-free"][i][0]
        if isinstance(got, ServeError) or isinstance(want, ServeError):
            continue
        if prov.rung == "native":
            native += 1
            if not same_bits(got, want):
                native_diff.append(i)
        else:
            degraded += 1
            worst = max(worst, rel_gap(got, want))
    out["chaos"] = dict(counts=counts, availability=avail, native=native,
                        degraded=degraded, rungs=rungs, worst_degraded=worst)
    print(f"  (b) injected {counts}; {len(idx)} poisoned; availability {avail:.4f} of "
          f"{len(clean)} clean; served by rung {rungs}; worst degraded gap {worst:.2e}")
    check(avail >= 0.99, f"(b) {served} of {len(clean)} clean requests served "
                         f"({avail:.4f} >= 0.99)")
    check(not native_diff, f"(b) every native-rung result ({native}) is bitwise equal to "
                           f"the fault-free run's ({len(native_diff)} differ)")
    check(worst <= 2e-4, f"(b) degraded results ({degraded}) within {worst:.2e} of the "
                         "fault-free run (<= 2e-4 of max(1, |ref|))")
    check(counts.get("transient", 0) >= 1 and counts.get("poison", 0) >= 1,
          f"(b) the plan fired at least one transient and one poison: {counts}")
    del runs
    lap("b")

    # (c) ladder drill at full width: the mix's 4096 appends (two groups, one
    # chunk each), each group forced onto rung k by k scripted failures
    appends = [r for r in reqs if r[0] == "append"]
    groups = [[r for r in appends if len(r) == 5], [r for r in appends if len(r) == 3]]
    drill = {}
    native_res = None
    with obs.collecting(reg):
        for k, rung in enumerate(DEFAULT_LADDER):
            d = ResilientDispatcher(device="cuda", max_batch=SERVE_MAX_BATCH,
                                    retry=RetryPolicy(max_attempts=1), sleep=no_sleep)
            eng = ContinuousBatcher(d)
            before = b1.launches
            got, served_by = [], set()
            for group in groups:
                with inject(ScriptedInjector(range(k))):
                    tickets = [eng.submit(*r) for r in group]
                    eng.flush()
                got += [resolve(eng, t) for t in tickets]
                served_by |= {p.rung for p in d.provenance[(tickets[0].group, tickets[0].cycle)]}
            launches = b1.launches - before
            gap = 0.0 if k == 0 else max(rel_gap(a, b) for a, b in zip(got, native_res))
            if k == 0:
                native_res = got
            hops = counter_sum(reg, "serve.degraded_dispatches", to=rung.name)
            drill[rung.name] = dict(launches=launches, gap=gap, hops=hops)
            print(f"  (c) rung {k} {rung.name}: served by {sorted(served_by)}, "
                  f"batched_update launches {launches}, gap to native {gap:.2e}, "
                  f"degraded_dispatches to it {hops:g}")
            check(served_by == {rung.name} and not any(isinstance(x, ServeError) for x in got),
                  f"(c) {len(got)} appends forced onto rung {rung.name!r}: provenance "
                  f"{sorted(served_by)}")
            check(k == 0 or hops >= 1, f"(c) serve.degraded_dispatches{{to={rung.name}}} "
                                       f"= {hops:g} (>= 1)")
            check(gap <= 2e-4, f"(c) rung {rung.name!r} within {gap:.2e} of native (<= 2e-4)")
            check((launches == 0) == (rung.name == "reference"),
                  f"(c) rung {rung.name!r} launched batched_update {launches} times "
                  "(the reference rung none)")
        purged0 = counter_sum(reg, "serve.cycles_purged")
        d = ResilientDispatcher(device="cuda", ladder=(Rung("native"),),
                                retry=RetryPolicy(max_attempts=1), sleep=no_sleep)
        eng = ContinuousBatcher(d)
        with inject(ScriptedInjector(range(64))):
            t = eng.submit(*groups[0][0])
            eng.flush()
        got = resolve(eng, t)
        purged = counter_sum(reg, "serve.cycles_purged") - purged0
        check(isinstance(got, ServeError) and got.classification == "transient"
              and purged == 1, f"(c) purge drill: the ticket resolves to "
                               f"{type(got).__name__}, serve.cycles_purged +{purged:g}")
    out["ladder"] = drill
    lap("c")

    # (d) quarantine through the kernel: a NaN lane past a disabled pre-check,
    # and the condition gate
    def serve_appends(batch, **kw):
        d = ResilientDispatcher(device="cuda", max_batch=SERVE_MAX_BATCH, sleep=no_sleep, **kw)
        eng = ContinuousBatcher(d)
        before = b1.launches
        tickets = [eng.submit(*r) for r in batch]
        eng.flush()
        return [resolve(eng, t) for t in tickets], b1.launches - before

    with obs.collecting(reg):
        clean_res, _ = serve_appends(appends, precheck=False)
        nan_i = next(i for i, r in enumerate(appends) if len(r) == 5 and i >= 100)
        bad_reqs = list(appends)
        R = bad_reqs[nan_i][1].clone()
        R[3, 5] = float("nan")
        bad_reqs[nan_i] = ("append", R, *bad_reqs[nan_i][2:])
        got, launches = serve_appends(bad_reqs, precheck=False)
        diff = [i for i, (a, b) in enumerate(zip(got, clean_res))
                if i != nan_i and not same_bits(a, b)]
        check(isinstance(got[nan_i], PoisonedError) and "post-dispatch" in got[nan_i].reason,
              f"(d) the NaN lane through batched_update resolves to "
              f"{type(got[nan_i]).__name__} ({launches} launches)")
        check(not diff and launches >= 3, f"(d) the other {len(got) - 1} appends are "
                                          f"bitwise equal to the fault-free run "
                                          f"({len(diff)} differ)")
        ill = [i for i, r in enumerate(appends) if len(r) == 5][7:7 + 8 * 300:300]
        cond_reqs = list(appends)
        for i in ill:
            _, R, U, *rest = cond_reqs[i]
            R, U = R.clone(), U.clone()
            R[:, -1] *= 1e-12  # the last unknown barely observed: cond >= 1e10
            U[:, -1] *= 1e-12
            cond_reqs[i] = ("append", R, U, *rest)
        got, _ = serve_appends(cond_reqs, max_cond=1e6)
        caught = [i for i, x in enumerate(got) if isinstance(x, PoisonedError)]
        check(caught == ill, f"(d) the condition gate (max_cond=1e6) quarantines exactly "
                             f"the {len(ill)} ill-conditioned appends: {caught}")
        ungated, _ = serve_appends([cond_reqs[i] for i in ill])
        conds = [float(torch.linalg.cond(x[0].double())) for x in ungated]
        check(min(conds) >= 1e10, f"(d) their factors' cond without the gate: "
                                  f"{min(conds):.2e} .. {max(conds):.2e} (>= 1e10)")
        del clean_res, got

    # the chaos, drill and quarantine snapshot passes the chaos preset
    path = ROOT / "build" / "smoke_metrics" / "chaos.jsonl"
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.exists():
        path.unlink()
    obs.write_jsonl(str(path), reg, {"phase": "7 resilient serving"})
    try:
        export.main(["--validate", str(path), "--preset", "chaos"])
        valid = "ok"
    except SystemExit as e:
        valid = str(e)
    check(valid == "ok", f"(b-d) obs.export --validate --preset chaos accepts {path}: {valid}")
    lap("d")

    # (e) the state vault: a (256, 256) RecursiveLS state on the card
    n = 256
    rng = np.random.default_rng(31)
    f64 = dict(dtype=torch.float64, device="cuda")
    rls = solvers.RecursiveLS(n=n)
    state = rls.init(torch.float64, device="cuda")
    root = ROOT / "build" / "smoke_vault"
    shutil.rmtree(root, ignore_errors=True)
    vault = StateVault(root=str(root), interval=4, keep=3)
    saved = {}
    t0 = time.perf_counter()
    for step in range(1, 13):
        U = torch.as_tensor(rng.standard_normal((4, n)), **f64)
        state = rls.observe(state, U, torch.as_tensor(rng.standard_normal((4, 1)), **f64))
        if vault.snapshot("rls", state):
            saved[step] = state
    kept = sorted(int(p.name.split("_")[1]) for p in (root / "rls").glob("step_*"))
    newest = root / "rls" / f"step_{max(kept):08d}" / "leaves.npz"
    with np.load(newest) as f:
        leaves = dict(f)
    leaves[".R"][n // 2, n // 2 + 1] = np.nan
    np.savez(newest, **leaves)
    with obs.collecting(reg):
        got, step = vault.restore_latest("rls", like=state)
    rejected = counter_sum(reg, "serve.state_restores", name="rls", outcome="rejected")
    check(rejected == 1, f"(e) serve.state_restores{{outcome=rejected}} = {rejected:g}")
    check(kept == [4, 8, 12] and step == 8 and got.R.device.type == "cuda"
          and all(same_bits(a, b) for a, b in zip(got, saved[8])),
          f"(e) vault: snapshots {kept}; with a NaN in the newest R, restore_latest returns "
          f"step {step} on {got.R.device}, bit-equal to what was saved")
    for s in kept:
        p = root / "rls" / f"step_{s:08d}" / "leaves.npz"
        with np.load(p) as f:
            leaves = dict(f)
        leaves[".d"][0, 0] = np.inf
        np.savez(p, **leaves)
    try:
        vault.restore_latest("rls", like=state)
        raised = "nothing"
    except IntegrityError:
        raised = "IntegrityError"
    check(raised == "IntegrityError", f"(e) with every snapshot corrupted, restore_latest "
                                      f"raises {raised}")
    print(f"  (e) 12 updates of a ({n}, {n}) f64 state, 3 snapshots, two restores: "
          f"{time.perf_counter() - t0:.1f} s")
    lap("e")

    # (f) the CLI, started in phase 6
    rc, text, _, wall = wait_cli(cli, 600)
    lines = text.strip().splitlines()
    check(rc == 0 and len(lines) == 2 and len(lines[-1].split(",")) == 3,
          f"(f) serve_qr --resilient --check --requests 512 exits {rc} with {len(lines)} "
          f"CSV lines in {wall:.1f} s (started in phase 6): {lines[-1:]}")
    lap("f")
    launches = {k: fn.launches for k, fn in kernels.items()}
    out["launches"] = launches
    out["shapes"] = {k: set(fn.shapes) for k, fn in kernels.items()}
    out["wall_s"]["phase"] = time.perf_counter() - t_phase
    print(f"  launches in phase 7: {launches} ({out['wall_s']['phase']:.1f} s wall)")
    check(launches["batched_update"] > 0, "phase 7 launched batched_update")
    return out


def close_to(a, b, tol: float = 1e-6) -> bool:
    """Two ticket results within rtol = atol = ``tol`` leaf by leaf (integer
    leaves, the pivoted solve's rank, equal)."""
    import torch

    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if not x.is_floating_point():
            if not torch.equal(x, y):
                return False
        elif not bool(((x.double() - y.double()).abs() <= tol + tol * y.double().abs()).all()):
            return False
    return True


def sharded_phase(reqs, kernels, card: str, cli: tuple) -> dict:
    """Phase 8 (a)-(e); returns the launches it made and its numbers.  ``cli``:
    (e)'s run, started in phase 6 (``start_cli``)."""
    from collections import Counter

    import numpy as np
    import torch

    from repro_torch.convert import from_numpy
    from repro_torch.launch.serve_qr import QRServer, _submit_all
    from repro_torch.parallel import BatchMesh
    from repro_torch.serve import KINDS, PoisonedError, ServeError
    from repro_torch.solvers import kf_step_batched, qr_append_rows_batched
    from repro_torch.testing.faults import FaultPlan, inject, poison_workload

    b1 = kernels["batched_update"]
    for fn in kernels.values():
        fn.launches = 0
        fn.shapes.clear()
    t_phase = time.perf_counter()
    out = {"wall_s": {}}
    shards = 4
    mesh = BatchMesh((torch.device("cuda", 0),) * shards)
    reqs = from_numpy(reqs, "cuda")
    t_sub = [time.perf_counter()]

    def lap(part: str) -> None:
        now = time.perf_counter()
        out["wall_s"][part] = now - t_sub[0]
        print(f"  ({part}) took {now - t_sub[0]:.1f} s")
        t_sub[0] = now

    def serve(srv, batch):
        before = b1.launches
        tickets = _submit_all(srv, batch)
        srv.flush()
        srv.drain()
        return tickets, [srv.result(t) for t in tickets], b1.launches - before

    def compare(label, batch, plain, sharded):
        """The two servers' results: kernel kinds bitwise, lstsq kinds within
        1e-6; returns the number of kernel-kind results that differ."""
        kinds = Counter(r[0] for r in batch)
        diff = Counter(r[0] for r, a, b in zip(batch, plain, sharded)
                       if r[0] in ("append", "kalman") and not same_bits(a, b))
        far = Counter(r[0] for r, a, b in zip(batch, plain, sharded)
                      if r[0] in ("lstsq", "lstsq_pivoted") and not close_to(b, a))
        n_kernel = kinds["append"] + kinds["kalman"]
        n_solve = kinds["lstsq"] + kinds["lstsq_pivoted"]
        check(not diff, f"({label}) append and kalman: {sum(diff.values())} of {n_kernel} "
                        f"sharded results differ from the plain server's bits {dict(diff)}")
        check(not far, f"({label}) lstsq and lstsq_pivoted: {sum(far.values())} of "
                       f"{n_solve} outside rtol = atol = 1e-6 {dict(far)}")
        return sum(diff.values())

    # (a) the full mix, sharded beside the plain server
    servers = {"plain": QRServer(device="cuda", max_batch=SERVE_MAX_BATCH),
               "sharded": QRServer(device="cuda", max_batch=SERVE_MAX_BATCH, mesh=mesh)}
    cache = servers["sharded"]._engine.dispatcher.executables
    res = {name: serve(srv, reqs) for name, srv in servers.items()}
    misses = cache.misses
    keys = sorted(k[0] for k in cache.keys())
    serve(servers["sharded"], reqs)
    check(misses == 2 and keys == ["lstsq", "lstsq_pivoted"] and cache.misses == 2
          and cache.hits == 2, f"(a) ExecutableCache: {misses} misses on the first flush "
                               f"({keys}), {cache.misses} misses and {cache.hits} hits "
                               "after the second (one miss per sharded lstsq kind)")
    out["full_differ"] = compare("a", reqs, res["plain"][1], res["sharded"][1])
    launches = {k: v[2] for k, v in res.items()}
    out["full_launches"] = launches
    check(launches["sharded"] == shards * launches["plain"] > 0,
          f"(a) batched_update launches: plain {launches['plain']}, sharded "
          f"{launches['sharded']} (= {shards} x plain)")
    rates = {"plain": [], "sharded": []}
    for name in ["plain", "sharded", "sharded", "plain"] * 2 + ["plain", "sharded"]:
        srv = servers[name]
        _submit_all(srv, reqs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        served = srv.flush()
        srv.drain()
        rates[name].append(served / (time.perf_counter() - t0))
    med = {k: float(np.median(v)) for k, v in rates.items()}
    out["serve_req_s"] = dict(rates, median=med)
    print(f"  (a) {len(reqs)}-request flush, 5 alternating pairs (plain, sharded, sharded, "
          f"plain, ...): plain {', '.join(f'{r:.1f}' for r in rates['plain'])}; sharded "
          f"{', '.join(f'{r:.1f}' for r in rates['sharded'])} req/s; medians "
          f"{med['plain']:.1f} / {med['sharded']:.1f}, ratio "
          f"{med['sharded'] / med['plain']:.3f} (a reading, not checked; {card})")
    srv = servers["sharded"]
    _submit_all(srv, reqs)
    profile_top(lambda: (srv.flush(), srv.drain()), "one sharded flush", host_ops=False)
    out["kind_ms"] = {}
    for kind in KINDS:  # where the flush time goes: each kind alone, both servers
        sub = [r for r in reqs if r[0] == kind]
        for name, srv in servers.items():
            _submit_all(srv, sub)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            srv.flush(kind)
            srv.drain()
            out["kind_ms"][f"{kind} {name}"] = (time.perf_counter() - t0) * 1e3
    print("  (a) each kind flushed alone, plain / sharded ms: " + "; ".join(
        f"{k} {out['kind_ms'][k + ' plain']:.2f} / {out['kind_ms'][k + ' sharded']:.2f}"
        for k in KINDS))
    del res
    lap("a")

    # (b) an odd count: every group pads to another width on the mesh than alone
    odd = reqs[:8075]
    res = {name: serve(srv, odd) for name, srv in servers.items()}
    plain_d = servers["plain"]._engine.dispatcher
    shard_d = servers["sharded"]._engine.dispatcher
    widths = []
    for group, nb in sorted(Counter(t.group for t in res["plain"][0]).items(), key=str):
        kind, dt = group[0], group[2]
        w1, w4 = plain_d.padded_chunk(nb, kind, dt), shard_d.padded_chunk(nb, kind, dt)
        widths.append((kind, nb, w1, w4))
    print("  (b) groups (kind, requests, padded alone, padded on the mesh): "
          + "; ".join(f"{k} {nb}: {w1} / {w4}" for k, nb, w1, w4 in widths))
    check(all(w1 != w4 for _, _, w1, w4 in widths),
          f"(b) every one of the {len(widths)} groups pads to another width on the mesh")
    out["odd_differ"] = compare("b", odd, res["plain"][1], res["sharded"][1])
    launches = {k: v[2] for k, v in res.items()}
    check(launches["sharded"] == shards * launches["plain"] > 0,
          f"(b) batched_update launches: plain {launches['plain']}, sharded "
          f"{launches['sharded']}")
    out["widths"] = widths
    del res
    lap("b")

    # (c) the batched functions alone, at the mix's append shape
    g = torch.Generator(device="cuda").manual_seed(8)
    one = BatchMesh((torch.device("cuda", 0),))
    n, p = 32, 8
    for B in (1, 7, 67, 8191):
        R = torch.triu(torch.randn((B, n, n), generator=g, device="cuda"))
        U = torch.randn((B, p, n), generator=g, device="cuda")
        d = torch.randn((B, n, 1), generator=g, device="cuda")
        Y = torch.randn((B, p, 1), generator=g, device="cuda")
        alone = qr_append_rows_batched(R, U, d, Y)
        on4 = qr_append_rows_batched(R, U, d, Y, mesh=mesh)
        on1 = qr_append_rows_batched(R, U, d, Y, mesh=one)
        check(same_bits(on4, alone) and same_bits(on1, alone),
              f"(c) qr_append_rows_batched B={B}: 4 shards and 1 shard bitwise equal "
              "to mesh=None")
    small = [r for r in reqs if r[0] == "kalman" and r[3] is reqs[1][3]][:11]
    R, d, F, Qi, H, z = (torch.stack([r[i] for r in small]) if i in (1, 2, 6)
                         else small[0][i] for i in range(1, 7))
    check(same_bits(kf_step_batched(R, d, F, Qi, H, z, mesh=mesh),
                    kf_step_batched(R, d, F, Qi, H, z)),
          "(c) kf_step_batched B=11, shared models: 4 shards bitwise equal to mesh=None")
    lap("c")

    # (d) resilient serving on the mesh
    resil = QRServer(device="cuda", max_batch=SERVE_MAX_BATCH, mesh=mesh, resilient=True)
    _, got, _ = serve(resil, reqs)
    _, want, _ = serve(servers["sharded"], reqs)
    diff = sum(not same_bits(a, b) for a, b in zip(got, want))
    check(diff == 0, f"(d) resilient sharded flush of {len(reqs)} requests: {diff} differ "
                     "from the plain sharded flush's bits")
    del got, want, servers
    poisoned, idx = poison_workload(reqs, rate=0.01, seed=11)
    runs = {}
    for name in ("fault-free", "chaos"):
        srv = QRServer(device="cuda", max_batch=512, mesh=mesh, resilient=True)
        tickets = _submit_all(srv, poisoned)
        t0 = time.perf_counter()
        if name == "chaos":
            with inject(FaultPlan(seed=7, transient_rate=0.2, poison_rate=0.05)) as inj:
                srv.flush()
                srv.drain()
        else:
            srv.flush()
            srv.drain()
        prov = srv._engine.dispatcher.provenance
        runs[name] = [(resolve(srv._engine, t), prov[(t.group, t.cycle)][t.index])
                      for t in tickets]
        print(f"  (d) {name} run on the mesh, max_batch 512: "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    for name, outs in runs.items():
        wrong = [i for i in idx if not isinstance(outs[i][0], PoisonedError)]
        check(not wrong, f"(d) {name}: all {len(idx)} poisoned requests resolve to "
                         f"PoisonedError (not: {wrong[:5]})")
    bad = set(idx)
    clean = [i for i in range(len(reqs)) if i not in bad]
    native_diff, native, worst = [], 0, 0.0
    served = 0
    for i in clean:
        got, prov = runs["chaos"][i]
        want = runs["fault-free"][i][0]
        if isinstance(got, ServeError) or isinstance(want, ServeError):
            continue
        served += 1
        if prov.rung == "native":
            native += 1
            if not same_bits(got, want):
                native_diff.append(i)
        else:
            worst = max(worst, rel_gap(got, want))
    out["chaos"] = dict(counts=dict(inj.counts), served=served, clean=len(clean),
                        native=native, worst_degraded=worst)
    print(f"  (d) injected {dict(inj.counts)}; {served} of {len(clean)} clean served, "
          f"{native} native; worst degraded gap {worst:.2e}")
    check(served >= 0.99 * len(clean), f"(d) {served} of {len(clean)} clean requests served")
    check(not native_diff, f"(d) every native-rung survivor ({native}) keeps the fault-free "
                           f"run's bits ({len(native_diff)} differ)")
    check(worst <= 2e-4, f"(d) degraded survivors within {worst:.2e} of the fault-free run")
    del runs
    lap("d")

    # (e) the CLI, started in phase 6
    cards = torch.cuda.device_count()
    rc, text, err, _ = wait_cli(cli, 600)
    lines = text.strip().splitlines()
    print(f"  (e) {cards} visible card(s); serve_qr --device cuda --mesh 4 --check exits "
          f"{rc}: {(lines[-1:] or [err.strip()[-160:]])[0]}")
    if cards < 4:
        check(rc != 0 and "4-device batch mesh" in err,
              "(e) with fewer than 4 cards, --mesh 4 exits non-zero naming the "
              "4-device batch mesh")
    else:
        check(rc == 0 and len(lines) == 2 and "mesh=4" in lines[-1],
              "(e) --mesh 4 serves with two CSV lines and mesh=4")
    lap("e")

    launches = {k: fn.launches for k, fn in kernels.items()}
    out["launches"] = launches
    out["shapes"] = {k: set(fn.shapes) for k, fn in kernels.items()}
    out["wall_s"]["phase"] = time.perf_counter() - t_phase
    print(f"  launches in phase 8: {launches} ({out['wall_s']['phase']:.1f} s wall)")
    check(launches["batched_update"] > 0, "phase 8 launched batched_update")
    # B1 per shard: the kernel alone at each shape the phase launched it at
    out["b1_ms"] = {}
    for shape, n_piv, dtype, _ in sorted(out["shapes"]["batched_update"], key=str):
        x = torch.randn(shape, generator=g, device="cuda", dtype=dtype)
        x[:, :n_piv, :n_piv] = torch.triu(x[:, :n_piv, :n_piv])
        out["b1_ms"][str(shape)] = cuda_ms(lambda: b1(x, n_piv), reps=20, warmup=2)
    b1.launches = launches["batched_update"]  # the timing launches do not count
    print("  batched_update per shard (kernel alone, 20 launches after 2): " + ", ".join(
        f"{s} {ms:.4f} ms" for s, ms in out["b1_ms"].items()) + f" ({card})")
    return out


# ------------------------------------------------------------ phase 9
def _kernel_fns() -> dict:
    """The four kernel wrappers by name (each counts its launches)."""
    from repro_torch.kernels import ggr_apply, ggr_panel, ggr_update

    return {"batched_update": ggr_update.batched_update,
            "batched_geqrt": ggr_panel.batched_geqrt,
            "panel_factor": ggr_panel.panel_factor,
            "apply_factors": ggr_apply.apply_factors}


def _zero_counts(kernels) -> None:
    for fn in kernels.values():
        fn.launches = 0
        fn.shapes.clear()


def _counts(kernels) -> tuple:
    return ({k: fn.launches for k, fn in kernels.items()},
            {k: set(fn.shapes) for k, fn in kernels.items()})


def qr_ranks(tsqr_too: bool) -> dict:
    """Phase 9 (a), and (b) when ``tsqr_too``, on one rank on cuda:0:
    ``distributed_ggr_qr_1d`` of the seeded (DQR_M, DQR_N) f32 matrix in both
    layouts, then ``tsqr`` and ``distributed_orthogonalize`` of the seeded
    (TSQR_M, TSQR_N) f64 matrix, TSQR_M / P rows a rank.  Each call runs once
    untimed, then once timed between barriers with the launch counts zeroed
    just before it; returns this rank's results on the host (for
    orthogonalize its block's Gram QᵀQ), walls, launches and shapes."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import (cyclic_perm, distributed_ggr_qr_1d,
                                  distributed_orthogonalize, tsqr)

    torch.cuda.set_device(0)
    kernels = _kernel_fns()
    P, r = dist.get_world_size(), dist.get_rank()
    g = torch.Generator(device="cuda").manual_seed(91)
    A = torch.randn((DQR_M, DQR_N), generator=g, device="cuda")
    nl = DQR_N // P
    perm, _ = cyclic_perm(DQR_N, P, DQR_PANEL)
    stored = torch.as_tensor(perm[r * nl:(r + 1) * nl], device="cuda")
    shards = {"logical": A[:, r * nl:(r + 1) * nl].contiguous(), "cyclic": A[:, stored]}
    del A
    calls = {f"qr {layout}": (lambda X=X, layout=layout: distributed_ggr_qr_1d(
        X, panel=DQR_PANEL, layout=layout)) for layout, X in shards.items()}
    if tsqr_too:
        B = torch.randn((TSQR_M, TSQR_N), generator=g, device="cuda",
                        dtype=torch.float64)
        ml = TSQR_M // P
        Bl = B[r * ml:(r + 1) * ml].contiguous()
        del B
        calls["tsqr"] = lambda: tsqr(Bl)
        calls["orthogonalize"] = lambda: distributed_orthogonalize(Bl)
    for call in calls.values():
        call()
    out = {"wall_s": {}, "launches": {}, "shapes": {}}
    for name, call in calls.items():
        torch.cuda.synchronize()
        dist.barrier()
        _zero_counts(kernels)
        t0 = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        out["wall_s"][name] = time.perf_counter() - t0
        out["launches"][name], out["shapes"][name] = _counts(kernels)
        out[name] = (res.mT @ res if name == "orthogonalize" else res).cpu()
    return out


def restore_ranks(ckpt_dir: str) -> dict:
    """Phase 9 (d) on one rank: ``restore(shardings=)`` of the saved tree
    onto cuda:0; returns each leaf's device and this rank's block on the
    host."""
    import torch
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.checkpoint import restore

    torch.cuda.set_device(0)
    like = {k: torch.empty(shape, dtype=getattr(torch, dt), device="cuda")
            for k, (shape, dt, _) in CKPT_SPEC.items()}
    shardings = {k: Replicate() if d == "replicate" else None if d is None else Shard(d)
                 for k, (_, _, d) in CKPT_SPEC.items()}
    tree, _ = restore(ckpt_dir, 1, like, shardings=shardings)
    return {k: (str(v.device), v.cpu()) for k, v in tree.items()}


def _work(kernel: str, shape, param, *_) -> int:
    """Elements a B3 / B4 launch sweeps: its active rows times its width."""
    B, m, w = shape
    return B * (m - (param if kernel == "panel_factor" else param[1])) * w


def plain_hold(held: dict, worst: dict):
    """A ``plain_driver`` hold (``orthant_check``): each B3 / B4 step of the
    plain driver also runs on the kernel, on the same inputs, and the
    (shape, param, dtype, accum) of a launch whose every output is finite,
    of the plain version's dtype and within ``rel_bound`` of it (the rule of
    ``KernelCase.compare``) goes into ``held[kernel]`` and its worst
    absolute error into ``worst[kernel]``; phase 10 holds any other the
    usual way."""
    from repro_torch.testing import kernel_check as kc

    def hold(name, key, kernel_out, plain_out):
        B, m, w = key[0]
        pairs = list(zip(_as_outputs(kernel_out), _as_outputs(plain_out)))
        if all(o.dtype == r.dtype and bool(o.isfinite().all())
               and kc.rel_err(o, r) <= kc.rel_bound(name, m, w, key[2]) for o, r in pairs):
            held[name].add(key)
            worst[name] = max(worst[name], max(
                float((o.double() - r.double()).abs().max()) for o, r in pairs))

    return hold


def direction_check(mom, hold=None) -> dict:
    """Phase 9 (c) on one momentum leaf: each matrix's Orthant direction Q
    (``orthant._orthogonalize``, the kernels) read for max|QᵀQ - I| and for
    max|Q - Q_lib·D| (Q_lib ``torch.linalg.qr``'s Q, D each column's sign
    matched to the port's diag(R)), each within DIR_FACTOR x the same
    reading of its direction through the kernels' plain versions, plus
    DIR_FLOOR.  The ratios to the same formula with cuSOLVER's R are kept
    as readings.  ``hold``: ``plain_driver``'s (``plain_hold``)."""
    import torch

    from repro_torch.testing.orthant_check import direction_readings

    rd = direction_readings(mom.reshape(-1, *mom.shape[-2:]), hold=hold)
    got, plain, lib = rd["kernels"], rd["plain"], rd["cusolver"]
    ok = torch.ones_like(got[0], dtype=torch.bool)
    for i in (0, 1):
        ok &= got[i] <= DIR_FACTOR * plain[i] + DIR_FLOOR
    return {"orth": float(got[0].max()), "agree": float(got[1].max()),
            "plain": [float(plain[i].max()) for i in (0, 1)],
            "over_plain": [float((got[i] / plain[i]).max()) for i in (0, 1)],
            "over_cusolver": [float((got[i] / lib[i]).max()) for i in (0, 1)],
            "ok": bool(ok.all())}


def distributed_phase(kernels, card: str, gen, timed=None) -> dict:
    """Phase 9 (a)-(d); returns the launches it made and its numbers, and
    under "plain_held" the B3 / B4 launches (c)'s plain driver held on its
    own steps (``plain_hold``).  ``timed()`` is called once B3 / B4 are
    timed, before (c)'s direction checks."""
    import threading

    import torch

    from repro_torch.checkpoint import save
    from repro_torch.core import cyclic_perm
    from repro_torch.optim import orthant
    from repro_torch.testing.orthant_check import OLMO, olmo_leaves, olmo_tree
    from repro_torch.testing.spawn import spawn_ranks

    t_phase = time.perf_counter()
    out = {"wall_s": {}, "launches": {k: 0 for k in kernels}}
    parts = {}  # sub-run -> kernel -> the (shape, param, dtype) it launched

    def tally(part, launches, launched):
        for k in kernels:
            out["launches"][k] += launches[k]
            parts.setdefault(part, {}).setdefault(k, set()).update(launched[k])

    # (a) distributed_ggr_qr_1d over 4 gloo ranks and 1 NCCL rank of cuda:0
    t0 = time.perf_counter()
    gloo = spawn_ranks(qr_ranks, DQR_RANKS, True, backend="gloo", timeout_s=900)
    one = spawn_ranks(qr_ranks, 1, False, backend="nccl", timeout_s=900)
    out["wall_s"]["spawned runs"] = time.perf_counter() - t0
    for res in gloo + one:
        for name in res["launches"]:
            tally("qr" if name.startswith("qr") else "tsqr", res["launches"][name],
                  res["shapes"][name])
    g = torch.Generator(device="cuda").manual_seed(91)
    A = torch.randn((DQR_M, DQR_N), generator=g, device="cuda")
    R_lib = torch.linalg.qr(A, mode="r").R
    _, inv = cyclic_perm(DQR_N, DQR_RANKS, DQR_PANEL)
    out["qr"] = {}
    for layout in ("logical", "cyclic"):
        R4 = torch.cat([res[f"qr {layout}"] for res in gloo], dim=1).cuda()
        if layout == "cyclic":  # back to logical order, then R's triangle
            R4 = torch.triu(R4[:, torch.as_tensor(inv, device="cuda")])
        R1_l = torch.triu(one[0][f"qr {layout}"].cuda())
        rows = {"P=4": R4, "P=1": R1_l}
        gaps = {p: float(torch.linalg.norm(R[:DQR_N].abs() - R_lib.abs())
                         / torch.linalg.norm(R_lib)) for p, R in rows.items()}
        differ = int((R4.view(torch.int32) != R1_l.view(torch.int32)).sum())
        walls = {"P=4": max(res["wall_s"][f"qr {layout}"] for res in gloo),
                 "P=1": one[0]["wall_s"][f"qr {layout}"]}
        out["qr"][layout] = {"rel_gap": gaps, "bits_differ": differ, "wall_s": walls}
        for p, gap in gaps.items():
            check(gap <= 1e-3, f"(a) distributed_ggr_qr_1d ({DQR_M}, {DQR_N}) f32 panel "
                               f"{DQR_PANEL}, {layout}, {p}: |R| within {gap:.3e} of "
                               "torch.linalg.qr's |R| (relative Frobenius, <= 1e-3)")
        gap41 = float(torch.linalg.norm(R4 - R1_l) / torch.linalg.norm(R1_l))
        check(gap41 <= 1e-5, f"(a) {layout}: P=4 gloo within {gap41:.3e} of P=1 NCCL "
                             "(relative Frobenius, <= 1e-5)")
        print(f"  (a) {layout}: wall P=4 (gloo, 4 ranks on one card) "
              f"{walls['P=4'] * 1e3:.1f} ms, P=1 (NCCL) {walls['P=1'] * 1e3:.1f} ms; "
              f"{differ} of {R4.numel()} R elements differ in bits between P=4 and "
              f"P=1 ({card})")
    del A, R_lib

    # (b) tsqr and distributed_orthogonalize of the sketch shape, f64, P = 4
    g = torch.Generator(device="cuda").manual_seed(91)
    torch.randn((DQR_M, DQR_N), generator=g, device="cuda")  # (a)'s draw first
    B = torch.randn((TSQR_M, TSQR_N), generator=g, device="cuda", dtype=torch.float64)
    R_lib = torch.linalg.qr(B, mode="r").R
    del B
    Rt = gloo[0]["tsqr"].cuda()
    same = all(torch.equal(res["tsqr"], gloo[0]["tsqr"]) for res in gloo)
    t_gap = float(torch.linalg.norm(Rt.abs() - R_lib.abs()) / torch.linalg.norm(R_lib))
    gram = sum(res["orthogonalize"] for res in gloo)
    orth = float((gram - torch.eye(TSQR_N, dtype=gram.dtype)).abs().max())
    walls = {k: max(res["wall_s"][k] for res in gloo) for k in ("tsqr", "orthogonalize")}
    out["tsqr"] = {"rel_gap": t_gap, "orth": orth, "wall_s": walls}
    check(same, "(b) tsqr: every rank holds the same R, bit for bit")
    check(t_gap <= 1e-10, f"(b) tsqr ({TSQR_M}, {TSQR_N}) f64 over {DQR_RANKS} ranks: "
                          f"|R| within {t_gap:.3e} of torch.linalg.qr's (<= 1e-10)")
    check(orth <= 1e-6, f"(b) distributed_orthogonalize: max|QᵀQ - I| {orth:.3e} "
                        "(<= 1e-6)")
    print(f"  (b) wall tsqr {walls['tsqr'] * 1e3:.1f} ms, orthogonalize "
          f"{walls['orthogonalize'] * 1e3:.1f} ms (4 gloo ranks on one card; {card})")
    del gloo, one, R_lib, Rt

    # (c) one Orthant step over olmo-1b's tree at full width
    g = torch.Generator(device="cuda").manual_seed(92)
    params = olmo_tree(g, OLMO_DEPTH, scale=True)
    grads = olmo_tree(g, OLMO_DEPTH, scale=False)
    state = orthant.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(kernels)
    t0 = time.perf_counter()
    new_params, state = orthant.update(grads, state, params, lr=0.02)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    tally("orthant", *_counts(kernels))
    peak = torch.cuda.max_memory_allocated()
    out["orthant"] = {"step_s": step_s, "peak_bytes": peak, "depth": OLMO_DEPTH,
                      "leaves": {}}
    print(f"  (c) olmo-1b Orthant step, {OLMO_DEPTH} of {OLMO.n_layers} layers "
          f"({'no cut' if OLMO_DEPTH == OLMO.n_layers else 'depth cut'}): "
          f"{step_s:.2f} s wall, peak {peak / 2**30:.2f} GiB allocated ({card})")
    check(step_s <= 60, f"(c) the step takes {step_s:.2f} s (<= 60 s at this depth)")
    del grads, params

    # B3 and B4 alone at the largest shape each sub-run launched them at
    out["timed"] = {}
    for part, launched in parts.items():
        for k in ("panel_factor", "apply_factors"):
            if launched[k]:
                shape, param, dtype, accum = max(launched[k], key=lambda s: _work(k, *s))
                case = KernelCase(k, shape, param, dtype, gen, accum=accum)
                case.compare()
                out["timed"][f"{part}: {case.label()}"] = case.times()
    out["shapes"] = {k: set().union(*(launched[k] for launched in parts.values()))
                     for k in kernels}
    if timed is not None:
        timed()

    # (d) restore(shardings=) of a saved tree onto 2 ranks, beside (c)'s checks
    g = torch.Generator().manual_seed(93)
    tree = {k: (torch.randn(shape, generator=g).to(getattr(torch, dt)) if dt != "int32"
                else torch.randint(0, 2**31 - 1, shape, generator=g, dtype=torch.int32))
            for k, (shape, dt, _) in CKPT_SPEC.items()}
    ckpt_dir = ROOT / "build" / "smoke_ckpt"
    save(str(ckpt_dir), 1, tree)
    restored = {}

    def restore_run():
        try:
            restored["blocks"] = spawn_ranks(restore_ranks, 2, str(ckpt_dir), backend="gloo",
                                             timeout_s=300)
        except BaseException as e:  # re-raised below, in the phase's thread
            restored["error"] = e

    th = threading.Thread(target=restore_run)
    th.start()
    out["plain_held"] = {k: set() for k in kernels}
    out["plain_worst"] = dict.fromkeys(kernels, 0.0)
    for key, mom in olmo_leaves(state.momentum).items():
        res = direction_check(mom, plain_hold(out["plain_held"], out["plain_worst"]))
        out["orthant"]["leaves"][key] = res
        check(res["ok"], f"(c) {key} {tuple(mom.shape)}: max|QᵀQ - I| {res['orth']:.3e}, "
                         f"max|Q - Q_lib·D| {res['agree']:.3e} (plain versions "
                         f"{res['plain'][0]:.3e} / {res['plain'][1]:.3e}); each matrix's at "
                         f"most {res['over_plain'][0]:.2f}x / {res['over_plain'][1]:.2f}x its "
                         f"plain versions' (<= {DIR_FACTOR:g}x + {DIR_FLOOR:g}); "
                         f"{res['over_cusolver'][0]:.2f}x / {res['over_cusolver'][1]:.2f}x "
                         "the same formula with cuSOLVER's R")
    check(all(bool(p.isfinite().all()) for p in olmo_leaves(new_params).values()),
          "(c) every updated parameter is finite")
    del new_params, state
    torch.cuda.empty_cache()

    th.join()
    if "error" in restored:
        raise restored["error"]
    blocks = restored["blocks"]
    for k, (shape, dt, d) in CKPT_SPEC.items():
        devs = {blk[k][0] for blk in blocks}
        got = [blk[k][1] for blk in blocks]
        same = (all(same_bits(x, tree[k]) for x in got) if d in (None, "replicate")
                else same_bits(torch.cat(got, dim=d), tree[k]))
        check(same and devs == {"cuda:0"},
              f"(d) restore {k} {shape} {dt} ({'Shard(%d)' % d if isinstance(d, int) else d}) "
              f"onto 2 ranks: blocks on {sorted(devs)}, bitwise equal to the saved leaf")

    out["wall_s"]["phase"] = time.perf_counter() - t_phase
    print(f"  launches in phase 9: {out['launches']} "
          f"({out['wall_s']['phase']:.1f} s wall)")
    check(out["launches"]["panel_factor"] > 0 and out["launches"]["apply_factors"] > 0,
          "phase 9 launched panel_factor and apply_factors")
    return out



# ------------------------------------------------------------ phase 11
# the LM serving path: every arch at smoke size, then olmo-1b at full width;
# decode against prefill and card against CPU within LM_REL of the logits'
# rms (float32 compute, TF32 off)
LM_REL = 1e-4
LM_SMOKE_S, LM_FULL_S, LM_FULL_B, LM_CPU_STEPS = 24, 64, 2, 2
# launch.serve at full width, default bfloat16 compute
LM_SERVE_ARCHS = ("olmo-1b", "zamba2-1.2b", "xlstm-125m")
LM_SERVE_ARGS = ("--batch", "8", "--tokens", "32", "--cache-len", "2048")
# each run started this long after the one before it: its start-up (~14 s)
# overlaps the run before it, whose decode takes ~1-2 s at its end
LM_SERVE_STAGGER = 6.0


def lm_phase(kernels, card: str) -> dict:
    """Phase 11: (a) every arch at smoke size on the card — 8 decode steps
    at float32 and 8 at bfloat16 compute (finite logits, the cache of
    ``cache_spec``), and decode against prefill at float32 for each decoder
    family and seamless-m4t; (b) olmo-1b at its published widths — decode
    against prefill (S = 64, B = 2) and the card's first 2 decode steps
    against the port on the CPU with the same weights, a trace of 4 served
    olmo-1b steps (batch 8, cache 2048, bf16), then ``python -m
    repro_torch.launch.serve`` at full width for LM_SERVE_ARCHS.  The path
    reaches none of the four kernels: their counts, zeroed before it, must
    read 0 after it."""
    import re

    import torch

    from repro_torch.configs import get_config, list_archs
    from repro_torch.launch.serve import greedy_decode, load
    from repro_torch.models import encdec, serve, transformer
    from repro_torch.testing.lm_check import decode_vs_prefill, no_drop_f32, rel_err

    def init(cfg, gen):
        f = encdec.init_encdec if cfg.family == "encdec" else transformer.init_lm
        return f(cfg, gen)

    t_phase = time.perf_counter()
    out = {"wall_s": {}, "decode_vs_prefill": {}}
    _zero_counts(kernels)
    gen = torch.Generator(device="cuda").manual_seed(23)
    with torch.inference_mode():
        # (a) every arch at smoke size
        for arch in list_archs():
            base = get_config(arch, smoke=True)
            params = init(base, gen)
            for compute in ("float32", "bfloat16"):
                cfg = base.scaled(compute_dtype=compute)
                cache = serve.init_cache(cfg, 2, 32, device="cuda")
                tok = torch.zeros((2,), dtype=torch.int32, device="cuda")
                finite = True
                for i in range(8):
                    logits, cache = serve.decode_step(params, cache, tok, i, cfg)
                    finite &= bool(torch.isfinite(logits).all())
                    tok = logits.argmax(-1).int()
                spec = serve.cache_spec(cfg, 2, 32)
                shaped = all(tuple(cache[k].shape) == sp.shape and cache[k].dtype == sp.dtype
                             for k, sp in spec.items())
                check(finite and shaped and logits.shape == (2, cfg.vocab),
                      f"(a) {arch} smoke, {compute}: 8 decode steps, finite logits, "
                      "cache of cache_spec", quiet=True)
            if arch in ("olmo-1b", "mixtral-8x22b", "zamba2-1.2b", "xlstm-125m",
                        "phi-3-vision-4.2b", "seamless-m4t-large-v2"):
                cfg = no_drop_f32(base)
                toks = torch.randint(0, cfg.vocab, (2, LM_SMOKE_S), generator=gen,
                                     device="cuda")
                frames = (torch.randn((2, LM_SMOKE_S // cfg.enc_downsample, cfg.d_model),
                                      generator=gen, device="cuda")
                          if cfg.family == "encdec" else None)
                e = decode_vs_prefill(cfg, params, toks, frames)
                out["decode_vs_prefill"][arch] = e
                check(e <= LM_REL, f"(a) {arch} smoke ({cfg.family}) f32: {LM_SMOKE_S} "
                                   f"decode steps vs prefill {e:.3e} of rms (<= {LM_REL})")
        out["wall_s"]["smoke"] = time.perf_counter() - t_phase
        print(f"  (a) 10 archs at smoke size, f32 and bf16 decode: "
              f"{out['wall_s']['smoke']:.1f} s")

        # (b) olmo-1b at full width, float32 compute
        t0 = time.perf_counter()
        cfg = get_config("olmo-1b").scaled(compute_dtype="float32")
        params = transformer.init_lm(cfg, gen)
        toks = torch.randint(0, cfg.vocab, (LM_FULL_B, LM_FULL_S), generator=gen, device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        e = decode_vs_prefill(cfg, params, toks)
        torch.cuda.synchronize()
        out["wall_s"]["full_decode_vs_prefill"] = time.perf_counter() - t1
        out["decode_vs_prefill"]["olmo-1b full"] = e
        check(e <= LM_REL, f"(b) olmo-1b full width ({cfg.param_count()} parameters) f32: "
                           f"{LM_FULL_S} decode steps vs prefill, B = {LM_FULL_B}: "
                           f"{e:.3e} of rms (<= {LM_REL})")
        def to_cpu(t):
            return {k: to_cpu(v) for k, v in t.items()} if isinstance(t, dict) else t.cpu()

        cpu = to_cpu(params)
        caches = {d: serve.init_cache(cfg, LM_FULL_B, LM_FULL_S, device=d)
                  for d in ("cuda", "cpu")}
        worst = 0.0
        for i in range(LM_CPU_STEPS):
            lc, _ = serve.decode_step(params, caches["cuda"], toks[:, i], i, cfg)
            lh, _ = serve.decode_step(cpu, caches["cpu"], toks[:, i].cpu(), i, cfg)
            worst = max(worst, rel_err(lc, lh))
        out["card_vs_cpu"] = worst
        check(worst <= LM_REL, f"(b) olmo-1b full width f32: the card's first "
                               f"{LM_CPU_STEPS} decode steps vs the CPU's, {worst:.3e} "
                               f"of rms (<= {LM_REL})")
        del params, cpu, caches
        # where a served step's time goes: launch.serve's own model and loop
        cfg = get_config("olmo-1b")
        params, cache = load(cfg, 8, 2048, torch.device("cuda"))
        tok = torch.zeros((8,), dtype=torch.int32, device="cuda")
        greedy_decode(params, cache, cfg, tok, 2)
        profile_top(lambda: greedy_decode(params, cache, cfg, tok, 4),
                    "4 olmo-1b decode steps, batch 8, cache 2048, bf16", host_ops=False)
        del params, cache
        torch.cuda.empty_cache()
        out["wall_s"]["full"] = time.perf_counter() - t0
    launches, _ = _counts(kernels)
    out["launches"] = launches
    check(not any(launches.values()),
          f"the LM path launched none of the GGR kernels: {launches}")

    out["serve"] = {}
    runs = run_staggered({f"serve_{arch}": ["repro_torch.launch.serve", "--arch", arch,
                                            *LM_SERVE_ARGS] for arch in LM_SERVE_ARCHS},
                         LM_SERVE_STAGGER, 300)
    for arch in LM_SERVE_ARCHS:
        rc, text, err, wall = runs[f"serve_{arch}"]
        text = text.strip()
        tok_s = re.search(r": ([0-9.]+) tok/s", text)
        peak = re.findall(r"(load|decode) ([0-9.]+) GiB", text)
        out["serve"][arch] = {"rc": rc, "wall_s": wall,
                              "tok_s": float(tok_s.group(1)) if tok_s else None,
                              "peak_gib": {k: float(v) for k, v in peak}}
        for line in text.splitlines():
            print(f"    {line}")
        check(rc == 0 and tok_s is not None,
              f"(b) launch.serve --arch {arch} {' '.join(LM_SERVE_ARGS)} (bf16) exits "
              f"{rc} in {wall:.1f} s, started {LM_SERVE_STAGGER:g} s after the one before "
              f"it ({card})" + ("" if rc == 0 else f": {err.strip()[-400:]}"))
    out["wall_s"]["phase"] = time.perf_counter() - t_phase
    print(f"  phase 11 wall {out['wall_s']['phase']:.1f} s; weights cast to bf16 once "
          "at load, embedding rows gathered before the cast")
    return out


# ------------------------------------------------------------ phase 12
# the LM training path: every arch at smoke size (card against CPU at f32
# compute, TF32 off, within TRAIN_REL of the gradients' rms and
# TRAIN_LOSS_REL of the loss), then olmo-1b at its published widths with the
# reference launcher's defaults (f32 params, bf16 compute, remat "full")
TRAIN_REL, TRAIN_LOSS_REL = 1e-4, 1e-5
TRAIN_SMOKE_S, TRAIN_SMOKE_B = 32, 2
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 256, 8, 4
# the bitwise-resume run: olmo-1b's widths at a cut depth (its checkpoint of
# params and Orthant's two moments is ~2.8 GB at 2 layers, ~14 GB at 16)
RESUME_DEPTH = 2
TRAIN_CLI_OPTIMIZERS = ("orthant", "adamw")


# phase 12 (b)'s check of the Orthant step on the trained momenta.  Phase 9
# (c)'s direction rule was set on random momenta (tools/orthant_readings.py:
# sound directions at most 2.13x their plain versions' readings, faulty ones
# at least 3.24x); trained momenta are far worse conditioned (cond 4e4-1e8
# at olmo-1b's widths: olmo's centred LayerNorm gives every weight gradient
# a near-null vector along d_model) and their sound directions read up to
# 3.23x at cond 4.6e4 and 9.16x at 6.6e7 (PERF.md §6), so that rule cannot
# tell sound from faulty there: its readings are printed.  What is held:
# each column of the direction that float32 determines against orthant's
# formula in float64, its error over u·cond_k within COL_RATIO and its sign
# the same (``orthant_check.momentum_readings``), and R's backward error
# ||RᵀR - MᵀM||_F / ||M||_F² within phase 5's bound for the dense QR.  Each
# matrix's two planted faults, the direction's first column flipped and R
# from the float16-rounded matrix, must fail the column check
GRAM_TOL, COL_RATIO = 1e-5, 20.0


def momentum_check(mom) -> dict:
    """Phase 12 (b) on one momentum leaf, the first and last matrix of a
    stack: ``momentum_readings`` with its faults (the direction readings
    against cuSOLVER, and against the plain versions for a square matrix,
    where its last sign needs the plain driver anyway; each R's backward
    error, the
    column check against float64) and each matrix's condition number (f32
    singular values of the scaled tall matrix).  ``ok``: every R through
    the kernels within GRAM_TOL, every held column within COL_RATIO and of
    the float64 column's sign; ``faults_seen``: every flipped direction
    with a sign off and every float16 one over COL_RATIO."""
    import torch

    from repro_torch.testing.orthant_check import momentum_readings

    M = mom.reshape(-1, *mom.shape[-2:])
    M = M[[0, -1]] if M.shape[0] > 2 else M
    rd = momentum_readings(M, faults=True, plain=False)  # plain readings: square ones only
    got, plain = rd["directions"]["kernels"], rd["directions"].get("plain")
    gram, cols = rd["gram"], rd["columns"]
    tall = M if M.shape[-2] >= M.shape[-1] else M.mT
    s = torch.linalg.svdvals(tall)

    def floats(x):
        return [float(v) for v in x]

    return {"matrices": M.shape[0], "cond": floats(s[:, 0] / s[:, -1]),
            "gram": {k: floats(v) for k, v in gram.items()},
            "held": cols["determined"].tolist(), "ratio": floats(cols["ratio"]),
            "signs_off": cols["signs_off"].tolist(),
            "flipped": [floats(cols["flipped"][0]), cols["flipped"][1].tolist()],
            "half": [floats(cols["half"][0]), cols["half"][1].tolist()],
            "orth": floats(got[0]), "agree": floats(got[1]),
            "over_plain": [floats(got[i] / plain[i]) for i in (0, 1)] if plain else None,
            "ok": bool((gram["kernels"] <= GRAM_TOL).all())
            and bool((cols["ratio"] <= COL_RATIO).all())
            and not bool(cols["signs_off"].any()),
            "faults_seen": bool((cols["flipped"][1] > 0).all())
            and bool((cols["half"][0] > COL_RATIO).all())}


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [_tree_to(v, device) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree.to(device)


def _flat(tree) -> dict:
    from repro_torch.checkpoint.ckpt import _walk

    return {"/".join(p): x for p, x in _walk(tree)}


def step_matrices(tree) -> dict:
    """{path: the first and last matrix of each stacked leaf of ``tree`` (a
    2-D leaf whole)} as float32 on the host: the matrices phase 13 (b) holds
    a step by (as ``momentum_check`` reads the first and last layer)."""
    from repro_torch.checkpoint.ckpt import _walk

    return {"/".join(p): (x[[0, -1]] if x.ndim > 2 else x).detach().float().cpu()
            for p, x in _walk(tree)}


def train_cli_start() -> dict:
    """Phase 12 (d)'s CLI runs, ``python -m repro_torch.launch.train --arch
    olmo-1b --steps 4 --optimizer X`` for each of TRAIN_CLI_OPTIMIZERS one
    after the other in a thread, started ahead of the phase (after phase
    9's B3 / B4 timings) to run beside phase 9 (c) to 10.  Returns the
    handle ``train_phase`` reads: under "runs" each optimizer's (exit
    code, stdout, stderr, seconds); join "thread" first."""
    import threading

    env = dict(os.environ, PYTHONPATH=str(SRC))
    h = {"runs": {}, "t0": time.perf_counter()}

    def cli_runs():
        for opt in TRAIN_CLI_OPTIMIZERS:
            t0 = time.perf_counter()
            try:
                cli = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                                      "--arch", "olmo-1b", "--steps", "4", "--optimizer", opt],
                                     capture_output=True, text=True, env=env, timeout=600)
                h["runs"][opt] = (cli.returncode, cli.stdout, cli.stderr,
                                  time.perf_counter() - t0)
            except subprocess.TimeoutExpired as e:
                h["runs"][opt] = (None, "", repr(e), time.perf_counter() - t0)

    h["thread"] = threading.Thread(target=cli_runs)
    h["thread"].start()
    return h


def train_phase(kernels, card: str, gen, recorded: dict, step1: dict, cli: dict) -> dict:
    """Phase 12: (a) every arch at smoke size — one ``value_and_grad`` on the
    card against the port on the CPU with the same weights and batch (f32
    compute; MoE at ``no_drop_f32``'s capacity), then one AdamW
    ``train_step`` on the card (params moved, finite); (b) olmo-1b at its
    published widths through ``Trainer`` (seq 256, batch 8): 4 Orthant steps
    and 4 AdamW steps, each step's wall split into forward+backward and
    optimizer (CUDA events), tok/s, peak memory, a trace of one more step
    of each, the Orthant step's momenta through ``momentum_check``, B3/B4
    launched by Orthant and never by AdamW; (c) resume: an Orthant run
    saved at step 2 and resumed for step 3 equals the uninterrupted run bit
    for bit (loss, params, optimizer state); (d) ``python -m
    repro_torch.launch.train --arch olmo-1b --steps 4 --optimizer X`` for
    both optimizers, run beside phases 9 (c) to 10 (``cli``:
    ``train_cli_start``'s handle, joined);
    (e) every (shape, dtype) it launched B3/B4 at and phase 10 did not hold
    is held against the plain version, and B3/B4 are timed at the largest
    shape each launched at (after (b)).  ``step1`` receives the Orthant
    run's first step (``step_matrices`` of the parameters before and after
    it and of the momentum after it, and its loss) for phase 13 (b)."""
    import gc
    import math
    import re
    import shutil

    import torch

    from repro_torch.configs import get_config, list_archs
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import encdec, transformer
    from repro_torch.testing.lm_check import no_drop_f32, rel_err
    from repro_torch.testing.orthant_check import olmo_leaves
    from repro_torch.train import Trainer, make_train_step
    from repro_torch.train.step import make_loss_fn, value_and_grad

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    out = {"wall_s": {}, "smoke": {}, "full": {},
           "launches": {k: 0 for k in kernels}, "shapes": {k: set() for k in kernels}}

    def tally():
        launches, shapes = _counts(kernels)
        for k in kernels:
            out["launches"][k] += launches[k]
            out["shapes"][k] |= shapes[k]
        return launches

    # (a) every arch at smoke size, card against CPU, f32 compute
    _zero_counts(kernels)
    g = torch.Generator().manual_seed(120)
    for arch in list_archs():
        cfg = no_drop_f32(get_config(arch, smoke=True))
        init = encdec.init_encdec if cfg.family == "encdec" else transformer.init_lm
        params = init(cfg, g)
        batch = SyntheticTokens(cfg.vocab, TRAIN_SMOKE_S, TRAIN_SMOKE_B, seed=12).batch_at(
            0, device="cpu")
        if cfg.family == "vlm":
            batch["patch_embs"] = torch.randn((TRAIN_SMOKE_B, cfg.n_patches, cfg.vision_dim),
                                              generator=g)
        if cfg.family == "encdec":
            batch["frames"] = torch.randn(
                (TRAIN_SMOKE_B, TRAIN_SMOKE_S // cfg.enc_downsample, cfg.d_model), generator=g)
        loss_fn = make_loss_fn(cfg)
        want_loss, want = value_and_grad(loss_fn, params, batch)
        params, batch = _tree_to(params, "cuda"), _tree_to(batch, "cuda")
        loss, grads = value_and_grad(loss_fn, params, batch)
        want, grads = _flat(want), _flat(grads)
        loss_gap = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
        worst = max(rel_err(grads[k], want[k]) for k in want)
        opt_init, step = make_train_step(cfg, optimizer="adamw", lr=1e-3)
        new, _, metrics = step(params, opt_init(params), batch)
        moved = any(not torch.equal(a, b) for a, b in zip(_flat(new).values(),
                                                          _flat(params).values()))
        finite = all(bool(x.isfinite().all()) for x in _flat(new).values())
        out["smoke"][arch] = {"loss_rel": loss_gap, "grad_rel": worst,
                              "loss": float(metrics["loss"])}
        check(loss_gap <= TRAIN_LOSS_REL and worst <= TRAIN_REL and moved and finite
              and sorted(grads) == sorted(want),
              f"(a) {arch} smoke ({cfg.family}) f32: card vs CPU loss {loss_gap:.2e} "
              f"(<= {TRAIN_LOSS_REL}), every leaf's gradient within {worst:.2e} of its rms "
              f"(<= {TRAIN_REL}); an AdamW step moved the params, all finite")
        del params, batch, grads, new
    launches = tally()
    check(not any(launches.values()), f"(a) the smoke AdamW steps launched no GGR kernel: "
                                      f"{launches}")
    out["wall_s"]["smoke"] = time.perf_counter() - t_phase
    print(f"  (a) 10 archs at smoke size: {out['wall_s']['smoke']:.1f} s")

    # (b) olmo-1b at its published widths, both optimizers
    cfg = get_config("olmo-1b")
    check(cfg.remat_policy == "full" and cfg.compute_dtype == "bfloat16"
          and cfg.param_dtype == "float32", "(b) olmo-1b trains with f32 params, bf16 "
          "compute and remat 'full'")
    for opt in ("orthant", "adamw"):
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(kernels)
        tr = Trainer(cfg, optimizer=opt, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                     device="cuda")
        if opt == "orthant":  # phase 13 (b) holds its mesh's first step against this one
            step1["p0"] = step_matrices(tr.params)
            losses = tr.run(1, log_fn=print)
            step1.update(p1=step_matrices(tr.params),
                         momentum=step_matrices(tr.opt_state.momentum), loss=losses[0])
            losses += tr.run(TRAIN_STEPS, log_fn=print)
        else:
            losses = tr.run(TRAIN_STEPS, log_fn=print)
        rec = {"losses": losses, "steps": tr.step_times[:], "parameters": cfg.param_count()}
        tokens = TRAIN_SEQ * TRAIN_BATCH
        for i, t in enumerate(tr.step_times):
            print(f"  (b) olmo-1b {opt} step {i + 1}: loss {losses[i]:.4f}, wall "
                  f"{t['wall_s'] * 1e3:.1f} ms (forward+backward {t['fwd_bwd_ms']:.1f} ms, "
                  f"optimizer {t['opt_ms']:.1f} ms on the device), "
                  f"{tokens / t['wall_s']:.1f} tok/s ({card})")
        steady = tr.step_times[1:]
        rec["steady_wall_s"] = sum(t["wall_s"] for t in steady) / len(steady)
        rec["tok_s"] = tokens / rec["steady_wall_s"]
        traced = []
        profile_top(lambda: traced.extend(tr.run(TRAIN_STEPS + 1, log_fn=print)),
                    f"one olmo-1b {opt} step (seq {TRAIN_SEQ}, batch {TRAIN_BATCH})",
                    rows=10, host_ops=False)
        rec["peak_bytes"] = torch.cuda.max_memory_allocated()
        launches = tally()
        rec["launches"] = launches
        print(f"  (b) olmo-1b {opt}: {rec['steady_wall_s'] * 1e3:.1f} ms/step over steps "
              f"2-{TRAIN_STEPS}, {rec['tok_s']:.1f} tok/s, peak "
              f"{rec['peak_bytes'] / 2**30:.2f} GiB allocated, launches {launches} ({card})")
        check(all(math.isfinite(x) for x in losses + traced),
              f"(b) olmo-1b {opt}: {TRAIN_STEPS + 1} finite losses")
        fused = launches["panel_factor"], launches["apply_factors"]
        if opt == "orthant":
            check(min(fused) > 0, f"(b) olmo-1b orthant launched panel_factor and "
                                  f"apply_factors {fused}")
            rec["directions"] = {}
            t1 = time.perf_counter()
            for key, mom in olmo_leaves(tr.opt_state.momentum).items():
                res = momentum_check(mom)
                rec["directions"][key] = res
                plain = ("" if res["over_plain"] is None else
                         f"plain versions {', '.join(f'{x:.2e}' for x in res['gram']['plain'])}, ")
                over = ("" if res["over_plain"] is None else ", " + ", ".join(
                    f"{a:.2f}x / {b:.2f}x" for a, b in zip(*res["over_plain"]))
                    + " the plain versions'")
                check(res["ok"], f"(b) {key} {tuple(mom.shape)}, {res['matrices']} "
                                 f"matrices: cond {', '.join(f'{x:.2e}' for x in res['cond'])}; "
                                 f"columns held {res['held']} of {min(mom.shape[-2:])}: "
                                 "error over u·cond_k "
                                 f"{', '.join(f'{x:.2f}' for x in res['ratio'])} "
                                 f"(<= {COL_RATIO:g}), signs off {res['signs_off']} (0); "
                                 "R's ||RᵀR - MᵀM|| / ||M||² "
                                 f"{', '.join(f'{x:.2e}' for x in res['gram']['kernels'])} "
                                 f"(<= {GRAM_TOL:g}; {plain}"
                                 f"cuSOLVER {', '.join(f'{x:.2e}' for x in res['gram']['cusolver'])}); "
                                 f"readings max|QᵀQ - I| {', '.join(f'{x:.2e}' for x in res['orth'])}, "
                                 f"max|Q - Q_lib·D| {', '.join(f'{x:.2e}' for x in res['agree'])}"
                                 f"{over}")
                check(res["faults_seen"], f"(b) {key}: both planted faults fail the column "
                                          f"check: first column flipped, signs off "
                                          f"{res['flipped'][1]} (> 0); float16 R, error over "
                                          f"u·cond_k {', '.join(f'{x:.1f}' for x in res['half'][0])} "
                                          f"(> {COL_RATIO:g}; its backward error "
                                          f"{', '.join(f'{x:.2e}' for x in res['gram']['half'])})")
            rec["check_s"] = time.perf_counter() - t1
            _zero_counts(kernels)  # the check's launches are not the path's
        else:
            check(max(fused) == 0, f"(b) olmo-1b adamw launched no panel_factor / "
                                   f"apply_factors {fused}")
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        rec["wall_s"] = time.perf_counter() - t0
        out["full"][opt] = rec
        print(f"  (b) olmo-1b {opt}: {rec['wall_s']:.1f} s wall"
              + (f", {rec['check_s']:.1f} s of it the momentum check" if "check_s" in rec
                 else ""))

    # (e)'s timings: B3/B4 at the largest shape (b) launched each at
    out["timed"] = {}
    for k in ("panel_factor", "apply_factors"):
        if out["shapes"][k]:
            shape, param, dtype, accum = max(out["shapes"][k], key=lambda s: _work(k, *s))
            case = KernelCase(k, shape, param, dtype, gen, accum=accum)
            case.compare()
            out["timed"][case.label()] = case.times()
            del case

    # (c) bitwise resume at olmo-1b's widths, RESUME_DEPTH layers
    t0 = time.perf_counter()
    cfg2 = cfg.scaled(n_layers=RESUME_DEPTH)
    kw = dict(optimizer="orthant", seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, device="cuda")
    ckpt_dir = ROOT / "build" / "smoke_train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    _zero_counts(kernels)
    whole = Trainer(cfg2, **kw)
    want = whole.run(3, log_fn=print)
    first = Trainer(cfg2, ckpt_dir=str(ckpt_dir), ckpt_every=2, **kw)
    first.run(2, log_fn=print)
    del first
    again = Trainer(cfg2, ckpt_dir=str(ckpt_dir), ckpt_every=2, resume=True, **kw)
    resumed_at = again.step_num
    got = again.run(3, log_fn=print)
    tally()
    differ = {}
    for name, a, b in (("params", whole.params, again.params),
                       ("opt", whole.opt_state, again.opt_state)):
        b = _flat(b)
        differ[name] = [k for k, x in _flat(a).items() if not same_bits(x, b[k])]
    out["resume"] = {"resumed_at": resumed_at, "loss": [want[-1], got[-1]],
                     "differ": differ, "wall_s": time.perf_counter() - t0}
    check(resumed_at == 2 and got == want[2:] and not any(differ.values()),
          f"(c) olmo-1b widths, {RESUME_DEPTH} layers, Orthant: saved at step 2, resumed "
          f"at {resumed_at}, step 3's loss {got} vs {want[2:]} uninterrupted; leaves with "
          f"other bits: {differ} ({out['resume']['wall_s']:.1f} s)")
    del whole, again
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the shapes phase 10 did not hold (B3/B4 were timed after (b))
    t0 = time.perf_counter()
    new = {k: out["shapes"][k] - recorded[k] for k in kernels}
    n_all = sum(len(s) for s in out["shapes"].values())
    n_new = sum(len(s) for s in new.values())
    out["recheck_worst"] = recheck_shapes(new, gen)
    print(f"  (e) {n_all} (shape, dtype) launches in phase 12: {n_all - n_new} held in "
          f"phase 10, {n_new} held now ({time.perf_counter() - t0:.1f} s); worst errors "
          f"{out['recheck_worst']}")

    # (d) the CLI runs, made beside phases 9 (c) to 10 (``train_cli_start``)
    out["cli"] = {}
    for opt in TRAIN_CLI_OPTIMIZERS:
        rc, text, err, wall = cli["runs"][opt]
        text = text.strip()
        s_step = re.search(r": ([0-9.]+) s/step, ([0-9.]+) tok/s", text)
        peak = re.search(r"peak memory allocated ([0-9.]+) GiB", text)
        out["cli"][opt] = {"rc": rc, "wall_s": wall,
                           "s_step": float(s_step.group(1)) if s_step else None,
                           "tok_s": float(s_step.group(2)) if s_step else None,
                           "peak_gib": float(peak.group(1)) if peak else None}
        for line in text.splitlines()[-3:]:
            print(f"    {line}")
        check(rc == 0 and s_step is not None and "done: 4 steps" in text,
              f"(d) launch.train --arch olmo-1b --steps 4 --optimizer {opt} exits {rc} in "
              f"{wall:.1f} s, beside phases 9 (c) to 10 ({card})"
              + ("" if rc == 0 else f": {err.strip()[-400:]}"))
    out["wall_s"]["phase"] = time.perf_counter() - t_phase
    print(f"  phase 12 wall {out['wall_s']['phase']:.1f} s; launches {out['launches']}")
    return out


# ------------------------------------------------------------ phase 13
# LM training on a mesh (``Trainer(mesh=...)``, ``DTensor`` over
# ``torch.distributed``): spawned ranks on cuda:0 — one NCCL rank, or gloo
# ranks sharing the card (NCCL refuses two ranks on one device)
MESH_SEQ, MESH_BATCH, MESH_LR = 32, 16, 1e-3  # the smoke runs: 512 uniform tokens a step
# a family each of those the Trainer trains, on the smoke meshes of (c)
MESH_FAMILIES = ("olmo-1b", "mixtral-8x22b", "phi-3-vision-4.2b", "zamba2-1.2b",
                 "xlstm-125m")
MESH_SMOKE = ((2, 2), (4, 1))
MESH_GAP = 1e-4  # testing.step_check's one-step rule, at float32 compute
# one step, held against the one-device steps and timed (a depth cut of the
# two steps that ran before, to keep the run inside its time: PERF.md §6)
MESH_FULL_STEPS = 1
FULL_LR = 3e-4  # the Trainer's default, phase 12 (b)'s
# (b) at bfloat16: the mesh's step (tensor-parallel partial sums rounded to
# bfloat16 where one device rounds a whole product once) is held by its
# distance to the one-device float32 step: within BF16_RATIO x the distance
# of the one-device bfloat16 step to it (on the CPU at smoke size the ratio
# reads 1.01-1.04x: ``python tests/test_torch_mesh_train.py bf16``), and
# never held tighter than MESH_GAP
BF16_RATIO = 1.5
MESH_CKPT = ROOT / "build" / "smoke_mesh_ckpt"
# the niceness of the smoke meshes' processes (``mesh_smoke_start``): they
# take the cores phases 9 (c) to 10 leave idle
MESH_NICE = 10


def _mesh_cfg(arch: str):
    from repro_torch.configs import get_config
    from repro_torch.testing.lm_check import no_drop_f32

    return no_drop_f32(get_config(arch, smoke=True))


def mesh_one_rank() -> dict:
    """Phase 13 (a) on one NCCL rank of cuda:0: olmo-1b (smoke) trained 3
    Orthant steps on a 1x1 mesh and by the one-device Trainer; the leaves
    whose bits differ, the losses and the mesh run's launches."""
    import torch

    from repro_torch.checkpoint.ckpt import _walk
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.train import Trainer

    os.nice(MESH_NICE)  # started beside phases 9-10: their work first
    torch.cuda.set_device(0)
    kernels = _kernel_fns()
    cfg = get_config("olmo-1b", smoke=True)
    kw = dict(optimizer="orthant", seq_len=MESH_SEQ, global_batch=MESH_BATCH)
    _zero_counts(kernels)
    mesh_tr = Trainer(cfg, mesh=make_debug_mesh(1, 1), **kw)
    got = mesh_tr.run(3, log_fn=print)
    launches, shapes = _counts(kernels)
    one = Trainer(cfg, **kw)
    want = one.run(3, log_fn=print)
    a = {"/".join(p): x.to_local() if hasattr(x, "to_local") else x
         for p, x in _walk({"params": mesh_tr.params, "opt": mesh_tr.opt_state})}
    b = {"/".join(p): x for p, x in _walk({"params": one.params, "opt": one.opt_state})}
    return {"losses": got, "want": want, "leaves": len(b), "launches": launches,
            "shapes": shapes, "differ": [k for k in b if not same_bits(a[k], b[k])]}


def _block_index(x) -> tuple:
    """The slices of a DTensor's global shape that this rank's block holds."""
    from torch.distributed.tensor import Shard

    idx = [slice(None)] * x.ndim
    size = list(x.shape)
    start = [0] * x.ndim
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard):
            n = x.device_mesh.size(i)
            size[p.dim] //= n
            start[p.dim] += x.device_mesh.get_local_rank(i) * size[p.dim]
    for d in range(x.ndim):
        if size[d] != x.shape[d]:
            idx[d] = slice(start[d], start[d] + size[d])
    return tuple(idx)


def _block_matrices(tree) -> dict:
    """{path: (the block's index in ``step_matrices``' arrays, this rank's
    block of them)}: the first and last matrix of a stacked leaf."""
    from repro_torch.checkpoint.ckpt import _walk

    out = {}
    for p, x in _walk(tree):
        local = x.to_local()
        idx = _block_index(x)
        if x.ndim > 2:  # matrices [0, -1] of the stack (never sharded: the rules keep it)
            local, idx = local[[0, -1]], (slice(None), *idx[1:])
        out["/".join(p)] = (idx, local.detach().float().cpu())
    return out


def mesh_full_rank() -> dict:
    """Phase 13 (b) on one of 4 gloo ranks sharing cuda:0: olmo-1b at its
    published widths on a 1x4 mesh, Orthant, MESH_FULL_STEPS steps: each
    step's wall and device split, launches and the card's memory in use
    after it; after step 1 this rank's blocks of the update (p0 - p1) / lr
    and of the momentum (``_block_matrices``); the digests of replicated
    blocks after each step; this rank's peak memory."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.specs import local_nbytes
    from repro_torch.testing.mesh_check import block_digests
    from repro_torch.train import Trainer

    torch.cuda.set_device(0)
    kernels = _kernel_fns()
    rank = dist.get_rank()
    cfg = get_config("olmo-1b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(cfg, mesh=make_debug_mesh(1, 4), optimizer="orthant", seq_len=TRAIN_SEQ,
                 global_batch=TRAIN_BATCH, lr=FULL_LR)
    out = {"init_s": time.perf_counter() - t0, "steps": [], "digests": [],
           # this rank's bytes of its blocks, which phase 15 (c) lays out by shape
           "local_bytes": {"params": local_nbytes(tr.params), "opt": local_nbytes(tr.opt_state)}}
    p0 = _block_matrices(tr.params)
    for step in range(1, MESH_FULL_STEPS + 1):
        torch.cuda.synchronize()
        dist.barrier()
        _zero_counts(kernels)
        loss = tr.run(step, log_fn=print if rank == 0 else (lambda *_: None))[0]
        torch.cuda.synchronize()
        launches, shapes = _counts(kernels)
        free, total = torch.cuda.mem_get_info()
        out["steps"].append({"loss": loss, **tr.step_times[-1], "launches": launches,
                             "shapes": shapes, "card_used": total - free})
        out["digests"].append(block_digests({"params": tr.params, "opt": tr.opt_state},
                                            replicated_only=True))
        if step == 1:
            p1 = _block_matrices(tr.params)
            out["update"] = {k: (idx, (p0[k][1] - p1[k][1]) / FULL_LR)
                             for k, (idx, _) in p1.items()}
            out["momentum"] = _block_matrices(tr.opt_state.momentum)
            del p0, p1
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def mesh_smoke_ranks(ckpt_dir: str) -> dict:
    """Phase 13 (c) and (d) on one of 4 gloo ranks sharing cuda:0: a family
    each at smoke size (float32 compute) on 2x2 and 4x1, one AdamW and one
    Orthant step each on ``UniformBatches``; then an AdamW olmo-1b run on
    2x2 saved at step 2, the uninterrupted run to step 4 (its states after
    steps 3 and 4) and a resume on 2x2 to step 4.  Rank 0 returns the global
    arrays, every rank the digests of its replicated blocks after each step,
    its launches and shapes."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.testing.mesh_check import UniformBatches, block_digests, flat_global
    from repro_torch.train import Trainer

    os.nice(MESH_NICE)  # started beside phases 9-10: their work first
    torch.cuda.set_device(0)
    kernels = _kernel_fns()
    rank = dist.get_rank()
    _zero_counts(kernels)
    meshes = {s: make_debug_mesh(*s) for s in MESH_SMOKE}
    out = {"cases": {}, "digests": {}, "wall_s": {}}

    def train(mesh, arch, opt, steps, keep_at=(), **kw):
        cfg = _mesh_cfg(arch)
        tr = Trainer(cfg, mesh=mesh, optimizer=opt, seq_len=MESH_SEQ,
                     global_batch=MESH_BATCH, lr=MESH_LR, **kw)
        tr.data = UniformBatches(cfg.vocab, MESH_SEQ, MESH_BATCH)
        seen, losses, states = [], [], {}
        while tr.step_num < steps:
            losses += tr.run(tr.step_num + 1, log_fn=lambda *_: None)
            seen.append(block_digests({"params": tr.params, "opt": tr.opt_state}))
            if tr.step_num in keep_at:
                states[tr.step_num] = flat_global({"params": tr.params, "opt": tr.opt_state})
        return tr, losses, seen, states

    for shape in MESH_SMOKE:
        for arch in MESH_FAMILIES:
            for opt in ("adamw", "orthant"):
                t0 = time.perf_counter()
                key = f"{shape[0]}x{shape[1]} {arch} {opt}"
                tr, losses, seen, _ = train(meshes[shape], arch, opt, 1)
                state = flat_global({"params": tr.params, "opt": tr.opt_state})
                if rank == 0:
                    out["cases"][key] = (losses, state)
                out["digests"][key] = seen
                out["wall_s"][key] = time.perf_counter() - t0
    # (d) elastic resume
    t0 = time.perf_counter()
    train(meshes[(2, 2)], "olmo-1b", "adamw", 2, ckpt_dir=ckpt_dir, ckpt_every=2)
    _, wl, wseen, wstates = train(meshes[(2, 2)], "olmo-1b", "adamw", 4, keep_at=(3, 4))
    again, al, aseen, _ = train(meshes[(2, 2)], "olmo-1b", "adamw", 4, ckpt_dir=ckpt_dir,
                                ckpt_every=100, resume=True)
    again_state = flat_global({"params": again.params, "opt": again.opt_state})
    if rank == 0:
        out["cases"]["elastic whole"] = (wl, wstates)
        out["cases"]["elastic again"] = (al, again_state)
    out["digests"]["elastic whole"], out["digests"]["elastic again"] = wseen, aseen
    out["wall_s"]["elastic 2x2"] = time.perf_counter() - t0
    out["launches"], out["shapes"] = _counts(kernels)
    return out


def mesh_resume_rank(ckpt_dir: str) -> dict:
    """Phase 13 (d) on one of 2 gloo ranks sharing cuda:0: the 2x2 step-2
    snapshot resumed on a 1x2 mesh (its leaves as restored) and run on to
    step 4 (its states after steps 3 and 4)."""
    import torch

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.testing.mesh_check import UniformBatches, flat_global
    from repro_torch.train import Trainer

    os.nice(MESH_NICE)  # started beside phases 9-10: their work first
    torch.cuda.set_device(0)
    cfg = _mesh_cfg("olmo-1b")
    tr = Trainer(cfg, mesh=make_debug_mesh(1, 2), optimizer="adamw", seq_len=MESH_SEQ,
                 global_batch=MESH_BATCH, lr=MESH_LR, ckpt_dir=ckpt_dir, ckpt_every=100,
                 resume=True)
    tr.data = UniformBatches(cfg.vocab, MESH_SEQ, MESH_BATCH)
    out = {"step": tr.step_num, "restored": flat_global({"params": tr.params,
                                                         "opt": tr.opt_state}),
           "losses": [], "states": {}}
    for step in (3, 4):
        out["losses"] += tr.run(step, log_fn=lambda *_: None)
        out["states"][step] = flat_global({"params": tr.params, "opt": tr.opt_state})
    return out


def _gap(got, want, mask=None) -> float:
    """rms(got - want) / rms(want) over ``mask`` (float64 on the card)."""
    import torch

    got, want = got.cuda().double(), want.cuda().double()
    if mask is not None:
        got, want = got[mask], want[mask]
    rms = float(want.square().mean().sqrt()) if want.numel() else 0.0
    err = float((got - want).square().mean().sqrt()) if want.numel() else 0.0
    return err / rms if rms > 0 else (0.0 if err == 0 else float("inf"))


def _leading_mask(m):
    """``step_check.leading_columns``' mask of a stack of matrices, on the
    card: the columns of each tall orientation (rows of a wide matrix) up to
    its numerical rank (singular values above 1e-5 of the largest)."""
    import torch

    m = m.cuda().float()
    flat = m.reshape(-1, *m.shape[-2:])
    a, b = flat.shape[-2:]
    s = torch.linalg.svdvals(flat if a >= b else flat.mT)
    ranks = (s > 1e-5 * s[:, :1]).sum(-1)
    idx = torch.arange(min(a, b), device=m.device)
    keep = idx[None, :] < ranks[:, None]  # (matrices, narrow side)
    mask = keep[:, None, :].expand(-1, a, b) if a >= b else keep[:, :, None].expand(-1, a, b)
    return mask.reshape(m.shape), ranks.tolist()


def mesh_smoke_start() -> dict:
    """Phase 13's smoke meshes, started ahead of the phase (after phase 9's
    B3 / B4 timings) to run on the host's cores beside phase 9 (c)-(d) and
    phase 10: (a)'s 1x1 NCCL rank and (c)+(d)'s gloo groups in threads, (f)'s
    CLI runs as subprocesses, every process at nice MESH_NICE.  Returns the
    handle ``mesh_smoke_join`` completes."""
    import shutil
    import threading

    from repro_torch.testing.spawn import spawn_ranks

    shutil.rmtree(MESH_CKPT, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    nice = ["nice", "-n", str(MESH_NICE)] if shutil.which("nice") else []
    res = {}
    h = {"t0": time.perf_counter(), "res": res}

    def popen(*args):
        return subprocess.Popen([*nice, sys.executable, "-m", "repro_torch.launch.train",
                                 "--arch", "olmo-1b", *args], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env)

    h["cli"] = popen("--smoke", "--mesh", "2x2", "--steps", "3")

    def groups():
        try:
            t0 = time.perf_counter()
            res["smoke"] = spawn_ranks(mesh_smoke_ranks, 4, str(MESH_CKPT), timeout_s=600)
            res["resume"] = spawn_ranks(mesh_resume_rank, 2, str(MESH_CKPT), timeout_s=300)
            res["wall"] = time.perf_counter() - t0
        except BaseException as e:  # re-raised in phase 13
            res["error"] = e

    def one():
        try:
            t0 = time.perf_counter()
            res["a"] = spawn_ranks(mesh_one_rank, 1, backend="nccl", timeout_s=300)[0]
            res["a_s"] = time.perf_counter() - t0
        except BaseException as e:  # re-raised in phase 13
            res["error a"] = e

    h["threads"] = [threading.Thread(target=groups), threading.Thread(target=one)]
    for th in h["threads"]:
        th.start()
    h["refused"] = {mesh: (need, popen("--mesh", mesh, "--steps", "3"))
                    for mesh, need in (("16x16", 256), ("prod", 256), ("prod2", 512))}
    return h


def mesh_smoke_join(h: dict) -> None:
    """Wait for ``mesh_smoke_start``'s runs; their results go into ``h``."""
    for th in h["threads"]:
        th.join()
    cli = h["cli"]
    out, err = cli.communicate(timeout=600)
    h["cli"] = (cli.returncode, out, err, time.perf_counter() - h["t0"])
    refused = {}
    for mesh, (need, r) in h["refused"].items():
        _, err = r.communicate(timeout=120)
        refused[mesh] = (need, r.returncode, err)
    h["refused"] = refused
    print(f"  phase 13's smoke meshes, beside phases 9 (c) to 10, done "
          f"{time.perf_counter() - h['t0']:.1f} s after their start")


def mesh_phase(kernels, card: str, gen, held: dict, step1: dict, smoke: dict) -> dict:
    """Phase 13: (a) a 1x1 NCCL mesh against the one-device Trainer, bitwise;
    (b) olmo-1b at its published widths on a 1x4 mesh of 4 gloo ranks of
    cuda:0 (Orthant, bf16 compute), its first step held against phase 12
    (b)'s and a one-device float32 step, the replicas' bits after every
    step, s/step, tok/s, each rank's and the card's memory, B3/B4 a step a
    rank; (c) a family each at smoke size on 2x2 and 4x1 with AdamW and
    Orthant, each step within the one-step rule of the one-device step;
    (d) elastic resume; (e) the kernels at the shapes this phase launched
    them at that earlier phases did not hold; (f) the CLI.  ``held``: the
    shapes earlier phases held; ``step1``: phase 12 (b)'s first Orthant
    step (``step_matrices``), or empty to take it here; ``smoke``:
    ``mesh_smoke_start``'s handle, joined: (a), (c), (d) and (f) ran beside
    phases 9 (c) to 10."""
    import gc
    import shutil

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.testing.mesh_check import (UniformBatches, flat_global, held_per_step,
                                                replicas_differ, split_state)
    from repro_torch.testing.spawn import spawn_ranks
    from repro_torch.testing.step_check import step_gaps
    from repro_torch.train import Trainer

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    out = {"wall_s": {}, "launches": {k: 0 for k in kernels},
           "shapes": {k: set() for k in kernels}}

    def tally(launches, shapes):
        for k in kernels:
            out["launches"][k] += launches[k]
            out["shapes"][k] |= shapes[k]

    res = smoke["res"]
    for e in ("error", "error a"):
        if e in res:
            raise res[e]
    full_cfg = get_config("olmo-1b")
    # (a) a 1x1 NCCL mesh, bitwise the one-device Trainer
    a = res["a"]
    out["wall_s"]["a"] = res["a_s"]
    tally(a["launches"], a["shapes"])
    check(a["losses"] == a["want"] and not a["differ"]
          and min(a["launches"]["panel_factor"], a["launches"]["apply_factors"]) > 0,
          f"(a) olmo-1b smoke, 3 Orthant steps on a 1x1 NCCL mesh: losses {a['losses']} "
          f"vs {a['want']} one-device; leaves with other bits {a['differ']} of "
          f"{a['leaves']}; B3/B4 launched {a['launches']['panel_factor']}/"
          f"{a['launches']['apply_factors']} ({out['wall_s']['a']:.1f} s, beside phases 9-10)")
    # the one-device steps (c) holds its meshes to
    t0 = time.perf_counter()
    one = {}
    for arch in MESH_FAMILIES:
        for opt in ("adamw", "orthant"):
            cfg = _mesh_cfg(arch)
            tr = Trainer(cfg, optimizer=opt, seq_len=MESH_SEQ, global_batch=MESH_BATCH,
                         lr=MESH_LR)
            tr.data = UniformBatches(cfg.vocab, MESH_SEQ, MESH_BATCH)
            p0 = flat_global(tr.params)
            losses = tr.run(1, log_fn=print)
            one[(arch, opt)] = (p0, losses, flat_global({"params": tr.params,
                                                         "opt": tr.opt_state}))
    out["wall_s"]["one-device references"] = time.perf_counter() - t0
    # (b)'s one-device steps
    if not step1:  # phase 12 (b) did not run: take its first Orthant step here
        tr = Trainer(full_cfg, optimizer="orthant", seq_len=TRAIN_SEQ,
                     global_batch=TRAIN_BATCH)
        step1["p0"] = step_matrices(tr.params)
        step1["loss"] = tr.run(1, log_fn=print)[0]
        step1.update(p1=step_matrices(tr.params),
                     momentum=step_matrices(tr.opt_state.momentum))
        del tr
    t0 = time.perf_counter()
    tr = Trainer(full_cfg.scaled(compute_dtype="float32"), optimizer="orthant",
                 seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    f32_loss = tr.run(1, log_fn=print)[0]
    f32 = {"p1": step_matrices(tr.params), "momentum": step_matrices(tr.opt_state.momentum)}
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"]["one-device f32 step"] = time.perf_counter() - t0
    _zero_counts(kernels)  # the references' launches are not the mesh path's

    # (c) a family each on 2x2 and 4x1
    ranks = res["smoke"]
    cases = ranks[0]["cases"]
    for r in ranks:
        tally(r["launches"], r["shapes"])
    b34 = [(r["launches"]["panel_factor"], r["launches"]["apply_factors"]) for r in ranks]
    check(min(min(x) for x in b34) > 0, f"(c) the Orthant steps launched B3/B4 on every "
                                        f"rank: {b34}")
    out["smoke"] = {}
    for shape in MESH_SMOKE:
        for arch in MESH_FAMILIES:
            for opt in ("adamw", "orthant"):
                key = f"{shape[0]}x{shape[1]} {arch} {opt}"
                p0, want_l, want = one[(arch, opt)]
                got_l, got = cases[key]
                r = step_gaps(p0, split_state(got), split_state(want), MESH_LR, opt)
                bad = replicas_differ([rk["digests"][key] for rk in ranks])
                loss_rel = abs(got_l[0] - want_l[0]) / abs(want_l[0])
                out["smoke"][key] = {"update": r["update"], "state": r["state"],
                                     "loss_rel": loss_rel, "replicas_differ": bad,
                                     "wall_s": ranks[0]["wall_s"][key]}
                check(r["update"][1] <= MESH_GAP and r["state"][1] <= MESH_GAP
                      and loss_rel <= 1e-5 and not bad,
                      f"(c) {key}: worst update {r['update'][0]} {r['update'][1]:.2e}, state "
                      f"{r['state'][0]} {r['state'][1]:.2e} of rms (<= {MESH_GAP}), loss "
                      f"{loss_rel:.1e} relative, replicas with other bits {bad} "
                      f"({ranks[0]['wall_s'][key]:.1f} s)")

    # (d) elastic resume: 2x2 -> 2x2 bitwise, -> 1x2 and -> no mesh by the rule
    wl, whole = cases["elastic whole"]
    al, again = cases["elastic again"]
    with np.load(MESH_CKPT / "step_00000002" / "leaves.npz") as f:
        saved = {k: f[k] for k in f.files}
    cfg = _mesh_cfg("olmo-1b")
    nomesh = Trainer(cfg, optimizer="adamw", seq_len=MESH_SEQ, global_batch=MESH_BATCH,
                     lr=MESH_LR, ckpt_dir=str(MESH_CKPT), resume=True)
    nomesh.data = UniformBatches(cfg.vocab, MESH_SEQ, MESH_BATCH)
    restored = {"1x2": (res["resume"][0]["step"], res["resume"][0]["restored"]),
                "no mesh": (nomesh.step_num, flat_global({"params": nomesh.params,
                                                          "opt": nomesh.opt_state}))}
    nm = {"losses": [], "states": {}}
    for step in (3, 4):
        nm["losses"] += nomesh.run(step, log_fn=print)
        nm["states"][step] = flat_global({"params": nomesh.params, "opt": nomesh.opt_state})
    same = [k for k in whole[4] if not np.array_equal(whole[4][k], again[k])]
    check(al == wl[2:] and not same and not replicas_differ(
        [rk["digests"]["elastic whole"] for rk in ranks]),
          f"(d) olmo-1b smoke, AdamW: saved at step 2 on 2x2 and resumed on 2x2, steps 3-4 "
          f"losses {al} vs {wl[2:]}; leaves with other bits at step 4 {same}")
    p2 = split_state(saved)[0]
    out["elastic"] = {}
    for name, (step, got) in restored.items():
        off = [k for k in saved if not np.array_equal(saved[k], got[k])]
        run = res["resume"][0] if name == "1x2" else nm
        held_steps = held_per_step(p2, run["states"], whole, MESH_LR, "adamw")
        worst = max(max(r["update"][1], r["state"][1]) for _, r in held_steps)
        out["elastic"][name] = {"restored_at": step, "differ": off, "worst": worst}
        check(step == 2 and not off and worst <= MESH_GAP
              and np.allclose(run["losses"], wl[2:], rtol=1e-5),
              f"(d) the 2x2 step-2 snapshot on {name}: restored at {step}, leaves with other "
              f"bits than the saved arrays {off}; steps 3-4 within {worst:.2e} of the "
              f"uninterrupted 2x2 run's rms (<= {MESH_GAP}), losses {run['losses']} vs {wl[2:]}")
    del nomesh
    shutil.rmtree(MESH_CKPT, ignore_errors=True)
    out["wall_s"]["c+d"] = res["wall"]

    # (f) the CLI: a 2x2 mesh runs; meshes one host cannot form exit naming their ranks
    rc, text, err, cli_s = smoke["cli"]
    text = text.strip()
    lines = text.splitlines()
    check(rc == 0 and bool(lines) and lines[0].startswith(
        "mesh 2x2 ('data', 'model'): 4 ranks, gloo") and "done: 3 steps" in text,
          f"(f) launch.train --smoke --mesh 2x2 --steps 3 exits {rc} in {cli_s:.1f} s "
          f"(beside (a), (c) and (d)): {lines[:1]} ... {lines[-2:]}"
          + ("" if rc == 0 else f": {err.strip()[-400:]}"))
    for mesh, (need, rc, err) in smoke["refused"].items():
        check(rc != 0 and f"needs {need} ranks" in err,
              f"(f) launch.train --mesh {mesh} exits {rc}: {err.strip()[-160:]}")

    # (b) olmo-1b at its published widths on a 1x4 mesh of 4 gloo ranks
    _zero_counts(kernels)
    t0 = time.perf_counter()
    full = spawn_ranks(mesh_full_rank, 4, timeout_s=900)
    out["wall_s"]["b"] = time.perf_counter() - t0
    for r in full:
        for s in r["steps"]:
            tally(s["launches"], s["shapes"])
    update, momentum = {}, {}
    for k, ref in step1["p1"].items():
        update[k] = torch.zeros_like(ref)
        momentum[k] = torch.zeros_like(ref)
        for r in full:
            idx, blk = r["update"][k]
            update[k][idx] = blk
            idx, blk = r["momentum"][k]
            momentum[k][idx] = blk
    rec = {"leaves": {}, "steps": []}
    ok = True
    for k in update:
        u_bf16 = (step1["p0"][k] - step1["p1"][k]) / FULL_LR
        u_f32 = (step1["p0"][k] - f32["p1"][k]) / FULL_LR
        mask, ranks_k = _leading_mask(f32["momentum"][k])
        g = {"mesh": _gap(update[k], u_f32, mask), "one": _gap(u_bf16, u_f32, mask),
             "mesh_vs_bf16": _gap(update[k], u_bf16, mask),
             "mom_mesh": _gap(momentum[k], f32["momentum"][k]),
             "mom_one": _gap(step1["momentum"][k], f32["momentum"][k]),
             "ranks": ranks_k, "held": float(mask.float().mean())}
        rec["leaves"][k] = g
        ok &= (g["mesh"] <= max(BF16_RATIO * g["one"], MESH_GAP)
               and g["mom_mesh"] <= max(BF16_RATIO * g["mom_one"], MESH_GAP))
        print(f"  (b) {k}: update {g['mesh']:.3e} of the f32 step's rms (one device "
              f"{g['one']:.3e}; against the one-device bf16 step {g['mesh_vs_bf16']:.3e}), "
              f"momentum {g['mom_mesh']:.3e} (one device {g['mom_one']:.3e}); columns held "
              f"{g['held']:.3f}, ranks {ranks_k}")
    losses = [s["loss"] for s in full[0]["steps"]]
    loss_ok = abs(losses[0] - f32_loss) <= max(BF16_RATIO * abs(step1["loss"] - f32_loss),
                                               1e-5 * abs(f32_loss))
    check(ok and loss_ok,
          f"(b) olmo-1b, 16 x 2048 on 1x4: step 1 (loss {losses[0]:.4f}, one device "
          f"{step1['loss']:.4f} bf16 / {f32_loss:.4f} f32), its update (over the columns the "
          f"f32 momentum determines) and momentum, leaf by leaf, within {BF16_RATIO}x the "
          "one-device bf16 step's distance to the one-device f32 step")
    bad = replicas_differ([r["digests"] for r in full])
    n_rep = len(full[0]["digests"][0])
    check(not bad, f"(b) replicated blocks bitwise equal across the 4 ranks after every step "
                   f"({n_rep} replicated leaves: the rules shard every olmo-1b leaf over "
                   f"'model' at 1x4); other bits: {bad}")
    tokens = TRAIN_SEQ * TRAIN_BATCH
    for i in range(MESH_FULL_STEPS):
        walls = [r["steps"][i]["wall_s"] for r in full]
        b3 = [r["steps"][i]["launches"]["panel_factor"] for r in full]
        b4 = [r["steps"][i]["launches"]["apply_factors"] for r in full]
        used = max(r["steps"][i]["card_used"] for r in full)
        rec["steps"].append({"wall_s": max(walls), "B3": b3, "B4": b4, "card_used": used,
                             "fwd_bwd_ms": [r["steps"][i].get("fwd_bwd_ms") for r in full],
                             "opt_ms": [r["steps"][i].get("opt_ms") for r in full]})
        fb, op = rec["steps"][-1]["fwd_bwd_ms"], rec["steps"][-1]["opt_ms"]
        print(f"  (b) step {i + 1}: loss {losses[i]:.4f}, wall {max(walls):.2f} s (ranks "
              f"{', '.join(f'{w:.2f}' for w in walls)}), {tokens / max(walls):.1f} tok/s; a "
              f"rank's forward+backward {min(fb):.0f}-{max(fb):.0f} ms and optimizer "
              f"{min(op):.0f}-{max(op):.0f} ms between its CUDA events (the card runs the "
              f"other ranks' work between them too); B3 {b3}, B4 {b4} a rank; card memory in "
              f"use {used / 2**30:.2f} GiB ({card})")
        check(min(b3) > 0 and min(b4) > 0, f"(b) step {i + 1}: every rank launched B3 and B4")
    # the steps after the first, or the first alone (its wall holds the warm-up)
    steady = [s["wall_s"] for s in rec["steps"][1:]] or [rec["steps"][0]["wall_s"]]
    rec["s_step"] = sum(steady) / len(steady)
    rec["tok_s"] = tokens / rec["s_step"]
    rec["peak_gib"] = [r["peak_bytes"] / 2**30 for r in full]
    rec["card_peak_gib"] = max(s["card_used"] for s in rec["steps"]) / 2**30
    rec["init_s"] = [r["init_s"] for r in full]
    rec["losses"] = losses
    rec["local_bytes"] = full[0]["local_bytes"]
    out["full"] = rec
    print(f"  (b) rank 0's blocks: parameters {rec['local_bytes']['params']} bytes, optimizer "
          f"state {rec['local_bytes']['opt']} bytes (phase 15 (c) lays them out by shape)")
    over = f"steps 2-{MESH_FULL_STEPS}" if MESH_FULL_STEPS > 1 else "step 1, warm-up included"
    print(f"  (b) olmo-1b on 1x4: {rec['s_step']:.2f} s/step over {over}, "
          f"{rec['tok_s']:.1f} tok/s; peak allocated a rank "
          f"{', '.join(f'{x:.2f}' for x in rec['peak_gib'])} GiB, the card's memory in use "
          f"{rec['card_peak_gib']:.2f} GiB at most; {out['wall_s']['b']:.1f} s wall ({card})")
    check(all(np.isfinite(losses)), f"(b) {MESH_FULL_STEPS} finite losses {losses}")

    # (e) the shapes this phase launched B3/B4 at that earlier phases did not hold
    t0 = time.perf_counter()
    new = {k: out["shapes"][k] - held[k] for k in kernels}
    out["recheck_worst"] = recheck_shapes(new, gen)
    print(f"  (e) {sum(len(s) for s in new.values())} (shape, dtype) launches held now "
          f"({time.perf_counter() - t0:.1f} s); worst errors {out['recheck_worst']}")
    out["wall_s"]["phase"] = time.perf_counter() - t_phase
    print(f"  phase 13 wall {out['wall_s']['phase']:.1f} s; launches {out['launches']}")
    return out


# ------------------------------------------------------------ phase 14
# each mixed tile dtype's serving policy; phase 14 (c)'s QR runs the same
# policies by their short names (kernel_check.POLICY) and these
MIXED_POLICY = {"bfloat16": "mixed_bf16", "float16": "mixed_f16"}
# a served state within SERVE_EPS x eps(tile dtype), relative Frobenius, of
# the f32-stored state: the reference's rule (tests/test_precision.py,
# test_server_bf16_storage_round_trip), held on each kind's results together
SERVE_EPS = 8.0
# mean NIS of each filter over p: the reference's band (test_precision.py)
NIS_BAND = (0.7, 1.3)


def stored_mix(reqs, dtype):
    """The request mix with every append and kalman request's operands
    stored at ``dtype`` on the card (a fleet-shared model stays one tensor,
    so the executor still broadcasts it); the lstsq kinds as they are."""
    import torch

    memo = {}

    def cast(x):
        if id(x) not in memo:
            memo[id(x)] = torch.as_tensor(x, device="cuda").to(dtype)
        return memo[id(x)]

    return [r if r[0] not in ("append", "kalman") else (r[0], *map(cast, r[1:]))
            for r in reqs]


def served_errors(reqs, got, ref) -> dict:
    """'kind n_out:i' -> relative Frobenius distance of the results ``got``
    from ``ref`` (each a list of result tuples, request by request)."""
    import torch

    groups, errs = {}, {}
    for r, a, b in zip(reqs, got, ref):
        groups.setdefault((r[0], len(a)), []).append((a, b))
    for (kind, n_out), pairs in sorted(groups.items()):
        for i in range(n_out):
            X = torch.stack([a[i] for a, _ in pairs]).double()
            Y = torch.stack([b[i] for _, b in pairs]).double()
            errs[f"{kind} {n_out}:{i}"] = float(torch.linalg.norm(X - Y)
                                                / torch.linalg.norm(Y))
    return errs


def mixed_phase(kernels, card: str, reqs, f32_req_s: float, M, dense_ms: dict,
                gen) -> dict:
    """Phase 14, mixed precision on the main path: (a) the serving mix with
    its append and kalman operands stored in bf16 / f16 through
    ``QRServer(precision="mixed_bf16" / "mixed_f16")`` against the f32
    server, then a resilient bf16 flush of the appends; (b) a bf16 Kalman
    fleet's NIS; (c) ``ggr_qr_blocked`` of phase 5's 4096^2 matrix at bf16
    and f16 under both schedules within the reference's error budgets; (d)
    every (shape, pair) (a)-(c) launched, held against the plain version.
    The counts are set to 0 just before each run of (a)-(c) and read just
    after it; every launch must be at the run's (tile, float32) pair."""
    import numpy as np
    import torch

    from repro_torch.core import ggr_qr_blocked
    from repro_torch.launch.serve_qr import QRServer, _as_tuple, _submit_all
    from repro_torch.testing import (budget_is_meaningful, dtype_eps, error_budget,
                                     factorization_errors, fleet_nis)
    from repro_torch.testing import kernel_check

    t_phase = time.perf_counter()
    out = {"wall_s": {}, "req_s": {}, "serve_rel": {}, "nis": {}, "qr": {}, "qr_ms": {},
           "launches": {d: {k: 0 for k in kernels} for d in MIXED},
           "shapes": {d: {k: set() for k in kernels} for d in MIXED}}

    def counted(dname: str, what: str, fn):
        _zero_counts(kernels)
        res = fn()
        torch.cuda.synchronize()
        launches, shapes = _counts(kernels)
        for k in kernels:
            out["launches"][dname][k] += launches[k]
            out["shapes"][dname][k] |= shapes[k]
        pairs = {(str(sh[2]).removeprefix("torch."), sh[3])
                 for recs in shapes.values() for sh in recs}
        check(pairs <= {(dname, "float32")},
              f"{what}: every launch at ({dname}, float32): {sorted(pairs)}", quiet=True)
        return res, launches

    # (a) serving: the f32 server's results, then each mixed policy's
    t0 = time.perf_counter()
    plain = QRServer(device="cuda", max_batch=SERVE_MAX_BATCH)
    tickets = _submit_all(plain, reqs)
    plain.flush()
    plain.drain()
    ref = [_as_tuple(plain.result(t)) for t in tickets]
    stored = {}
    for dname in MIXED:
        dtype = getattr(torch, dname)
        stored[dname] = sreqs = stored_mix(reqs, dtype)
        srv = QRServer(device="cuda", max_batch=SERVE_MAX_BATCH,
                       precision=MIXED_POLICY[dname])
        _submit_all(srv, sreqs)  # warm-up flush
        srv.flush()
        srv.drain()
        tickets = _submit_all(srv, sreqs)

        def timed_flush():
            t1 = time.perf_counter()
            served = srv.flush()
            srv.drain()
            return served, time.perf_counter() - t1

        (served, dt), launches = counted(dname, f"(a) {MIXED_POLICY[dname]} flush",
                                         timed_flush)
        out["req_s"][dname] = served / dt
        print(f"  (a) {MIXED_POLICY[dname]}: served {served} requests (appends and kalman "
              f"steps stored in {dname}) in {dt * 1e3:.2f} ms: {served / dt:.1f} req/s "
              f"(phase 4, f32: {f32_req_s:.1f} req/s; {card}); launches {launches}")
        check(served == len(reqs) and launches["batched_update"] > 0,
              f"(a) {MIXED_POLICY[dname]} served all {len(reqs)} requests and launched "
              "batched_update")
        groups: dict = {}
        for r, t, want in zip(reqs, tickets, ref):
            if r[0] in ("append", "kalman"):
                got = _as_tuple(srv.result(t))
                groups.setdefault((r[0], len(got)), []).append((got, want))
        eps = dtype_eps(dname)
        for (kind, n_out), pairs in sorted(groups.items()):
            for i in range(n_out):
                got = [a[i] for a, _ in pairs]
                X = torch.stack(got).double()
                Y = torch.stack([b[i] for _, b in pairs]).double()
                rel = float(torch.linalg.norm(X - Y) / torch.linalg.norm(Y))
                one = float(((X - Y).flatten(1).norm(dim=1)
                             / Y.flatten(1).norm(dim=1)).max())
                out["serve_rel"][f"{dname} {kind} {n_out}:{i}"] = rel
                check(all(g.dtype == dtype for g in got) and rel <= SERVE_EPS * eps,
                      f"(a) {dname} {kind} ({len(pairs)} requests, output {i} of {n_out}): "
                      f"at {dname}, within {rel / eps:.2f} eps of the f32-stored results "
                      f"(relative Frobenius, <= {SERVE_EPS:g} eps; the worst single "
                      f"request {one / eps:.2f} eps, a reading)")
    # the resilient layer at the mixed policy: the bf16 appends, one flush
    appends = [r for r in stored["bfloat16"] if r[0] == "append"]
    servers = {"plain": QRServer(device="cuda", max_batch=SERVE_MAX_BATCH,
                                 precision="mixed_bf16"),
               "resilient": QRServer(device="cuda", max_batch=SERVE_MAX_BATCH,
                                     precision="mixed_bf16", resilient=True)}
    res = {}
    for name, srv in servers.items():
        tickets = _submit_all(srv, appends)
        _, launches = counted("bfloat16", f"(a) {name} mixed_bf16 flush of the appends",
                              lambda: (srv.flush(), srv.drain()))
        res[name] = ([srv.result(t) for t in tickets], launches["batched_update"])
    diff = sum(not same_bits(a, b) for a, b in zip(res["plain"][0], res["resilient"][0]))
    provs = {(p.rung, p.attempts) for ps in
             servers["resilient"]._engine.dispatcher.provenance.values() for p in ps}
    check(diff == 0 and provs == {("native", 1)} and res["plain"][1] == res["resilient"][1],
          f"(a) resilient mixed_bf16 flush of {len(appends)} bf16 appends: provenance "
          f"{provs}, {diff} results differ from the plain server's bits, B1 launches "
          f"{res['resilient'][1]} / {res['plain'][1]}")
    del res, servers, stored
    out["wall_s"]["a"] = time.perf_counter() - t0

    # (b) a bf16 Kalman fleet stays innovation-consistent
    t0 = time.perf_counter()
    p = 2
    nis, launches = counted("bfloat16", "(b) fleet_nis", lambda: fleet_nis(
        B=8, n=4, w=4, p=p, T=150, precision="bf16", device="cuda"))
    out["nis"] = [float(v) for v in nis]
    check(bool(np.all(NIS_BAND[0] * p < nis) and np.all(nis < NIS_BAND[1] * p))
          and launches["batched_update"] > 0,
          f"(b) fleet_nis(B=8, n=4, w=4, p=2, T=150, bf16) on the card: mean NIS "
          f"{np.round(nis, 3).tolist()} in ({NIS_BAND[0] * p:g}, {NIS_BAND[1] * p:g}); "
          f"B1 launches {launches['batched_update']}")
    out["wall_s"]["b"] = time.perf_counter() - t0

    # (c) phase 5's dense QR at each mixed policy under both schedules
    t0 = time.perf_counter()
    m, n = M.shape
    M64 = M.double()
    A64 = M64.cpu().numpy()
    R_ref = torch.linalg.qr(M64, mode="r").R.cpu().numpy()
    cond = float(torch.linalg.cond(M64))
    needs = {"fused": ("panel_factor", "apply_factors"),
             "tree": ("batched_geqrt", "batched_update")}
    for dname in MIXED:
        pol = kernel_check.POLICY[dname]
        for sched, need in needs.items():
            R, launches = counted(dname, f"(c) {sched} qr precision={pol!r}",
                                  lambda: ggr_qr_blocked(M, schedule=sched, precision=pol))
            errs = factorization_errors(A64, R.float().cpu().numpy(), R_ref=R_ref)
            held = {k: (v, error_budget(dname, k, m, n, cond)) for k, v in errs.items()
                    if k == "gram_residual" or budget_is_meaningful(dname, k, m, n, cond)}
            out["qr"][f"{dname} {sched}"] = errs
            check(R.dtype == getattr(torch, dname) and all(launches[k] > 0 for k in need)
                  and all(v < b for v, b in held.values()),
                  f"(c) ggr_qr_blocked {m}x{n} f32 input, precision={pol!r}, {sched}: R at "
                  f"{R.dtype}, launches {launches}; held (value < budget at cond "
                  f"{cond:.3e}): " + ", ".join(f"{k} {v:.3e} < {b:.3e}" for k, (v, b)
                                               in held.items())
                  + "; not meaningful there: " + ", ".join(
                      f"{k} {v:.3e}" for k, v in errs.items() if k not in held))
            ms = cuda_ms(lambda: ggr_qr_blocked(M, schedule=sched, precision=pol), reps=3)
            out["qr_ms"][f"{dname} {sched}"] = ms
            print(f"  (c) {sched} qr {m}x{n} precision={pol!r}: {ms:.2f} ms (phase 5 "
                  f"f32: {dense_ms[f'{sched} qr']:.2f} ms; torch.linalg.qr f32 "
                  f"{dense_ms['torch.linalg.qr']:.2f} ms; {card})")
    out["wall_s"]["c"] = time.perf_counter() - t0

    # (d) every (shape, pair) (a)-(c) launched, against the plain version
    t0 = time.perf_counter()
    out["recheck_worst"] = {d: recheck_shapes(out["shapes"][d], gen) for d in MIXED}
    n_shapes = sum(len(v) for d in MIXED for v in out["shapes"][d].values())
    print(f"  (d) {n_shapes} (shape, pair) launches rechecked "
          f"({time.perf_counter() - t0:.1f} s); worst errors {out['recheck_worst']}")
    out["wall_s"]["d"] = time.perf_counter() - t0
    for dname in MIXED:
        check(all(v > 0 for v in out["launches"][dname].values()),
              f"phase 14 launched every kernel at ({dname}, float32): "
              f"{out['launches'][dname]}")
    out["wall_s"]["phase"] = time.perf_counter() - t_phase
    print(f"  phase 14 wall {out['wall_s']['phase']:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in out["wall_s"].items() if k != "phase") + ")")
    return out


def wide_phase(kernels, card: str, reqs, M, dense_ms: dict, gen) -> dict:
    """Phase 14 (e)-(g), f64 sums on the main path (every kernel's wide
    instances): (e) ``ggr_qr_blocked`` of phase 5's 4096^2 matrix under
    the tree schedule, the fused schedule and ``"auto"`` (fused on the card)
    at ``Precision(t, "float64", t)`` for t = f32, bf16 and f16, within the
    reference's error budgets of the tile dtype, ``"auto"`` bitwise the
    fused run; (f) the mix's appends and kalman steps stored in bf16 / f16,
    served by ``QRServer(precision=Precision(t, "float64", t))``, each
    kind's results within SERVE_EPS eps(t) (relative Frobenius) of the same
    requests served in f64; (g) the pairs B3 and B4 do not take, bf16 / f16
    tiles summed at their own width: the fused schedule, ``"auto"``, B3 and
    B4 raise ``NotImplementedError`` naming both dtypes, with no launch; then
    every (shape, pair) (e)-(f) launched, held against the plain version on
    fresh inputs (``kernel_check.wide_accurate``).  The counts are set to 0
    just before each run of (e)-(f) and read just after it; every launch
    must be at the run's (tile, float64) pair, and a schedule launches its
    own two kernels and no other."""
    import torch

    from repro_torch.core import ggr_qr_blocked
    from repro_torch.kernels import Precision, ggr_apply, ggr_panel
    from repro_torch.launch.serve_qr import QRServer, _as_tuple, _submit_all
    from repro_torch.testing import (budget_is_meaningful, dtype_eps, error_budget,
                                     forward_error, gram_residual, orthogonality_loss)

    t_phase = time.perf_counter()
    needs = {"tree": ("batched_geqrt", "batched_update"), "fused": FUSED, "auto": FUSED}
    out = {"wall_s": {}, "req_s": {}, "serve_rel": {}, "qr": {}, "qr_ms": {},
           "launches": {d: {k: 0 for k in kernels} for d in WIDE},
           "shapes": {d: {k: set() for k in kernels} for d in WIDE}}

    def counted(dname: str, what: str, fn):
        _zero_counts(kernels)
        res = fn()
        torch.cuda.synchronize()
        launches, shapes = _counts(kernels)
        for k in kernels:
            out["launches"][dname][k] += launches[k]
            out["shapes"][dname][k] |= shapes[k]
        pairs = {(str(sh[2]).removeprefix("torch."), sh[3])
                 for recs in shapes.values() for sh in recs}
        check(pairs <= {(dname, "float64")},
              f"{what}: every launch at ({dname}, float64): {sorted(pairs)}", quiet=True)
        return res, launches

    # (e) the QR at each wide pair under each schedule, held by every metric
    # of the reference's factorization_errors whose budget is meaningful at
    # the matrix's condition (the gram residual always), computed only there
    t0 = time.perf_counter()
    m, n = M.shape
    M64 = M.double()
    A64 = M64.cpu().numpy()
    cond = float(torch.linalg.cond(M64))
    metrics = {"gram_residual": lambda R: gram_residual(A64, R),
               "orthogonality_loss": lambda R: orthogonality_loss(A64, R),
               "forward_error": lambda R: forward_error(R, R_ref)}
    if any(budget_is_meaningful(d, "forward_error", m, n, cond) for d in WIDE):
        R_ref = torch.linalg.qr(M64, mode="r").R.cpu().numpy()
    for dname in WIDE:
        prec = Precision(dname, "float64", dname)
        runs = {}
        for sched, need in needs.items():
            t1 = time.perf_counter()
            R, launches = counted(dname, f"(e) {sched} qr at ({dname}, float64)",
                                  lambda: ggr_qr_blocked(M, schedule=sched, precision=prec))
            runs[sched] = R
            R64 = R.double().cpu().numpy()
            held = {k: (f(R64), error_budget(dname, k, m, n, cond))
                    for k, f in metrics.items()
                    if k == "gram_residual" or budget_is_meaningful(dname, k, m, n, cond)}
            out["qr"][f"{dname} {sched}"] = {k: v for k, (v, _) in held.items()}
            same = sched != "auto" or torch.equal(R, runs["fused"])  # auto is fused here
            check(R.dtype == getattr(torch, dname)
                  and all(launches[k] > 0 for k in need)
                  and all(launches[k] == 0 for k in kernels if k not in need)
                  and all(v < b for v, b in held.values()) and same,
                  f"(e) ggr_qr_blocked {m}x{n} f32 input, {sched}, ({dname}, float64): R "
                  f"at {R.dtype}, launches {launches}; held (value < budget at cond "
                  f"{cond:.3e}): "
                  + ", ".join(f"{k} {v:.3e} < {b:.3e}" for k, (v, b) in held.items())
                  + "; not meaningful there, so not computed: "
                  + (", ".join(k for k in metrics if k not in held) or "none")
                  + ("; bitwise the fused run" if sched == "auto" and same else ""))
            ms = cuda_ms(lambda: ggr_qr_blocked(M, schedule=sched, precision=prec), reps=2)
            out["qr_ms"][f"{dname} {sched}"] = ms
            print(f"  (e) {sched} qr {m}x{n} ({dname}, float64): {ms:.2f} ms (phase 5 f32 "
                  f"{sched} {dense_ms[f'{sched} qr']:.2f} ms; {card}); run, check and "
                  f"timing {time.perf_counter() - t1:.1f} s")
        del runs
    out["wall_s"]["e"] = time.perf_counter() - t0

    # (f) the bf16 / f16 stored appends and kalman steps served with f64 sums,
    # beside the same requests served in f64
    t0 = time.perf_counter()
    kinds = ("append", "kalman")

    def serve(sreqs, precision=None):
        srv = QRServer(device="cuda", max_batch=SERVE_MAX_BATCH, precision=precision)
        tickets = _submit_all(srv, sreqs)
        t1 = time.perf_counter()
        served = srv.flush()
        srv.drain()
        return [_as_tuple(srv.result(t)) for t in tickets], served / (time.perf_counter() - t1)

    for dname in MIXED:
        dtype = getattr(torch, dname)
        sreqs = [r for r in stored_mix(reqs, dtype) if r[0] in kinds]
        ref, _ = serve(stored_mix(sreqs, torch.float64))  # the same values, in f64
        out.setdefault("served64", {})[dname] = (sreqs, ref)  # for phase 14 (h)
        prec = Precision(dname, "float64", dname)
        serve(sreqs, prec)  # warm-up flush
        (got, req_s), launches = counted(dname, f"(f) ({dname}, float64) flush",
                                         lambda: serve(sreqs, prec))
        out["req_s"][dname] = req_s
        eps = dtype_eps(dname)
        rels = served_errors(sreqs, got, ref)
        ok_dtype = all(x.dtype == dtype for a in got for x in a)
        for key, rel in rels.items():
            check(ok_dtype and rel <= SERVE_EPS * eps,
                  f"(f) {dname} {key} ({len(sreqs)} requests) served at ({dname}, float64): "
                  f"at {dname}, within {rel / eps:.3f} eps of the f64-served results "
                  f"(relative Frobenius, <= {SERVE_EPS:g} eps)")
        out["serve_rel"][dname] = rels
        check(launches["batched_update"] > 0,
              f"(f) ({dname}, float64) flush of {len(sreqs)} appends / kalman steps: "
              f"{req_s:.1f} req/s ({card}), launches {launches}")
    out["wall_s"]["f"] = time.perf_counter() - t0

    # (g) the pairs B3 and B4 do not take: bf16 / f16 tiles summed at their own
    # width (B1 and B2 take them: phase 14 (h))
    t0 = time.perf_counter()
    for dname in MIXED:
        prec = Precision(dname, dname, dname)
        pan = torch.zeros((1, 64, 8), device="cuda", dtype=getattr(torch, dname))
        refusals = {"fused qr": lambda: ggr_qr_blocked(M[:256, :256], schedule="fused",
                                                       precision=prec),
                    "auto qr": lambda: ggr_qr_blocked(M[:256, :256], precision=prec),
                    "panel_factor": lambda: ggr_panel.panel_factor(pan, precision=prec),
                    "apply_factors": lambda: ggr_apply.apply_factors(pan, pan, pan,
                                                                     precision=prec)}
        for what, call in refusals.items():
            _zero_counts(kernels)
            try:
                call()
                msg = "no error"
            except NotImplementedError as e:
                msg = str(e)
            launched = sum(_counts(kernels)[0].values())
            check(f"{dname} tiles with {dname} accumulation" in msg and launched == 0,
                  f"(g) {what} at ({dname}, {dname}) raises NotImplementedError naming "
                  f"both dtypes, no launch: {msg[:100]!r}, {launched} launches")
    out["wall_s"]["g"] = time.perf_counter() - t0

    # every (shape, pair) of (e)-(f) against the plain version on fresh inputs
    t0 = time.perf_counter()
    out["recheck_worst"] = {}
    for dname in WIDE:
        t1 = time.perf_counter()
        out["recheck_worst"][dname] = recheck_shapes(out["shapes"][dname], gen)
        print(f"  ({dname}, float64): " + ", ".join(
            f"{len(v)} {k}" for k, v in out["shapes"][dname].items())
            + f" (shape, pair) launches rechecked in {time.perf_counter() - t1:.1f} s")
    n_shapes = sum(len(v) for d in WIDE for v in out["shapes"][d].values())
    print(f"  (e)-(f) {n_shapes} (shape, pair) launches rechecked "
          f"({time.perf_counter() - t0:.1f} s); worst errors {out['recheck_worst']}")
    out["wall_s"]["recheck"] = time.perf_counter() - t0
    for dname in WIDE:
        check(all(v > 0 for v in out["launches"][dname].values()),
              f"phase 14 (e)-(f) launched every kernel at ({dname}, float64): "
              f"{out['launches'][dname]}")
    out["wall_s"]["phase"] = time.perf_counter() - t_phase
    print(f"  phase 14 (e)-(g) wall {out['wall_s']['phase']:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in out["wall_s"].items() if k != "phase") + ")")
    return out


# ------------------------------------------------------------ phase 14 (h)
# B1 and B2 at bf16 / f16 tiles summed at their own width: the tree QR's
# Gram residual at least NARROW_GRAM x the mixed policy's on the same matrix
# (the reference's tests/test_precision.py::test_mixed_accumulation_beats_all_bf16,
# on its own 96 x 80 matrix at both dtypes and on phase 5's 4096^2 matrix
# where the all-tile sums lose to the f32 ones there: f16), and each
# reading on the card within NARROW_BAND x the same call's on a CPU copy
# (the plain versions): the QR at NARROW_QR_N^2, the served results on the
# append and kalman requests among the mix's first NARROW_SERVED
NARROW_GRAM = 1.5
NARROW_BAND = (0.5, 2.0)
NARROW_QR_N, NARROW_SERVED = 1024, 512
NARROW_DIR = ROOT / "build" / "smoke_narrow"
# the CPU copies run beside phases 3-4 on NARROW_THREADS cores at the
# lowest priority, so they hold back no phase
NARROW_THREADS, NARROW_NICE = 4, 19
# the dtypes whose 4096^2 tree QR discriminates the sums' width: at bf16 the
# all-bf16 sums do not lose to f32 ones at that size (the JAX package on a
# CPU, tools/ref_gram.py on a Gaussian matrix: 1.274x the mixed policy's
# Gram residual at 1024^2, 0.887x at 2048^2; the port on the card,
# tools/mixed_gram.py --accum tile; PERF.md §6)
NARROW_GRAM_4096 = ("float16",)


def gram_torch(A64, R) -> float:
    """``testing.gram_residual`` in torch, on A64's device (the card's f64
    GEMMs): ||AᵀA - RᵀR||_F / ||AᵀA||_F in f64, R's upper triangle."""
    import torch

    R = torch.triu(R.double())
    AtA = A64.T @ A64
    return float(torch.linalg.norm(AtA - R.T @ R) / torch.linalg.norm(AtA))


def narrow_cpu(out_path: str) -> None:
    """Phase 14 (h)'s CPU copies, in a subprocess beside phases 3-4: the tree
    QR of NARROW_DIR/m.pt (phase 5's matrix, its leading NARROW_QR_N^2
    block) at Precision(t, t, t), and the append and kalman requests among
    the first NARROW_SERVED of the mix stored at t, served at the pair and
    in f64; writes each reading as JSON to ``out_path``."""
    import torch

    from repro_torch.core import ggr_qr_blocked
    from repro_torch.kernels import Precision
    from repro_torch.launch.serve_qr import QRServer, _as_tuple, _submit_all, make_workload

    os.nice(NARROW_NICE)
    torch.set_num_threads(NARROW_THREADS)
    M = torch.load(NARROW_DIR / "m.pt")
    reqs = [r for r in make_workload(num=NARROW_SERVED, n=32, rows=8, k=1, device="cpu")
            if r[0] in ("append", "kalman")]

    def serve(sreqs, precision=None):
        srv = QRServer(device="cpu", max_batch=SERVE_MAX_BATCH, precision=precision)
        tickets = _submit_all(srv, sreqs)
        srv.flush()
        srv.drain()
        return [_as_tuple(srv.result(t)) for t in tickets]

    memo = {}  # a fleet-shared model stays one tensor, so the executor broadcasts it

    def cast(r, dtype):
        def one(x):
            if (id(x), dtype) not in memo:
                memo[(id(x), dtype)] = torch.as_tensor(x).to(dtype)
            return memo[(id(x), dtype)]
        return (r[0], *map(one, r[1:]))

    out = {}
    for dname in MIXED:
        dtype, prec = getattr(torch, dname), Precision(dname, dname, dname)
        R = ggr_qr_blocked(M, schedule="tree", precision=prec)
        out[f"{dname} gram"] = gram_torch(M.double(), R)
        sreqs = [cast(r, dtype) for r in reqs]
        out[f"{dname} served"] = served_errors(
            sreqs, serve(sreqs, prec), serve([cast(r, torch.float64) for r in sreqs]))
    Path(out_path).write_text(json.dumps(out))


def narrow_cpu_start(M) -> tuple:
    """Start ``narrow_cpu`` on the leading NARROW_QR_N^2 block of the card
    matrix ``M``; returns the handle ``narrow_phase`` waits on."""
    import torch

    NARROW_DIR.mkdir(parents=True, exist_ok=True)
    torch.save(M[:NARROW_QR_N, :NARROW_QR_N].cpu().clone(), NARROW_DIR / "m.pt")
    out = NARROW_DIR / "cpu.json"
    out.unlink(missing_ok=True)
    code = (f"import sys; sys.path[:0] = [{str(SRC)!r}, {str(ROOT)!r}]; "
            f"import chip_smoke; chip_smoke.narrow_cpu({str(out)!r})")
    return start_cli("narrow_cpu", ["-c", code], module=False), out


def narrow_phase(kernels, card: str, reqs, M, mixed: dict, served64: dict, cpu: tuple,
                 gen) -> dict:
    """Phase 14 (h), B1 and B2 at bf16 / f16 tiles summed at their own width
    (``Precision(t, t, t)``), t = bf16 then f16: (i) ``ggr_qr_blocked`` of
    phase 5's 4096^2 matrix under the tree schedule, R finite at t, its
    Gram residual at least NARROW_GRAM x the mixed policy's (phase 14 (c))
    for the dtypes of NARROW_GRAM_4096, and the same discrimination on the
    reference test's own 96 x 80 matrix at both; the QR of the leading
    NARROW_QR_N^2 block within NARROW_BAND x the CPU copy's Gram residual;
    (ii) the mix, its append and kalman operands stored at t, served by
    ``QRServer(precision=Precision(t, t, t))`` (a warm-up flush, then a
    timed one): each kind's relative distance from the same requests served
    in f64 (``served64``, phase 14 (f)), on the append and kalman requests
    among the first NARROW_SERVED, within NARROW_BAND x the CPU copy's;
    (iii) every (shape, pair) (i)-(ii) launched, held by the wide rule at
    ``kernel_check.NARROW_EQUAL`` over WIDE_DRAWS draws with the (t,
    float32) instance as the control that must fail it.  The counts are set
    to 0 just before each run of (i)-(ii) and read just after it; every
    launch must be at (t, t), and only B1 and B2 launch.  Only the 4096^2
    QR's and the timed flush's launches are the main path's (``launches``);
    the 96 x 80 and NARROW_QR_N^2 runs add their shapes to (iii) alone."""
    import torch

    from repro_torch.core import ggr_qr_blocked
    from repro_torch.kernels import Precision
    from repro_torch.launch.serve_qr import QRServer, _as_tuple, _submit_all
    from repro_torch.testing import graded_matrix

    t_phase = time.perf_counter()
    out = {"wall_s": {}, "req_s": {}, "gram": {}, "served": {}, "qr_ms": {},
           "launches": {d: {k: 0 for k in kernels} for d in MIXED},
           "shapes": {d: {k: set() for k in kernels} for d in MIXED}}
    tree = ("batched_geqrt", "batched_update")

    def counted(dname: str, what: str, fn, tally: bool = True):
        # tally=False: a run off the main path (the reference test's matrix,
        # the leading block); (iii) rechecks its shapes, but its launches
        # are not the main path's
        _zero_counts(kernels)
        res = fn()
        torch.cuda.synchronize()
        launches, shapes = _counts(kernels)
        for k in kernels:
            out["launches"][dname][k] += launches[k] if tally else 0
            out["shapes"][dname][k] |= shapes[k]
        pairs = {(str(sh[2]).removeprefix("torch."), sh[3])
                 for recs in shapes.values() for sh in recs}
        check(pairs <= {(dname, dname)} and all(launches[k] == 0 for k in FUSED),
              f"{what}: every launch at ({dname}, {dname}), none of B3 / B4: "
              f"{sorted(pairs)}, {launches}", quiet=True)
        return res, launches

    t0 = time.perf_counter()
    rc, cpu_out, cpu_err, cpu_s = wait_cli(cpu[0], WATCHDOG_S)
    check(rc == 0, f"(h) the CPU copies ran (exit {rc}, {cpu_s:.1f} s): {cpu_err[-300:]!r}")
    ref_cpu = json.loads(cpu[1].read_text()) if rc == 0 else {}
    out["wall_s"]["cpu wait"] = time.perf_counter() - t0

    m, n = M.shape
    M64 = M.double()
    G = torch.from_numpy(graded_matrix(96, 80, 1.0, seed=7)).float().cuda()
    for dname in MIXED:
        prec = Precision(dname, dname, dname)
        dtype = getattr(torch, dname)
        # (i) the tree QR at 4096^2, its Gram residual beside the mixed policy's
        t0 = time.perf_counter()
        R, launches = counted(dname, f"(h)(i) tree qr at ({dname}, {dname})",
                              lambda: ggr_qr_blocked(M, schedule="tree", precision=prec))
        gram = gram_torch(M64, R)
        gram_mixed = mixed["qr"][f"{dname} tree"]["gram_residual"]
        out["gram"][f"{dname} {m}"] = gram
        held = dname in NARROW_GRAM_4096
        check(R.dtype == dtype and bool(R.isfinite().all())
              and all(launches[k] > 0 for k in tree)
              and (not held or gram >= NARROW_GRAM * gram_mixed),
              f"(h)(i) tree qr {m}x{n} at ({dname}, {dname}): R finite at {R.dtype}, "
              f"launches {launches}; Gram residual {gram:.4e}, {gram / gram_mixed:.3f}x the "
              f"mixed policy's {gram_mixed:.4e} ("
              + (f">= {NARROW_GRAM:g}x" if held else "a reading: at bf16 the all-bf16 "
                 "sums do not lose to f32 ones at this size") + ")")
        ms = cuda_ms(lambda: ggr_qr_blocked(M, schedule="tree", precision=prec), reps=2)
        out["qr_ms"][f"{dname} tree"] = ms
        print(f"  (h)(i) tree qr {m}x{n} at ({dname}, {dname}): {ms:.2f} ms (phase 14 (c) "
              f"mixed {mixed['qr_ms'][f'{dname} tree']:.2f} ms; {card})")
        # the reference test's own matrix, on the card
        g_n, _ = counted(dname, "(h)(i) the reference test's 96 x 80 QR",
                         lambda: gram_torch(G.double(), ggr_qr_blocked(
                             G, schedule="tree", precision=prec)), tally=False)
        g_m = gram_torch(G.double(), ggr_qr_blocked(
            G, schedule="tree", precision=Precision(dname, "float32", dname)))
        out["gram"][f"{dname} 96x80"] = [g_n, g_m]
        check(g_n >= NARROW_GRAM * g_m,
              f"(h)(i) the reference test's graded 96 x 80 matrix (seed 7) at ({dname}, "
              f"{dname}): Gram residual {g_n:.4e}, {g_n / g_m:.3f}x the ({dname}, float32) "
              f"policy's {g_m:.4e} (>= {NARROW_GRAM:g}x)")
        # the leading block, beside the CPU copy's plain versions
        R, _ = counted(dname, f"(h)(i) tree qr {NARROW_QR_N}^2",
                       lambda: ggr_qr_blocked(M[:NARROW_QR_N, :NARROW_QR_N], schedule="tree",
                                              precision=prec), tally=False)
        g_card = gram_torch(M64[:NARROW_QR_N, :NARROW_QR_N], R)
        g_cpu = ref_cpu.get(f"{dname} gram", float("nan"))
        out["gram"][f"{dname} {NARROW_QR_N}"] = [g_card, g_cpu]
        check(NARROW_BAND[0] <= g_card / g_cpu <= NARROW_BAND[1],
              f"(h)(i) tree qr {NARROW_QR_N}^2 at ({dname}, {dname}): Gram residual "
              f"{g_card:.4e} on the card, {g_cpu:.4e} on a CPU copy (the plain versions), "
              f"{g_card / g_cpu:.3f}x (within {NARROW_BAND[0]:g}-{NARROW_BAND[1]:g})")
        del R
        out["wall_s"][f"{dname} i"] = time.perf_counter() - t0

        # (ii) the mix stored at t, served at (t, t)
        t0 = time.perf_counter()
        sreqs = stored_mix(reqs, dtype)
        srv = QRServer(device="cuda", max_batch=SERVE_MAX_BATCH, precision=prec)
        _submit_all(srv, sreqs)  # warm-up flush
        srv.flush()
        srv.drain()
        tickets = _submit_all(srv, sreqs)

        def timed_flush():
            t1 = time.perf_counter()
            served = srv.flush()
            srv.drain()
            return served, time.perf_counter() - t1

        (served, dt), launches = counted(dname, f"(h)(ii) ({dname}, {dname}) flush",
                                         timed_flush)
        out["req_s"][dname] = served / dt
        check(served == len(reqs) and launches["batched_update"] > 0,
              f"(h)(ii) ({dname}, {dname}): served {served} requests (appends and kalman "
              f"steps stored in {dname}) in {dt * 1e3:.2f} ms: {served / dt:.1f} req/s "
              f"({card}); launches {launches}")
        first = [i for i, r in enumerate(reqs[:NARROW_SERVED]) if r[0] in ("append", "kalman")]
        _, ref64 = served64[dname]
        got = [_as_tuple(srv.result(tickets[i])) for i in first]
        errs = served_errors([sreqs[i] for i in first], got, ref64[:len(first)])
        cpu_errs = ref_cpu.get(f"{dname} served", {})
        out["served"][dname] = {k: [v, cpu_errs.get(k)] for k, v in errs.items()}
        for key, e in errs.items():
            c = cpu_errs.get(key, float("nan"))
            check(NARROW_BAND[0] <= e / c <= NARROW_BAND[1],
                  f"(h)(ii) {dname} {key} ({len(first)} requests, the append and kalman "
                  f"among the first {NARROW_SERVED}): {e:.4e} from the f64-served results "
                  f"on the card, {c:.4e} on a CPU copy, {e / c:.3f}x (within "
                  f"{NARROW_BAND[0]:g}-{NARROW_BAND[1]:g})")
        del srv, tickets, got, sreqs
        out["wall_s"][f"{dname} ii"] = time.perf_counter() - t0

    # (iii) every (shape, pair) (i)-(ii) launched, by the wide rule
    t0 = time.perf_counter()
    out["worst"] = {d: {} for d in MIXED}
    for dname in MIXED:
        for name, shapes in out["shapes"][dname].items():
            for shape, param, dtype, accum in sorted(shapes, key=str):
                case = KernelCase(name, shape, param, dtype, gen, accum=accum)
                out["worst"][dname][name] = max(out["worst"][dname].get(name, 0.0),
                                                case.compare())
    n_shapes = sum(len(v) for d in MIXED for v in out["shapes"][d].values())
    print(f"  (h)(iii) {n_shapes} (shape, pair) launches held by the wide rule at "
          f"NARROW_EQUAL ({time.perf_counter() - t0:.1f} s); worst errors {out['worst']}")
    out["wall_s"]["iii"] = time.perf_counter() - t0
    for dname in MIXED:
        check(all(out["launches"][dname][k] > 0 for k in tree),
              f"phase 14 (h) launched B1 and B2 at ({dname}, {dname}): "
              f"{out['launches'][dname]}")
    out["wall_s"]["phase"] = time.perf_counter() - t_phase
    print(f"  phase 14 (h) wall {out['wall_s']['phase']:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in out["wall_s"].items() if k != "phase") + ")")
    return out

# ------------------------------------------------------------ phase 15
# the dry run's cells on a fake 16x16 mesh of 256 ranks, on the card's host:
# their outputs, each subprocess's time limit, the phase's budget (printed
# beside its wall)
DRYRUN_DIR = ROOT / "build" / "dryrun"
CLI_DIR = ROOT / "build" / "smoke_cli"  # run_staggered's output files
DRYRUN_TIMEOUT, DRYRUN_BUDGET = 300.0, 60.0
# part -> (arch, shape, flags): (a) AdamW with the depth probe, (b) Orthant
# without it
DRYRUN_CELLS = {
    "a": ("olmo-1b", "train_4k", []),
    "b": ("olmo-1b", "train_4k", ["--optimizer", "orthant", "--no-probe"]),
    # (d) sequence parallelism (ROADMAP C5: failed under torch 2.11 before)
    "d": ("olmo-1b", "train_4k", ["--seq-parallel", "--no-probe"]),
    # (e) the long_500k cells whose caches split their sequence (C6)
    "e zamba2": ("zamba2-1.2b", "long_500k", ["--no-probe"]),
    "e mixtral": ("mixtral-8x22b", "long_500k", ["--no-probe"]),
}


def start_dryruns() -> tuple:
    """Phase 15's subprocesses (``DRYRUN_CELLS``), started ahead of the
    phase at nice MESH_NICE: they take the host's cores phases 11 to 14
    leave idle.
    Returns ({part: (result path, stderr path, process)}, the start time)."""
    import shutil

    DRYRUN_DIR.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    nice = ["nice", "-n", str(MESH_NICE)] if shutil.which("nice") else []
    procs = {}
    for name, (arch, shape, extra) in DRYRUN_CELLS.items():
        path = DRYRUN_DIR / f"{name.replace(' ', '_')}.json"
        path.unlink(missing_ok=True)
        err = path.with_suffix(".err")
        with open(err, "w") as f:
            procs[name] = (path, err, subprocess.Popen(
                [*nice, sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                 "--shape", shape, *extra, "--out", str(path)],
                stdout=subprocess.DEVNULL, stderr=f, text=True, env=env))
    return procs, time.perf_counter()


def dryrun_phase(kernels, card: str, mesh_full: dict, started: tuple) -> dict:
    """Phase 15: (a) ``python -m repro_torch.launch.dryrun --arch olmo-1b
    --shape train_4k`` (16x16 fake ranks, AdamW, the depth probe): the
    reference's keys, 256 chips, a dominant term, local FLOPs and collective
    bytes, the useful-FLOPs ratio within the hand count's band
    (``testing.dryrun_check``); (b) the same cell with Orthant, B3/B4's
    launches and FLOPs a rank and the momenta's all-gather bytes beside
    AdamW's; (c) ``launch.specs``' parameter and Orthant-state trees of
    olmo-1b on a fake 1x4 mesh in this process: rank 0's bytes exactly those
    of phase 13 (b)'s rank 0 (``mesh_full``); (d) the (a) cell with
    ``--seq-parallel``: fewer all-reduce bytes than (a), reduce-scatter and
    all-gather present, the useful-FLOPs ratio within the band; (e) the
    long_500k cells of zamba2-1.2b and mixtral-8x22b, whose decode caches
    split their sequence.  (a), (b), (d) and (e) run as subprocesses, each
    with its own time limit from its start (``start_dryruns``, at phase
    11's start); no kernel is launched."""
    import torch

    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch import dryrun, specs
    from repro_torch.optim import make_optimizer
    from repro_torch.parallel import MeshRules
    from repro_torch.testing.dryrun_check import missing_keys, useful_band

    t_phase = time.perf_counter()
    procs, t_start = started
    out = {"wall_s": {}}

    # (c) meanwhile: phase 13 (b)'s blocks laid out by shape on a fake 1x4 mesh
    t0 = time.perf_counter()
    before = _counts(kernels)[0]
    cfg = get_config("olmo-1b")
    try:
        with dryrun.fake_mesh((1, 4), ("data", "model")) as mesh:
            rules = MeshRules(mesh)
            p = specs.param_specs(cfg, rules)
            o = specs.opt_specs(p, cfg, rules, make_optimizer("orthant")[0])
            laid = {"params": specs.local_nbytes(p), "opt": specs.local_nbytes(o)}
    except Exception as e:  # a failed check, not a crash of the whole run
        laid = {"error": repr(e)}
    real = (mesh_full or {}).get("local_bytes")
    out["local_bytes"] = {"dry run": laid, "card": real}
    out["wall_s"]["c"] = time.perf_counter() - t0
    check(real is not None and laid == real and _counts(kernels)[0] == before,
          f"(c) olmo-1b on a fake 1x4 mesh: rank 0's parameter / Orthant-state bytes "
          f"{laid} by shape, phase 13 (b)'s rank 0 on the card {real} (exactly equal); no "
          f"kernel launched ({out['wall_s']['c']:.1f} s)")

    res = {}
    for name, (path, errpath, proc) in procs.items():  # each within its own time limit
        left = max(1.0, DRYRUN_TIMEOUT - (time.perf_counter() - t_start))
        try:
            proc.wait(timeout=left)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        err = errpath.read_text()
        ok = proc.returncode == 0 and path.exists()
        arch, shape, extra = DRYRUN_CELLS[name]
        args = " ".join([f"--arch {arch} --shape {shape}", *extra])
        check(ok, f"({name}) launch.dryrun {args} exits 0 (rc {proc.returncode})"
                  + ("" if ok else f": {err[-2000:]}"))
        res[name] = json.loads(path.read_text()) if ok else None
    out["wall_s"]["subprocesses"] = time.perf_counter() - t_start

    a = res["a"]
    if a is not None:
        pd, roof = a["per_device"], a["roofline_seconds_corrected"]
        lo, hi = useful_band(cfg, get_shape("train_4k"))
        ratio = a["useful_flops_ratio_corrected"]
        missing = missing_keys(a)
        check(not missing and a["chips"] == 256
              and roof["dominant"] in ("compute", "memory", "collective")
              and pd["hlo_flops"] > 0 and pd["collective_bytes"] > 0 and lo <= ratio <= hi,
              f"(a) olmo-1b train_4k on 16x16 (AdamW): keys missing {missing}, chips "
              f"{a['chips']}, dominant {roof['dominant']}, useful FLOPs ratio {ratio:.4f} in "
              f"[{lo:.4f}, {hi:.4f}] (the hand count's band)")
        print(f"  (a) per device: {pd['hlo_flops']:.6e} FLOPs, {pd['hlo_bytes']:.6e} bytes, "
              f"collectives {json.dumps(pd['collectives'])} ({pd['collective_bytes']} bytes); "
              f"roofline compute {roof['compute']:.6f} s, memory {roof['memory']:.6f} s, "
              f"collective {roof['collective']:.6f} s (H100 constants: {dryrun.PEAK_FLOPS:.3e} "
              f"FLOP/s, {dryrun.HBM_BW:.3e} B/s, {dryrun.ICI_BW:.3e} B/s); the step took "
              f"{a['compile_seconds']:.2f} s on this host; card {card}")
        out["adamw"] = {"per_device": pd, "roofline_corrected": roof, "useful": ratio,
                        "band": [lo, hi], "seconds": a["compile_seconds"]}
    b = res["b"]
    if b is not None:
        ks = b["per_device"].get("kernels", {})
        b3, b4 = ks.get("panel_factor", {}), ks.get("apply_factors", {})
        card_steps = (mesh_full or {}).get("steps") or [{}]
        on_card = (card_steps[0].get("B3", [None])[0], card_steps[0].get("B4", [None])[0])
        gathered = b["per_device"]["collectives"]["all-gather"] - (
            a["per_device"]["collectives"]["all-gather"] if a else 0)
        check(b["chips"] == 256 and b3.get("launches", 0) > 0 and b4.get("launches", 0) > 0,
              f"(b) olmo-1b train_4k on 16x16 (Orthant): B3 {b3.get('launches')} launches, "
              f"{b3.get('flops', 0):.6e} FLOPs; B4 {b4.get('launches')} launches, "
              f"{b4.get('flops', 0):.6e} FLOPs a rank a step, counted by shape (phase 13 (b)'s "
              f"rank 0 launched {on_card[0]} / {on_card[1]} in its first step); all-gather "
              f"{b['per_device']['collectives']['all-gather']} bytes, {gathered} more than "
              f"AdamW's (the momenta each rank gathers whole); card {card}")
        out["orthant"] = {"kernels": ks, "per_device": b["per_device"],
                          "momenta_all_gather_bytes": gathered, "card_launches": on_card,
                          "seconds": b["compile_seconds"]}
    d = res["d"]
    if d is not None:
        lo, hi = useful_band(cfg, get_shape("train_4k"))
        ratio, coll = d["useful_flops_ratio"], d["per_device"]["collectives"]
        plain = a["per_device"]["collectives"] if a else None
        check(plain is not None and coll["all-reduce"] < plain["all-reduce"]
              and coll["reduce-scatter"] > 0 and coll["all-gather"] > 0 and lo <= ratio <= hi,
              f"(d) olmo-1b train_4k on 16x16 with --seq-parallel under torch "
              f"{torch.__version__}: all-reduce {coll['all-reduce']} bytes (< (a)'s "
              f"{plain and plain['all-reduce']}), reduce-scatter {coll['reduce-scatter']}, "
              f"all-gather {coll['all-gather']} bytes a device; useful FLOPs ratio "
              f"{ratio:.4f} in [{lo:.4f}, {hi:.4f}]; the step took "
              f"{d['compile_seconds']:.2f} s on this host")
        out["seq_parallel"] = {"collectives": coll, "useful": ratio,
                               "seconds": d["compile_seconds"]}
    for name in ("e zamba2", "e mixtral"):
        e = res[name]
        if e is not None:
            pd = e["per_device"]
            check(e["chips"] == 256 and pd["hlo_flops"] > 0 and pd["collective_bytes"] > 0,
                  f"({name}) {e['arch']} long_500k on 16x16 (batch 1: the cache's sequence "
                  f"over the data axes): {pd['hlo_flops']:.4e} FLOPs, {pd['hlo_bytes']:.4e} "
                  f"bytes, collectives {json.dumps(pd['collectives'])} a device; the step "
                  f"took {e['compile_seconds']:.2f} s on this host")
            out[name] = {"per_device": pd, "seconds": e["compile_seconds"]}
    out["wall_s"]["phase"] = time.perf_counter() - t_phase
    print(f"  phase 15 wall {out['wall_s']['phase']:.1f} s, its subprocesses "
          f"{out['wall_s']['subprocesses']:.1f} s from their start in phase 11 "
          f"(budget {DRYRUN_BUDGET:.0f} s; "
          + ", ".join(f"{k} {v:.1f} s" for k, v in out["wall_s"].items() if k != "phase") + ")")
    return out


# past this many seconds the run stops itself (``watchdog``): every thread's
# stack on stderr, every process it started killed, exit 3, inside the
# 1200 s the run has
WATCHDOG_S = 1170.0


def _descendants(pid: int) -> list:
    """Every process under ``pid`` (read from /proc), children first."""
    parent = {}
    for d in Path("/proc").iterdir():
        if d.name.isdigit():
            try:
                stat = (d / "stat").read_text()
            except OSError:
                continue
            parent[int(d.name)] = int(stat.rsplit(")", 1)[1].split()[1])
    out, todo = [], [pid]
    while todo:
        cur = todo.pop()
        kids = [p for p, pp in parent.items() if pp == cur]
        out += kids
        todo += kids
    return out


def stop_children() -> None:
    """Kill every process the run started that still runs."""
    import signal

    for pid in _descendants(os.getpid()):
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass


def watchdog() -> None:
    """Stop the run ``WATCHDOG_S`` seconds after its start: the phase it is
    in and every thread's stack go to stderr, every process it started is
    killed, and it exits 3 without printing the last line."""
    import faulthandler
    import threading

    def stop():
        print(f"chip_smoke.py: still running {time.perf_counter() - _T0:.0f} s after its "
              f"start, in phase {_PHASE[0]!r}: stopping (every thread's stack follows)",
              file=sys.stderr, flush=True)
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        stop_children()
        sys.stderr.flush()
        os._exit(3)

    timer = threading.Timer(WATCHDOG_S - (time.perf_counter() - _T0), stop)
    timer.daemon = True
    timer.start()


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: run from the root of a checkout (src/repro_torch "
              "not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    watchdog()
    import torch

    # ------------------------------------------------------------ phase 1
    phase("1. card check")
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "float32 matmuls run in full float32 (allow_tf32 is False)")

    from repro_torch.core import ggr_qr_blocked
    from repro_torch.kernels import _cuda, ggr_qr_pallas
    from repro_torch.kernels.backend import degraded_mode
    from repro_torch.launch.serve_qr import QRServer, _as_tuple, _submit_all, make_workload
    from repro_torch.serve import KINDS
    from repro_torch.solvers import ggr_lstsq

    kernels = _kernel_fns()

    # ------------------------------------------------------------ phase 2
    phase("2. build")
    import threading

    from repro_torch.testing.kernel_check import build_narrow

    t0 = time.perf_counter()
    # phase 3's probe of the casts from double, built beside the kernels
    narrow = threading.Thread(target=build_narrow)
    narrow.start()
    logs = _cuda.build()
    narrow.join()
    print(f"  built {sorted(logs)} and the casts' probe into {_cuda.build_dir()} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        print(f"  --- {name}.cu ({_cuda.BUILD_S.get(name, 0.0):.1f} s) ptxas:")
        for line in log.strip().splitlines():
            print(f"    {line}")

    # phase 5's inputs, drawn now: phase 14 (h)'s CPU copies of M's leading
    # block run beside phases 3-4, whose host work is one thread
    g = torch.Generator(device="cuda").manual_seed(1)
    dense_in = [torch.randn(s, generator=g, device="cuda", dtype=torch.float32)
                for s in ((8192, 1024), (8192, 4), (4096, 4096))]
    narrow_cpu = narrow_cpu_start(dense_in[2])

    # ------------------------------------------------------------ phase 3
    phase("3. kernels vs plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [KernelCase(name, shape, param, getattr(torch, dname), gen, *data)
             for name, shape, param, dname, *data in PHASE3]
    worst = {(c.name, c.pair): 0.0 for c in cases}
    timed, walls = {}, {}
    for case in cases:
        t0 = time.perf_counter()
        worst[(case.name, case.pair)] = max(worst[(case.name, case.pair)], case.compare())
        case.zero_batch()
        # keyed by both dtypes: an f32 and an f64 case may share a shape
        timed[(case.name, case.shape, case.dname, case.accum, case.data)] = t = case.times()
        was = (TABLE_MS.get((case.name, case.shape, case.dname, case.data))
               if case.pair == "uniform" else None)
        if was is not None:
            print(f"    PERF.md §6 table: {was:.4f} ms; this run {t['ms']:.4f} ms "
                  f"({t['ms'] / was:.2f}x)")
        kind = ("wide" if case.wide else "narrow" if case.narrow else
                "mixed" if case.mixed else "uniform",
                "B3/B4" if case.name in FUSED else "B1/B2")
        walls[kind] = walls.get(kind, 0.0) + time.perf_counter() - t0
    print("  phase 3 walls (checks and timings): " + ", ".join(
        f"{k} {b} {v:.1f} s" for (k, b), v in walls.items()))
    # the wide instances' stores: ggr_common.cuh's narrow from double, alone
    from repro_torch.kernels.backend import to_tile
    from repro_torch.testing.kernel_check import narrow_on_card, tie_values

    ties = tie_values().cuda()
    for dname in WIDE:
        got, want = narrow_on_card(ties, dname), to_tile(ties, dname)
        itype = torch.int16 if got.element_size() == 2 else torch.int32
        once = int((to_tile(ties, dname).view(itype)
                    != ties.to(getattr(torch, dname)).view(itype)).sum())
        check(torch.equal(got.view(itype), want.view(itype)),
              f"narrow<{dname}>(double) on the card, {ties.numel()} tie values: bitwise "
              f"the plain versions' to_tile ({once} of them where one rounding and "
              "torch's cast differ)")

    # ------------------------------------------------------------ phase 4
    phase("4. serving")
    n, rows, nrhs, num = 32, 8, 1, 8192
    server = QRServer(device="cuda", max_batch=SERVE_MAX_BATCH)
    reqs = make_workload(num=num, n=n, rows=rows, k=nrhs, device="cuda")
    _submit_all(server, reqs)  # warm-up flush
    server.flush()
    server.drain()
    tickets = _submit_all(server, reqs)
    for fn in kernels.values():
        fn.launches = 0
        fn.shapes.clear()
    t0 = time.perf_counter()
    served = server.flush()
    server.drain()
    dt = time.perf_counter() - t0
    serve_launches = {name: fn.launches for name, fn in kernels.items()}
    recorded = {name: set(fn.shapes) for name, fn in kernels.items()}
    req_s = served / dt
    print(f"  served {served} requests (n={n}, rows={rows}, nrhs={nrhs}, "
          f"max_batch={SERVE_MAX_BATCH}) in {dt * 1e3:.2f} ms: "
          f"{req_s:.1f} req/s on {card}")
    print(f"  launches in the timed flush: {serve_launches}")
    check(served == num, f"served all {num} requests")
    check(serve_launches["batched_update"] > 0,
          "serving launched batched_update (append + kalman kinds)")

    ref = QRServer(backend="reference", device="cuda", max_batch=SERVE_MAX_BATCH)
    rticks = _submit_all(ref, reqs)
    ref.flush()
    ref.drain()
    errs: dict[str, float] = {}
    # every 7th ticket: the stride is coprime to the mix's period of 8, so
    # the sample covers all four kinds
    for r, tk, rt in list(zip(reqs, tickets, rticks))[::7]:
        a, b = _as_tuple(server.result(tk)), _as_tuple(ref.result(rt))
        scale = max(1.0, max(float(y.abs().max()) for y in b))
        e = max(float((x.double() - y.double()).abs().max()) for x, y in zip(a, b))
        if not all(bool(x.isfinite().all()) for x in a):
            e = float("inf")
        errs[r[0]] = max(errs.get(r[0], 0.0), e / scale)
    check(sorted(errs) == sorted(KINDS), f"cross-check sampled every kind: {sorted(errs)}")
    for kind, e in sorted(errs.items()):
        check(e <= 2e-4, f"serving {kind} vs reference backend: max error "
                         f"{e:.3e} (relative to max(1, |ref|)) <= 2e-4")
    _submit_all(server, reqs)
    profile_top(lambda: (server.flush(), server.drain()), "one serving flush")
    for kind in KINDS:  # where the flush time goes: each kind flushed alone
        sub = [r for r in reqs if r[0] == kind]
        _submit_all(server, sub)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server.flush(kind)
        server.drain()
        print(f"  {kind}: {len(sub)} requests flushed alone in "
              f"{(time.perf_counter() - t0) * 1e3:.2f} ms")

    # ------------------------------------------------------------ phase 5
    phase("5. dense")
    A, b, M = dense_in
    del dense_in

    def tree_lstsq():
        with degraded_mode(schedule="tree"):
            return ggr_lstsq(A, b)

    tree, fused = ("batched_geqrt", "batched_update"), ("panel_factor", "apply_factors")
    routes = {  # name -> (call, kernels it must launch, kernels it must not)
        "tree lstsq": (tree_lstsq, tree, ()),
        "tree qr": (lambda: ggr_qr_blocked(M, schedule="tree"), tree, ()),
        "fused qr": (lambda: ggr_qr_blocked(M, schedule="fused"), fused, ()),
        # "auto" on a CUDA tensor is the fused schedule
        "auto qr": (lambda: ggr_qr_blocked(M), fused, ("batched_geqrt",)),
        "fused lstsq": (lambda: ggr_lstsq(A, b), fused, ("batched_geqrt",)),
        "pallas qr": (lambda: ggr_qr_pallas(M, panel=32), fused, ()),
    }
    for fn in kernels.values():
        fn.launches = 0
    results, route_launches = {}, {}
    torch.cuda.synchronize()
    t_dense = time.perf_counter()
    for name, (call, _, _) in routes.items():
        before = {k: fn.launches for k, fn in kernels.items()}
        t0 = time.perf_counter()
        results[name] = call()
        torch.cuda.synchronize()
        route_launches[name] = {k: fn.launches - before[k] for k, fn in kernels.items()}
        print(f"  {name}: first call {(time.perf_counter() - t0) * 1e3:.1f} ms wall, "
              f"launches {route_launches[name]}")
    dense_wall = time.perf_counter() - t_dense
    dense_launches = {name: fn.launches for name, fn in kernels.items()}
    for name, fn in kernels.items():
        recorded[name] |= fn.shapes
    print(f"  launches in the dense run ({dense_wall * 1e3:.1f} ms wall): "
          f"{dense_launches}")
    for name, (_, needs, avoids) in routes.items():
        check(all(route_launches[name][k] > 0 for k in needs),
              f"{name} launched {' and '.join(needs)}")
        for k in avoids:
            check(route_launches[name][k] == 0, f"{name} launched no {k}")
    check(all(v > 0 for v in dense_launches.values()),
          "the dense run launched every kernel")

    A64, b64 = A.double(), b.double()
    x_ref = torch.linalg.lstsq(A64, b64, driver="gels").solution
    r_ref = torch.linalg.norm(A64 @ x_ref - b64, dim=0)
    for name in ("tree lstsq", "fused lstsq"):
        fit = results[name]
        r_ours = torch.linalg.norm(A64 @ fit.x.double() - b64, dim=0)
        res_gap = float(((r_ours - r_ref) / r_ref).abs().max())
        x_err = float(torch.linalg.norm(fit.x.double() - x_ref)
                      / torch.linalg.norm(x_ref))
        rep_gap = float(((fit.resid.double() - r_ref) / r_ref).abs().max())
        check(res_gap <= 1e-4, f"{name} (8192, 1024) f32: residual within "
                               f"{res_gap:.3e} of torch.linalg.lstsq f64 (<= 1e-4)")
        check(x_err <= 1e-3, f"{name} solution relative error {x_err:.3e} (<= 1e-3)")
        check(rep_gap <= 1e-3, f"{name} reported residual within {rep_gap:.3e} "
                               "of the f64 residual (<= 1e-3)")

    R_lib = torch.linalg.qr(M, mode="r").R
    M64 = M.double()
    for name in ("tree qr", "fused qr", "auto qr", "pallas qr"):
        R = results[name]
        r_gap = float(torch.linalg.norm(R.abs() - R_lib.abs()) / torch.linalg.norm(R_lib))
        check(r_gap <= 1e-3, f"{name} 4096^2 f32: |R| within {r_gap:.3e} of "
                             "torch.linalg.qr's |R| (relative Frobenius, <= 1e-3)")
        R64 = R.double()
        gram = float(torch.linalg.norm(R64.T @ R64 - M64.T @ M64)
                     / torch.linalg.norm(M64) ** 2)
        check(gram <= 1e-5, f"{name} Gram residual ||R^T R - A^T A|| / ||A||^2 "
                            f"= {gram:.3e} (<= 1e-5)")
    del results
    profile_top(lambda: ggr_qr_blocked(M, schedule="tree"),
                "ggr_qr_blocked 4096^2 f32 (tree)")
    profile_top(lambda: ggr_qr_blocked(M, schedule="fused"),
                "ggr_qr_blocked 4096^2 f32 (fused)")
    profile_top(tree_lstsq, "ggr_lstsq (8192, 1024) + 4 rhs f32 (tree)")
    dense_ms = {name: cuda_ms(call, reps=3) for name, (call, _, _) in routes.items()}
    dense_ms["torch.linalg.qr"] = cuda_ms(lambda: torch.linalg.qr(M), reps=3)
    dense_ms["torch.linalg.lstsq"] = cuda_ms(
        lambda: torch.linalg.lstsq(A, b).solution, reps=3)
    for name, ms in dense_ms.items():
        shape = "(8192, 1024) + 4 rhs" if "lstsq" in name else "4096x4096"
        print(f"  {name} {shape} f32: {ms:.2f} ms ({card})")

    # ------------------------------------------------------------ phase 6
    phase("6. instrumented path and sketch least squares")
    early = {}  # the CLI runs phase 6 starts for phases 6-8
    inst = instrumented_phase(server, reqs, kernels, card, early)
    for name in kernels:
        recorded[name] |= inst["shapes"][name]

    # ------------------------------------------------------------ phase 7
    phase("7. resilient serving")
    resil = resilient_phase(reqs, kernels, card, early["7"])
    for name in kernels:
        recorded[name] |= resil["shapes"][name]

    # ------------------------------------------------------------ phase 8
    phase("8. sharded serving")
    shard = sharded_phase(reqs, kernels, card, early["8"])
    for name in kernels:
        recorded[name] |= shard["shapes"][name]

    # ------------------------------------------------------------ phase 9
    phase("9. distributed QR and the Orthant optimizer")
    # phase 13's smoke meshes and phase 12's CLI runs, from phase 9 (c) to phase 10's end
    smoke, train_cli = {}, {}
    dist_out = distributed_phase(kernels, card, gen, timed=lambda: (
        smoke.update(mesh_smoke_start()), train_cli.update(train_cli_start())))
    for name in kernels:
        recorded[name] |= dist_out["shapes"][name]

    # ------------------------------------------------------------ phase 10
    phase("10. kernels vs plain versions at every main-path shape")
    t0 = time.perf_counter()
    plain_held = {k: recorded[k] & dist_out["plain_held"][k] for k in kernels}
    n_shapes = sum(len(s) for s in recorded.values())
    n_held = sum(len(s) for s in plain_held.values())
    recheck_worst = recheck_shapes({k: recorded[k] - plain_held[k] for k in kernels}, gen)
    recheck_worst = {k: max(v, dist_out["plain_worst"][k]) for k, v in recheck_worst.items()}
    print(f"  {n_shapes} (shape, dtype) launches: {n_held} held on phase 9 (c)'s plain "
          f"driver's own steps, the other {n_shapes - n_held} rechecked now "
          f"({time.perf_counter() - t0:.1f} s); worst errors {recheck_worst}")
    mesh_smoke_join(smoke)
    train_cli["thread"].join()
    print(f"  phase 12's CLI runs, beside phases 9 (c) to 10, done "
          f"{time.perf_counter() - train_cli['t0']:.1f} s after their start")

    # ------------------------------------------------------------ phase 11
    phase("11. LM serving")
    dryruns = start_dryruns()  # phase 15's subprocesses, on the host's cores from here on
    lm = lm_phase(kernels, card)

    # ------------------------------------------------------------ phase 12
    phase("12. LM training")
    step1 = {}
    train = train_phase(kernels, card, gen, recorded, step1, train_cli)

    # ------------------------------------------------------------ phase 13
    phase("13. LM training on a mesh")
    mesh = mesh_phase(kernels, card, gen,
                      {k: recorded[k] | train["shapes"][k] for k in kernels}, step1, smoke)
    del step1

    # ------------------------------------------------------------ phase 14
    phase("14. mixed precision on the main path")
    mixed = mixed_phase(kernels, card, reqs, req_s, M, dense_ms, gen)
    wide = wide_phase(kernels, card, reqs, M, dense_ms, gen)
    narrow = narrow_phase(kernels, card, reqs, M, mixed, wide.pop("served64"), narrow_cpu,
                          gen)

    # ------------------------------------------------------------ phase 15
    phase("15. the dry run on the card's host")
    dry = dryrun_phase(kernels, card, mesh.get("full"), dryruns)

    # ------------------------------------------------------------ phase 16
    phase("16. summary")
    headline = {"batched_update": ("batched_update", (8192, 40, 33), "float32"),
                "batched_geqrt": ("batched_geqrt", (128, 64, 128), "float32"),
                "panel_factor": ("panel_factor", (1, 4096, 64), "float32"),
                "apply_factors": ("apply_factors", (1, 4096, 4032), "float32")}
    meta = {"batched_update": ("src/repro_torch/kernels/csrc/ggr_update.cu",
                               "src/repro/kernels/ggr_update.py:91"),
            "batched_geqrt": ("src/repro_torch/kernels/csrc/ggr_panel.cu",
                              "src/repro/kernels/ggr_panel.py:211"),
            "panel_factor": ("src/repro_torch/kernels/csrc/ggr_panel_factor.cu",
                             "src/repro/kernels/ggr_panel.py:135"),
            "apply_factors": ("src/repro_torch/kernels/csrc/ggr_apply.cu",
                              "src/repro/kernels/ggr_apply.py:28")}
    rows_out = []
    for name in kernels:
        t = timed[(*headline[name], "float32", "random")]
        rows_out.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1],
            "launches": (serve_launches[name] + dense_launches[name]
                         + inst["launches"][name] + resil["launches"][name]
                         + shard["launches"][name] + dist_out["launches"][name]
                         + train["launches"][name] + mesh["launches"][name]),
            "max_abs_err": max(worst[(name, "uniform")], recheck_worst[name],
                               train["recheck_worst"].get(name, 0.0),
                               mesh["recheck_worst"].get(name, 0.0)),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": list(headline[name][1]), "dtype": headline[name][2],
        })
    for dname in MIXED:  # the bf16 / f16 instances at the same shapes
        for name in kernels:
            shape = headline[name][1]
            t = timed[(name, shape, dname, "float32", "random")]
            rows_out.append({
                "name": f"{name}_{_cuda.suffix(getattr(torch, dname), 'float32')}",
                "route": "cuda", "source": meta[name][0], "replaces": meta[name][1],
                "launches": mixed["launches"][dname][name],
                "max_abs_err": max(worst[(name, f"{dname}/float32")],
                                   mixed["recheck_worst"][dname].get(name, 0.0)),
                "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "shape": list(shape), "dtype": dname, "accum_dtype": "float32",
                "library_dtype": "float32",
            })
    for dname in WIDE:  # the f64-summed instances at the same shapes
        for name in kernels:
            shape = headline[name][1]
            pair = f"{dname}/float64"
            t = timed[(name, shape, dname, "float64", "random")]
            rows_out.append({
                "name": f"{name}_{_cuda.suffix(getattr(torch, dname), 'float64')}",
                "route": "cuda", "source": meta[name][0], "replaces": meta[name][1],
                "launches": wide["launches"][dname][name],
                "max_abs_err": max(worst[(name, pair)],
                                   wide["recheck_worst"][dname].get(name, 0.0)),
                "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "shape": list(shape), "dtype": dname, "accum_dtype": "float64",
                "library_dtype": "float64",
            })
    for dname in MIXED:  # B1's and B2's narrow instances at the same shapes
        for name in ("batched_update", "batched_geqrt"):
            shape = headline[name][1]
            t = timed[(name, shape, dname, dname, "random")]
            rows_out.append({
                "name": f"{name}_{_cuda.suffix(getattr(torch, dname))}",
                "route": "cuda", "source": meta[name][0], "replaces": meta[name][1],
                "launches": narrow["launches"][dname][name],
                "max_abs_err": max(worst[(name, f"{dname}/{dname}")],
                                   narrow["worst"][dname].get(name, 0.0)),
                "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "shape": list(shape), "dtype": dname, "accum_dtype": dname,
                "library_dtype": "float32",
            })
    for (name, shape, dname, accum, data), t in timed.items():
        print(f"  {name} {shape} {dname}/{accum} {data}: " + ", ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in t.items()))
    print(f"  serving: {req_s:.1f} req/s; dense ms: " + ", ".join(
        f"{k} {v:.2f}" for k, v in dense_ms.items()) + f"; card {card}")
    print(f"  phase 6: {json.dumps({k: v for k, v in inst.items() if k != 'shapes'})}")
    print(f"  phase 7: {json.dumps({k: v for k, v in resil.items() if k != 'shapes'})}")
    print(f"  phase 8: {json.dumps({k: v for k, v in shard.items() if k != 'shapes'})}")
    print("  phase 9: " + json.dumps({k: v for k, v in dist_out.items()
                                      if k not in ("shapes", "plain_held")}))
    print(f"  phase 11: {json.dumps(lm)}")
    print(f"  phase 12: {json.dumps({k: v for k, v in train.items() if k != 'shapes'})}")
    print(f"  phase 13: {json.dumps({k: v for k, v in mesh.items() if k != 'shapes'})}")
    print(f"  phase 14: {json.dumps({k: v for k, v in mixed.items() if k != 'shapes'})}")
    print(f"  phase 14 (e)-(g): "
          f"{json.dumps({k: v for k, v in wide.items() if k != 'shapes'})}")
    print(f"  phase 14 (h): "
          f"{json.dumps({k: v for k, v in narrow.items() if k != 'shapes'})}")
    print(f"  phase 15: {json.dumps(dry)}")
    if FAILURES:
        print(f"\nchip_smoke.py: {len(FAILURES)} check(s) failed:", file=sys.stderr)
        for f in FAILURES:
            print(f"  {f}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": rows_out}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except BaseException:
        stop_children()  # the subprocesses that run beside the phases
        raise
    sys.exit(rc)
