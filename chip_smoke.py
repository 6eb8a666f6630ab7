#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --phases 1,19-21  # a subset (phase 1 always)
    python3 chip_smoke.py --yardsticks     # also time plans no route takes

Phases (each prints its own lines; any failure exits non-zero). A listed
phase brings the rest of its group, the phases that read each other's
results: 3, 5, 24, 25 and 29; 7-10; 12 and 14; 16 and 18:
  1. build the CUDA kernels from the sources in the checkout, one nvcc per
     source, all at once;
  2. each kernel against its plain PyTorch version on the card: one dense
     epoch on a 6x6 grid of 256x256 cells, the diagonal walk at dim 64 in
     both working types, the wavefront walk (bf16) at dims 8 and 64, the
     routed walk (bf16) at dims 128 and 300 (rows of two and three 128-lane
     groups, which the route sends to the diagonal walk);
     one gen-1 epoch at the geometry the gen-1 path picks for the training
     set (``pick_cell_geometry``), on 6x6 tiles at ML-10M density, in both
     working types;
  3. the dense path: ``tpu_mf_torch.train.train_mf`` on ``cuda``, 3 epochs
     at dim 64 and the default CLI hyperparameters, on the ML-10M-shape
     calibrated stand-in (nu 69,878, nv 10,677, 10M ratings, split 90/10);
     the dense kernel's launch count must rise in every epoch, every launch
     on the wavefront walk, and tRMSE must fall; then the same 3 epochs from
     the same tables through the runner, kernel and plain version in turns,
     timed with CUDA events; then one epoch from init_mf's tables at dims
     64 and 8 on the diagonal and the wavefront walk in turns (diagonal,
     wavefront, wavefront, diagonal) and at dim 128 on its routed walk
     (the diagonal walk, twice), the same diagonal walk composed of cuBLAS
     batched products as a yardstick, the walk's plan, clusters and cells
     in flight, and the walk's clocks per cell and block by phase at dims
     64 and 8 from a diagnostic build (``-DTMF_WALK_CLOCKS``);
  4. the gen-1 path: the same run with ``use_dense=False`` (``--no-dense``):
     the gen-1 kernel must carry every epoch and the dense kernel none, and
     tRMSE must fall; then its epochs timed as in phase 3 on that run's
     runner and plans (on the walk ``cell_sgd.cu``'s route picks); then
     epoch 1's plan through the plain version once and on the grid and the
     tile walk in turns (grid, tile, tile, grid), each held to the plain
     version, with the tile walk's units, windows, critical path and
     route, and its clocks per window step by phase (a
     ``-DTMF_TILE_CLOCKS`` build); then epoch 1's plan on the grid walk in
     turns with the same plan at every weight 0 (the grid walk's
     skeleton), us per window step;
  5. the {result}_3 checkpoint written, read back and checked;
  6. the rank-8 path with dense on: ``train_mf`` at dim 8, 3 epochs: the
     lane-packed runner must carry epochs 1-2 and dense epoch 3;
  7. the rank-8 ladder: ``train_mf`` at dim 8 with ``use_dense=False``, 11
     epochs: the packed runner, then at least one slot runner, must carry
     epochs (launches counted per runner family), and tRMSE must fall;
  8. the packed and slot window plans against the plain version on the
     card at the geometry phase 7's schedule picked (tiles, batch, every
     slot sub, plain and striped), on 6x6 tiles at ML-10M density, both
     working types, at 8/8 groups and at an eta whose windows span 2+
     columns;
  9. phase 7's run replayed with the plain version: the schedule that run
     built (its runners and plans, kept from ``_mf_runner_schedule``) from
     the same initial tables, the packed phase's epochs on the kernel
     (phase 10 holds its first against the plain version) and every slot
     epoch through ``cell_epoch_reference``, with handovers through
     trim/pad; the final tables must agree with train_mf's, each table's
     difference must be small beside how far training moved it, and the
     tRMSE must agree;
 10. one full epoch of each phase of that schedule (packed at epoch 1,
     each slot phase at its first epoch) from the same initial tables,
     timed with CUDA events: the packed and the first slot phase plain
     version, kernel, kernel, held to each other as in phase 9; the later
     slot phases kernel, kernel (phase 9 holds their epochs);
 11. the two SGLD kernels, each on both walks (the tile walk and the grid
     walk), against their plain versions on the card, both working types,
     at temp 0 and temp 1 (the same normals or ring on both sides), stamps
     equal as integers: one gen-1 round at dim 128 on 6x6 tiles of 512x512
     at ML-10M density, and slot rounds at dim 8 on 6x6 tiles of
     1024x1024 (plain plans at noise_every 8, striped at 1 and 8); each
     plan's units, critical path and route;
 12. the DP-SGLD main path: ``tpu_mf_torch.train.train_dpmf`` on ``cuda``,
     3 rounds at dim 128 (the reference default), temp 1,
     eta = SCAL_DP / ntrain, hyperb 1000: the gen-1 SGLD runner must carry
     every round, each on the walk the route picks, RMSE and tRMSE must be
     finite, tRMSE below the initial tables'; then the plans' units,
     critical paths and routes, and one round from the initial state:
     the plain version, then the grid and the tile walk in turns (grid,
     tile, tile, grid) at temp 1 (each held to max_abs_err), both walks and
     the plain version at temp 0 (held as in phase 9), timed with CUDA
     events; the tile walk's clocks per window step by phase (a
     ``-DTMF_TILE_CLOCKS`` build);
 13. the same at dim 8: the striped slot SGLD runner every round;
 14. phase 12's state written as the dpmf checkpoint {result}_3, read back
     with ``load_dpmf_binary`` and checked;
 15. both AdaptReg plan families, on the tile walk, against the plain
     version on the card, one whole segmented epoch each (segments and
     hypergradient steps, the same validation draws on both sides), both
     working types, losses 0 and 1, on 6x6 tiles at ML-10M density: gen-1
     plans at dim 128, tiles 512, batch 4096 (8/8 groups; also a negative
     decay base), striped slot plans at dim 8, tile 1024 (8/8 and windows
     of 2+ columns); each plan's units, critical path and route;
 16. the AdaptReg main path: ``tpu_mf_torch.train.train_admf`` on ``cuda``,
     3 epochs at dim 128 (the CLI default) on the stand-in's train split
     less a 5% validation split (``bench.py:261-270``: lam 0.05, eta 0.002,
     eta_reg 0.01): the gen-1 AdaptReg runner must carry every epoch, 8
     launches each on the walk the route picks, tRMSE must be finite and
     fall, the lambdas stay >= 0 and move; eta times the plans' per-column
     duplicate maxima; the plans' units, critical paths and routes; then
     one epoch from the initial state, the plain version, then the tile
     walk twice, with the same validation draws, each held to the plain
     version; then the segments alone, the tile walk twice and the plain
     version once, timed with CUDA events, and the tile walk's clocks per
     window step by phase;
 17. the same at dim 8 with the striped slot AdaptReg runner, 4 launches an
     epoch, at eta = min(0.002, 0.18 / the slot gate's duplicate counts);
 18. phase 16's state written as the {result}_3 checkpoint (the reference
     MF binary with lam_u), read back and checked;
 19. the mega runner's window plans and the free-column kernel against
     their plain versions on the card, both working types, on 6x6 tiles at
     ML-10M density: mega at pack 1 (dim 64, tiles 512, mxu_pred on) and
     pack 8 (dim 8, tiles 1024), each padded with all-sentinel batches, at
     8/8 groups and at an eta whose windows span 2+ columns; free on its
     tile walk at dim 64, tiles 128, groups 8/8, 1/1, 8/1 and 4/2,
     saturation on and off, on a plan whose last batch has sentinel
     columns, with the plan's units, critical path and route;
 20. the mega path: ``MegaEpochRunner`` on the stand-in at dim 64 (pack 1,
     two plans, saturating, bf16), pad, 3 epochs from ``init_mf``'s tables
     at the CLI defaults' eta, trim: the runner's and ``cell_epoch``'s
     launches must rise by one every epoch and no other kernel's, tRMSE
     must fall; then epoch 1 from the same tables, plain version, kernel,
     kernel, timed with CUDA events and held as in phase 9, then on both
     walks of ``cell_sgd.cu`` in turns as in phase 4;
 21. the free-column path the same way: ``FreeEpochRunner`` at dim 64 (its
     default balance, saturation and picked batch), counted on
     ``FreeEpochRunner.launches`` and ``free_epoch.launches``; the plans'
     units, critical paths and cluster sizes; then epoch 1 from the same
     tables, the plain version once and the tile walk twice, timed with
     CUDA events and each held to the plain version; the tile walk at
     clusters of 1, 2, 4 and 8 blocks in turns; its clocks per
     window step by phase (a ``-DTMF_TILE_CLOCKS`` build); then the same
     epoch once more as the one-user-tile window plan on ``cell_sgd.cu``,
     timed and held to the plain version, with ``--yardsticks`` only (no
     route takes that plan);
 22. the item-sharded runner (``PhiShardedRunner``) against its plain
     version on the card at the Yahoo stand-in's geometry (tiles 4096x2040,
     batch 4096, dim 128) on 2x4 tiles at its density, two item tiles a
     shard (K = 2), both working types, 8/8 groups and eta 0.02's groups;
 23. the item-sharded path at the Yahoo stand-in (``bench.py:315``: nu
     1,000,990, nv 624,961, 20M ratings of the ML-10M calibration, seed
     11, split 90/10), dim 128, the CLI defaults: ``train_mf`` on
     ``cuda``, 3 epochs: ``PhiShardedRunner`` every epoch, K ``cell_sgd``
     launches each, tRMSE falling; its plan build, each epoch and eval
     timed with CUDA events, updates/s and the run's peak device memory;
     then, on that run's runner and plans, shard 0's sub-epoch of epoch 1
     through the plain version and the kernel (twice), timed and held as
     in phase 9, and at each grouping of ``Y_GROUPS`` through the plain
     version once and on the grid and the tile walk in turns, each held to
     the plain version, with the tile walk's clocks at 8/8 and 4/4;
 24. ``--resume`` through the CLI (``tpu_mf_torch.cli.main``) at phase 3's
     configuration: the stand-in written as raw text (once a run, shared
     with phases 26-28), 2 epochs with ``--result --resume``, then
     ``--iter 3 --measure 1``, which must resume round 2, run epoch 3
     alone and print the ranking line; its tables and tRMSE held to phase
     3's uninterrupted run;
 25. ``train_mf`` with bfloat16 tables (``dtype="bfloat16"``) at phase 3's
     configuration: dense every epoch, tRMSE finite and falling, printed
     beside phase 3's float32 run;
 26. the streamed path: ``--alg mf --stream`` through the CLI on the raw
     text, dim 64, 3 epochs, batch 8192: ``FusedStreamTrainer``, one
     ``cell_sgd`` launch a shard and epoch, tRMSE falling; the ShardStore,
     per epoch the plan build or cache load, upload and kernel times, wall
     time and tRMSE, peak device memory; epoch 1's launch held against
     the plain version on the card (``stream`` in the JSON line);
 27. ``FusedStreamTrainer`` at 4 shards (``mem_limit`` 2,500,000), one
     epoch: its wall time beside the sums of plan builds, uploads and
     kernels (how much the Prefetcher overlaps);
 28. ``--alg dpmf --stream`` and ``--alg admf --stream`` through the CLI,
     one round / epoch each at dim 128 (the per-batch path), beside one
     parse-only pass over the file;
 29. ``--measure 1``'s ranking metrics on phase 3's model, timed, and
     ``recommend_topk`` for 1,024 users against float64 on the CPU;
 30. the rating-set SSE of ``calc_mse`` (``csrc/rating_sse.cu``) at dim
     128 on views of fused tables, as the loops evaluate: the DP-SGLD train
     set (9M ratings), the ML-10M test set (1M) and a Yahoo-shape test set
     (2M): one launch timed with CUDA events beside its bound, ``calc_mse``
     on the host clock, the plain version (chunks of 2^20) timed and each
     side's device memory above the tables; the kernel held to the plain
     version (float32 and bf16 tables) and two launches to the same bits.

Every run of ``train_mf``, ``train_dpmf`` and ``train_admf`` above also
reads the launch count of ``csrc/rating_sse.cu`` at each epoch's or round's
log line: one launch an epoch's test RMSE, two a DP-SGLD round (its train
MSE and test RMSE), or the phase fails.

Each phase group prints its seconds. The last lines are the kernels' JSON
summary (time, launches on the main path, bound; for ``rating_sse`` the
time and bound of the DP-SGLD train set and the launches of phase 12's
rounds; for the SGLD kernels the walk the main path took, whose time and
error the line gives; for ``phi_shard``, ``cell_sgd.cu`` on the item-sharded
path, the time, error and bound of one sub-epoch, shard 0 of epoch 1, and
the shard count; for ``stream``, ``cell_sgd.cu`` on the streamed path, the
same of epoch 1's first launch), the card's name and power limit, and
{"ok": true, "device": {...}}. Imports nothing of JAX or
of tpu_mf. Plans are built anew (``TPU_MF_PLAN_CACHE=0``): nothing is
written outside the checkout.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

DEVICE = "cuda"
N_USERS, N_ITEMS, N_RATINGS = 69_878, 10_677, 10_000_000
DIM, EPOCHS = 64, 3
# the rank-8 runs: dense on (packed, then dense from epoch 3), and the
# --no-dense ladder, long enough for the slot envelope to clear
DIM8, LADDER_EPOCHS = 8, 11
# tolerances of the kernel against its plain version (phase 2):
#   float32: the same f32 products summed in another order;
#   bfloat16: the two sides round E to bf16 from f32 values that may differ
#   in the last bit; a flipped element moves a row by eta * 2^-8 * |E| * |x|.
ATOL = {"float32": 1e-4, "bfloat16": 2e-3}
# phase 3: one full ML-10M-shape epoch from the same tables, bf16 working
# type; the per-element bound above accumulated over a row's 42 cells
ATOL_FULL = 2e-2
# gen-1 kernel against its plain version (phase 2): the same reasons, with
# atomics summing the deltas of a window in no fixed order
ATOL_CELL = {"float32": 1e-4, "bfloat16": 2e-3}
# phase 4: 3 full ML-10M-shape gen-1 epochs, bf16: the per-element bound
# above, carried by later updates of the same rows (as ATOL_FULL)
ATOL_CELL_FULL = 2e-2
# packed and slot window plans on the same kernel (phase 8): the gen-1
# reasons and tolerances
ATOL_LADDER = ATOL_CELL
# phase 10: one full ML-10M-shape epoch from init_mf's tables, bf16; the
# readings were 1.6e-4 to 1.2e-3 (PERF.md), and one epoch at the ladder's
# etas moves a factor lane by about 3e-3, so the element bound alone cannot
# tell a wrong update: REL_FULL does
ATOL_LADDER_FULL = 5e-3
# phase 9: 11 full epochs of the ladder, bf16, the per-element bound carried
# by later updates of the same rows (as ATOL_CELL_FULL)
ATOL_LADDER_REPLAY = ATOL_CELL_FULL
# phases 9 and 10, per table: ||kernel - plain|| / ||plain - init||, the two
# sides' distance beside how far the epochs moved the table; an update that
# is skipped gives 1, one of the wrong sign 2, and an eta 10% off 0.1; the
# readings were 2e-5 to 1e-3 (PERF.md)
REL_FULL = 1e-2
# the SGLD kernels against their plain versions (phases 11-13): the
# window-plan reasons and tolerances (both sides draw the same normals)
ATOL_SGLD = ATOL_CELL
# phases 12-13: one full ML-10M-shape round, bf16, the per-element bound
# carried by later updates of the same rows (as ATOL_CELL_FULL)
ATOL_SGLD_FULL = ATOL_CELL_FULL
# the DP-SGLD runs: the reference's default dim and a rank-8 run
DIM_DP, DIM_DP8, ROUNDS = 128, 8, 3
# their step scal = eta * ntrain * bound * lambda_r at lambda_r = 1 (bound 1).
# A gen-1 window is one column, and a row repeated k times in it takes k
# steps from the same point: the stand-in's columns repeat a user up to 149
# times (items 108), so scal * 149 must stay near 0.2 or the biases
# overshoot and the round diverges (scal = 0.05 gave NaN in round 1)
SCAL_DP = 1e-3
# the AdaptReg runs: the CLI's default rank (gen-1 AdaptReg runner) and a
# rank-8 run (striped slot runner), at bench.py:262-270's lam, eta, eta_reg
DIM_AD, DIM_AD8, AD_EPOCHS = 128, 8, 3
LAM_AD, ETA_AD, ETA_REG_AD = 0.05, 0.002, 0.01
# the AdaptReg kernels against their plain versions (phases 15-17): the
# lambdas' hypergradient reads rows that differ by the window-plan
# tolerances above, so the two sides' lambdas agree to a small share of
# how far the epoch moved them
LAM_REL = 1e-2
KERNELS = ("dense_cell", "cell_sgd", "sgld_cells", "adreg_cells",
           "free_cells", "rating_sse")
# phase 30: the rating-set SSE against its plain version: both take each
# product in the storage type and sum the dot product and residual in
# float32, in different orders; the plain version sums each chunk's squared
# errors in float32 (tests/test_torch_cuda.py: SSE_RTOL)
SSE_RTOL = 5e-6
# the two walks of csrc/cell_sgd.cu and csrc/sgld_cells.cu
# (tpu_mf_torch/ops/tile_walk.py: WALKS)
WALKS = ("tile", "grid")
# the free-column kernel's groups in phase 19 (user/item): one column a
# window, whole batches, and windows of unequal widths
FREE_GROUPS = ((8, 8), (1, 1), (8, 1), (4, 2))
# the free tile walk's cluster sizes timed in phase 21
# (tpu_mf_torch/ops/tile_walk.py: FREE_CLUSTERS), in turns
FREE_PROBE = (1, 2, 4, 8, 8, 4, 2, 1)
# phase 27: the ShardStore's ratings a shard, which cuts the stand-in's 9M
# training ratings into 4 shards
STREAM_MEM_LIMIT, STREAM_SHARDS = 2_500_000, 4
# the card's published peaks (H100 SXM data sheet, at 700 W): memory bytes/s,
# bf16 tensor-core and float32 CUDA-core operations/s
HBM_BYTES_S, PEAK_BF16, PEAK_F32 = 3.35e12, 989e12, 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, ops: float, peak: float):
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def dense_bound(cells, dim):
    """A dense epoch reads S, W and the row counts once and every table row
    once, and writes the rows once; per stored cell element it does the
    pred, dtheta and dphi products over dim + 2 lanes (bf16 tensor cores)."""
    n_gu, n_gvp, tu, tv = cells.s.shape
    elems = n_gu * n_gvp * tu * tv
    nbytes = (elems * (cells.s.element_size() + cells.w.element_size())
              + 4 * (cells.ku.numel() + cells.kv.numel())
              + 2 * 4 * (n_gu * tu + n_gvp * tv) * (dim + 3))
    return bound(nbytes, 6 * elems * (dim + 2), PEAK_BF16)


def window_bytes(plan, rows_u, rows_v, n_real, dim):
    """A window-plan epoch reads each real rating once (u, v, r: 12 bytes;
    padded slots and the weight stream are the plan's layout, not the
    work), the per-batch tiles and apply flags, and every table row once,
    and writes the rows once."""
    return (12 * n_real + 4 * (plan.gu.numel() + 2 * plan.gv.numel())
            + 2 * 4 * (rows_u + rows_v) * (dim + 3))


def window_bound(plan, rows_u, rows_v, n_real, dim):
    """``window_bytes``, and per real rating a dim + 2 lane dot product and
    two dim + 2 lane scaled adds (float32 CUDA cores)."""
    return bound(window_bytes(plan, rows_u, rows_v, n_real, dim),
                 6 * n_real * (dim + 2), PEAK_F32)


def touched_rows(plan):
    """(user rows, item rows) that a window plan's real slots touch: the
    rows its epoch must read and write where the plan covers only part of
    its tables, as an item shard's sub-epoch does."""
    import torch

    real = plan.w > 0
    gu = plan.gu.long()[:, None, None] * plan.tile_u + plan.u
    gv = plan.gv.long()[:, :, None] * plan.tile_v + plan.v
    return tuple(int(torch.unique(g[real]).numel()) for g in (gu, gv))


def free_bound(plan, rows_u, rows_v, n_real, dim):
    """``window_bound`` over a free-column plan: each column names its own
    user tile and item tile (``gu`` and ``gv`` are both (NB, 8)) and carries
    an apply flag for each side, so the plan's per-column bytes are four
    int32s where a gen-1 plan's are two and a quarter."""
    return bound(window_bytes(plan, rows_u, rows_v, n_real, dim)
                 + 4 * plan.gv.numel(), 6 * n_real * (dim + 2), PEAK_F32)


def sgld_bound(runner, plan, n_real, dim, slot):
    """A window-plan round's bytes and operations (``window_bound``), plus
    each table row's stamp (8 bytes) and inverse frequency (4) read once
    and the stamp written once, and the noise and the decay: one normal
    per kept lane (dim + 1) of each row a noise injection touches (two hash
    words of two finalizer rounds and Box-Muller, counted as 25
    operations) and a log and an exp per kept lane of each row an apply
    decays (4 operations). Rows are counted from this plan's real slots:
    per batch (slot mode; noise on the noise batches) or per batch for the
    noise and per column for the decay (gen-1 mode)."""
    import torch

    cp = plan.cells
    p = runner.plan
    rows_u, rows_v = p.n_gu * p.tile_u, p.n_gv * p.tile_v
    nb = cp.u.shape[0]
    real = cp.w > 0
    dev = cp.u.device
    b = torch.arange(nb, device=dev)[:, None, None].expand_as(real)
    col = b * 8 + torch.arange(8, device=dev)[None, :, None]
    gu = cp.gu.long()[:, None, None] * p.tile_u + cp.u
    gv = cp.gv.long()[:, :, None] * p.tile_v + cp.v
    total = rows_u + rows_v

    def distinct(window, mask):
        keys = torch.cat([(window * total + gu)[mask],
                          (window * total + rows_u + gv)[mask]])
        return int(torch.unique(keys).numel())

    if slot:
        ne = runner.noise_every
        noise = distinct(b, real & (b % ne == ne - 1))
        decay = distinct(b, real)
    else:
        noise, decay = distinct(b, real), distinct(col, real)
    nbytes = (window_bytes(cp, rows_u, rows_v, n_real, dim)
              + (16 + 4) * total)
    ops = (6 * n_real * (dim + 2) + 25 * (dim + 1) * noise
           + 4 * (dim + 1) * decay)
    return bound(nbytes, ops, PEAK_F32)


def adreg_bound(runner, plan, n_real, dim, eta):
    """An AdaptReg epoch's segments: bytes and operations as
    ``window_bound``, plus per row an apply decays the decay's multiply and
    the delta's add on each kept lane (dim + 1) and the two powers of its
    side's bases (an exp each: 2 (dim + 1) + 4 operations), the rows counted
    once per theta / phi window of the groups the runner picks at ``eta``,
    from this plan's real slots. The bases' logs (once per launch) and the
    hypergradient steps between segments are left out."""
    import torch

    p = runner.plan
    rows_u, rows_v = p.n_gu * p.tile_u, p.n_gv * p.tile_v
    tg_w = 8 // runner.pick_theta_groups(eta)
    pg_w = 8 // runner.pick_phi_groups(eta)
    nb = plan.u.shape[0]
    real = plan.w > 0
    dev = plan.u.device
    col = (torch.arange(nb, device=dev)[:, None, None] * 8
           + torch.arange(8, device=dev)[None, :, None])
    gu = plan.gu.long()[:, None, None] * p.tile_u + plan.u
    gv = plan.gv.long()[:, :, None] * p.tile_v + plan.v
    decay = (int(torch.unique((col // tg_w * rows_u + gu)[real]).numel())
             + int(torch.unique((col // pg_w * rows_v + gv)[real]).numel()))
    ops = 6 * n_real * (dim + 2) + (2 * (dim + 1) + 4) * decay
    return bound(window_bytes(plan, rows_u, rows_v, n_real, dim), ops,
                 PEAK_F32)


def calibrated_ml10m(seed: int = 0):
    """The ML-10M-shape stand-in of bench.py (Zipf-Mandelbrot marginals
    matched to the real dataset; benchmarks/ML10M_STUDY.md)."""
    from tpu_mf_torch.data.coo import synthetic_ratings

    return synthetic_ratings(
        N_USERS, N_ITEMS, N_RATINGS, rank=8, seed=seed,
        noise=0.76, signal=1.0, bias_std=0.38,
        zipf=1.0, zipf_q=50.0, zipf_u=1.0, zipf_uq=250.0,
    )


def phase_build():
    from tpu_mf_torch.ops import _build

    t = time.perf_counter()
    _build.build_all(KERNELS)
    log(f"# phase 1: built {', '.join(KERNELS)} in "
        f"{time.perf_counter() - t:.1f} s")
    for name in KERNELS:
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"#   ptxas {name}: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"# card: {card}")
    return card


def corner(rng, tu, tv):
    """Uniform ratings on 6x6 tiles of tu x tv at ML-10M density, and
    random tables at dim 64."""
    from tpu_mf_torch.data.coo import RatingsCOO

    nu, nv = 6 * tu, 6 * tv
    n = int(nu * nv * N_RATINGS / (N_USERS * N_ITEMS))
    ds = RatingsCOO(u=rng.integers(0, nu, n), v=rng.integers(0, nv, n),
                    r=rng.uniform(0.5, 5.0, n), nu=nu, nv=nv)
    return ds, n


def tables(rng, ds, dim):
    return [rng.normal(0, 0.1, s).astype("float32")
            for s in ((ds.nu, dim), (ds.nv, dim), (ds.nu,), (ds.nv,))]


def phase_compare(torch, td, rng):
    """Dense kernel vs plain version, one epoch on 6x6 cells of 256x256:
    the diagonal walk at dim 64 in both working types, the wavefront walk
    (bf16) at dims 8 and 64, and the routed walk (bf16) at dims 128 and 300
    (rows of 2 and 3 lane groups, too wide for the wavefront walk: the
    diagonal walk). Returns the largest error per (walk, working type)."""
    from tpu_mf_torch.models.mf import params_from_numpy

    ds, n = corner(rng, 256, 256)
    eta, lam, gb = 0.02, 5e-3, 3.5
    errs = {}
    cases = [("diagonal", "float32", DIM), ("diagonal", "bfloat16", DIM)] + [
        ("wavefront", "bfloat16", d) for d in (8, DIM)] + [
        (None, "bfloat16", d) for d in (128, 300)]
    runners = {}
    for walk, mxu, dim in cases:
        if mxu not in runners:
            runners[mxu] = td.DenseEpochRunner(ds, tile_u=256, tile_v=256,
                                               k_cells=6, mxu=mxu,
                                               device=DEVICE)
        r = runners[mxu]
        walk = walk or td.dense_route(256, 256, dim, r.work_dtype,
                                      r.cells.w.dtype)
        tabs = tables(rng, ds, dim)
        got = r.pad(params_from_numpy(*tabs, gb, device=DEVICE))
        want = tuple(t.clone() for t in got)
        td.dense_epoch_reference(*want, r.cells, eta, lam, gb,
                                 max(1.0, 0.2 / eta), dim)
        td.dense_epoch(*got, r.cells, eta, lam, gb, max(1.0, 0.2 / eta), dim,
                       walk=walk)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        errs[walk, mxu] = max(errs.get((walk, mxu), 0.0), err)
        plan = td.plan_dense_walk(256, 256, dim, r.work_dtype,
                                  r.cells.w.dtype)
        log(f"# phase 2: dense_cell {walk} walk vs plain, {mxu}, 6x6 cells "
            f"of 256x256, dim {dim} (wavefront plan {plan}), {n} ratings: "
            f"max_abs_err {err:.3e} (atol {ATOL[mxu]:g})")
        if not err <= ATOL[mxu]:
            raise AssertionError(f"dense_cell {walk} disagrees ({mxu}, dim "
                                 f"{dim}): {err}")
    return errs


def compare_window_runner(torch, tc, make, ds, tabs, dim, name, what, atol,
                          phase):
    """A window-plan runner's kernel vs the plain version, one epoch per
    working type, at 8/8 groups (an eta past every wider window's envelope)
    and at the eta whose windows span 4 or more columns on both sides;
    returns the largest error per working type."""
    from tpu_mf_torch.models.mf import params_from_numpy

    lam, gb = 5e-3, 3.5
    errs = {}
    for mxu in ("float32", "bfloat16"):
        r = make(mxu)
        r.pad(params_from_numpy(*tabs, gb, device=DEVICE))
        seq = max(0.05, 1.01 * 0.2 / min(r._dup_max[4], r._vdup_max[4]))
        for eta in (seq, 0.2 / max(r._dup_max[2], r._vdup_max[2])):
            with warnings.catch_warnings():  # seq is past the envelope
                warnings.simplefilter("ignore")
                tg, pg = r.pick_theta_groups(eta), r.pick_phi_groups(eta)
            got = r.pad(params_from_numpy(*tabs, gb, device=DEVICE))
            want = tuple(t.clone() for t in got)
            tc.cell_epoch_reference(*want, r._dev[0], eta, lam, gb,
                                    max(1.0, 0.2 / eta), dim, tg, pg,
                                    r.work_dtype, True, r.mxu_pred)
            r.epoch(got, eta, lam, gb)
            torch.cuda.synchronize()
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            errs[mxu] = max(errs.get(mxu, 0.0), err)
            log(f"# phase {phase}: {name} vs plain, {mxu}, groups {tg}/{pg} "
                f"(eta {eta:.3g}), {what}, {r.plan.u.shape[0]} batches, dim "
                f"{dim}, {len(ds)} ratings: max_abs_err {err:.3e} "
                f"(atol {atol[mxu]:g})")
            if not err <= atol[mxu]:
                raise AssertionError(f"{name} disagrees ({mxu}): {err}")
    return errs


def phase_compare_cells(torch, tc, rng, geometry):
    """Gen-1 kernel vs plain version, one epoch at the gen-1 path's geometry
    on 6x6 tiles at ML-10M density, saturating."""
    tu, tv, batch = geometry
    ds, _ = corner(rng, tu, tv)
    return compare_window_runner(
        torch, tc, lambda mxu: tc.CellEpochRunner(
            ds, tile_u=tu, tile_v=tv, batch=batch, mxu=mxu, saturate=True,
            device=DEVICE),
        ds, tables(rng, ds, DIM), DIM, "cell_sgd",
        f"batch {batch} at tiles {tu}x{tv}", ATOL_CELL, 2)


def load_data():
    t = time.perf_counter()
    ds = calibrated_ml10m()
    train, test = ds.split(0.1, seed=1)
    log(f"# data: {len(train)} train / {len(test)} test ratings in "
        f"{time.perf_counter() - t:.1f} s")
    return train, test


def counters():
    """Launch counts: the dense kernel's wrapper, and the window-plan
    kernel's per runner family (``cell_epoch.launches`` sums them)."""
    from tpu_mf_torch.ops import sgd_cells as tc
    from tpu_mf_torch.ops import sgd_dense as td
    from tpu_mf_torch.ops import sgd_packed as tpk
    from tpu_mf_torch.ops import sgd_slot as tsl

    return {"dense_cell": td.dense_epoch, "cell_sgd": tc.CellEpochRunner,
            "packed": tpk.PackedEpochRunner, "slot": tsl.SlotEpochRunner}


@contextlib.contextmanager
def keep_built(torch, name="_mf_runner_schedule", timed=None):
    """For the ``with`` block, keep what ``train.loop.<name>`` builds for
    the main path (``_mf_runner_schedule``'s schedule, ``_dpmf_runner``'s
    or ``_admf_runner``'s runner) in the yielded list, each beside the
    seconds its build took, so that later phases run on the main path's
    own runners and plans. With a ``timed`` list, each epoch of a kept
    schedule's runners also appends (runner, start, end), CUDA events
    recorded around it. Launches and counts are untouched."""
    from tpu_mf_torch.train import loop

    build, kept, wrapped = getattr(loop, name), [], []

    def timed_epoch(runner, epoch):
        def run(*args, **kwargs):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            out = epoch(*args, **kwargs)
            b.record()
            timed.append((runner, a, b))
            return out
        return run

    def keep(*args, **kwargs):
        t = time.perf_counter()
        out = build(*args, **kwargs)
        kept.append((out, time.perf_counter() - t))
        if timed is not None:
            for _, runner in out:
                runner.epoch = timed_epoch(runner, runner.epoch)
                wrapped.append(runner)
        return out

    setattr(loop, name, keep)
    try:
        yield kept
    finally:
        setattr(loop, name, build)
        for runner in wrapped:
            del runner.epoch


def run_main_path(torch, train, test, phase, dim, iters, use_dense,
                  on_line=None, **opts):
    """train_mf on cuda with every kernel count set to 0 just before; the
    per-epoch launch counts of every kernel read just after. ``on_line``
    sees each line the run logs; ``opts`` are further TrainConfig
    fields."""
    from tpu_mf_torch.config import TrainConfig
    from tpu_mf_torch.ops import sgd_cells as tc
    from tpu_mf_torch.ops.phi_shard import PhiShardedRunner
    from tpu_mf_torch.ops.rating_sse import rating_sse
    from tpu_mf_torch.train import train_mf

    cfg = TrainConfig(dim=dim, iters=iters, gb=train.mean_rating(),
                      use_dense=use_dense, **opts)
    counts = counters()
    lines, marks, sse = [], [], []

    def record(line):
        lines.append(line)
        log(line)
        if line.startswith("iter#"):
            marks.append({k: c.launches for k, c in counts.items()})
            sse.append(rating_sse.launches)
        if on_line is not None:
            on_line(line)

    for c in list(counts.values()) + [tc.cell_epoch, PhiShardedRunner,
                                      rating_sse]:
        c.launches = 0
    walks = counts["dense_cell"].walks
    for k in walks:
        walks[k] = 0
    t = time.perf_counter()
    params = train_mf(cfg, train, test, log=record, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    per_epoch = {k: [b[k] - a[k] for a, b in zip([dict.fromkeys(counts, 0)]
                                                 + marks, marks)]
                 for k in counts}
    if sum(map(sum, per_epoch.values())) != tc.cell_epoch.launches + sum(
            per_epoch["dense_cell"]):
        raise AssertionError("a window-plan launch outside the runners")
    log(f"# phase {phase}: train_mf(dim={dim}, use_dense={use_dense}"
        f"{''.join(f', {k}={v!r}' for k, v in opts.items())}) on "
        f"cuda, {iters} epochs in {wall:.1f} s (set-up included); launches "
        f"per epoch " + ", ".join(f"{k} {v}" for k, v in per_epoch.items())
        + f"; dense_cell launches by walk {walks}")
    if walks["wavefront"] + walks["diagonal"] != sum(per_epoch["dense_cell"]):
        raise AssertionError("a dense launch outside the two walks")
    log(f"# phase {phase}: rating_sse launches per epoch "
        f"{sse_evals(sse, 1, f'phase {phase}')}")
    rm = [float(x.split("tRMSE=")[1]) for x in lines if "tRMSE=" in x]
    if not (len(rm) == iters and all(map(math.isfinite, rm))
            and rm[-1] < rm[0]):
        raise AssertionError(f"tRMSE not finite and falling: {rm}")
    return cfg, params, rm, lines, per_epoch


def only(per_epoch, kernel, epochs, per=1):
    """The kernel launched exactly ``per`` times in each of ``epochs``
    (1-based) and in no other; returns its launches."""
    got = per_epoch[kernel]
    want = [per * int(i + 1 in epochs) for i in range(len(got))]
    if got != want:
        raise AssertionError(f"{kernel} launches per epoch {got}, want {want}")
    return sum(got)


def sse_evals(marks, per, what):
    """``csrc/rating_sse.cu``'s launches in each epoch or round of a main-path
    run, from its wrapper's count (set to 0 just before the run) read at each
    epoch's or round's log line: ``per`` in each, one a test RMSE and one a
    DP-SGLD round's train MSE. Returns them."""
    got = [b - a for a, b in zip([0] + marks, marks)]
    if not got or got != [per] * len(got):
        raise AssertionError(f"{what}: rating_sse launches per epoch or round "
                             f"{got}, want {per} each")
    return got


def phase_train(torch, train, test):
    cfg, params, rm, lines, per_epoch = run_main_path(
        torch, train, test, 3, DIM, EPOCHS, True)
    if not any(x.startswith("# dense-cell kernel from epoch 1") for x in lines):
        raise AssertionError("the dense runner did not carry epoch 1")
    launches = only(per_epoch, "dense_cell", range(1, EPOCHS + 1))
    from tpu_mf_torch.ops.sgd_dense import dense_epoch

    if dense_epoch.walks["wavefront"] != launches:
        raise AssertionError(f"the main path's dense epochs did not all run "
                             f"on the wavefront walk: {dense_epoch.walks}")
    return cfg, params, rm, launches


def phase_train_cells(torch, train, test):
    """--no-dense at dim 64: gen-1 every epoch; returns the run's config,
    final tables, tRMSEs and launches, its runner and the seconds its
    schedule took to build."""
    with keep_built(torch) as kept:
        cfg, params, rm, lines, per_epoch = run_main_path(
            torch, train, test, 4, DIM, EPOCHS, False)
    if not any(x.startswith(f"# gen-1 cell kernel: epochs 1..{EPOCHS}")
               for x in lines):
        raise AssertionError("the gen-1 runner did not carry the epochs")
    launches = only(per_epoch, "cell_sgd", range(1, EPOCHS + 1))
    only(per_epoch, "dense_cell", ())
    ((_, runner),), built = kept[0]
    return cfg, params, rm, launches, runner, built


def phase_train_rank8(torch, train, test):
    """Dense on at dim 8: packed carries epochs 1-2, dense from epoch 3."""
    _, _, _, lines, per_epoch = run_main_path(torch, train, test, 6, DIM8,
                                              EPOCHS, True)
    if "# epoch 3: switching to DenseEpochRunner" not in lines:
        raise AssertionError("dense did not take over at epoch 3")
    only(per_epoch, "packed", (1, 2))
    only(per_epoch, "dense_cell", (3,))
    only(per_epoch, "slot", ())
    only(per_epoch, "cell_sgd", ())


def phase_train_ladder(torch, train, test):
    """--no-dense at dim 8: packed until the slot envelope clears, then the
    slot phases; returns the run's config, final tables and tRMSEs, the
    schedule's packed and slot geometries, the launches of each family and
    the schedule the run built."""
    with keep_built(torch) as kept:
        cfg, params, rm, lines, per_epoch = run_main_path(
            torch, train, test, 7, DIM8, LADDER_EPOCHS, False)
    packed = re.search(r"# lane-packed kernel: epochs 1\.\.(\d+), tiles "
                       r"(\d+)x(\d+), batch (\d+)", "\n".join(lines))
    slots = re.findall(r"# slot kernel( \(striped\))?: epochs (\d+)\.\.(\d+), "
                       r"sub (\d+), tiles (\d+)x(\d+)", "\n".join(lines))
    if packed is None or not slots:
        raise AssertionError("the schedule has no packed or no slot phase")
    first_slot = int(slots[0][1])
    only(per_epoch, "packed", range(1, first_slot))
    only(per_epoch, "slot", range(first_slot, LADDER_EPOCHS + 1))
    only(per_epoch, "dense_cell", ())
    only(per_epoch, "cell_sgd", ())
    geo_packed = tuple(int(x) for x in packed.groups()[1:])
    geo_slots = sorted({(int(sub), bool(st), int(tu), int(tv), int(ep))
                        for st, ep, _, sub, tu, tv in slots})
    return (cfg, params, rm, geo_packed, geo_slots, sum(per_epoch["packed"]),
            sum(per_epoch["slot"]), kept[0][0])


def phase_compare_ladder(torch, tc, tpk, tsl, rng, geo_packed, geo_slots):
    """Packed and slot window plans vs the plain version at the geometry of
    the ladder run, on 6x6 tiles at ML-10M density, saturating."""
    tu, tv, batch = geo_packed
    ds, _ = corner(rng, tu, tv)
    tabs = tables(rng, ds, DIM8)
    errs = {"packed": compare_window_runner(
        torch, tc, lambda mxu: tpk.PackedEpochRunner(
            ds, tile_u=tu, tile_v=tv, batch=batch, dim=DIM8, mxu=mxu,
            saturate=True, device=DEVICE),
        ds, tabs, DIM8, "packed", f"batch {batch} at tiles {tu}x{tv}",
        ATOL_LADDER, 8)}
    errs["slot"] = {}
    for sub, striped, tu, tv, _ in geo_slots:
        e = compare_window_runner(
            torch, tc, lambda mxu: tsl.SlotEpochRunner(
                ds, tile_u=tu, tile_v=tv, sub=sub, dim=DIM8, mxu=mxu,
                balance=True, striped=striped, saturate=True, device=DEVICE),
            ds, tabs, DIM8, "slot",
            f"{'striped' if striped else 'plain'} sub {sub} at tiles "
            f"{tu}x{tv}", ATOL_LADDER, 8)
        for k, v in e.items():
            errs["slot"][k] = max(errs["slot"].get(k, 0.0), v)
    return errs


def time_in_turns(torch, cfg, runner, plain_epoch, train, test,
                  params_final, rm, phase, name, atol):
    """The main path's epochs again from the same initial tables, kernel
    (``runner.epoch``) and plain version (``plain_epoch``) in turns, timed
    with CUDA events; returns the median epoch ms of each."""
    from tpu_mf_torch.models.mf import init_mf, rmse

    init = init_mf(train.nu, train.nv, DIM, cfg.gb,
                   torch.Generator().manual_seed(cfg.seed), DEVICE)
    kern, plain = runner.pad(init), runner.pad(init)
    t_k, t_p, err = [], [], 0.0
    for it in range(1, EPOCHS + 1):
        eta = cfg.eta_at(it)
        for which in (("plain", "kernel") if it % 2 else ("kernel", "plain")):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            if which == "kernel":
                runner.epoch(kern, eta, cfg.lam, cfg.gb, epoch_idx=it)
            else:
                plain_epoch(plain, eta, it)
            b.record()
            torch.cuda.synchronize()
            (t_k if which == "kernel" else t_p).append(a.elapsed_time(b))
        err = max(err, max(float((x - y).abs().max())
                           for x, y in zip(kern, plain)))
    n = len(train)
    for what, ts in ((f"{name} kernel", t_k), ("plain version", t_p)):
        log(f"# phase {phase}: {what}: epoch ms {[round(x, 3) for x in ts]}, "
            f"rating updates/s {[round(n / (x / 1e3)) for x in ts]}")
    # the runner replays train_mf's kernel epochs; atomics sum in no fixed
    # order, so the replay is close, not equal
    same = max(float((x - y).abs().max()) for x, y in
               zip(runner.trim(kern), params_final))
    rm_plain = rmse(runner.trim(plain), test)
    log(f"# phase {phase}: kernel vs plain over {EPOCHS} full epochs: "
        f"max_abs_err {err:.3e} (atol {atol:g}); final tRMSE kernel "
        f"{rm[-1]:.6f} plain {rm_plain:.6f}; replay vs train_mf tables "
        f"{same:.3e}")
    if not (err <= atol and same <= atol and abs(rm_plain - rm[-1]) <= 1e-3):
        raise AssertionError(f"{name} and its plain version disagree at "
                             "full size")
    return median(t_k), median(t_p)


def median(ts):
    return sorted(ts)[len(ts) // 2]


def plain_epoch(tc, runner, tables, eta, lam, gb, it):
    """What ``runner.epoch`` launches at epoch ``it``, through the plain
    version."""
    tc.cell_epoch_reference(
        *tables, runner.materialize()._dev[it % len(runner._dev)], eta, lam,
        gb, max(1.0, 0.2 / eta), runner.dim, runner.pick_theta_groups(eta),
        runner.pick_phi_groups(eta), runner.work_dtype, runner.saturate,
        runner.mxu_pred)


def hold(what, got, want, init, atol, phase):
    """``got`` against ``want`` (MFParams): the largest element difference
    within ``atol``, and per table the norm of the difference within
    REL_FULL of the norm of ``want``'s change from ``init``."""
    names = ("theta", "phi", "bu", "bv")
    err = max(float((a - b).abs().max()) for a, b in zip(got[:4], want[:4]))
    rel = {n: float((a - b).norm() / (b - c).norm())
           for n, a, b, c in zip(names, got, want, init)}
    log(f"# phase {phase}: {what}: max_abs_err {err:.3e} (atol {atol:g}); "
        f"difference / change from init " + ", ".join(
            f"{n} {r:.3e}" for n, r in rel.items()) + f" (limit {REL_FULL:g})")
    if not (err <= atol and all(r <= REL_FULL for r in rel.values())):
        raise AssertionError(f"{what}: the kernel and its plain version "
                             "disagree at full size")
    return err


def phase_replay_ladder(torch, tc, cfg, train, test, params, rm, geo_packed,
                        geo_slots, sched):
    """Phase 7's run replayed from the same initial tables on the schedule
    it built (its runners and plans): the first (packed) phase's epochs on
    the kernel, whose first epoch phase 10 holds against the plain
    version, and the slot phases' epochs and handovers through the plain
    version; returns the initial tables."""
    from tpu_mf_torch.models.mf import init_mf, rmse

    init = init_mf(train.nu, train.nv, cfg.dim, cfg.gb,
                   torch.Generator().manual_seed(cfg.seed), DEVICE)
    (first, runner), *upcoming = sched
    slots = sorted((r.sub, r.striped, r.tile_u, r.tile_v, ep)
                   for ep, r in upcoming)
    if (first, type(runner).__name__, (runner.tile_u, runner.tile_v,
                                       runner.batch), slots) != (
            1, "PackedEpochRunner", geo_packed, geo_slots):
        raise AssertionError("phase 7's schedule is not the one it logged")
    gb = float(init.gb)
    packed = runner
    tables = runner.pad(init)
    ms = []
    for it in range(1, cfg.iters + 1):
        while upcoming and it >= upcoming[0][0]:
            nxt = upcoming.pop(0)[1]
            tables = nxt.pad(runner.trim(tables))
            runner = nxt
        if runner is packed:
            runner.epoch(tables, cfg.eta_at(it), cfg.lam, gb, epoch_idx=it)
            continue
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        plain_epoch(tc, runner, tables, cfg.eta_at(it), cfg.lam, gb, it)
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    final = runner.trim(tables)
    log(f"# phase 9: packed epochs 1..{sched[1][0] - 1} on the kernel; "
        f"plain replay of epochs {sched[1][0]}..{cfg.iters}, ms "
        f"{[round(x, 3) for x in ms]}")
    hold(f"train_mf's tables after {cfg.iters} epochs vs the plain replay",
         params, final, init, ATOL_LADDER_REPLAY, 9)
    rm_plain = rmse(final, test)
    log(f"# phase 9: final tRMSE train_mf {rm[-1]:.6f} plain replay "
        f"{rm_plain:.6f}")
    if not abs(rm_plain - rm[-1]) <= 1e-3:
        raise AssertionError("the ladder's tRMSE and its plain replay's "
                             "disagree")
    return init


def time_one_epoch(torch, tc, cfg, runner, train, test, init, it, name,
                   phase=10, atol=ATOL_LADDER_FULL):
    """One full epoch at epoch ``it``'s eta from the initial tables, plain
    version (``plain_epoch``; once: it takes seconds), kernel, kernel,
    timed with CUDA events and held to each other; returns the median
    epoch ms of each, the bound of the epoch and the plain version's
    tables."""
    from tpu_mf_torch.models.mf import rmse

    eta = cfg.eta_at(it)
    gb = float(init.gb)
    tg, pg = runner.pick_theta_groups(eta), runner.pick_phi_groups(eta)
    plan = runner.materialize()._dev[it % len(runner._dev)]
    times, out = {"kernel": [], "plain": []}, {}
    for which in ("plain", "kernel", "kernel"):
        tabs = runner.pad(init)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        if which == "kernel":
            runner.epoch(tabs, eta, cfg.lam, gb, epoch_idx=it)
        else:
            plain_epoch(tc, runner, tabs, eta, cfg.lam, gb, it)
        b.record()
        torch.cuda.synchronize()
        times[which].append(a.elapsed_time(b))
        out.setdefault(which, runner.trim(tabs))
    n = len(train)
    for what, ts in times.items():
        log(f"# phase {phase}: {name} {what}: epoch ms "
            f"{[round(x, 3) for x in ts]}, rating updates/s "
            f"{[round(n / (x / 1e3)) for x in ts]}")
    hold(f"{name} epoch {it} (eta {eta:g}, groups {tg}/{pg}, "
         f"{plan.u.shape[0]} batches, columns of {plan.u.shape[2]}, "
         f"{cell_route(tc, runner, eta, it)} walk), kernel vs plain",
         out["kernel"], out["plain"], init, atol, phase)
    rm_k, rm_p = rmse(out["kernel"], test), rmse(out["plain"], test)
    log(f"# phase {phase}: {name} tRMSE kernel {rm_k:.6f} plain {rm_p:.6f}")
    if not abs(rm_k - rm_p) <= 1e-3:
        raise AssertionError(f"{name}: tRMSE of kernel and plain disagree")
    p = runner.plan
    return (median(times["kernel"]), median(times["plain"]),
            window_bound(plan, p.n_gu * p.tile_u, p.n_gv * p.tile_v, n,
                         cfg.dim)), out["plain"]


def phase_time(torch, td, cfg, train, test, params_final, rm):
    r = td.DenseEpochRunner(train, saturate=True, dim=DIM, device=DEVICE)

    def plain(tables, eta, it):
        td.dense_epoch_reference(*tables, r.cells, eta, cfg.lam, cfg.gb,
                                 max(1.0, 0.2 / eta), DIM)

    ms = time_in_turns(torch, cfg, r, plain, train, test, params_final, rm,
                       3, "dense_cell", ATOL_FULL)
    time_walks(torch, td, cfg, train, r)
    return ms + (dense_bound(r.cells, DIM),)


def dense_epoch_library(torch, theta, phi, cells, eta, lam, gb, cap, dim):
    """A yardstick the port never calls: the diagonal walk composed of
    PyTorch calls, the three products as cuBLAS batched bf16 products
    (``torch.baddbmm``, ``torch.bmm``, bf16 out) over the dim + 2 used
    lanes, E and the apply elementwise in f32."""
    n_gu, n_gvp, tu, tv = cells.s.shape
    lanes = theta.shape[1]
    kk = -(-(dim + 2) // 8) * 8
    th = theta.view(n_gu, tu, lanes)
    ph = phi.view(n_gvp, tv, lanes)
    lane = torch.arange(kk, device=theta.device)
    keep_u = (lane <= dim).float()
    keep_v = ((lane < dim) | (lane == dim + 1)).float()
    ln_decay = math.log(1.0 - eta * lam)
    gbt = torch.full((1, 1, 1), gb, dtype=torch.bfloat16,
                     device=theta.device)

    def apply(cur, d, k, keep):
        d = d * eta * torch.clamp(cap / torch.clamp(k, min=1.0), max=1.0)
        return cur * (1.0 + keep * (torch.exp(k * ln_decay) - 1.0)) + d * keep

    for diag in range(n_gu + n_gvp - 1):
        i = torch.arange(max(0, diag - n_gvp + 1), min(n_gu - 1, diag) + 1,
                         device=theta.device)
        c = diag - i
        t0, p0 = th[i, :, :kk], ph[c, :, :kk]
        tb, pb = t0.bfloat16(), p0.bfloat16()
        pred = torch.baddbmm(gbt, tb, pb.transpose(1, 2))
        e = (cells.s[i, c].float()
             - cells.w[i, c].float() * pred.float()).bfloat16()
        dth = torch.bmm(e, pb).float()
        dph = torch.bmm(e.transpose(1, 2), tb).float()
        th[i, :, :kk] = apply(t0, dth, cells.ku[i, c].unsqueeze(2), keep_u)
        ph[c, :, :kk] = apply(p0, dph, cells.kv[i, c].unsqueeze(2), keep_v)


def time_walks(torch, td, cfg, train, r):
    """One epoch at epoch 1's eta from init_mf's tables at dims 64, 128 and
    8, on the diagonal and the wavefront walk in turns where the wavefront
    walk takes the dim, else on the diagonal walk alone (CUDA events); at
    dim 64 also the cuBLAS composition. The two walks' tables are held to
    each other (both bf16); at dims 64 and 8 the walk's clocks by phase
    (``walk_clocks``)."""
    from tpu_mf_torch.models.mf import init_mf

    cells, n = r.cells, len(train)
    n_gu, n_gvp, tu, tv = cells.s.shape
    eta = cfg.eta_at(1)
    cap = max(1.0, 0.2 / eta)
    for dim in (DIM, 128, DIM8):
        init = init_mf(train.nu, train.nv, dim, cfg.gb,
                       torch.Generator().manual_seed(cfg.seed), DEVICE)
        start = r.pad(init)
        plan = td.plan_dense_walk(tu, tv, dim, cells.s.dtype, cells.w.dtype)
        route = td.dense_route(tu, tv, dim, cells.s.dtype, cells.w.dtype)
        if plan is None:
            turns = ("diagonal", "diagonal")
            log(f"# phase 3: dim {dim}: route {route}; the wavefront walk "
                f"does not take {dim + 2} lanes")
        else:
            turns = ("diagonal", "wavefront", "wavefront", "diagonal")
            clusters = min(td.walk_clusters(plan, cells.w.dtype,
                                            start[0].device), n_gu)
            log(f"# phase 3: dim {dim}: route {route}; wavefront plan "
                f"{plan}, {clusters} clusters of {plan.cluster} blocks "
                f"resident, {min(clusters, n_gu, n_gvp)} cells in flight (a "
                f"diagonal holds at most {min(n_gu, n_gvp)})")
        times, out = {w: [] for w in turns}, {}
        for walk in turns:
            tabs = tuple(t.clone() for t in start)
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            td.dense_epoch(*tabs, cells, eta, cfg.lam, cfg.gb, cap, dim,
                           walk=walk)
            b.record()
            torch.cuda.synchronize()
            times[walk].append(a.elapsed_time(b))
            out.setdefault(walk, tabs)
        for walk, ts in times.items():
            log(f"# phase 3: dim {dim} {walk} walk: epoch ms "
                f"{[round(x, 3) for x in ts]}, rating updates/s "
                f"{[round(n / (x / 1e3)) for x in ts]}")
        if plan is None:
            continue
        diff = max(float((x - y).abs().max())
                   for x, y in zip(out["diagonal"], out["wavefront"]))
        log(f"# phase 3: dim {dim}: the walks' tables differ by {diff:.3e} "
            f"(atol {ATOL['bfloat16']:g})")
        if not diff <= ATOL["bfloat16"]:
            raise AssertionError(f"the two dense walks disagree at dim {dim}")
        walk_clocks(torch, td, cells, start, eta, cfg, cap, dim, plan)
        if dim != DIM:
            continue
        lib = []
        for _ in range(2):
            tabs = tuple(t.clone() for t in start)
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            dense_epoch_library(torch, *tabs, cells, eta, cfg.lam, cfg.gb,
                                cap, dim)
            b.record()
            torch.cuda.synchronize()
            lib.append(a.elapsed_time(b))
        lib_err = max(float((x - y).abs().max())
                      for x, y in zip(tabs, out["wavefront"]))
        log(f"# phase 3: dim {dim}: the diagonal walk composed of cuBLAS "
            f"batched bf16 products (torch.baddbmm, torch.bmm) and "
            f"elementwise ops: epoch ms {[round(x, 3) for x in lib]}; its "
            f"tables differ from the wavefront walk's by {lib_err:.3e} "
            f"(bf16 sums)")


# the phases of a wavefront cell that the clock build of csrc/dense_cell.cu
# times (its WALK_TICK indices): thread 0, the shared part and the
# reduction group; thread 256, the theta group
WALK_CLOCK_PHASES = (
    "wait", "phi tile", "pred", "S/W wait", "E", "dphi", "cluster barrier",
    "reduction", "release", "end of cell", "theta: shared part",
    "theta: dtheta and apply", "theta: cluster barrier", "theta: end of cell")


def walk_clocks(torch, td, cells, start, eta, cfg, cap, dim, plan):
    """A diagnostic: one wavefront epoch from ``start`` on the clock build
    of ``csrc/dense_cell.cu`` (``-DTMF_WALK_CLOCKS``), logging the clocks
    per cell and block of each phase. The main build has no clocks."""
    from tpu_mf_torch.ops import _build

    lib = td.bind_dense_lib(_build.load("dense_cell",
                                        defines=("TMF_WALK_CLOCKS",)))
    lib.tmf_dense_walk_clocks.argtypes = [ctypes.c_void_p]
    sums = (ctypes.c_ulonglong * len(WALK_CLOCK_PHASES))()
    main = td._dense_lib
    td._dense_lib = lambda: lib  # this epoch only, then the main build
    try:
        lib.tmf_dense_walk_clocks(sums)  # zeroes them
        tabs = tuple(t.clone() for t in start)
        td.dense_epoch(*tabs, cells, eta, cfg.lam, cfg.gb, cap, dim,
                       walk="wavefront")
        torch.cuda.synchronize()
        rc = lib.tmf_dense_walk_clocks(sums)
    finally:
        td._dense_lib = main
    if rc != 0:
        raise RuntimeError(f"dense walk clocks: CUDA error {rc}")
    n_gu, n_gvp = cells.s.shape[:2]
    per = [x / (n_gu * n_gvp * plan.cluster) for x in sums]
    log(f"# phase 3: dim {dim} wavefront walk, clocks per cell and block "
        f"(clock build): " + ", ".join(
            f"{k} {v:.0f}" for k, v in zip(WALK_CLOCK_PHASES, per))
        + f"; thread 0 {sum(per[:10]):.0f}, thread 256 {sum(per[10:]):.0f}")


def phase_time_cells(torch, tc, cfg, train, test, params_final, rm, r,
                     built):
    """Phase 4's timings on the main path's gen-1 runner ``r`` (its
    plans), whose schedule took ``built`` seconds."""
    log(f"# phase 4: plans built in {built:.1f} s (2 plans, balance maps, "
        f"window stats) by train_mf's schedule; {r.plan.u.shape[0]} batches "
        f"of {r.batch}, tiles {r.tile_u}x{r.tile_v}")
    for it in range(1, EPOCHS + 1):
        eta = cfg.eta_at(it)
        log(f"# phase 4: epoch {it}: eta {eta:g}, groups "
            f"{r.pick_theta_groups(eta)}/{r.pick_phi_groups(eta)}")

    def plain(tables, eta, it):
        tc.cell_epoch_reference(
            *tables, r._dev[it % 2], eta, cfg.lam, cfg.gb,
            max(1.0, 0.2 / eta), DIM, r.pick_theta_groups(eta),
            r.pick_phi_groups(eta), r.work_dtype, True, r.mxu_pred)

    ms = time_in_turns(torch, cfg, r, plain, train, test, params_final,
                       rm, 4, "cell_sgd", ATOL_CELL_FULL)
    log(f"# phase 4: the epochs above ran on the "
        f"{cell_route(tc, r, cfg.eta_at(1), 1)} walk (the route)")
    from tpu_mf_torch.models.mf import init_mf

    init = init_mf(train.nu, train.nv, DIM, cfg.gb,
                   torch.Generator().manual_seed(cfg.seed), DEVICE)
    time_cell_walks(torch, tc, r, lambda: r.pad(init), cfg.eta_at(1),
                    cfg.lam, cfg.gb, 1, 4, "epoch 1", ATOL_CELL_FULL)
    cell_clocks(torch, tc, r, lambda: r.pad(init), cfg.eta_at(1), cfg.lam,
                cfg.gb, 1, 4, "epoch 1")
    time_skeleton(torch, tc, cfg, r, train)
    p = r.plan
    return ms + (window_bound(r._dev[1], p.n_gu * p.tile_u,
                              p.n_gv * p.tile_v, len(train), DIM),)


def time_skeleton(torch, tc, cfg, r, train):
    """Epoch 1's plan on ``cell_sgd.cu``'s grid walk and the same plan with
    every weight 0 (its skeleton: slot loads, the step's two grid syncs and
    the apply's count reads; every slot returns at w == 0 and every row at
    k == 0), in turns, timed with CUDA events; logs the us per window step
    of each and their difference (the memory chain)."""
    from tpu_mf_torch.models.mf import init_mf

    eta = cfg.eta_at(1)
    tg, pg = r.pick_theta_groups(eta), r.pick_phi_groups(eta)
    plan = r._dev[1]
    pad = plan._replace(w=torch.zeros_like(plan.w))
    steps = plan.u.shape[0] * 8 // min(8 // tg, 8 // pg)
    init = init_mf(train.nu, train.nv, DIM, cfg.gb,
                   torch.Generator().manual_seed(cfg.seed), DEVICE)
    ts = {"full": [], "skeleton": []}
    for which in ("full", "skeleton", "skeleton", "full", "full", "skeleton"):
        tabs = r.pad(init)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        tc.cell_epoch(*tabs, plan if which == "full" else pad, eta, cfg.lam,
                      cfg.gb, max(1.0, 0.2 / eta), DIM, tg, pg, r.work_dtype,
                      r.saturate, r.mxu_pred, walk="grid")
        b.record()
        torch.cuda.synchronize()
        ts[which].append(a.elapsed_time(b))
    full, skel = median(ts["full"]), median(ts["skeleton"])
    log(f"# phase 4: grid walk, {steps} window steps (groups {tg}/{pg}): "
        f"epoch ms "
        f"{[round(x, 3) for x in ts['full']]}, all-padding ms "
        f"{[round(x, 3) for x in ts['skeleton']]}; us per step: full "
        f"{full * 1e3 / steps:.3f}, skeleton {skel * 1e3 / steps:.3f}, "
        f"memory chain {(full - skel) * 1e3 / steps:.3f}")


def cell_route(tc, runner, eta, it):
    """The walk ``csrc/cell_sgd.cu`` takes on ``runner``'s plan of epoch
    ``it`` at eta's groups (``upload_window_walks``' route)."""
    plan = runner.materialize()._dev[it % len(runner._dev)]
    return runner.route(it, runner.pick_theta_groups(eta),
                        runner.pick_phi_groups(eta)) if plan.walk else "grid"


def time_cell_walks(torch, tc, runner, fresh, eta, lam, gb, it, phase,
                    label, atol, groups=None):
    """``runner``'s plan of epoch ``it`` (a window runner) at ``groups``
    (default: eta's): the plain version once, then ``csrc/cell_sgd.cu``'s
    grid and tile walks in turns (grid, tile, tile, grid), each from the
    tables ``fresh()`` makes, timed with CUDA events, each walk's tables
    held to the plain version's (the largest element difference within
    ``atol``); logs the route and the tile walk's units, windows, critical
    path and clusters. Returns {"plain" / walk: median ms} and {walk:
    max_abs_err}."""
    saved = runner.theta_groups, runner.phi_groups
    if groups is not None:
        runner.theta_groups, runner.phi_groups = groups
    try:
        tg, pg = runner.pick_theta_groups(eta), runner.pick_phi_groups(eta)
        plan = runner.materialize()._dev[it % len(runner._dev)]
        dw = tc.cell_walk(plan, tg, pg)
        w = dw.walks[0]
        times, out = {"plain": [], "grid": [], "tile": []}, {}
        for which in ("plain", "grid", "tile", "tile", "grid"):
            tabs = fresh()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            if which == "plain":
                tc.cell_epoch_reference(
                    *tabs, plan, eta, lam, gb, max(1.0, 0.2 / eta),
                    runner.dim, tg, pg, runner.work_dtype, runner.saturate,
                    runner.mxu_pred)
            else:
                runner.epoch(tabs, eta, lam, gb, epoch_idx=it, walk=which)
            b.record()
            torch.cuda.synchronize()
            times[which].append(a.elapsed_time(b))
            out.setdefault(which, tabs)
        errs = {k: max(float((x - y).abs().max())
                       for x, y in zip(out[k], out["plain"])) for k in WALKS}
    finally:
        runner.theta_groups, runner.phi_groups = saved
    log(f"# phase {phase}: {label} groups {tg}/{pg} (window {w.window} "
        f"columns of {plan.u.shape[2]}, route {dw.route}): tile walk "
        f"{w.n_units} units, {w.n_windows} windows, critical path {w.crit}, "
        f"clusters of {dw.cluster}; epoch ms plain "
        f"{[round(x, 3) for x in times['plain']]}, grid "
        f"{[round(x, 3) for x in times['grid']]}, tile "
        f"{[round(x, 3) for x in times['tile']]}; max_abs_err vs plain: grid "
        f"{errs['grid']:.3e}, tile {errs['tile']:.3e} (atol {atol:g})")
    if not all(e <= atol for e in errs.values()):
        raise AssertionError(f"{label}: a walk of cell_sgd.cu and the plain "
                             f"version disagree at groups {tg}/{pg}")
    return {k: median(v) for k, v in times.items()}, errs


def cell_clocks(torch, tc, runner, fresh, eta, lam, gb, it, phase, label,
                groups=None):
    """``tile_clocks`` of ``csrc/cell_sgd.cu``'s tile walk on ``runner``'s
    epoch ``it`` at ``groups`` (default: eta's)."""
    saved = runner.theta_groups, runner.phi_groups
    if groups is not None:
        runner.theta_groups, runner.phi_groups = groups
    try:
        tile_clocks(torch, tc, "cell", phase,
                    f"{label} groups {runner.pick_theta_groups(eta)}/"
                    f"{runner.pick_phi_groups(eta)}", runner,
                    lambda tabs: runner.epoch(tabs, eta, lam, gb,
                                              epoch_idx=it, walk="tile"),
                    fresh, source="cell_sgd")
    finally:
        runner.theta_groups, runner.phi_groups = saved


def phase_time_ladder(torch, tc, cfg, train, test, init, sched):
    """One full epoch of each phase of the ladder's schedule at its first
    epoch: the packed and the first slot phase against the plain version
    (``time_one_epoch``), the later slot phases on the kernel alone (phase
    9's replay holds their epochs to the plain version); returns the first
    two phases' times."""
    timed = []
    for i, (ep, r) in enumerate(sched):
        name = ("packed" if not hasattr(r, "sub") else
                f"slot{' striped' if r.striped else ''} sub {r.sub}")
        if i < 2:
            timed.append(time_one_epoch(torch, tc, cfg, r, train, test, init,
                                        ep, name)[0])
            continue
        ts = []
        for _ in range(2):
            tabs = r.pad(init)
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            r.epoch(tabs, cfg.eta_at(ep), cfg.lam, float(init.gb),
                    epoch_idx=ep)
            b.record()
            torch.cuda.synchronize()
            ts.append(a.elapsed_time(b))
        log(f"# phase 10: {name} kernel "
            f"({cell_route(tc, r, cfg.eta_at(ep), ep)} walk): epoch ms "
            f"{[round(x, 3) for x in ts]}, rating updates/s "
            f"{[round(len(train) / (x / 1e3)) for x in ts]}")
    return timed[0], timed[1]


def phase_checkpoint(torch, cfg, params):
    from tpu_mf_torch.io.checkpoint import load_mf_binary, save_mf_binary

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, f"model_{cfg.iters}")
        save_mf_binary(path, params, cfg.lam)
        back, lam = load_mf_binary(path, gb=cfg.gb, device=DEVICE)
        size = os.path.getsize(path)
    want = 16 + 4 * (N_USERS + N_ITEMS) * (DIM + 1)
    if size != want or lam != float(torch.tensor(cfg.lam)):
        raise AssertionError(f"checkpoint size {size} != {want} or lambda")
    for a, b in zip(back[:4], params[:4]):
        if a.shape != b.shape or not torch.equal(a, b.contiguous()):
            raise AssertionError("checkpoint does not read back")
        if not bool(torch.isfinite(a).all()):
            raise AssertionError("non-finite tables")
    log(f"# phase 5: checkpoint model_{cfg.iters} ({size} bytes) reads back")


def dp_state(torch, ds, dim, gb, seed=0):
    from tpu_mf_torch.models.dpmf import init_dpmf

    return init_dpmf(ds, dim, gb, torch.Generator().manual_seed(seed), DEVICE)


def plan_walks(runner):
    """The ``DeviceWalk`` of each plan of an SGLD or AdaptReg runner."""
    runner.materialize()
    if hasattr(runner, "walks"):  # the AdaptReg runners
        return runner.walks
    return [p.walk for p in runner._dev]


def log_walk(phase, name, runner):
    """Each plan's tile walk: launch ranges, units, windows, the critical
    path in windows (summed over the ranges) and the route."""
    for idx, w in enumerate(plan_walks(runner)):
        units = [x.n_units for x in w.walks]
        crit = [x.crit for x in w.walks]
        wins = sum(x.n_windows for x in w.walks)
        log(f"# phase {phase}: {name} plan {idx}: {len(units)} launch "
            f"range(s), {sum(units)} units {units}, {wins} windows of "
            f"{w.walks[0].window} column(s) with a real slot, critical path "
            f"{sum(crit)} windows {crit} ({wins / max(1, sum(crit)):.1f}x "
            f"shorter), clusters of {w.cluster} blocks, route {w.route}")


# the phases of a window step that the clock build of the tile walk times
# (tile_walk.cuh: TW_TICK indices 0-7)
TILE_CLOCK_PHASES = ("ticket", "wait", "noise", "scatter",
                     "barrier after scatter", "apply", "barrier after apply",
                     "release")


def tile_clocks(torch, mod, name, phase, label, runner, run, fresh,
                source=None):
    """A diagnostic: ``run(fresh())`` (the tile walk's launches of one epoch
    or round) on the clock build of ``csrc/{source}.cu`` (default
    ``{name}_cells``; ``-DTMF_TILE_CLOCKS``), logging clocks per window
    step and block of each phase. The main build has no clocks."""
    from tpu_mf_torch.ops import _build

    lib = getattr(mod, f"bind_{name}_lib")(_build.load(
        source or f"{name}_cells", defines=("TMF_TILE_CLOCKS",)))
    fn = getattr(lib, f"tmf_{name}_walk_clocks")
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sums = (ctypes.c_ulonglong * (len(TILE_CLOCK_PHASES) + 1))()
    attr = f"_{name}_lib"
    main = getattr(mod, attr)
    setattr(mod, attr, lambda: lib)  # these launches only
    try:
        fn(sums)  # zeroes them
        tabs = fresh()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        run(tabs)
        b.record()
        torch.cuda.synchronize()
        rc = fn(sums)
    finally:
        setattr(mod, attr, main)
    if rc != 0:
        raise RuntimeError(f"{name} walk clocks: CUDA error {rc}")
    steps = sums[len(TILE_CLOCK_PHASES)]
    per = [x / max(1, steps) for x in sums[:len(TILE_CLOCK_PHASES)]]
    log(f"# phase {phase}: {label} tile walk, clock build: "
        f"{a.elapsed_time(b):.3f} ms, {steps} window steps summed over "
        f"blocks; clocks per window step and block: " + ", ".join(
            f"{k} {v:.0f}" for k, v in zip(TILE_CLOCK_PHASES, per))
        + f"; total {sum(per):.0f}")


def plain_round(tg, tss, runner, tables, clock0, hyper, noise_seed,
                epoch_idx=0, ring=None):
    """What ``runner.epoch`` launches, through the plain version."""
    plan = runner.materialize()._dev[epoch_idx % len(runner._dev)]
    if isinstance(runner, tss.SlotSgldRunner):
        if ring is None:
            ring = tss.slot_ring(noise_seed, runner.tile_u, runner.tile_v,
                                 DEVICE)
        tss.sgld_slot_epoch_reference(
            *tables, *runner.invf, runner.lam, plan, clock0, hyper,
            runner.dim, noise_seed, ring, runner.pack, runner.noise_every,
            tss.saturation_cap(hyper[3]), runner.work_dtype)
    else:
        tg.sgld_cell_epoch_reference(
            *tables, *runner.invf, runner.lam, plan, clock0, hyper,
            runner.dim, noise_seed, runner.work_dtype)


def sgld_err(torch, got, want):
    """(largest table difference, stamps equal as integers)."""
    err = max(float((a - b).abs().max()) for a, b in zip(got[:2], want[:2]))
    return err, all(torch.equal(a, b) for a, b in zip(got[2:], want[2:]))


def compare_sgld(torch, tg, tss, make, ds, dim, name, what):
    """An SGLD runner's kernel on each walk vs its plain version, one round
    per working type at temp 0 and temp 1 from init_dpmf's state; returns
    the largest error per walk and working type."""
    gb = ds.mean_rating()
    errs = {}
    for mxu in ("float32", "bfloat16"):
        r = make(mxu)
        for temp in (0.0, 1.0):
            state = dp_state(torch, ds, dim, gb)
            eta = 0.05 / len(ds)
            hyper = (eta, temp, 1.0, eta * len(ds), gb)
            want = r.pad(state)
            plain_round(tg, tss, r, want, 0, hyper, 11)
            for walk in WALKS:
                got = r.pad(state)
                r.epoch(got, 0, hyper, noise_seed=11, walk=walk)
                torch.cuda.synchronize()
                err, stamps = sgld_err(torch, got, want)
                errs[walk, mxu] = max(errs.get((walk, mxu), 0.0), err)
                log(f"# phase 11: {name} {walk} walk vs plain, {mxu}, temp "
                    f"{temp:g}, {what}, {r.plan.u.shape[0]} batches, dim "
                    f"{dim}, {len(ds)} ratings: max_abs_err {err:.3e} (atol "
                    f"{ATOL_SGLD[mxu]:g}), stamps "
                    f"{'equal' if stamps else 'DIFFER'}")
                if not (err <= ATOL_SGLD[mxu] and stamps):
                    raise AssertionError(f"{name} {walk} walk disagrees "
                                         f"({mxu}, temp {temp})")
    log_walk(11, name, r)
    return errs


def phase_compare_sgld(torch, tg, tss, rng):
    ds, _ = corner(rng, 512, 512)
    errs = {"sgld": compare_sgld(
        torch, tg, tss, lambda mxu: tg.SgldCellRunner(
            ds, tile_u=512, tile_v=512, batch=8192, mxu=mxu, device=DEVICE),
        ds, DIM_DP, "sgld", "batch 8192 at tiles 512x512")}
    ds, _ = corner(rng, 1024, 1024)
    errs["slot_sgld"] = {}
    for striped, ne in ((False, 8), (True, 1), (True, 8)):
        e = compare_sgld(
            torch, tg, tss, lambda mxu: tss.SlotSgldRunner(
                ds, dim=DIM_DP8, mxu=mxu, striped=striped, noise_every=ne,
                device=DEVICE),
            ds, DIM_DP8, "slot_sgld",
            f"{'striped' if striped else 'plain'} plans, noise_every {ne}")
        for k, v in e.items():
            errs["slot_sgld"][k] = max(errs["slot_sgld"].get(k, 0.0), v)
    return errs


def run_dpmf(torch, train, test, phase, dim):
    """train_dpmf on cuda with every kernel count set to 0 just before; the
    per-round launch counts read just after. RMSE and tRMSE must be finite
    every round and tRMSE below the initial tables'."""
    from tpu_mf_torch.config import TrainConfig
    from tpu_mf_torch.models.mf import rmse
    from tpu_mf_torch.ops import sgld_cells as tg
    from tpu_mf_torch.ops import sgld_slot as tss
    from tpu_mf_torch.ops.rating_sse import rating_sse
    from tpu_mf_torch.train import train_dpmf

    cfg = TrainConfig(alg="dpmf", dim=dim, iters=ROUNDS,
                      eta=SCAL_DP / len(train),
                      hyperb=1000.0, gb=train.mean_rating())
    rm_init = rmse(dp_state(torch, train, dim, cfg.gb, cfg.seed).params, test)
    counts = {**counters(), "sgld": tg.SgldCellRunner,
              "slot_sgld": tss.SlotSgldRunner}
    wrappers = (tg.sgld_cell_epoch, tss.sgld_slot_epoch)
    lines, marks, sse = [], [], []

    def record(line):
        lines.append(line)
        log(line)
        if line.startswith("round #"):
            marks.append({k: c.launches for k, c in counts.items()})
            sse.append(rating_sse.launches)

    for c in list(counts.values()) + list(wrappers) + [rating_sse]:
        c.launches = 0
    for c in wrappers:
        c.walks = dict.fromkeys(WALKS, 0)
    t = time.perf_counter()
    state = train_dpmf(cfg, train, test, log=record, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    per_round = {k: [b[k] - a[k] for a, b in zip([dict.fromkeys(counts, 0)]
                                                 + marks, marks)]
                 for k in counts}
    if [w.launches for w in wrappers] != [sum(per_round["sgld"]),
                                           sum(per_round["slot_sgld"])]:
        raise AssertionError("an SGLD launch outside the runners")
    walks = {w: sum(c.walks[w] for c in wrappers) for w in WALKS}
    evals = sse_evals(sse, 2, f"phase {phase}")
    log(f"# phase {phase}: train_dpmf(dim={dim}) on cuda, {ROUNDS} rounds in "
        f"{wall:.1f} s (set-up included); launches per round "
        + ", ".join(f"{k} {v}" for k, v in per_round.items())
        + f"; SGLD launches by walk {walks}; rating_sse launches per round "
        f"{evals}")
    rows = [x.split("\t") for x in lines if x.startswith("round #")]
    rmse_tr = [float(x[1].split("=")[1]) for x in rows]
    rm = [float(x[2].split("=")[1]) for x in rows]
    log(f"# phase {phase}: initial tables' tRMSE {rm_init:.6f}")
    if any("batched path" in x for x in lines):
        raise AssertionError("a round left the fused kernel")
    if not (len(rm) == ROUNDS and all(map(math.isfinite, rm + rmse_tr))
            and max(rm) < rm_init):
        raise AssertionError(f"RMSE {rmse_tr} / tRMSE {rm} not finite or "
                             f"not below the initial {rm_init}")
    return cfg, state, rm, per_round, walks, sum(evals)


def time_dpmf_round(torch, tg, tss, cfg, train, test, phase, name, runner,
                    built):
    """One full round from the initial state through the main path's
    runner (built in ``built`` seconds by ``train_dpmf``): plain version, then the grid and the tile walk in turns (grid,
    tile, tile, grid) at temp 1 (each held to max_abs_err, stamps equal),
    then both walks and the plain version at temp 0 (held as in phase 9),
    timed with CUDA events; the tile walk's clocks by phase (a clock
    build). Returns (the median round ms of the routed walk and of the
    plain version at temp 1, the bound), and the route."""
    import dataclasses

    from tpu_mf_torch.models.dpmf import dp_bound
    from tpu_mf_torch.models.mf import MFParams, rmse

    init = dp_state(torch, train, cfg.dim, cfg.gb, cfg.seed)
    slot = isinstance(runner, tss.SlotSgldRunner)
    runner.materialize()
    log(f"# phase {phase}: {type(runner).__name__}, train_dpmf's, built in "
        f"{built:.1f} s: {runner.plan.u.shape[0]} batches"
        + (f", sub {runner.sub}" if slot else f" of {runner.batch}")
        + f", tiles {runner.tile_u}x{runner.tile_v}")
    log_walk(phase, name, runner)
    n = len(train)
    bnd = dp_bound(cfg.epsilon, cfg.tau, train.nv)
    eta = cfg.eta_at_cutoff(1)
    seed = cfg.seed * 1_000_003 + runner.seed_stride
    times, outs = {"plain": [], **{w: [] for w in WALKS}}, {}
    for temp, order in ((1.0, ("plain", "grid", "tile", "tile", "grid")),
                        (0.0, ("tile", "grid", "plain"))):
        hyper = (eta, temp, bnd, eta * n * bnd * float(init.lambda_r),
                 float(init.params.gb))
        for which in order:
            tabs = runner.pad(init)
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            if which in WALKS:
                runner.epoch(tabs, 0, hyper, noise_seed=seed, walk=which)
            else:
                plain_round(tg, tss, runner, tabs, 0, hyper, seed)
            b.record()
            torch.cuda.synchronize()
            if temp:
                times[which].append(a.elapsed_time(b))
            outs.setdefault((temp, which), tabs)
    for what, ts in times.items():
        log(f"# phase {phase}: {name} {what} at temp 1: round ms "
            f"{[round(x, 3) for x in ts]}, rating updates/s "
            f"{[round(n / (x / 1e3)) for x in ts]}")

    def params(tabs):
        return runner.unpack(init, tabs).params

    for walk in WALKS:
        err, stamps = sgld_err(torch, outs[1.0, walk], outs[1.0, "plain"])
        log(f"# phase {phase}: {name} round 1 at temp 1, {walk} walk vs "
            f"plain: max_abs_err {err:.3e} (atol {ATOL_SGLD_FULL:g}), stamps "
            f"{'equal' if stamps else 'DIFFER'}")
        if not (err <= ATOL_SGLD_FULL and stamps):
            raise AssertionError(f"{name}: the {walk} walk and plain "
                                 "disagree at temp 1")
        got, want = params(outs[0.0, walk]), params(outs[0.0, "plain"])
        hold(f"{name} round 1 at temp 0, {walk} walk vs plain", got, want,
             init.params, ATOL_SGLD_FULL, phase)
        rm_k, rm_p = rmse(got, test), rmse(want, test)
        log(f"# phase {phase}: {name} tRMSE after round 1 at temp 0: {walk} "
            f"walk {rm_k:.6f} plain {rm_p:.6f}")
        if not abs(rm_k - rm_p) <= 1e-3:
            raise AssertionError(f"{name}: tRMSE of the {walk} walk and "
                                 "plain disagree")
    route = runner.route()
    hyper = (eta, 1.0, bnd, eta * n * bnd * float(init.lambda_r),
             float(init.params.gb))
    tile_clocks(torch, tg, "sgld", phase, name, runner,
                lambda tabs: runner.epoch(tabs, 0, hyper, noise_seed=seed,
                                          walk="tile"),
                lambda: runner.pad(init))
    plan = runner._dev[0]
    return (median(times[route]), median(times["plain"]),
            sgld_bound(runner, plan, n, cfg.dim, slot)), route


def phase_dpmf(torch, tg, tss, train, test, phase, dim, family):
    """Phases 12 and 13: the main path, then its round timed; every round
    of the main path must take the routed walk. Returns the run's config
    and state, the family's launches, the timed round, the route and the
    main path's launches of ``csrc/rating_sse.cu``."""
    with keep_built(torch, "_dpmf_runner") as kept:
        cfg, state, _, per_round, walks, evals = run_dpmf(
            torch, train, test, phase, dim)
    launches = only(per_round, family, range(1, ROUNDS + 1))
    for k in per_round:
        if k != family:
            only(per_round, k, ())
    (runner, built), = kept
    timed, route = time_dpmf_round(torch, tg, tss, cfg, train, test, phase,
                                   family, runner, built)
    if walks[route] != launches:
        raise AssertionError(f"{family}: {walks} launches by walk, not all "
                             f"{launches} on the routed {route} walk")
    return cfg, state, launches, timed, route, evals


def phase_checkpoint_dpmf(torch, cfg, state):
    from tpu_mf_torch.io.checkpoint import load_dpmf_binary, save_dpmf_binary

    lam = [float(state.lambda_r), float(state.lambda_ub),
           float(state.lambda_vb)]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, f"model_{cfg.iters}")
        save_dpmf_binary(path, state.params, *lam,
                         state.lambda_u.cpu().numpy(),
                         state.lambda_v.cpu().numpy())
        back, hyper = load_dpmf_binary(path, gb=cfg.gb, device=DEVICE)
        size = os.path.getsize(path)
    want = 12 + 4 * (3 + 2 * DIM_DP) + 4 * (N_USERS + N_ITEMS) * (DIM_DP + 1)
    if size != want or list(hyper[:3]) != [float(torch.tensor(x))
                                           for x in lam]:
        raise AssertionError(f"dpmf checkpoint size {size} != {want} or "
                             "precisions")
    if not (torch.equal(torch.as_tensor(hyper[3]), state.lambda_u.cpu())
            and torch.equal(torch.as_tensor(hyper[4]), state.lambda_v.cpu())):
        raise AssertionError("lambda_u / lambda_v do not read back")
    for a, b in zip(back[:4], state.params[:4]):
        if a.shape != b.shape or not torch.equal(a, b.contiguous()):
            raise AssertionError("dpmf checkpoint does not read back")
        if not bool(torch.isfinite(a).all()):
            raise AssertionError("non-finite tables")
    log(f"# phase 14: dpmf checkpoint model_{cfg.iters} ({size} bytes) reads "
        "back")


def admf_state(torch, ds, dim, gb, lam, tabs=None, seed=0):
    """init_admf's state, or one from the numpy ``tabs``, on the card."""
    from tpu_mf_torch.models.admf import init_admf, with_shadows
    from tpu_mf_torch.models.mf import params_from_numpy

    if tabs is None:
        return init_admf(ds.nu, ds.nv, dim, lam, gb,
                         torch.Generator().manual_seed(seed), DEVICE)
    return with_shadows(params_from_numpy(*tabs, gb, device=DEVICE),
                        (lam,) * 4)


def adreg_epochs(torch, runner, state, eta, eta_reg, key, order,
                 samples=None, timed=None):
    """One AdaptReg epoch of ``runner`` from ``state`` per entry of
    ``order`` ("tile", the kernel's walk, or "plain"), the same validation
    draws on every turn; returns {which: (fused tables, lambdas)} of each
    one's first turn and appends each turn's CUDA-event ms to
    ``timed[which]``."""
    out = {}
    for which in order:
        tabs = runner.pad(state)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        runner.epoch(tabs, eta, eta_reg, key, samples=samples,
                     reference=which == "plain")
        b.record()
        torch.cuda.synchronize()
        if timed is not None:
            timed[which].append(a.elapsed_time(b))
        out.setdefault(which, (tabs, runner.lams.clone()))
    return out


def hold_lams(what, got, want, lam0, phase):
    """The kernel's lambdas within LAM_REL of how far the plain version's
    moved from ``lam0``; returns the largest difference."""
    moved = float((want - lam0).abs().max())
    err = float((got - want).abs().max())
    log(f"# phase {phase}: {what}: lambdas kernel {got.tolist()} plain "
        f"{want.tolist()} from {lam0.tolist()}: difference {err:.3e} "
        f"(limit {LAM_REL:g} x motion {moved:.3e})")
    if not (moved > 0 and err <= LAM_REL * moved + 1e-7):
        raise AssertionError(f"{what}: the lambdas disagree or did not move")
    return err


def binary(ds):
    """The ratings as 1 above the mean and 0 below (logistic targets)."""
    import dataclasses

    return dataclasses.replace(ds, r=(ds.r > ds.mean_rating()).astype(
        "float32"))


def compare_adreg(torch, make, ds, va, tabs, dim, name, what, cases):
    """An AdaptReg runner's kernel (its tile walk) vs the plain version, one
    whole epoch (eta_reg 0.5, so the lambdas move) per working type, loss
    and (eta, lam) of ``cases(runner)``; returns the largest table error
    per working type."""
    errs = {}
    for mxu in ("float32", "bfloat16"):
        for loss in (0, 1):
            tr, vl = (binary(ds), binary(va)) if loss else (ds, va)
            gb = 0.0 if loss else 3.5
            r = make(tr, vl, mxu, loss)
            for eta, lam in cases(r):
                with warnings.catch_warnings():  # 8/8 past the envelope
                    warnings.simplefilter("ignore")
                    tg, pg = r.pick_theta_groups(eta), r.pick_phi_groups(eta)
                    state = admf_state(torch, tr, dim, gb, lam, tabs)
                    lam0 = torch.full((4,), lam, device=DEVICE)
                    out = adreg_epochs(torch, r, state, eta, 0.5, 1,
                                       ("plain", "tile"))
                err = max(float((a - b).abs().max()) for a, b in
                          zip(out["tile"][0], out["plain"][0]))
                errs[mxu] = max(errs.get(mxu, 0.0), err)
                desc = (f"{name} tile walk vs plain, {mxu}, loss {loss}, "
                        f"groups {tg}/{pg} (eta {eta:.3g}, eta*lam "
                        f"{eta * lam:.3g}), {what}, {r.plan.u.shape[0]} "
                        f"batches in {r.segments} segments, dim {dim}, "
                        f"{len(ds)} ratings")
                log(f"# phase 15: {desc}: max_abs_err {err:.3e} (atol "
                    f"{ATOL_CELL[mxu]:g})")
                if not err <= ATOL_CELL[mxu]:
                    raise AssertionError(f"{name} tile walk disagrees "
                                         f"({mxu})")
                hold_lams(desc, out["tile"][1], out["plain"][1], lam0, 15)
    log_walk(15, name, r)
    return errs


def phase_compare_adreg(torch, tac, tas, rng):
    """Both AdaptReg families vs the plain version on 6x6 tiles at ML-10M
    density: gen-1 plans at the main path's dim 128, tiles 512, batch 4096
    (at 8/8; eta*lam 1.5 gives a negative decay base), striped slot plans at
    dim 8, tile 1024 (at 8/8, and at the eta whose windows span 2+ columns
    on both sides). The validation set is a second draw of the corner."""
    from tpu_mf_torch.data.coo import RatingsCOO

    def corner_pair(tu, tv):
        ds, _ = corner(rng, tu, tv)
        va, _ = corner(rng, tu, tv)
        return ds, RatingsCOO(va.u[:5000], va.v[:5000], va.r[:5000],
                              va.nu, va.nv)

    ds, va = corner_pair(512, 512)
    errs = {"adreg": compare_adreg(
        torch, lambda tr, vl, mxu, loss: tac.AdRegCellRunner(
            tr, vl, tile_u=512, tile_v=512, batch=4096, mxu=mxu, loss=loss,
            device=DEVICE),
        ds, va, tables(rng, ds, DIM_AD), DIM_AD, "adreg",
        "batch 4096 at tiles 512x512",
        lambda r: ((0.05, LAM_AD), (0.05, 1.5 / 0.05)))}
    ds, va = corner_pair(1024, 1024)

    def slot_etas(r):
        seq = max(0.05, 1.01 * 0.2 / min(r._dup_max[4], r._vdup_max[4]))
        return ((seq, LAM_AD),
                (0.2 / max(r._dup_max[2], r._vdup_max[2]), LAM_AD))

    errs["slot_adreg"] = compare_adreg(
        torch, lambda tr, vl, mxu, loss: tas.SlotAdRegRunner(
            tr, vl, dim=DIM_AD8, mxu=mxu, loss=loss, striped=True,
            device=DEVICE),
        ds, va, tables(rng, ds, DIM_AD8), DIM_AD8, "slot_adreg",
        "striped plans at tiles 1024x1024", slot_etas)
    return errs


def run_admf(torch, train, valid, test, phase, dim, eta):
    """train_admf on cuda with every kernel count set to 0 just before; the
    per-epoch launch counts read just after. tRMSE must be finite and
    fall, the lambdas stay >= 0 and move."""
    from tpu_mf_torch.config import TrainConfig
    from tpu_mf_torch.ops import adreg_cells as tac
    from tpu_mf_torch.ops import adreg_slot as tas
    from tpu_mf_torch.ops import sgld_cells as tg
    from tpu_mf_torch.ops import sgld_slot as tss
    from tpu_mf_torch.ops.rating_sse import rating_sse
    from tpu_mf_torch.train import train_admf

    cfg = TrainConfig(alg="admf", dim=dim, iters=AD_EPOCHS, lam=LAM_AD,
                      eta=eta, eta_reg=ETA_REG_AD, gb=train.mean_rating())
    counts = {**counters(), "sgld": tg.SgldCellRunner,
              "slot_sgld": tss.SlotSgldRunner, "adreg": tac.AdRegCellRunner,
              "slot_adreg": tas.SlotAdRegRunner}
    wrappers = (tac.adreg_segment, tg.sgld_cell_epoch, tss.sgld_slot_epoch)
    lines, marks, sse = [], [], []

    def record(line):
        lines.append(line)
        log(line)
        if line.startswith("iter#"):
            marks.append({k: c.launches for k, c in counts.items()})
            sse.append(rating_sse.launches)

    for c in list(counts.values()) + list(wrappers) + [rating_sse]:
        c.launches = 0
    tac.adreg_segment.walks = dict.fromkeys(WALKS, 0)
    t = time.perf_counter()
    state = train_admf(cfg, train, valid, test, log=record, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    per_epoch = {k: [b[k] - a[k] for a, b in zip([dict.fromkeys(counts, 0)]
                                                 + marks, marks)]
                 for k in counts}
    if tac.adreg_segment.launches != sum(per_epoch["adreg"]) + sum(
            per_epoch["slot_adreg"]):
        raise AssertionError("an AdaptReg launch outside the runners")
    walks = dict(tac.adreg_segment.walks)
    log(f"# phase {phase}: train_admf(dim={dim}, eta={eta:g}) on cuda, "
        f"{AD_EPOCHS} epochs in {wall:.1f} s (set-up included); launches per "
        f"epoch " + ", ".join(f"{k} {v}" for k, v in per_epoch.items())
        + f"; AdaptReg launches by walk {walks}; rating_sse launches per "
        f"epoch {sse_evals(sse, 1, f'phase {phase}')}")
    rm = [float(x.split("tRMSE=")[1]) for x in lines if "tRMSE=" in x]
    lams = [float(x) for x in state[5:]]
    log(f"# phase {phase}: lambdas lam_u, lam_v, lam_bu, lam_bv {lams} "
        f"(from {LAM_AD:g})")
    if any("batched path" in x for x in lines):
        raise AssertionError("an epoch left the fused kernels")
    if not (len(rm) == AD_EPOCHS and all(map(math.isfinite, rm))
            and rm[-1] < rm[0]):
        raise AssertionError(f"tRMSE not finite and falling: {rm}")
    if not (min(lams) >= 0 and any(x != float(torch.tensor(LAM_AD))
                                   for x in lams)):
        raise AssertionError(f"lambdas negative or unmoved: {lams}")
    return cfg, state, lines, per_epoch, walks


def time_segments(torch, runner, init, eta, n, phase, name):
    """One epoch's segments alone from ``init``, the tile walk twice, then
    the plain version, each launch timed with CUDA events: the lambdas stay
    at ``init``'s and the hypergradient steps between segments are left
    out, as the bound leaves them out; then the tile walk's clocks by phase
    (a clock build). Returns the median summed ms of the tile walk and of
    the plain version, and the bound."""
    from tpu_mf_torch.ops import adreg_cells as tac

    plan = runner.materialize()._dev[0]
    tg, pg = runner.pick_theta_groups(eta), runner.pick_phi_groups(eta)
    seg = runner.seg_len(0)
    times = {"tile": [], "plain": []}

    def segments(theta, phi, walk, ev=None):
        for s in range(runner.segments):
            if ev:
                ev[s][0].record()
            if walk == "plain":
                tac.adreg_segment_reference(
                    theta, phi, plan, s * seg, (s + 1) * seg, eta,
                    runner.lams, runner.gb, runner.dim, tg, pg,
                    runner.work_dtype, runner.loss)
            else:
                tac.adreg_segment(
                    theta, phi, plan, s * seg, (s + 1) * seg, eta,
                    runner.lams, runner.gb, runner.dim, tg, pg,
                    runner.work_dtype, runner.loss, runner.walks[0])
            if ev:
                ev[s][1].record()

    for which in ("tile", "tile", "plain"):
        theta, phi = runner.pad(init)
        ev = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
              for _ in range(runner.segments)]
        segments(theta, phi, which, ev)
        torch.cuda.synchronize()
        times[which].append(sum(a.elapsed_time(b) for a, b in ev))
    for what, ts in times.items():
        log(f"# phase {phase}: {name} {what}: the {runner.segments} segments "
            f"alone, ms {[round(x, 3) for x in ts]}, rating updates/s "
            f"{[round(n / (x / 1e3)) for x in ts]}")
    tile_clocks(torch, tac, "adreg", phase, name, runner,
                lambda tabs: segments(*tabs, "tile"),
                lambda: runner.pad(init))
    return (median(times["tile"]), median(times["plain"]),
            adreg_bound(runner, plan, n, runner.dim, eta))


def time_admf_epoch(torch, cfg, runner, train, test, phase, name):
    """One full epoch of the main path's runner from the initial state,
    plain version, then the tile walk twice, with the same validation
    draws (epoch 1's), timed with CUDA events and the tile walk held to the
    plain version; then the segments alone (``time_segments``), whose
    times it returns."""
    from tpu_mf_torch.models.mf import rmse
    from tpu_mf_torch.ops.sgd_cells import _dup_stats
    from tpu_mf_torch.train.loop import _admf_key

    init = admf_state(torch, train, cfg.dim, cfg.gb, cfg.lam, seed=cfg.seed)
    eta, eta_reg = cfg.eta_at(1), cfg.eta_reg_at(1)
    key = _admf_key(cfg, 1)
    if runner._dup_max is None:  # gen-1: groups pinned at 8/8
        dups = (max(_dup_stats(p.u, p.tile_u)[8] for p in runner.plans),
                max(_dup_stats(p.v, p.tile_v)[8] for p in runner.plans))
    else:
        dups = (runner._dup_max[8], runner._vdup_max[8])
    log(f"# phase {phase}: {type(runner).__name__}: {runner.plan.u.shape[0]} "
        f"batches in {runner.segments} segments, tiles {runner.tile_u}x"
        f"{runner.tile_v}, groups {runner.pick_theta_groups(eta)}/"
        f"{runner.pick_phi_groups(eta)}; per-column duplicate maxima user "
        f"{dups[0]}, item {dups[1]}: eta x maxima {eta * dups[0]:.3g}, "
        f"{eta * dups[1]:.3g}")
    log_walk(phase, name, runner)
    runner.pad(init)
    samples = torch.stack([runner.draw_samples(key, s)
                           for s in range(runner.segments)])
    times = {"plain": [], "tile": []}
    out = adreg_epochs(torch, runner, init, eta, eta_reg, key,
                       ("plain", "tile", "tile"), samples, times)
    n = len(train)
    for what, ts in times.items():
        log(f"# phase {phase}: {name} {what}: epoch ms (hypergradient steps "
            f"included) {[round(x, 3) for x in ts]}, rating updates/s "
            f"{[round(n / (x / 1e3)) for x in ts]}")
    want = runner.trim(out["plain"][0])
    got = runner.trim(out["tile"][0])
    hold(f"{name} epoch 1 (eta {eta:g}), tile walk vs plain", got, want,
         init.params, ATOL_CELL_FULL, phase)
    hold_lams(f"{name} epoch 1, tile walk", out["tile"][1], out["plain"][1],
              torch.stack(list(init[5:])), phase)
    rm_k, rm_p = rmse(got, test), rmse(want, test)
    log(f"# phase {phase}: {name} tRMSE after epoch 1: tile walk "
        f"{rm_k:.6f} plain {rm_p:.6f}")
    if not abs(rm_k - rm_p) <= 1e-3:
        raise AssertionError(f"{name}: tRMSE of the tile walk and plain "
                             "disagree")
    return time_segments(torch, runner, init, eta, n, phase, name)


def phase_admf(torch, train, valid, test, phase, dim, eta, family, runner):
    """Phases 16 and 17: the main path with ``family`` carrying every epoch,
    one launch per segment, then one epoch timed through ``runner`` (None:
    the main path's own runner)."""
    with keep_built(torch, "_admf_runner") as kept:
        cfg, state, lines, per_epoch, walks = run_admf(torch, train, valid,
                                                       test, phase, dim, eta)
    if runner is None:
        (runner, _), = kept
    if type(runner).__name__ != {"adreg": "AdRegCellRunner",
                                 "slot_adreg": "SlotAdRegRunner"}[family]:
        raise AssertionError(f"{type(runner).__name__} is not {family}'s")
    launches = only(per_epoch, family, range(1, AD_EPOCHS + 1),
                    runner.segments)
    for k in per_epoch:
        if k != family:
            only(per_epoch, k, ())
    timed = time_admf_epoch(torch, cfg, runner, train, test, phase, family)
    if walks != {"tile": sum(per_epoch[family]), "grid": 0}:
        raise AssertionError(f"{family}: {walks} launches by walk, not all "
                             "on the tile walk")
    return cfg, state, launches, timed


def phase_slot_admf(torch, tas, tsl, atrain, avalid, test):
    """Phase 17: ``train_admf`` at dim 8 at the eta the slot gate admits
    (the striped slot AdaptReg runner), one epoch timed; returns its
    launches and times."""
    from tpu_mf_torch.config import TrainConfig

    cfg = TrainConfig(alg="admf", gb=atrain.mean_rating())
    t = time.perf_counter()
    lb, _ = tsl.slot_dup_lower_bound(atrain, dim=DIM_AD8, balance=True)
    # the runner train_admf builds at dim 8 (loop.py's _admf_runner): its
    # window statistics set eta, and it is the one phase 17 times
    probe = tas.SlotAdRegRunner(atrain, avalid, seed=cfg.seed, n_plans=2,
                                dim=DIM_AD8, striped=True, device=DEVICE)
    eta8 = min(ETA_AD, 0.18 / max(lb, probe._dup_max[8], probe._vdup_max[8]))
    log(f"# phase 17: slot gate at dim {DIM_AD8}: pigeonhole bound {lb}, "
        f"plan duplicate maxima user {probe._dup_max[8]}, item "
        f"{probe._vdup_max[8]}: eta {eta8:g} (host statistics in "
        f"{time.perf_counter() - t:.1f} s)")
    if eta8 >= 1e-5:
        _, _, launches, timed = phase_admf(
            torch, atrain, avalid, test, 17, DIM_AD8, eta8, "slot_adreg",
            probe)
        return launches, timed
    # not forced past the gate: the main path at dim 8 is gen-1's, and the
    # slot kernel is only timed against its plain version
    log(f"# phase 17: the slot gate refuses every eta >= 1e-5 at dim "
        f"{DIM_AD8}: train_admf runs the gen-1 runner at eta {ETA_AD:g}")
    phase_admf(torch, atrain, avalid, test, 17, DIM_AD8, ETA_AD, "adreg",
               None)
    return 0, time_segments(
        torch, probe, admf_state(torch, atrain, DIM_AD8, cfg.gb, LAM_AD,
                                 seed=cfg.seed),
        ETA_AD, len(atrain), 17, "slot_adreg")


def phase_checkpoint_admf(torch, cfg, state, nu, nv):
    from tpu_mf_torch.io.checkpoint import load_mf_binary, save_mf_binary

    lam = float(state.lam_u)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, f"model_{cfg.iters}")
        save_mf_binary(path, state.params, lam)
        back, lam_back = load_mf_binary(path, gb=cfg.gb, device=DEVICE)
        size = os.path.getsize(path)
    want = 16 + 4 * (nu + nv) * (DIM_AD + 1)
    if size != want or lam_back != lam:
        raise AssertionError(f"admf checkpoint size {size} != {want} or "
                             "lam_u")
    for a, b in zip(back[:4], state.params[:4]):
        if a.shape != b.shape or not torch.equal(a, b.contiguous()):
            raise AssertionError("admf checkpoint does not read back")
        if not bool(torch.isfinite(a).all()):
            raise AssertionError("non-finite tables")
    log(f"# phase 18: admf checkpoint model_{cfg.iters} ({size} bytes, "
        f"lam_u {lam:g}) reads back")


def phase_compare_mega_free(torch, tc, tpk, tm, tf, rng):
    """Phase 19: the mega runner's window plans and the free-column kernel
    against their plain versions on the card, both working types, on 6x6
    tiles at ML-10M density. Mega at pack 1 (dim 64, tiles 512, mxu_pred
    on) and pack 8 (dim 8, tiles 1024), each padded with all-sentinel
    batches, at 8/8 groups and at an eta whose windows span 2+ columns;
    free (its tile walk) at dim 64, tiles 128, groups 8/8, 1/1, 8/1 and
    4/2, saturation on and off, on a plan whose last batch has sentinel
    columns."""
    from tpu_mf_torch.models.mf import params_from_numpy

    errs = {"mega": {}, "free": {}}
    for dim in (DIM, DIM8):
        pack = tm.mega_packing_factor(dim)
        tile = 512 if pack == 1 else 1024
        ds, _ = corner(rng, tile, tile)
        nb = tpk.prepare_cells_packed(ds, tile, tile, 8192, 0, pack).u.shape[0]
        mega = next(m for m in range(8, 1, -1) if nb % m)
        e = compare_window_runner(
            torch, tc, lambda mxu: tm.MegaEpochRunner(
                ds, dim=dim, mega=mega, mxu=mxu, saturate=True,
                device=DEVICE),
            ds, tables(rng, ds, dim), dim, "mega",
            f"pack {pack}, tiles {tile}, mega {mega} ({nb} batches padded)",
            ATOL_CELL, 19)
        for k, v in e.items():
            errs["mega"][k] = max(errs["mega"].get(k, 0.0), v)
    ds, n = corner(rng, 128, 128)
    tabs = tables(rng, ds, DIM)
    eta, lam, gb = 0.02, 5e-3, 3.5
    for mxu in ("float32", "bfloat16"):
        for saturate in (False, True):
            r = tf.FreeEpochRunner(ds, mxu=mxu, saturate=saturate,
                                   device=DEVICE)
            r.pad(params_from_numpy(*tabs, gb, device=DEVICE))
            sentinel = int((r.plan.w.sum(axis=1) == 0).sum())
            if not sentinel:
                raise AssertionError("the free plan has no sentinel column")
            if mxu == "float32" and not saturate:
                log_walk(19, "free", r)
            for groups in FREE_GROUPS:
                start = r.pad(params_from_numpy(*tabs, gb, device=DEVICE))
                want = tuple(t.clone() for t in start)
                hyper = (eta, lam, gb, max(1.0, 0.2 / eta), DIM, *groups,
                         r.work_dtype, saturate, r.mxu_pred)
                tf.free_epoch_reference(*want, r._dev[0], *hyper)
                got = tuple(t.clone() for t in start)
                tf.free_epoch(*got, r._dev[0], *hyper)
                torch.cuda.synchronize()
                err = max(float((a - b).abs().max())
                          for a, b in zip(got, want))
                errs["free"][mxu] = max(errs["free"].get(mxu, 0.0), err)
                log(f"# phase 19: free vs plain, tile walk, {mxu}, groups "
                    f"{groups[0]}/{groups[1]}, saturate {saturate}, batch "
                    f"{r.batch} at tiles 128x128, {r.plan.u.shape[0]} "
                    f"batches ({sentinel} sentinel columns), dim {DIM}, {n} "
                    f"ratings: max_abs_err {err:.3e} (atol "
                    f"{ATOL_CELL[mxu]:g})")
                if not err <= ATOL_CELL[mxu]:
                    raise AssertionError(
                        f"free (tile walk) disagrees ({mxu}): {err}")
    return errs


def run_runner(torch, cfg, runner, init, test, phase, family, counts):
    """The runner's own path, as ``_mf_runner_schedule``'s runners are
    driven: ``pad``, EPOCHS epochs at ``cfg.eta_at``, ``trim``, with every
    count in ``counts`` set to 0 just before and read after each epoch.
    ``family`` and the wrapper its kernel counts on must rise by 1 every
    epoch and no other count may move; tRMSE must be finite and fall.
    Returns the final tables and the launches."""
    from tpu_mf_torch.models.mf import rmse

    for c in counts.values():
        c.launches = 0
    t = time.perf_counter()
    tables = runner.pad(init)
    marks, rm = [], []
    for it in range(1, EPOCHS + 1):
        eta = cfg.eta_at(it)
        a = time.perf_counter()
        runner.epoch(tables, eta, cfg.lam, cfg.gb, epoch_idx=it)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - a) * 1e3
        marks.append({k: c.launches for k, c in counts.items()})
        rm.append(rmse(runner.trim(tables), test))
        log(f"iter#{it}\t{ms:.3f} ms\teta={eta:g}\tgroups="
            f"{runner.pick_theta_groups(eta)}/{runner.pick_phi_groups(eta)}"
            f"\ttRMSE={rm[-1]:.6f}")
    wall = time.perf_counter() - t
    per_epoch = {k: [b[k] - a[k] for a, b in zip([dict.fromkeys(counts, 0)]
                                                 + marks, marks)]
                 for k in counts}
    log(f"# phase {phase}: {type(runner).__name__} on cuda, {EPOCHS} epochs "
        f"in {wall:.1f} s (pad and eval included); launches per epoch "
        + ", ".join(f"{k} {v}" for k, v in per_epoch.items()))
    for k in per_epoch:
        only(per_epoch, k, range(1, EPOCHS + 1) if k in family else ())
    if not (all(map(math.isfinite, rm)) and rm[-1] < rm[0]):
        raise AssertionError(f"tRMSE not finite and falling: {rm}")
    return runner.trim(tables), sum(per_epoch[family[0]])


def all_counts(tc, tm, tf):
    """Every launch count: the kernel families' runners and wrappers."""
    from tpu_mf_torch.ops import adreg_cells as tac
    from tpu_mf_torch.ops import adreg_slot as tas
    from tpu_mf_torch.ops import sgld_cells as tg
    from tpu_mf_torch.ops import sgld_slot as tss

    return {**counters(), "mega": tm.MegaEpochRunner,
            "free": tf.FreeEpochRunner, "cell_epoch": tc.cell_epoch,
            "free_epoch": tf.free_epoch, "sgld": tg.SgldCellRunner,
            "slot_sgld": tss.SlotSgldRunner, "adreg": tac.AdRegCellRunner,
            "slot_adreg": tas.SlotAdRegRunner}


def phase_mega(torch, tc, tm, tf, train, test):
    """Phase 20: ``MegaEpochRunner`` at dim 64 (pack 1, tiles 512, batch
    8192, mxu_pred on) on the stand-in, as ``_mf_runner_schedule`` builds
    its runners (two plans, saturating, bf16), 3 epochs from ``init_mf``'s
    tables at the CLI defaults; then epoch 1 timed against the plain
    version."""
    from tpu_mf_torch.config import TrainConfig
    from tpu_mf_torch.models.mf import init_mf

    cfg = TrainConfig(dim=DIM, iters=EPOCHS, gb=train.mean_rating())
    t = time.perf_counter()
    r = tm.MegaEpochRunner(train, dim=DIM, seed=cfg.seed, n_plans=2,
                           saturate=True, mxu="bfloat16",
                           device=DEVICE).materialize()
    torch.cuda.synchronize()
    eta = cfg.eta_at(1)
    log(f"# phase 20: mega runner built and staged in "
        f"{time.perf_counter() - t:.1f} s: pack {r.pack}, mxu_pred "
        f"{r.mxu_pred}, tiles {r.tile_u}x{r.tile_v}, batch {r.batch}, mega "
        f"{r.mega}, {[p.u.shape[0] for p in r.plans]} batches; window "
        f"duplicate maxima user {r._dup_max}, item {r._vdup_max}")
    init = init_mf(train.nu, train.nv, DIM, cfg.gb,
                   torch.Generator().manual_seed(cfg.seed), DEVICE)
    _, launches = run_runner(torch, cfg, r, init, test, 20,
                             ("mega", "cell_epoch"), all_counts(tc, tm, tf))
    timed, _ = time_one_epoch(torch, tc, cfg, r, train, test, init, 1,
                              "mega", 20, ATOL_CELL_FULL)
    log(f"# phase 20: epoch 1 at eta {eta:g}: groups "
        f"{r.pick_theta_groups(eta)}/{r.pick_phi_groups(eta)}")
    time_cell_walks(torch, tc, r, lambda: r.pad(init), eta, cfg.lam,
                    float(init.gb), 1, 20, "mega epoch 1", ATOL_CELL_FULL)
    return launches, timed


def phase_free(torch, tc, tm, tf, train, test, yardsticks=False):
    """Phase 21: ``FreeEpochRunner`` at dim 64 (tiles 128, picked batch,
    balance and saturation on, mxu_pred on) on the stand-in, two plans,
    bf16, 3 epochs from ``init_mf``'s tables at the CLI defaults; then
    epoch 1 on the tile walk and the plain version (``time_free_walks``);
    with ``yardsticks`` the same epoch as the one-user-tile window plan on
    ``csrc/cell_sgd.cu`` (``free_window_yardstick``)."""
    from tpu_mf_torch.config import TrainConfig
    from tpu_mf_torch.models.mf import init_mf

    cfg = TrainConfig(dim=DIM, iters=EPOCHS, gb=train.mean_rating())
    t = time.perf_counter()
    r = tf.FreeEpochRunner(train, seed=cfg.seed, n_plans=2, mxu="bfloat16",
                           device=DEVICE).materialize()
    torch.cuda.synchronize()
    p = r.plan
    cols = p.gu.size
    log(f"# phase 21: free runner built and staged in "
        f"{time.perf_counter() - t:.1f} s: tiles {p.tile_u}x{p.tile_v} "
        f"({p.n_gu}x{p.n_gv}), batch {r.batch}, "
        f"{[q.u.shape[0] for q in r.plans]} batches, {cols} columns, fill "
        f"{p.n_real / p.u.size:.3f}, "
        f"{int((p.w.sum(axis=1) == 0).sum())} sentinel columns; window "
        f"duplicate maxima user {r._dup_max}, item {r._vdup_max}")
    init = init_mf(train.nu, train.nv, DIM, cfg.gb,
                   torch.Generator().manual_seed(cfg.seed), DEVICE)
    _, launches = run_runner(torch, cfg, r, init, test, 21,
                             ("free", "free_epoch"), all_counts(tc, tm, tf))
    log_walk(21, "free", r)
    eta, it = cfg.eta_at(1), 1
    tg, pg = r.pick_theta_groups(eta), r.pick_phi_groups(eta)
    cap = max(1.0, 0.2 / eta)
    timed, want = time_free_walks(torch, tf, cfg, r, train, test, init, it,
                                  eta, tg, pg, cap)
    if yardsticks:
        free_window_yardstick(torch, tc, tf, cfg, r, init, it, eta, tg, pg,
                              cap, timed, want)
    return launches, timed


def free_window_yardstick(torch, tc, tf, cfg, r, init, it, eta, tg, pg, cap,
                          timed, want):
    """Phase 21 with ``--yardsticks``: the free epoch as the one-user-tile
    window plan (``free_window_plan``) on ``csrc/cell_sgd.cu``, which no
    route takes; timed twice and held to the free plain version."""
    t = time.perf_counter()
    window = tc.upload_plan(tf.free_window_plan(r.plans[it % 2]), DEVICE)
    torch.cuda.synchronize()
    log(f"# phase 21: one-user-tile window plan (tile_u "
        f"{window.tile_u}) converted and staged in "
        f"{time.perf_counter() - t:.1f} s")
    ms = []
    for _ in range(2):
        tabs = r.pad(init)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        tc.cell_epoch(*tabs, window, eta, cfg.lam, cfg.gb, cap, DIM, tg, pg,
                      r.work_dtype, r.saturate, r.mxu_pred)
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    log(f"# phase 21: the epoch as a one-user-tile window plan on cell_sgd: "
        f"epoch ms {[round(x, 3) for x in ms]} (free_cells {timed[0]:.3f})")
    hold("the one-user-tile window plan on cell_sgd vs the free plain "
         "version", r.trim(tabs), want, init, ATOL_CELL_FULL, 21)


def time_free_walks(torch, tf, cfg, r, train, test, init, it, eta, tg, pg,
                    cap):
    """Epoch ``it`` of ``FreeEpochRunner`` ``r`` from ``init``: the plain
    version once, then the tile walk twice, timed with CUDA events and
    held to the plain version; the tile walk at each cluster size of
    FREE_PROBE in turns, each held too; the tile walk's clocks per window
    step by phase (a ``-DTMF_TILE_CLOCKS`` build). Returns the tile walk's
    and the plain version's median ms with the bound, and the plain
    version's tables."""
    from tpu_mf_torch.models.mf import rmse

    idx = it % len(r._dev)
    plan = r._dev[idx]
    gb = float(init.gb)
    times, out = {"plain": [], "tile": []}, {}

    def run(which, tabs):
        if which == "plain":
            tf.free_epoch_reference(*tabs, plan, eta, cfg.lam, gb, cap, DIM,
                                    tg, pg, r.work_dtype, r.saturate,
                                    r.mxu_pred)
        else:
            r.epoch(tabs, eta, cfg.lam, gb, epoch_idx=it)

    def timed_run(which):
        tabs = r.pad(init)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        run(which, tabs)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b), r.trim(tabs)

    for which in ("plain", "tile", "tile"):
        ms, tabs = timed_run(which)
        times[which].append(ms)
        out.setdefault(which, tabs)
    n = len(train)
    for what, ts in times.items():
        log(f"# phase 21: free {what}: epoch ms {[round(x, 3) for x in ts]}, "
            f"rating updates/s {[round(n / (x / 1e3)) for x in ts]}")
    hold(f"free epoch {it} (eta {eta:g}, groups {tg}/{pg}, "
         f"{plan.u.shape[0]} batches, columns of {plan.u.shape[2]}), tile "
         "walk vs plain", out["tile"], out["plain"], init, ATOL_CELL_FULL, 21)
    rm_k, rm_p = rmse(out["tile"], test), rmse(out["plain"], test)
    log(f"# phase 21: free tRMSE tile walk {rm_k:.6f} plain {rm_p:.6f}")
    if not abs(rm_k - rm_p) <= 1e-3:
        raise AssertionError("free: tRMSE of the tile walk and plain "
                             "disagree")
    routed = plan.walk
    probe = {c: [] for c in FREE_PROBE}
    try:
        for c in FREE_PROBE:
            r._dev[idx] = plan._replace(walk=routed._replace(cluster=c))
            ms, tabs = timed_run("tile")
            probe[c].append(ms)
            hold(f"free tile walk on clusters of {c}", tabs, out["plain"],
                 init, ATOL_CELL_FULL, 21)
    finally:
        r._dev[idx] = plan
    log(f"# phase 21: free tile walk by cluster size (picked "
        f"{routed.cluster}), epoch ms in turns: " + "; ".join(
            f"{c}: {[round(x, 3) for x in ts]}" for c, ts in probe.items()))
    tile_clocks(torch, tf, "free", 21, "free", r,
                lambda tabs: run("tile", tabs), lambda: r.pad(init))
    p = r.plan
    return (median(times["tile"]), median(times["plain"]),
            free_bound(plan, p.n_gu * p.tile_u, p.n_gv * p.tile_v, n,
                       cfg.dim)), out["plain"]


# ---- item-sharded epochs (phases 22-23), resume and bf16 tables (24-25) ----

# the Yahoo stand-in of bench.py:315: the reference's Yahoo catalog
# (src/run.py:6-9) at 20M ratings of the ML-10M calibration, seed 11
Y_USERS, Y_ITEMS, Y_RATINGS, Y_SEED = 1_000_990, 624_961, 20_000_000, 11
# the CLI's default rank: 256-lane rows, 18 item shards at the stand-in
Y_DIM = 128
# phase 23: the (theta, phi) groups the Yahoo cell's shards take as eta
# falls, and two where the phi side is the wider, shard 0 timed at each
Y_GROUPS = ((8, 8), (4, 4), (4, 8), (2, 2), (2, 4), (4, 2), (1, 1))


def yahoo_corner(rng, tu, tv, n_gu, n_gv):
    """Uniform ratings on n_gu x n_gv tiles of tu x tv at the Yahoo
    stand-in's density."""
    from tpu_mf_torch.data.coo import RatingsCOO

    nu, nv = n_gu * tu, n_gv * tv
    n = int(nu * nv * Y_RATINGS / (Y_USERS * Y_ITEMS))
    ds = RatingsCOO(u=rng.integers(0, nu, n), v=rng.integers(0, nv, n),
                    r=rng.uniform(0.5, 5.0, n), nu=nu, nv=nv)
    return ds, n


def phase_compare_sharded(torch, rng):
    """Phase 22: ``PhiShardedRunner`` at the stand-in's geometry (tiles
    4096x2040, batch 4096, dim 128) on 2x4 tiles at its density, a budget
    of two item tiles a shard (K = 2), one epoch through the kernel (K
    launches) against every shard's sub-epoch through the plain version,
    theta chained, both working types, at 8/8 groups and at the groups eta
    0.02 picks."""
    from tpu_mf_torch.models.mf import params_from_numpy
    from tpu_mf_torch.ops import sgd_cells as tc
    from tpu_mf_torch.ops.phi_shard import PhiShardedRunner
    from tpu_mf_torch.ops.rows import row_lanes

    tu, tv, batch = 4096, 2040, 4096
    ds, n = yahoo_corner(rng, tu, tv, 2, 4)
    tabs = tables(rng, ds, Y_DIM)
    for mxu in ("float32", "bfloat16"):
        for groups in ((8, 8), (None, None)):
            r = PhiShardedRunner(
                ds, dim=Y_DIM, tile_u=tu, tile_v=tv, batch=batch, seed=1,
                mxu=mxu, budget=2 * tv * row_lanes(Y_DIM) * 4,
                theta_groups=groups[0], phi_groups=groups[1], device=DEVICE)
            if r.n_shards != 2:
                raise AssertionError(f"{r.n_shards} shards, want 2")
            eta, lam, gb = 0.02, 5e-3, 3.5
            got = r.pad(params_from_numpy(*tabs, gb, device=DEVICE))
            want = r.pad(params_from_numpy(*tabs, gb, device=DEVICE))
            for inner, phi_k in zip(r.inners, want[1]):
                plain_epoch(tc, inner, (want[0], phi_k), eta, lam, gb, 0)
            before = tc.cell_epoch.launches
            r.epoch(got, eta, lam, gb)
            torch.cuda.synchronize()
            if tc.cell_epoch.launches != before + r.n_shards:
                raise AssertionError("not one launch a shard")
            err = max(float((a - b).abs().max())
                      for a, b in zip(r.trim(got)[:4], r.trim(want)[:4]))
            g = [(i.pick_theta_groups(eta), i.pick_phi_groups(eta))
                 for i in r.inners]
            log(f"# phase 22: phi_shard vs plain, {mxu}, groups {g}, "
                f"{r.n_shards} shards of {r.shard_rows} items, tiles "
                f"{tu}x{tv}, batch {batch}, "
                f"{[i.plan.u.shape[0] for i in r.inners]} batches, dim "
                f"{Y_DIM}, {n} ratings: max_abs_err {err:.3e} "
                f"(atol {ATOL_CELL[mxu]:g})")
            if not err <= ATOL_CELL[mxu]:
                raise AssertionError(f"phi_shard disagrees ({mxu}): {err}")


def load_yahoo():
    from tpu_mf_torch.data.coo import synthetic_ratings

    t = time.perf_counter()
    ds = synthetic_ratings(
        Y_USERS, Y_ITEMS, Y_RATINGS, rank=8, seed=Y_SEED,
        noise=0.76, signal=1.0, bias_std=0.38,
        zipf=1.0, zipf_q=50.0, zipf_u=1.0, zipf_uq=250.0,
    )
    train, test = ds.split(0.1, seed=1)
    log(f"# phase 23: Yahoo-shape stand-in (nu {Y_USERS}, nv {Y_ITEMS}): "
        f"{len(train)} train / {len(test)} test ratings in "
        f"{time.perf_counter() - t:.1f} s")
    return train, test


def phase_sharded(torch, tc, train, test):
    """Phase 23: the item-sharded path at the Yahoo stand-in, dim 128, the
    CLI's default hyperparameters. The main path: ``train_mf`` on ``cuda``
    for 3 epochs, which must run ``PhiShardedRunner`` with K ``cell_sgd``
    launches every epoch and a falling tRMSE; its plan build and set-up
    timed, each epoch timed with CUDA events around the runner's
    ``epoch`` and each eval (trim, tRMSE) up to its log line, the peak
    device memory of the run beside the memory held before it. Then, on
    the runner that run built (its plans), shard 0's sub-epoch of epoch 1
    from ``init_mf``'s tables through the plain version and the kernel
    (twice), timed and held as in phase 9. Returns the launches, shard 0's
    sub-epoch (ms, plain ms, bound from the rows its plan touches) and
    error against the plain version, and the shard count."""
    from tpu_mf_torch.models.mf import init_mf
    from tpu_mf_torch.ops.phi_shard import PhiShardedRunner

    timed, evals = [], []

    def on_line(line):
        if line.startswith("iter#"):
            evals.append(torch.cuda.Event(enable_timing=True))
            evals[-1].record()

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with keep_built(torch, timed=timed) as kept:
        cfg, params, rm, lines, per_epoch = run_main_path(
            torch, train, test, 23, Y_DIM, EPOCHS, True, on_line=on_line)
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    (sched, built), = kept
    (_, r), = sched
    k_shards = r.n_shards
    head = (f"# item table exceeds VMEM (nv={train.nv}): item-sharded fused "
            f"epochs, {k_shards} shards")
    if not (isinstance(r, PhiShardedRunner)
            and any(x.startswith(head) for x in lines)):
        raise AssertionError("the sharded runner did not carry the epochs")
    launches = only(per_epoch, "cell_sgd", range(1, EPOCHS + 1), k_shards)
    only(per_epoch, "dense_cell", ())
    if PhiShardedRunner.launches != launches:
        raise AssertionError("a cell_sgd launch outside the sharded runner")
    if len(timed) != EPOCHS or len(evals) != EPOCHS:
        raise AssertionError("not one timed epoch and eval an epoch")
    iters = [x for x in lines if x.startswith("iter#")]
    log(f"# phase 23: PhiShardedRunner: {k_shards} shards of "
        f"{r.shard_rows} items, tiles {r.tile_u}x{r.tile_v}, batch "
        f"{r.batch}, {[i.plan.u.shape[0] for i in r.inners[:3]]}... batches "
        f"a shard plan, {r.n_slots} slots a plan rotation; plans built in "
        f"{built:.1f} s (balance maps, 2 plans a shard, window stats); "
        f"train_mf's set-up before epoch 1 (plans, upload, fused tables) "
        f"{wall - float(iters[-1].split()[1]):.1f} s")
    for it, ((_, a, b), c) in enumerate(zip(timed, evals), 1):
        eta = cfg.eta_at(it)
        ep, ev = a.elapsed_time(b), b.elapsed_time(c)
        groups = sorted({(i.pick_theta_groups(eta), i.pick_phi_groups(eta))
                         for i in r.inners})
        log(f"# phase 23: epoch {it} (eta {eta:g}, groups {groups}): "
            f"{ep:.3f} ms, {len(train) / (ep / 1e3):.0f} rating updates/s; "
            f"eval {ev:.3f} ms ({ev / (ep + ev):.1%} of epoch and eval); "
            f"tRMSE {rm[it - 1]:.6f}")
    log(f"# phase 23: peak device memory of train_mf's run "
        f"{peak / 2**30:.2f} GiB, of which {held / 2**30:.2f} GiB was held "
        f"before it: {(peak - held) / 2**30:.2f} GiB its own")
    log(f"# phase 23: train_mf ran PhiShardedRunner on every epoch, "
        f"{k_shards} cell_sgd launches each; tRMSE {rm}")
    del params
    init = init_mf(train.nu, train.nv, Y_DIM, cfg.gb,
                   torch.Generator().manual_seed(cfg.seed), DEVICE)
    it, eta = 1, cfg.eta_at(1)
    inner = r.inners[0]
    idx = it % len(inner._dev)
    plan = inner._dev[idx]
    times, out = {"kernel": [], "plain": []}, {}
    for which in ("plain", "kernel", "kernel"):
        tabs = r.pad(init)
        shard = (tabs[0], tabs[1][0])
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        if which == "kernel":
            inner.epoch(shard, eta, cfg.lam, cfg.gb, epoch_idx=it)
        else:
            plain_epoch(tc, inner, shard, eta, cfg.lam, cfg.gb, it)
        b.record()
        torch.cuda.synchronize()
        times[which].append(a.elapsed_time(b))
        out.setdefault(which, r.trim(tabs))
    n0 = int(inner.plans[idx].n_real)
    for what, ts in times.items():
        log(f"# phase 23: shard 0 {what}: sub-epoch ms "
            f"{[round(x, 3) for x in ts]}, rating updates/s "
            f"{[round(n0 / (x / 1e3)) for x in ts]}")
    err = hold(f"shard 0 of epoch {it} (eta {eta:g}, groups "
               f"{inner.pick_theta_groups(eta)}/{inner.pick_phi_groups(eta)}"
               f", {plan.u.shape[0]} batches, {n0} ratings), kernel vs "
               "plain", out["kernel"], out["plain"], init, ATOL_CELL_FULL, 23)
    def shard0():
        tabs = r.pad(init)
        return tabs[0], tabs[1][0]

    for groups in Y_GROUPS:
        time_cell_walks(torch, tc, inner, shard0, eta, cfg.lam, cfg.gb, it,
                        23, "shard 0", ATOL_CELL_FULL, groups)
    for groups in Y_GROUPS[:2]:
        cell_clocks(torch, tc, inner, shard0, eta, cfg.lam, cfg.gb, it, 23,
                    "shard 0", groups)
    rows_u, rows_v = touched_rows(plan)
    p = inner.plan
    log(f"# phase 23: shard 0's plan touches {rows_u} of {p.n_gu * p.tile_u}"
        f" user rows and {rows_v} of {p.n_gv * p.tile_v} item rows")
    timed = (median(times["kernel"]), median(times["plain"]),
             window_bound(plan, rows_u, rows_v, n0, Y_DIM))
    return launches, timed, err, k_shards


def _raw_lines(chunk):
    """Rows (u, v, r) as the reference's raw ``u,v,r,t`` lines; r with 9
    significant digits, which a float32 survives exactly."""
    import io

    import numpy as np

    u, v, r = chunk
    buf = io.StringIO()
    np.savetxt(buf, np.column_stack([u, v, r.astype(np.float64),
                                     np.zeros(len(u))]),
               fmt=["%d", "%d", "%.9g", "%d"], delimiter=",")
    return buf.getvalue()


def write_raw(path, ds, workers=8):
    """``ds`` in the reference's raw text format (``n`` then ``u,v,r,t``
    lines, what ``read_raw`` reads), formatted by ``workers`` processes."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    n = len(ds)
    cuts = np.linspace(0, n, 4 * workers + 1).astype(int)
    chunks = [(ds.u[a:b], ds.v[a:b], ds.r[a:b])
              for a, b in zip(cuts[:-1], cuts[1:])]
    with ProcessPoolExecutor(workers, mp_context=mp.get_context("spawn")
                             ) as pool, open(path, "w") as f:
        f.write(f"{n}\n")
        for text in pool.map(_raw_lines, chunks):
            f.write(text)


_RAW = {}  # the ML-10M stand-in as raw text: "dir" and its file paths


def raw_standin(train, test, phase):
    """(train path, test path) of the ML-10M stand-in as the reference's raw
    text, written once a run (``write_raw``) into a temporary directory
    that ``main`` removes."""
    if not _RAW:
        t = time.perf_counter()
        d = tempfile.mkdtemp(prefix="chip_smoke_raw_")
        _RAW["dir"] = d
        for name, ds in (("train", train), ("test", test)):
            _RAW[name] = os.path.join(d, f"{name}.txt")
            write_raw(_RAW[name], ds)
        log(f"# phase {phase}: stand-in written as raw text in "
            f"{time.perf_counter() - t:.1f} s")
    return _RAW["train"], _RAW["test"]


def run_cli(argv):
    """``tpu_mf_torch.cli.main(argv)``, its standard output echoed and
    returned as lines."""
    import io

    from tpu_mf_torch.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(line)
    if rc != 0:
        raise AssertionError(f"the CLI exited {rc}: {argv}")
    return lines


def phase_resume(torch, cfg, train, test, params, rm):
    """Phase 24: ``--resume`` through the CLI at ML-10M shape, dim 64 on
    ``cuda`` (the dense kernel): the stand-in written as raw text, 2 epochs
    with ``--result P --resume``, then ``--iter 3``, which must print
    ``# resumed from round 2`` and run epoch 3 alone; its {P}_3 tables and
    tRMSE held to phase 3's uninterrupted 3 epochs of the same
    configuration (the kernel's ATOL_FULL, REL_FULL and a tRMSE within
    1e-3)."""
    from tpu_mf_torch.io.checkpoint import load_mf_binary

    paths = raw_standin(train, test, 24)
    with tempfile.TemporaryDirectory() as d:
        prefix = os.path.join(d, "model")
        args = ["--train", paths[0], "--test", paths[1], "--nu",
                str(train.nu), "--nv", str(train.nv), "--dim", str(DIM),
                "--bias", repr(cfg.gb), "--result", prefix, "--resume",
                "--device", DEVICE, "--iter", "2"]
        t = time.perf_counter()
        run_cli(args)
        t2 = time.perf_counter()
        states = sorted(os.listdir(d))
        lines = run_cli(args + ["--iter", "3", "--measure", "1"])
        log(f"# phase 24: CLI runs of 2 epochs and resumed to 3 with "
            f"--measure 1 in {t2 - t:.1f} s and "
            f"{time.perf_counter() - t2:.1f} s (reads, plans and the "
            f"ranking included); files after the first run {states}")
        if f"# resumed from round 2 ({prefix}.state)" not in lines:
            raise AssertionError("the second run did not resume round 2")
        iters = [x for x in lines if x.startswith("iter#")]
        if [x.split("\t")[0] for x in iters] != ["iter#3"]:
            raise AssertionError(f"the resumed run ran {iters}")
        ranking = [x for x in lines if x.startswith("recall@10=")]
        if len(ranking) != 1:
            raise AssertionError("--measure 1 printed no ranking line")
        got, _ = load_mf_binary(f"{prefix}_3", gb=cfg.gb, device=DEVICE)
    from tpu_mf_torch.models.mf import init_mf

    init = init_mf(train.nu, train.nv, DIM, cfg.gb,
                   torch.Generator().manual_seed(cfg.seed), DEVICE)
    hold("the resumed CLI run's epoch 3 vs phase 3's uninterrupted run",
         got, params, init, ATOL_FULL, 24)
    rm3 = float(iters[0].split("tRMSE=")[1])
    log(f"# phase 24: tRMSE after epoch 3: resumed {rm3:.6f}, "
        f"uninterrupted {rm[-1]:.6f}")
    if not abs(rm3 - rm[-1]) <= 1e-3:
        raise AssertionError("the resumed run's tRMSE disagrees")
    return ranking[0]


def phase_bf16(torch, train, test, rm):
    """Phase 25: ``train_mf`` with bfloat16 tables (``--dtype bfloat16``)
    at dim 64, 3 epochs on ``cuda``: the dense kernel every epoch, float32
    tables out (the fused kernels widen the rows, as ``tpu_mf``'s), tRMSE
    finite and falling, printed beside phase 3's float32 run."""
    _, params, brm, _, per_epoch = run_main_path(
        torch, train, test, 25, DIM, EPOCHS, True, dtype="bfloat16")
    only(per_epoch, "dense_cell", range(1, EPOCHS + 1))
    if params.theta.dtype != torch.float32:
        raise AssertionError(f"tables came back {params.theta.dtype}")
    log(f"# phase 25: tRMSE by epoch, bf16 tables {brm}, float32 tables "
        f"(phase 3) {rm}")
    if not abs(brm[-1] - rm[-1]) <= 1e-2:
        raise AssertionError("bf16 tables end far from float32's")


def stream_counts():
    """Every launch count of the kernels and runners set to 0: what a main
    path run reads afterwards."""
    from tpu_mf_torch.io.stream_fused import FusedStreamTrainer
    from tpu_mf_torch.ops import sgd_cells as tc

    counts = counters()
    for c in list(counts.values()) + [tc.cell_epoch, FusedStreamTrainer]:
        c.launches = 0
    return counts


@contextlib.contextmanager
def keep_trainers():
    """For the ``with`` block, keep every ``FusedStreamTrainer`` that
    ``train.loop`` builds in the yielded list, each with the seconds its
    ShardStore took (``store_s``) and the device plan of its first launch
    (``first``). Launches and counts are untouched."""
    from tpu_mf_torch.io.stream_fused import FusedStreamTrainer as cls

    init, launch, kept = cls.__init__, cls._launch, []

    def keep_init(self, *args, **kwargs):
        t = time.perf_counter()
        init(self, *args, **kwargs)
        self.store_s = time.perf_counter() - t
        self.first = None
        kept.append(self)

    def keep_launch(self, tables, plan, *args):
        if self.first is None:
            self.first = plan
        launch(self, tables, plan, *args)

    cls.__init__, cls._launch = keep_init, keep_launch
    try:
        yield kept
    finally:
        cls.__init__, cls._launch = init, launch


def spans_named(recs, name, **attrs):
    """The span records of ``name`` whose attributes hold ``attrs``."""
    return [r for r in recs if r["name"] == name
            and all(r["attrs"].get(k) == v for k, v in attrs.items())]


def span_s(rec):
    """A span record's host seconds."""
    return (rec["t1"] - rec["t0"]) * 1e-9


def shard_times(recs):
    """(plan s, upload ms, kernel ms) summed over a streamed run's span
    records: the shards' ``tmf.plan_build`` spans (host seconds, on the
    worker thread), ``tmf.plan_upload`` and ``tmf.sub_epoch`` (CUDA
    events)."""
    return (sum(map(span_s, spans_named(recs, "tmf.plan_build"))),
            sum(r["device_ms"] for r in spans_named(recs,
                                                    "tmf.plan_upload")),
            sum(r["device_ms"] for r in spans_named(recs, "tmf.sub_epoch")))


def phase_stream(torch, tc, train, test, gen1_rm):
    """Phase 26: the slice's main path at full size: ``python -m
    tpu_mf_torch.cli --alg mf --stream`` (``run_cli``) on the ML-10M
    stand-in's raw text, dim 64, 3 epochs, batch 8192, ``--nu/--nv``
    given: ``FusedStreamTrainer`` (tiles 512x512, one shard at the 20M
    default ``mem_limit``), one ``cell_sgd`` launch per shard and epoch at
    8/8 groups without saturation, tRMSE falling. Logged: the ShardStore
    build, per epoch the plan build or cache load, the upload and kernel
    times (CUDA events), the wall time and tRMSE, the run's peak device
    memory, and phase 4's in-memory gen-1 tRMSE beside it. Then epoch 1's
    launch (the first shard's plan of that run) from ``init_mf``'s tables
    through the plain version and the kernel (twice), timed and held as in
    phase 23. Returns the launches, the launch's (ms, plain ms, bound from
    the rows its plan touches), its error and the shard count."""
    from tpu_mf_torch.io.stream_fused import FusedStreamTrainer
    from tpu_mf_torch.models.mf import init_mf
    from tpu_mf_torch.train.metrics import recording

    paths = raw_standin(train, test, 26)
    gb = train.mean_rating()
    args = ["--alg", "mf", "--stream", "--train", paths[0], "--test",
            paths[1], "--nu", str(train.nu), "--nv", str(train.nv), "--dim",
            str(DIM), "--iter", str(EPOCHS), "--batch_size", "8192",
            "--bias", repr(gb), "--device", DEVICE]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    counts = stream_counts()
    t = time.perf_counter()
    with keep_trainers() as kept, recording() as recs:
        lines = run_cli(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    launches = tc.cell_epoch.launches
    (r,) = kept
    k = r.store.n_shards
    if not (launches == FusedStreamTrainer.launches == EPOCHS * k
            and len(spans_named(recs, "tmf.sub_epoch")) == EPOCHS * k):
        raise AssertionError(f"cell_sgd launches {launches}, trainer "
                             f"{FusedStreamTrainer.launches}, want "
                             f"{EPOCHS} x {k}")
    if any(c.launches for c in counts.values()):
        raise AssertionError("another kernel ran on the streamed path")
    rm = [float(x.split("tRMSE=")[1]) for x in lines if "tRMSE=" in x]
    if not (len(rm) == EPOCHS and all(map(math.isfinite, rm))
            and rm[-1] < rm[0]):
        raise AssertionError(f"tRMSE not finite and falling: {rm}")
    ends = [float(x.split("\t")[1]) for x in lines if x.startswith("iter#")]
    log(f"# phase 26: CLI --stream mf, dim {DIM}, {EPOCHS} epochs in "
        f"{wall:.1f} s (the test file's read included); ShardStore of "
        f"{r.n} ratings, {k} shard(s) of {r.store.tiles_per_shard} user "
        f"tiles, built in {r.store_s:.1f} s (scan and scatter: two text "
        f"passes); tiles {r.tile_u}x{r.tile_v}, batch {r.batch}")
    for it in range(1, EPOCHS + 1):
        es = [e for e in recs if e["attrs"].get("epoch") == it]
        plan_s, up, ker = shard_times(es)
        cached = spans_named(es, "tmf.plan_build")[0]["attrs"]["cached"]
        log(f"# phase 26: epoch {it}: plan {'cache load' if cached else 'build'} "
            f"{plan_s:.2f} s, upload {up:.1f} ms, kernel {ker:.3f} ms "
            f"({[e['device_ms'] for e in spans_named(es, 'tmf.sub_epoch')]}"
            f" a shard), wall {ends[it - 1] - (ends[it - 2] if it > 1 else 0):.2f}"
            f" s{' (the ShardStore included)' if it == 1 else ''}, tRMSE "
            f"{rm[it - 1]:.6f}, "
            f"{r.n / (ker / 1e3):.0f} rating updates/s of kernel time")
    log(f"# phase 26: peak device memory of the run {peak / 2**30:.2f} GiB, "
        f"of which {held / 2**30:.2f} GiB was held before it")
    log(f"# phase 26: tRMSE streamed {rm}; in-memory gen-1 (phase 4) "
        f"{gen1_rm if gen1_rm is not None else 'not run'}")
    init = init_mf(train.nu, train.nv, DIM, gb,
                   torch.Generator().manual_seed(0), DEVICE)
    eta, lam = 2e-2, 5e-3  # the CLI's defaults at epoch 1
    plan = r.first
    times, out = {"kernel": [], "plain": []}, {}
    for which in ("plain", "kernel", "kernel"):
        tabs = r.pad(init)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        if which == "kernel":
            r._launch(tabs, plan, eta, lam, gb)
        else:
            tc.cell_epoch_reference(*tabs, plan, eta, lam, gb,
                                    max(1.0, 0.2 / eta), DIM, 8, 8,
                                    r.work_dtype, False, True)
        b.record()
        torch.cuda.synchronize()
        times[which].append(a.elapsed_time(b))
        out.setdefault(which, r.trim(tabs))
    n0 = int(spans_named(recs, "tmf.sub_epoch")[0]["attrs"]["n_real"])
    for what, ts in times.items():
        log(f"# phase 26: epoch 1, shard 0 {what}: ms "
            f"{[round(x, 3) for x in ts]}, rating updates/s "
            f"{[round(n0 / (x / 1e3)) for x in ts]}")
    route = tc.cell_walk(plan, 8, 8).route
    err = hold(f"epoch 1's streamed launch ({plan.u.shape[0]} batches, {n0} "
               f"ratings, groups 8/8, no saturation, {route} walk), kernel "
               "vs plain",
               out["kernel"], out["plain"], init, ATOL_CELL_FULL, 26)
    rows_u, rows_v = touched_rows(plan)
    timed = (median(times["kernel"]), median(times["plain"]),
             window_bound(plan, rows_u, rows_v, n0, DIM))
    r.first = None
    return launches, timed, err, k


def phase_stream_shards(torch, tc, train, test):
    """Phase 27: ``FusedStreamTrainer`` on the stand-in's raw text with
    ``mem_limit`` 2,500,000 (4 shards), dim 64, one epoch (plan variant 1,
    built and cached): its wall time beside the sums of the shards' plan
    builds (the Prefetcher's thread), uploads and kernels, which shows how
    much the Prefetcher overlaps; one launch per shard, finite tables."""
    from tpu_mf_torch.io.stream_fused import FusedStreamTrainer
    from tpu_mf_torch.models.mf import init_mf
    from tpu_mf_torch.train.metrics import recording

    paths = raw_standin(train, test, 27)
    gb = train.mean_rating()
    t = time.perf_counter()
    r = FusedStreamTrainer(paths[0], batch=8192, mem_limit=STREAM_MEM_LIMIT,
                           plan_cache=2, device=DEVICE)
    store_s = time.perf_counter() - t
    try:
        tabs = r.pad(init_mf(r.nu, r.nv, DIM, gb,
                             torch.Generator().manual_seed(0), DEVICE))
        before = tc.cell_epoch.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        with recording() as recs:
            r.epoch(tabs, 2e-2, 5e-3, gb, epoch_idx=1)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
        k = r.store.n_shards
        if tc.cell_epoch.launches != before + k or k != STREAM_SHARDS:
            raise AssertionError(f"{k} shards, "
                                 f"{tc.cell_epoch.launches - before} launches")
        if not all(bool(torch.isfinite(x).all()) for x in tabs):
            raise AssertionError("non-finite tables after the epoch")
        plan_s, up, ker = shard_times(recs)
        subs = spans_named(recs, "tmf.sub_epoch")
        builds = spans_named(recs, "tmf.plan_build")
        log(f"# phase 27: {k} shards of {r.store.tiles_per_shard} user "
            f"tiles ({[e['attrs']['n_real'] for e in subs]} ratings), "
            f"ShardStore {store_s:.1f} s; one epoch {wall:.2f} s wall: plan "
            f"builds {plan_s:.2f} s ({[round(span_s(e), 2) for e in builds]}), "
            f"uploads {up:.1f} ms, kernels {ker:.1f} ms; the epoch's wall "
            f"beyond the plan builds {wall - plan_s:.2f} s")
    finally:
        r.close()


@contextlib.contextmanager
def timed_parse():
    """For the ``with`` block, every batch ``io/stream.py`` parses is timed
    on the thread that parses it (``time.thread_time``: that thread's CPU
    seconds, the waits for the interpreter lock left out); yields the
    one-element list the seconds add to."""
    from tpu_mf_torch.io import stream as tstream

    base, spent = tstream.stream_batches, [0.0]

    def timed(path, batch_size):
        it = base(path, batch_size)
        while True:
            t = time.thread_time()
            b = next(it, None)
            spent[0] += time.thread_time() - t
            if b is None:
                return
            yield b

    tstream.stream_batches = timed
    try:
        yield spent
    finally:
        tstream.stream_batches = base


def phase_stream_dp_ad(torch, train, test):
    """Phase 28: ``--alg dpmf --stream`` (dim 128, the SGLD step of phases
    12-13) and ``--alg admf --stream`` (dim 128, phase 16's lam, eta and
    eta_reg, the test set's halves as validation and test files) through
    the CLI on the stand-in's raw text, 1 round / epoch each, the
    per-batch path (no kernel launch). Each round's time beside the CPU
    seconds its parse took on the Prefetcher's thread (``timed_parse``):
    dpmf parses the file twice a round (the SGLD pass and the streamed
    train MSE), admf once; the set-up scan before the round is not in
    either."""
    paths = raw_standin(train, test, 28)
    valid, rest = test.split(0.5, seed=3)
    with tempfile.TemporaryDirectory() as d:
        vpath, tpath = os.path.join(d, "valid.txt"), os.path.join(d, "t.txt")
        write_raw(vpath, valid)
        write_raw(tpath, rest)
        base = ["--stream", "--train", paths[0], "--nu", str(train.nu),
                "--nv", str(train.nv), "--iter", "1", "--bias",
                repr(train.mean_rating()), "--device", DEVICE]
        runs = {
            "dpmf": ["--alg", "dpmf", "--test", paths[1], "--dim",
                     str(DIM_DP), "--eta", repr(SCAL_DP / len(train)),
                     "--hyperb", "1000"],
            "admf": ["--alg", "admf", "--valid", vpath, "--test", tpath,
                     "--dim", str(DIM_AD), "--lambda", repr(LAM_AD),
                     "--eta", repr(ETA_AD), "--eta_reg", repr(ETA_REG_AD)]}
        for alg, extra in runs.items():
            counts = stream_counts()
            t = time.perf_counter()
            with timed_parse() as parse:
                lines = run_cli(base + extra)
            wall = time.perf_counter() - t
            line = [x for x in lines if x.startswith(
                "round #1" if alg == "dpmf" else "iter#1")]
            if len(line) != 1 or "nan" in line[0]:
                raise AssertionError(f"{alg}: no finite first round")
            if any(c.launches for c in counts.values()):
                raise AssertionError(f"{alg}: a kernel ran on the per-batch "
                                     "path")
            secs = float(line[0].split("\t")[-1 if alg == "dpmf" else 1])
            log(f"# phase 28: --alg {alg} --stream: round 1 {secs:.1f} s, "
                f"of which its parse took {parse[0]:.1f} s of the "
                f"Prefetcher thread's CPU time ({2 if alg == 'dpmf' else 1} "
                f"pass(es)); the rest, {secs - parse[0]:.1f} s, is the "
                f"consumer's device work, staging and waits; the CLI call "
                f"{wall:.1f} s (the set-up scan of the file and the test and "
                f"valid reads included)")


def phase_measure(torch, params, train, test, cli_line):
    """Phase 29: ``--measure 1`` on phase 3's dense dim-64 model:
    ``ranking_metrics`` (recall / precision / ndcg at 10, the train items
    masked) timed on the card, beside the line phase 24's resumed CLI run
    printed; then ``recommend_topk`` for 1,024 users held against a
    float64 CPU computation of the same scores: every returned item's
    score within 1e-4 of the float64 top-10's, and the ids equal where the
    float64 gaps to the items before and after exceed 1e-4."""
    from tpu_mf_torch.models.eval import ranking_metrics
    from tpu_mf_torch.models.serving import recommend_topk

    torch.cuda.synchronize()
    t = time.perf_counter()
    m = ranking_metrics(params, test, train_ds=train, k=10)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    log(f"# phase 29: ranking_metrics on phase 3's model in {secs:.2f} s: "
        f"recall@10={m['recall@k']:f}\tprecision@10={m['precision@k']:f}"
        f"\tndcg@10={m['ndcg@k']:f}\tn_users={m['n_users']} "
        f"(n_truncated {m['n_truncated']}); phase 24's CLI: {cli_line}")
    step = max(1, train.nu // 1024)
    users = torch.arange(0, min(1024, train.nu) * step, step, device=DEVICE)
    idx, vals = recommend_topk(params, users, 10)
    f64 = [x.detach().double().cpu() for x in params[:4]]
    u = users.cpu()
    ref = (f64[0][u] @ f64[1].T + f64[2][u, None] + f64[3][None]
           + float(params.gb))
    top, top_idx = torch.topk(ref, 11, dim=1)
    got = ref.gather(1, idx.cpu())
    err = float((got - top[:, :10]).abs().max())
    verr = float((vals.double().cpu() - top[:, :10]).abs().max())
    gaps = top[:, :10] - top[:, 1:11]  # each position to the next
    prev = torch.cat([torch.full_like(gaps[:, :1], math.inf), gaps[:, :9]], 1)
    sure = (gaps > 1e-4) & (prev > 1e-4)
    same = bool((idx.cpu()[sure] == top_idx[:, :10][sure]).all())
    log(f"# phase 29: recommend_topk for {len(users)} users vs float64 on "
        f"the CPU: score of the returned items {err:.3e} from the float64 "
        f"top-10 (limit 1e-4), returned scores {verr:.3e}; ids equal at "
        f"all {int(sure.sum())} positions with gaps over 1e-4: {same}")
    if not (err <= 1e-4 and verr <= 1e-4 and same
            and 0.0 <= m["recall@k"] <= 1.0 and m["n_users"] > 0):
        raise AssertionError("recommend_topk disagrees with float64")


# ---- the rating-set SSE of calc_mse (phase 30) ----------------------------

def sse_sets(torch, train, test):
    """(name, nu, nv, u, v, r) of phase 30's rating sets, on the card."""
    from tpu_mf_torch.data.coo import synthetic_ratings

    t = time.perf_counter()
    ytest = synthetic_ratings(
        Y_USERS, Y_ITEMS, 2_000_000, rank=8, seed=Y_SEED, noise=0.76,
        signal=1.0, bias_std=0.38, zipf=1.0, zipf_q=50.0, zipf_u=1.0,
        zipf_uq=250.0)
    log(f"# phase 30: Yahoo-shape test set, {len(ytest)} ratings, in "
        f"{time.perf_counter() - t:.1f} s")
    return [(name, ds.nu, ds.nv,
             *(torch.as_tensor(getattr(ds, k)).to(DEVICE) for k in "uvr"))
            for name, ds in (("dpmf train", train), ("ML-10M test", test),
                             ("Yahoo test", ytest))]


def sse_bound(torch, nu, nv, u, v, dim):
    """Each rating's ids and rating read once, and each row it touches
    (factors and bias, float32) once; 2 dim + 5 float32 operations a
    rating."""
    rows = (torch.unique(u).numel() + torch.unique(v).numel()) * (dim + 1)
    n = u.numel()
    return bound(12 * n + 4 * rows, n * (2 * dim + 5), PEAK_F32)


def phase_rating_sse(torch, train, test):
    """Phase 30 (module docstring); returns the max relative error and
    (ms, plain ms, bound) of the DP-SGLD train set."""
    from tpu_mf_torch.models.mf import (MFParams, calc_mse,
                                        calc_mse_reference)
    from tpu_mf_torch.ops import rating_sse as rs
    from tpu_mf_torch.ops.rows import pad_params, split_params

    dim, reps = DIM_DP, 20
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out, worst = None, 0.0
    for name, nu, nv, u, v, r in sse_sets(torch, train, test):
        g = torch.Generator(device=DEVICE).manual_seed(nu)
        p = MFParams(*(0.1 * torch.randn(*s, generator=g, device=DEVICE)
                       for s in ((nu, dim), (nv, dim), (nu,), (nv,))),
                     torch.tensor(3.5, device=DEVICE))
        p = split_params(*pad_params(p, nu, nv), nu, nv, dim, p.gb)
        lay = rs.sse_layout(p.theta, p.phi)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        first = rs.rating_sse(*p, u, v, r)
        for _ in range(3):
            if not torch.equal(rs.rating_sse(*p, u, v, r), first):
                raise AssertionError("phase 30: two launches differ")
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(reps):
            rs.rating_sse(*p, u, v, r)
        e1.record()
        torch.cuda.synchronize()
        ms = e0.elapsed_time(e1) / reps
        k_mem = torch.cuda.max_memory_allocated() - base
        t, before = time.perf_counter(), rs.rating_sse.launches
        for _ in range(reps):
            got = calc_mse(p, u, v, r)
        host_ms = (time.perf_counter() - t) / reps * 1e3
        if rs.rating_sse.launches != before + reps:
            raise AssertionError("phase 30: calc_mse did not launch once a "
                                 "call")
        torch.cuda.reset_peak_memory_stats()
        e0.record()
        for _ in range(3):
            want = calc_mse_reference(p, u, v, r)
        e1.record()
        torch.cuda.synchronize()
        plain_ms = e0.elapsed_time(e1) / 3
        p_mem = torch.cuda.max_memory_allocated() - base
        err = abs(got - want) / want
        bf = MFParams(*(x.to(torch.bfloat16) for x in p[:4]), p.gb)
        got_bf = calc_mse(bf, u, v, r)
        want_bf = calc_mse_reference(bf, u, v, r)
        err_bf = abs(got_bf - want_bf) / want_bf
        bms, by = sse_bound(torch, nu, nv, u, v, dim)
        n = u.numel()
        gathered = 2 * n * dim * 4
        log(f"# phase 30: {name}: {n} ratings, nu {nu}, nv {nv}, "
            f"dim {dim}, layout {tuple(lay)}, grid {rs.grid_blocks(n, sms)}: "
            f"kernel {ms:.4f} ms ({gathered / ms / 1e6:.0f} GB/s of rows "
            f"gathered), calc_mse {host_ms:.4f} ms on the host clock, plain "
            f"{plain_ms:.3f} ms, bound {bms:.4f} ms ({by}); device memory "
            f"above the tables: kernel {k_mem / 2**20:.2f} MiB, plain "
            f"{p_mem / 2**20:.1f} MiB; mse {got:.9f} / plain {want:.9f} "
            f"(rel {err:.2e}), bf16 tables {got_bf:.9f} / {want_bf:.9f} "
            f"(rel {err_bf:.2e})")
        if max(err, err_bf) > SSE_RTOL:
            raise AssertionError(f"phase 30: rating_sse and its plain "
                                 f"version disagree on the {name} set")
        worst = max(worst, err, err_bf)
        if out is None:
            out = (ms, plain_ms, (bms, by))
        del p, bf
    return worst, out


def entry(name, replaces, launches, err, timed, source=None, walk=None):
    """A kernel's line of the JSON summary; ``walk`` names the walk of
    ``csrc/sgld_cells.cu`` that the main path took (and that ``ms`` and
    ``max_abs_err`` are of)."""
    ms, plain_ms, (bound_ms, bound_by) = timed
    out = {"name": name, "route": "cuda",
           "source": source or f"tpu_mf_torch/csrc/{name}.cu",
           "replaces": replaces, "launches": launches, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by,
           # no single PyTorch call computes an SGD, SGLD or AdaptReg epoch
           "library_ms": None}
    if walk is not None:
        out["walk"] = walk
    return out


# phases that run together: a later one reads what the first one made
PHASE_GROUPS = ((1,), (2,), (3, 5, 24, 25, 29), (4,), (6,), (7, 8, 9, 10),
                (11,), (12, 14), (13,), (15,), (16, 18), (17,), (19,), (20,),
                (21,), (22,), (23,), (26,), (27,), (28,), (30,))


def parse_args(argv):
    """(the phases to run, whether to time the yardsticks): every phase
    without ``--phases``, else the listed ones ("1,19-21"), each widened to
    its group, with phase 1 always."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases or ranges, e.g. 1,19-21")
    ap.add_argument("--yardsticks", action="store_true",
                    help="also time plans no route takes (phase 21: the "
                         "free epoch as a one-user-tile window plan on "
                         "cell_sgd.cu)")
    args = ap.parse_args(argv)
    return parse_phases(ap, args.phases), args.yardsticks


def parse_phases(ap, spec):
    every = {p for g in PHASE_GROUPS for p in g}
    if spec is None:
        return every
    asked = set()
    for part in spec.split(","):
        lo, _, hi = part.partition("-")
        asked.update(range(int(lo), int(hi or lo) + 1))
    if not asked <= every:
        ap.error(f"no phase {sorted(asked - every)}")
    return {1} | {p for g in PHASE_GROUPS if asked & set(g) for p in g}


def main(argv=None) -> int:
    phases, yardsticks = parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    os.environ["TPU_MF_PLAN_CACHE"] = "0"
    from tpu_mf_torch.ops import adreg_cells as tac
    from tpu_mf_torch.ops import adreg_slot as tas
    from tpu_mf_torch.ops import sgd_cells as tc
    from tpu_mf_torch.ops import sgd_dense as td
    from tpu_mf_torch.ops import sgd_free as tf
    from tpu_mf_torch.ops import sgd_mega as tm
    from tpu_mf_torch.ops import sgd_packed as tpk
    from tpu_mf_torch.ops import sgd_slot as tsl
    from tpu_mf_torch.ops import sgld_cells as tg
    from tpu_mf_torch.ops import sgld_slot as tss

    last = [time.perf_counter()]

    def lap(done):
        now = time.perf_counter()
        log(f"# phases {done}: {now - last[0]:.1f} s")
        last[0] = now

    def want(*ps):
        return any(p in phases for p in ps)

    def ran(*ps):
        return all(p in phases for p in ps)

    log(f"# phases to run: {sorted(phases)}")
    t_start = time.perf_counter()
    card = phase_build()
    if want(*range(2, 11), 12, 13, 14, 16, 17, 18, 20, 21, 26, 27, 28, 30):
        train, test = load_data()
    cell_src = "tpu_mf_torch/csrc/cell_sgd.cu"
    sgld_src = "tpu_mf_torch/csrc/sgld_cells.cu"
    adreg_src = "tpu_mf_torch/csrc/adreg_cells.cu"
    free_src = "tpu_mf_torch/csrc/free_cells.cu"
    ent = {}  # kernel name: its entry, where its phases ran
    if want(2):
        errs = phase_compare(torch, td, np.random.default_rng(0))
        cell_errs = phase_compare_cells(torch, tc, np.random.default_rng(1),
                                        tc.pick_cell_geometry(train))
        lap("1-2")
    if want(3):
        cfg, params, rm, launches = phase_train(torch, train, test)
        dense_t = phase_time(torch, td, cfg, train, test, params, rm)
        phase_checkpoint(torch, cfg, params)
        ranking = phase_resume(torch, cfg, train, test, params, rm)
        phase_bf16(torch, train, test, rm)
        phase_measure(torch, params, train, test, ranking)
        lap("3, 5, 24, 25, 29")
        if want(2):
            ent["dense_cell"] = entry(
                "dense_cell", "tpu_mf/ops/pallas_sgd_dense.py:239", launches,
                errs["wavefront", "bfloat16"], dense_t)
    if want(4):
        (ccfg, cparams, crm, claunches, crunner,
         cbuilt) = phase_train_cells(torch, train, test)
        cell_t = phase_time_cells(torch, tc, ccfg, train, test, cparams, crm,
                                  crunner, cbuilt)
        lap("4")
        if want(2):
            ent["cell_sgd"] = entry(
                "cell_sgd", "tpu_mf/ops/pallas_sgd.py:412", claunches,
                cell_errs["bfloat16"], cell_t)
    if want(6):
        phase_train_rank8(torch, train, test)
        lap("6")
    if want(7):
        (lcfg, lparams, lrm, geo_packed, geo_slots, plaunches,
         slaunches, sched) = phase_train_ladder(torch, train, test)
        lerrs = phase_compare_ladder(torch, tc, tpk, tsl,
                                     np.random.default_rng(2), geo_packed,
                                     geo_slots)
        init = phase_replay_ladder(torch, tc, lcfg, train, test, lparams,
                                   lrm, geo_packed, geo_slots, sched)
        packed_t, slot_t = phase_time_ladder(torch, tc, lcfg, train, test,
                                             init, sched)
        lap("7-10")
        ent["packed"] = entry(
            "packed", "tpu_mf/ops/pallas_sgd_packed.py:226", plaunches,
            lerrs["packed"]["bfloat16"], packed_t, cell_src)
        ent["slot"] = entry(
            "slot", "tpu_mf/ops/pallas_sgd_slot.py:606", slaunches,
            lerrs["slot"]["bfloat16"], slot_t, cell_src)
    if want(11):
        sgld_errs = phase_compare_sgld(torch, tg, tss,
                                       np.random.default_rng(3))
    if want(12):
        dcfg, dstate, sgld_launches, sgld_t, sgld_walk, sse_main = phase_dpmf(
            torch, tg, tss, train, test, 12, DIM_DP, "sgld")
        phase_checkpoint_dpmf(torch, dcfg, dstate)
    if want(13):
        _, _, slot_sgld_launches, slot_sgld_t, slot_sgld_walk, _ = phase_dpmf(
            torch, tg, tss, train, test, 13, DIM_DP8, "slot_sgld")
    if want(11, 12, 13):
        lap("11-14")
    if ran(11, 12):
        ent["sgld"] = entry(
            "sgld", "tpu_mf/ops/pallas_sgld.py:120", sgld_launches,
            sgld_errs["sgld"][sgld_walk, "bfloat16"], sgld_t, sgld_src,
            sgld_walk)
    if ran(11, 13):
        ent["slot_sgld"] = entry(
            "slot_sgld", "tpu_mf/ops/pallas_sgld_slot.py:59",
            slot_sgld_launches,
            sgld_errs["slot_sgld"][slot_sgld_walk, "bfloat16"], slot_sgld_t,
            sgld_src, slot_sgld_walk)
    if want(15):
        ad_errs = phase_compare_adreg(torch, tac, tas,
                                      np.random.default_rng(4))
        lap("15")
    if want(16, 17):
        atrain, avalid = train.split(0.05, seed=3)
    if want(16):
        acfg, astate, ad_launches, ad_t = phase_admf(
            torch, atrain, avalid, test, 16, DIM_AD, ETA_AD, "adreg", None)
        phase_checkpoint_admf(torch, acfg, astate, atrain.nu, atrain.nv)
        lap("16, 18")
    if want(17):
        slot_ad_launches, slot_ad_t = phase_slot_admf(
            torch, tas, tsl, atrain, avalid, test)
        lap("17")
    if ran(15, 16):
        ent["adreg"] = entry(
            "adreg", "tpu_mf/ops/pallas_adreg.py:46", ad_launches,
            ad_errs["adreg"]["bfloat16"], ad_t, adreg_src)
    if ran(15, 17):
        ent["slot_adreg"] = entry(
            "slot_adreg", "tpu_mf/ops/pallas_adreg_slot.py:51",
            slot_ad_launches, ad_errs["slot_adreg"]["bfloat16"], slot_ad_t,
            adreg_src)
    if want(19):
        mf_errs = phase_compare_mega_free(torch, tc, tpk, tm, tf,
                                          np.random.default_rng(5))
        lap("19")
    if want(20):
        mega_launches, mega_t = phase_mega(torch, tc, tm, tf, train, test)
        lap("20")
        if want(19):
            ent["mega"] = entry(
                "mega", "tpu_mf/ops/pallas_sgd_mega.py:105", mega_launches,
                mf_errs["mega"]["bfloat16"], mega_t, cell_src)
    if want(21):
        free_launches, free_t = phase_free(torch, tc, tm, tf, train, test,
                                           yardsticks)
        lap("21")
        if want(19):
            ent["free"] = entry(
                "free", "tpu_mf/ops/pallas_sgd_free.py:183", free_launches,
                mf_errs["free"]["bfloat16"], free_t, free_src)
    if want(22):
        phase_compare_sharded(torch, np.random.default_rng(6))
        lap("22")
    if want(23):
        ytrain, ytest = load_yahoo()
        shard_launches, shard_t, shard_err, k_shards = phase_sharded(
            torch, tc, ytrain, ytest)
        del ytrain, ytest
        lap("23")
        # ms, plain_ms, max_abs_err and the bound are of one full-size
        # sub-epoch (shard 0 of epoch 1), launches of the main path
        ent["phi_shard"] = dict(entry(
            "phi_shard", "tpu_mf/ops/pallas_sgd.py:412", shard_launches,
            shard_err, shard_t, cell_src), shards=k_shards)
    if want(26):
        stream_launches, stream_t, stream_err, stream_shards = phase_stream(
            torch, tc, train, test, crm if want(4) else None)
        lap("26")
        # ms, plain_ms, max_abs_err and the bound are of epoch 1's launch
        # (its first shard), launches of the main path's 3 epochs
        ent["stream"] = dict(entry(
            "stream", "tpu_mf/ops/pallas_sgd.py:412", stream_launches,
            stream_err, stream_t, cell_src), shards=stream_shards)
    if want(27):
        phase_stream_shards(torch, tc, train, test)
        lap("27")
    if want(28):
        phase_stream_dp_ad(torch, train, test)
        lap("28")
    if want(30):
        sse_err, sse_t = phase_rating_sse(torch, train, test)
        lap("30")
    if ran(12, 30):
        # launches of phase 12's main path (two a round); ms, plain_ms,
        # max_abs_err (here relative: of the mean squared error) and the
        # bound are of the DP-SGLD train set
        ent["rating_sse"] = entry("rating_sse", None, sse_main, sse_err,
                                  sse_t)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "tpu_mf"))
    if bad:
        raise AssertionError(f"the port imported JAX or tpu_mf: {bad[:5]}")
    log(f"# phases {sorted(phases)}: {time.perf_counter() - t_start:.1f} s")
    kinds = [k for k in ("dense_cell", "cell_sgd", "phi_shard", "stream",
                         "packed", "slot", "sgld", "slot_sgld", "adreg",
                         "slot_adreg", "mega", "free", "rating_sse")
             if k in ent]
    log(json.dumps({"kernels": [ent[k] for k in kinds]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        if _RAW:
            shutil.rmtree(_RAW["dir"], ignore_errors=True)
    sys.exit(rc)
