#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  1. build the CUDA kernels from the sources in the checkout, one nvcc per
     source, all at once;
  2. each kernel against its plain PyTorch version on the card, in both
     working types: one dense epoch on a 6x6 grid of 256x256 cells at dim
     64; one gen-1 epoch at the geometry the gen-1 path picks for the
     training set (``pick_cell_geometry``), on 6x6 tiles at ML-10M density;
  3. the dense path: ``tpu_mf_torch.train.train_mf`` on ``cuda``, 3 epochs
     at dim 64 and the default CLI hyperparameters, on the ML-10M-shape
     calibrated stand-in (nu 69,878, nv 10,677, 10M ratings, split 90/10);
     the dense kernel's launch count must rise in every epoch and tRMSE
     must fall; then the same 3 epochs from the same tables through the
     runner, kernel and plain version in turns, timed with CUDA events;
  4. the gen-1 path: the same run with ``use_dense=False`` (``--no-dense``):
     the gen-1 kernel must carry every epoch and the dense kernel none, and
     tRMSE must fall; then its epochs timed as in phase 3;
  5. the {result}_3 checkpoint written, read back and checked.

The last lines are the kernels' JSON summary, the card's name and power
limit, and {"ok": true, "device": {...}}. Imports no JAX. Plans are built
anew (``TPU_MF_PLAN_CACHE=0``): nothing is written outside the checkout.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

DEVICE = "cuda"
N_USERS, N_ITEMS, N_RATINGS = 69_878, 10_677, 10_000_000
DIM, EPOCHS = 64, 3
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
KERNELS = ("dense_cell", "cell_sgd")


def log(msg: str) -> None:
    print(msg, flush=True)


def calibrated_ml10m(seed: int = 0):
    """The ML-10M-shape stand-in of bench.py (Zipf-Mandelbrot marginals
    matched to the real dataset; benchmarks/ML10M_STUDY.md)."""
    from tpu_mf.data.coo import synthetic_ratings

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


def phase_compare(torch, td, rng):
    """Dense kernel vs plain version, one epoch on 6x6 cells of 256x256."""
    from tpu_mf.data.coo import RatingsCOO
    from tpu_mf_torch.models.mf import params_from_numpy

    nu = nv = 6 * 256
    n = int(nu * nv * N_RATINGS / (N_USERS * N_ITEMS))  # ML-10M density
    ds = RatingsCOO(u=rng.integers(0, nu, n), v=rng.integers(0, nv, n),
                    r=rng.uniform(0.5, 5.0, n), nu=nu, nv=nv)
    tabs = [rng.normal(0, 0.1, s).astype("float32")
            for s in ((nu, DIM), (nv, DIM), (nu,), (nv,))]
    eta, lam, gb = 0.02, 5e-3, 3.5
    errs = {}
    for mxu in ("float32", "bfloat16"):
        r = td.DenseEpochRunner(ds, tile_u=256, tile_v=256, k_cells=6,
                                mxu=mxu, device=DEVICE)
        got = r.pad(params_from_numpy(*tabs, gb, device=DEVICE))
        want = tuple(t.clone() for t in got)
        td.dense_epoch_reference(*want, r.cells, eta, lam, gb,
                                 max(1.0, 0.2 / eta), DIM)
        r.epoch(got, eta, lam, gb)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        errs[mxu] = err
        log(f"# phase 2: dense_cell vs plain, {mxu}, 6x6 cells of 256x256, "
            f"dim {DIM}, {n} ratings: max_abs_err {err:.3e} "
            f"(atol {ATOL[mxu]:g})")
        if not err <= ATOL[mxu]:
            raise AssertionError(f"dense_cell disagrees ({mxu}): {err}")
    return errs


def phase_compare_cells(torch, tc, rng, geometry):
    """Gen-1 kernel vs plain version, one epoch at the gen-1 path's geometry
    on 6x6 tiles at ML-10M density, fully sequential (8/8 groups) and at an
    eta whose windows span 2+ columns, saturating."""
    from tpu_mf.data.coo import RatingsCOO
    from tpu_mf_torch.models.mf import params_from_numpy

    tu, tv, batch = geometry
    nu, nv = 6 * tu, 6 * tv
    n = int(nu * nv * N_RATINGS / (N_USERS * N_ITEMS))
    ds = RatingsCOO(u=rng.integers(0, nu, n), v=rng.integers(0, nv, n),
                    r=rng.uniform(0.5, 5.0, n), nu=nu, nv=nv)
    tabs = [rng.normal(0, 0.1, s).astype("float32")
            for s in ((nu, DIM), (nv, DIM), (nu,), (nv,))]
    lam, gb = 5e-3, 3.5
    errs = {}
    for mxu in ("float32", "bfloat16"):
        r = tc.CellEpochRunner(ds, tile_u=tu, tile_v=tv, batch=batch,
                               mxu=mxu, saturate=True, device=DEVICE)
        r.pad(params_from_numpy(*tabs, gb, device=DEVICE))
        for eta in (0.05, 0.2 / max(r._dup_max[2], r._vdup_max[2])):
            tg, pg = r.pick_theta_groups(eta), r.pick_phi_groups(eta)
            got = r.pad(params_from_numpy(*tabs, gb, device=DEVICE))
            want = tuple(t.clone() for t in got)
            tc.cell_epoch_reference(*want, r._dev[0], eta, lam, gb,
                                    max(1.0, 0.2 / eta), DIM, tg, pg,
                                    r.work_dtype, True, r.mxu_pred)
            r.epoch(got, eta, lam, gb)
            torch.cuda.synchronize()
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            errs[mxu] = max(errs.get(mxu, 0.0), err)
            log(f"# phase 2: cell_sgd vs plain, {mxu}, groups {tg}/{pg}, "
                f"{r.plan.u.shape[0]} batches of {batch} at tiles {tu}x{tv}, "
                f"dim {DIM}, {n} ratings: max_abs_err {err:.3e} "
                f"(atol {ATOL_CELL[mxu]:g})")
            if not err <= ATOL_CELL[mxu]:
                raise AssertionError(f"cell_sgd disagrees ({mxu}): {err}")
    return errs


def load_data():
    t = time.perf_counter()
    ds = calibrated_ml10m()
    train, test = ds.split(0.1, seed=1)
    log(f"# data: {len(train)} train / {len(test)} test ratings in "
        f"{time.perf_counter() - t:.1f} s")
    return train, test


def run_main_path(torch, train, test, phase, use_dense):
    """train_mf on cuda with every kernel count set to 0 just before; the
    per-epoch launch counts of both kernels read just after."""
    from tpu_mf.config import TrainConfig
    from tpu_mf_torch.ops import sgd_cells as tc
    from tpu_mf_torch.ops import sgd_dense as td
    from tpu_mf_torch.train import train_mf

    cfg = TrainConfig(dim=DIM, iters=EPOCHS, gb=train.mean_rating(),
                      use_dense=use_dense)
    counters = {"dense_cell": td.dense_epoch, "cell_sgd": tc.cell_epoch}
    lines, marks = [], []

    def record(line):
        lines.append(line)
        log(line)
        if line.startswith("iter#"):
            marks.append({k: c.launches for k, c in counters.items()})

    for c in counters.values():
        c.launches = 0
    t = time.perf_counter()
    params = train_mf(cfg, train, test, log=record, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    per_epoch = {k: [b[k] - a[k] for a, b in zip([dict.fromkeys(marks[0], 0)]
                                                 + marks, marks)]
                 for k in marks[0]} if marks else {}
    log(f"# phase {phase}: train_mf(use_dense={use_dense}) on cuda, {EPOCHS} "
        f"epochs in {wall:.1f} s (set-up included); launches per epoch "
        f"dense_cell {per_epoch.get('dense_cell')}, cell_sgd "
        f"{per_epoch.get('cell_sgd')}")
    rm = [float(x.split("tRMSE=")[1]) for x in lines if "tRMSE=" in x]
    if not (len(rm) == EPOCHS and all(map(math.isfinite, rm))
            and rm[-1] < rm[0]):
        raise AssertionError(f"tRMSE not finite and falling: {rm}")
    return cfg, params, rm, lines, per_epoch


def phase_train(torch, train, test):
    cfg, params, rm, lines, per_epoch = run_main_path(torch, train, test, 3,
                                                      True)
    if not any(x.startswith("# dense-cell kernel from epoch 1") for x in lines):
        raise AssertionError("the dense runner did not carry epoch 1")
    counts = per_epoch.get("dense_cell", [])
    if len(counts) != EPOCHS or min(counts) < 1:
        raise AssertionError(f"dense_cell not launched in every epoch: {counts}")
    return cfg, params, rm, sum(counts)


def phase_train_cells(torch, train, test):
    cfg, params, rm, lines, per_epoch = run_main_path(torch, train, test, 4,
                                                      False)
    if not any(x.startswith(f"# gen-1 cell kernel: epochs 1..{EPOCHS}")
               for x in lines):
        raise AssertionError("the gen-1 runner did not carry the epochs")
    counts = per_epoch.get("cell_sgd", [])
    if len(counts) != EPOCHS or min(counts) < 1:
        raise AssertionError(f"cell_sgd not launched in every epoch: {counts}")
    if sum(per_epoch.get("dense_cell", [])) != 0:
        raise AssertionError("the dense kernel ran with use_dense=False")
    return cfg, params, rm, sum(counts)


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
    return sorted(t_k)[len(t_k) // 2], sorted(t_p)[len(t_p) // 2]


def phase_time(torch, td, cfg, train, test, params_final, rm):
    r = td.DenseEpochRunner(train, saturate=True, dim=DIM, device=DEVICE)

    def plain(tables, eta, it):
        td.dense_epoch_reference(*tables, r.cells, eta, cfg.lam, cfg.gb,
                                 max(1.0, 0.2 / eta), DIM)

    return time_in_turns(torch, cfg, r, plain, train, test, params_final, rm,
                         3, "dense_cell", ATOL_FULL)


def phase_time_cells(torch, tc, cfg, train, test, params_final, rm):
    t = time.perf_counter()
    tu, tv, b = tc.pick_cell_geometry(train)
    r = tc.CellEpochRunner(train, tile_u=tu, tile_v=tv, batch=b,
                           seed=cfg.seed, n_plans=2, balance=True,
                           saturate=True, device=DEVICE)
    built = time.perf_counter() - t
    r.materialize()
    torch.cuda.synchronize()
    log(f"# phase 4: plans built in {built:.1f} s (2 plans, balance maps, "
        f"window stats), uploaded in {time.perf_counter() - t - built:.1f} s;"
        f" {r.plan.u.shape[0]} batches of {b}, tiles {tu}x{tv}")
    for it in range(1, EPOCHS + 1):
        eta = cfg.eta_at(it)
        log(f"# phase 4: epoch {it}: eta {eta:g}, groups "
            f"{r.pick_theta_groups(eta)}/{r.pick_phi_groups(eta)}")

    def plain(tables, eta, it):
        tc.cell_epoch_reference(
            *tables, r._dev[it % 2], eta, cfg.lam, cfg.gb,
            max(1.0, 0.2 / eta), DIM, r.pick_theta_groups(eta),
            r.pick_phi_groups(eta), r.work_dtype, True, r.mxu_pred)

    return time_in_turns(torch, cfg, r, plain, train, test, params_final,
                         rm, 4, "cell_sgd", ATOL_CELL_FULL)


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    os.environ["TPU_MF_PLAN_CACHE"] = "0"
    from tpu_mf_torch.ops import sgd_cells as tc
    from tpu_mf_torch.ops import sgd_dense as td

    card = phase_build()
    errs = phase_compare(torch, td, np.random.default_rng(0))
    train, test = load_data()
    cell_errs = phase_compare_cells(torch, tc, np.random.default_rng(1),
                                    tc.pick_cell_geometry(train))
    cfg, params, rm, launches = phase_train(torch, train, test)
    ms, plain_ms = phase_time(torch, td, cfg, train, test, params, rm)
    ccfg, cparams, crm, claunches = phase_train_cells(torch, train, test)
    cms, cplain_ms = phase_time_cells(torch, tc, ccfg, train, test, cparams,
                                      crm)
    phase_checkpoint(torch, cfg, params)
    if "jax" in sys.modules:
        raise AssertionError("the port imported JAX")
    log(json.dumps({"kernels": [{
        "name": "dense_cell", "route": "cuda",
        "source": "tpu_mf_torch/csrc/dense_cell.cu",
        "replaces": "tpu_mf/ops/pallas_sgd_dense.py:239",
        "launches": launches, "max_abs_err": errs["bfloat16"],
        "ms": ms, "plain_ms": plain_ms,
    }, {
        "name": "cell_sgd", "route": "cuda",
        "source": "tpu_mf_torch/csrc/cell_sgd.cu",
        "replaces": "tpu_mf/ops/pallas_sgd.py:412",
        "launches": claunches, "max_abs_err": cell_errs["bfloat16"],
        "ms": cms, "plain_ms": cplain_ms,
    }]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
