#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  1. build the CUDA kernels from the sources in the checkout;
  2. each kernel against its plain PyTorch version on the card, one dense
     epoch on a 6x6 grid of 256x256 cells at dim 64, in both working types;
  3. the main path: ``tpu_mf_torch.train.train_mf`` on ``cuda``, 3 epochs at
     dim 64 and the default CLI hyperparameters, on the ML-10M-shape
     calibrated stand-in (nu 69,878, nv 10,677, 10M ratings, split 90/10);
     the kernel's launch count must rise in every epoch and tRMSE must fall;
     then the same 3 epochs from the same tables through the runner, kernel
     and plain version in turns, timed with CUDA events;
  4. the {result}_3 checkpoint written, read back and checked.

The last lines are the kernels' JSON summary, the card's name and power
limit, and {"ok": true, "device": {...}}. Imports no JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

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
    _build.build("dense_cell")
    log(f"# phase 1: built dense_cell in {time.perf_counter() - t:.1f} s")
    for line in _build.build_logs.get("dense_cell", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"#   ptxas: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"# card: {card}")
    return card


def phase_compare(torch, td, rng):
    """Kernel vs plain version, one epoch on 6x6 cells of 256x256."""
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
                                mxu=mxu, device="cuda")
        got = r.pad(params_from_numpy(*tabs, gb, device="cuda"))
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


def phase_train(torch, td):
    from tpu_mf.config import TrainConfig
    from tpu_mf_torch.train import train_mf

    t = time.perf_counter()
    ds = calibrated_ml10m()
    train, test = ds.split(0.1, seed=1)
    log(f"# phase 3: data {len(train)} train / {len(test)} test ratings in "
        f"{time.perf_counter() - t:.1f} s")
    cfg = TrainConfig(dim=DIM, iters=EPOCHS, gb=train.mean_rating())
    lines, per_epoch = [], []

    def record(line):
        lines.append(line)
        log(line)
        if line.startswith("iter#"):
            per_epoch.append(td.dense_epoch.launches)

    td.dense_epoch.launches = 0
    t = time.perf_counter()
    params = train_mf(cfg, train, test, log=record, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = td.dense_epoch.launches
    counts = [b - a for a, b in zip([0] + per_epoch, per_epoch)]
    log(f"# phase 3: train_mf on cuda, {EPOCHS} epochs in {wall:.1f} s "
        f"(set-up included); dense_cell launches per epoch {counts}")
    if not any(x.startswith("# dense-cell kernel from epoch 1") for x in lines):
        raise AssertionError("the dense runner did not carry epoch 1")
    if len(counts) != EPOCHS or min(counts) < 1:
        raise AssertionError(f"dense_cell not launched in every epoch: {counts}")
    rm = [float(x.split("tRMSE=")[1]) for x in lines if "tRMSE=" in x]
    if not (len(rm) == EPOCHS and all(map(math.isfinite, rm))
            and rm[-1] < rm[0]):
        raise AssertionError(f"tRMSE not finite and falling: {rm}")
    return cfg, train, test, params, rm, launches


def phase_time(torch, td, cfg, train, test, params_final, rm):
    """The main path's epochs again from the same initial tables, kernel
    and plain version in turns, timed with CUDA events."""
    from tpu_mf_torch.models.mf import init_mf, rmse

    r = td.DenseEpochRunner(train, saturate=True, dim=DIM, device="cuda")
    init = init_mf(train.nu, train.nv, DIM, cfg.gb,
                   torch.Generator().manual_seed(cfg.seed), "cuda")
    kern, plain = r.pad(init), r.pad(init)
    t_k, t_p, err = [], [], 0.0
    for it in range(1, EPOCHS + 1):
        eta = cfg.eta_at(it)
        cap = max(1.0, 0.2 / eta)
        for which in (("plain", "kernel") if it % 2 else ("kernel", "plain")):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            if which == "kernel":
                r.epoch(kern, eta, cfg.lam, cfg.gb)
            else:
                td.dense_epoch_reference(*plain, r.cells, eta, cfg.lam,
                                         cfg.gb, cap, DIM)
            b.record()
            torch.cuda.synchronize()
            (t_k if which == "kernel" else t_p).append(a.elapsed_time(b))
        err = max(err, max(float((x - y).abs().max())
                           for x, y in zip(kern, plain)))
    n = len(train)
    for name, ts in (("dense_cell kernel", t_k), ("plain version", t_p)):
        log(f"# phase 3: {name}: epoch ms {[round(x, 3) for x in ts]}, "
            f"rating updates/s {[round(n / (x / 1e3)) for x in ts]}")
    # the runner replays train_mf's kernel epochs with its own densify,
    # whose atomics may sum duplicate ratings in another order
    same = max(float((x - y).abs().max()) for x, y in
               zip(r.trim(kern), params_final))
    rm_plain = rmse(r.trim(plain), test)
    log(f"# phase 3: kernel vs plain over {EPOCHS} full epochs: max_abs_err "
        f"{err:.3e} (atol {ATOL_FULL:g}); final tRMSE kernel {rm[-1]:.6f} "
        f"plain {rm_plain:.6f}; replay vs train_mf tables {same:.3e}")
    if not (err <= ATOL_FULL and same <= ATOL_FULL
            and abs(rm_plain - rm[-1]) <= 1e-3):
        raise AssertionError("kernel and plain version disagree at full size")
    return sorted(t_k)[len(t_k) // 2], sorted(t_p)[len(t_p) // 2]


def phase_checkpoint(torch, cfg, params):
    from tpu_mf_torch.io.checkpoint import load_mf_binary, save_mf_binary

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, f"model_{cfg.iters}")
        save_mf_binary(path, params, cfg.lam)
        back, lam = load_mf_binary(path, gb=cfg.gb, device="cuda")
        size = os.path.getsize(path)
    want = 16 + 4 * (N_USERS + N_ITEMS) * (DIM + 1)
    if size != want or lam != float(torch.tensor(cfg.lam)):
        raise AssertionError(f"checkpoint size {size} != {want} or lambda")
    for a, b in zip(back[:4], params[:4]):
        if a.shape != b.shape or not torch.equal(a, b.contiguous()):
            raise AssertionError("checkpoint does not read back")
        if not bool(torch.isfinite(a).all()):
            raise AssertionError("non-finite tables")
    log(f"# phase 4: checkpoint model_{cfg.iters} ({size} bytes) reads back")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from tpu_mf_torch.ops import sgd_dense as td

    card = phase_build()
    errs = phase_compare(torch, td, np.random.default_rng(0))
    cfg, train, test, params, rm, launches = phase_train(torch, td)
    ms, plain_ms = phase_time(torch, td, cfg, train, test, params, rm)
    phase_checkpoint(torch, cfg, params)
    if "jax" in sys.modules:
        raise AssertionError("the port imported JAX")
    log(json.dumps({"kernels": [{
        "name": "dense_cell", "route": "cuda",
        "source": "tpu_mf_torch/csrc/dense_cell.cu",
        "replaces": "tpu_mf/ops/pallas_sgd_dense.py:239",
        "launches": launches, "max_abs_err": errs["bfloat16"],
        "ms": ms, "plain_ms": plain_ms,
    }]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
