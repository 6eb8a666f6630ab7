"""MF training on one device (counterpart of the single-device, in-memory MF
part of ``tpu_mf/train/loop.py``).

Each epoch prints the reference's line (src/mf.h:35):

    iter#<n>\t<elapsed>\ttRMSE=<rmse>

Routing mirrors ``tpu_mf``: with ``cfg.use_pallas`` on a CUDA device the
fused kernel schedule runs (``_train_mf_fused``); otherwise every epoch is
the batched ``sgd_epoch``. Ratings are shuffled on the host
(``epoch_batches``), as ``tpu_mf`` does with ``device_shuffle=False``.
"""

from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Callable, Optional

import numpy as np
import torch

from tpu_mf.config import TrainConfig
from tpu_mf.data.coo import RatingsCOO, epoch_batches
from tpu_mf_torch.models.mf import MFParams, init_mf, rmse
from tpu_mf_torch.ops.sgd import sgd_epoch
from tpu_mf_torch.train.metrics import MetricsLogger, profile_trace


class _Observer:
    """--metrics JSONL lines, --trace capture and a once-per-run warning
    when the test RMSE stops being finite."""

    def __init__(self, cfg: TrainConfig, n_train: int,
                 log: Callable[[str], None] = print):
        self.cfg = cfg
        self.n_train = n_train
        self.ml = MetricsLogger(cfg.metrics) if cfg.metrics else None
        self._log = log
        self._diverged = False

    def trace(self):
        return profile_trace(self.cfg.trace)

    def epoch_done(self, rnd: int, **fields):
        if not self._diverged:
            v = fields.get("tRMSE")
            if v is not None and not np.isfinite(v):
                self._diverged = True
                self._log(
                    f"# WARNING: non-finite tRMSE at round {rnd} — SGD "
                    "diverged. A row repeated k times inside one apply "
                    "window takes k gradients computed at the same "
                    "point; at this eta and duplicate density that "
                    "overshoots (bias terms first). Reduce --eta, "
                    "raise --gam (faster decay), or shrink --batch."
                )
        if self.ml is not None:
            self.ml.count_updates(self.n_train)
            self.ml.log(round=rnd, **fields)

    def close(self):
        if self.ml is not None:
            self.ml.close()


class BatchedRunner:
    """The batched ``sgd_epoch`` behind the runner interface
    (pad / epoch / trim), so that one loop drives every schedule."""

    def __init__(self, train_ds: RatingsCOO, batch_size: int, seed: int):
        self.ds, self.batch_size, self.seed = train_ds, batch_size, seed

    def pad(self, params: MFParams) -> MFParams:
        return params

    def trim(self, params: MFParams) -> MFParams:
        return params

    def epoch(self, params: MFParams, eta: float, lam: float, gb: float,
              epoch_idx: int = 0) -> MFParams:
        del gb  # carried in params
        dev = params.theta.device
        u, v, r, w = epoch_batches(self.ds, self.batch_size, epoch_idx,
                                   self.seed)
        batches = (torch.as_tensor(u.astype(np.int64)).to(dev),
                   torch.as_tensor(v.astype(np.int64)).to(dev),
                   torch.as_tensor(r).to(dev), torch.as_tensor(w).to(dev))
        return sgd_epoch(params, batches, eta, lam)


def _unsupported(cfg: TrainConfig) -> Optional[str]:
    if cfg.mesh > 1:
        return "--mesh > 1 (multi-device training, ROADMAP Queue 1 item 10)"
    if cfg.resume:
        return "--resume (io/resume.py, ROADMAP Queue 1 item 13)"
    if cfg.dtype != "float32":
        return (f"--dtype {cfg.dtype} tables (float32 only so far, "
                "ROADMAP Queue 1 item 13)")
    return None


def train_mf(
    cfg: TrainConfig,
    train_ds: RatingsCOO,
    test_ds: Optional[RatingsCOO] = None,
    params: Optional[MFParams] = None,
    log: Callable[[str], None] = print,
    device: torch.device | str = "cpu",
) -> MFParams:
    """Biased-MF SGD training (reference: run(MF&), src/main.cc:36-52).

    ``params`` (if given) is copied, not modified; new tables are drawn
    from a ``torch.Generator`` seeded with ``cfg.seed``."""
    why = _unsupported(cfg)
    if why is not None:
        raise NotImplementedError(f"tpu_mf_torch does not port {why} yet")
    device = torch.device(device)
    if params is None:
        gen = torch.Generator().manual_seed(cfg.seed)
        params = init_mf(train_ds.nu, train_ds.nv, cfg.dim, cfg.gb, gen,
                         device)
    else:
        params = MFParams(*(t.to(device, torch.float32).clone()
                            for t in params))
    obs = _Observer(cfg, len(train_ds), log)
    try:
        with obs.trace():
            if cfg.use_pallas and device.type == "cuda":
                return _train_mf_fused(cfg, train_ds, test_ds, params, log,
                                       obs)
            sched = [(1, BatchedRunner(train_ds, cfg.batch_size, cfg.seed))]
            return _run_schedule(cfg, sched, test_ds, params, log, obs)
    finally:
        obs.close()


def _mf_runner_schedule(cfg, train_ds, params, log, start=0):
    """Epoch-indexed schedule ``[(first_epoch, runner), ...]``; each runner
    serves epochs [first_epoch, next phase's first_epoch).

    The dense-cell runner engages where ``tpu_mf``'s schedule engages it.
    The one-hot kernels that ``tpu_mf`` runs before that (or instead, when
    dense is ineligible) are not ported yet: those epochs run the batched
    ``sgd_epoch``, as ``tpu_mf --no-pallas`` does."""
    from tpu_mf_torch.ops.sgd_dense import (
        DenseEpochRunner,
        dense_eligible,
        dense_engage_epoch,
    )

    device = params.theta.device
    batched = BatchedRunner(train_ds, cfg.batch_size, cfg.seed)
    dense_from = None
    if cfg.use_dense and dense_eligible(params, train_ds):
        # bf16 storage and operands on the GPU; f32 keeps CPU runs exact
        dense_r = DenseEpochRunner(
            train_ds, saturate=True, dim=cfg.dim, device=device,
            mxu="bfloat16" if device.type == "cuda" else "float32",
        )
        dense_from = dense_engage_epoch(cfg.eta_at, cfg.iters, cfg.dim,
                                        dense_r.plan, start)
        if dense_from == start + 1:
            log(f"# dense-cell kernel from epoch {dense_from} "
                f"(k_cells {dense_r.k_cells})")
            return [(dense_from, dense_r)]
        if dense_from is not None:
            log(f"# dense-cell kernel engages at epoch {dense_from} "
                f"(eta {cfg.eta_at(dense_from):g}, k_cells "
                f"{dense_r.k_cells})")
    last = cfg.iters if dense_from is None else dense_from - 1
    log(f"# one-hot kernels (gen-1/packed/slot) not yet ported: epochs "
        f"{start + 1}..{last} use the batched path")
    sched = [(start + 1, batched)]
    if dense_from is not None:
        sched.append((dense_from, dense_r))
    return sched


def _train_mf_fused(cfg, train_ds, test_ds, params, log, obs,
                    start=0) -> MFParams:
    """MF epochs on the fused kernel schedule (``_mf_runner_schedule``)."""
    sched = _mf_runner_schedule(cfg, train_ds, params, log, start)
    return _run_schedule(cfg, sched, test_ds, params, log, obs, start)


def _run_schedule(cfg, sched, test_ds, params, log, obs,
                  start=0) -> MFParams:
    dev = params.theta.device
    if test_ds is not None:  # the test set crosses to the device once
        test_ds = SimpleNamespace(**{
            k: torch.as_tensor(getattr(test_ds, k)).to(dev) for k in "uvr"})
    runner = sched[0][1]
    upcoming = list(sched[1:])
    tables = runner.pad(params)
    gb = float(params.gb)
    t0 = time.perf_counter()
    for it in range(start + 1, cfg.iters + 1):
        while upcoming and it >= upcoming[0][0]:
            nxt = upcoming.pop(0)[1]
            log(f"# epoch {it}: switching to {type(nxt).__name__}")
            tables = nxt.pad(runner.trim(tables))
            runner = nxt
        tables = runner.epoch(tables, cfg.eta_at(it), cfg.lam, gb,
                              epoch_idx=it)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        elapsed = time.perf_counter() - t0
        t_rmse = None
        if test_ds is not None:
            t_rmse = rmse(runner.trim(tables), test_ds)
            log(f"iter#{it}\t{elapsed:f}\ttRMSE={t_rmse:f}")
        else:
            log(f"iter#{it}\t{elapsed:f}")
        obs.epoch_done(it, alg="mf", kernel=type(runner).__name__,
                       eta=cfg.eta_at(it), elapsed=elapsed, tRMSE=t_rmse)
    return MFParams(*(t.contiguous() for t in runner.trim(tables)))
