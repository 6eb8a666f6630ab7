"""MF, DP-SGLD and AdaptReg training on one device (counterpart of the
single-device, in-memory MF, DPMF and AdaptRegMF parts of
``tpu_mf/train/loop.py``).

Each MF or AdaptReg epoch prints the reference's line (src/mf.h:35):

    iter#<n>\t<elapsed>\ttRMSE=<rmse>

and each DPMF round ``round #<n>\tRMSE=<train>\ttRMSE=<test>\t<elapsed>``.

Routing mirrors ``tpu_mf``: with ``cfg.use_pallas`` on a CUDA device the
fused kernels run (``_train_mf_fused``; ``_dpmf_runner``;
``_admf_runner``); otherwise every epoch is the batched ``sgd_epoch`` /
``sgld_epoch`` / ``adreg_epoch``. Ratings are shuffled on the host
(``epoch_batches``), as ``tpu_mf`` does with ``device_shuffle=False``.

Out of core (``--stream``), ``train_mf_stream``, ``train_dpmf_stream`` and
``train_admf_stream`` never load the training file whole: streamed MF runs
the gen-1 kernel a shard at a time (``io/stream_fused.py``) where
``tpu_mf`` routes it to its fused kernel, and every other streamed epoch or
round runs the batched update per parsed batch (``io/stream.py``).

With ``cfg.resume`` and ``cfg.result`` every ``cfg.resume_every`` rounds
write their state to ``<result>.state.r%06d.npz`` (``io/resume.py``), and a
run starts after the newest such round. Every per-round seed and plan pick
depends on the round alone, so a resumed run repeats the rounds an
uninterrupted one would have run.
"""

from __future__ import annotations

import dataclasses
import time
from types import SimpleNamespace
from typing import Any, Callable, Optional

import numpy as np
import torch

from tpu_mf_torch.config import TrainConfig
from tpu_mf_torch.data.coo import RatingsCOO, epoch_batches
from tpu_mf_torch.models.admf import (
    LAMBDAS,
    AdaptRegState,
    init_admf,
    with_shadows,
)
from tpu_mf_torch.models.dpmf import DPMFState, dp_bound, init_dpmf
from tpu_mf_torch.models.mf import MFParams, calc_mse, init_mf, rmse
from tpu_mf_torch.ops.adreg import (
    N_REG_SAMPLES,
    AdRegHyper,
    adreg_epoch,
)
from tpu_mf_torch.ops.gibbs import sample_hyper
from tpu_mf_torch.ops.rows import MAX_DIM
from tpu_mf_torch.ops.sgd import sgd_epoch
from tpu_mf_torch.ops.sgld import SgldHyper, finish_noise, sgld_epoch
from tpu_mf_torch.train.metrics import (
    COUNTS,
    MetricsLogger,
    drain,
    profile_trace,
    span,
    spans_path,
    subtree,
    write_spans,
)


class _Observer:
    """--metrics JSONL lines, --trace capture, a once-per-run warning
    when the test RMSE stops being finite, and --resume: atomic per-round
    state under ``<result>.state.*`` and the round to restart after."""

    def __init__(self, cfg: TrainConfig, n_train: int,
                 log: Callable[[str], None] = print):
        self.cfg = cfg
        self.n_train = n_train
        self.ml = MetricsLogger(cfg.metrics) if cfg.metrics else None
        self.prefix = (f"{cfg.result}.state" if (cfg.resume and cfg.result)
                       else None)
        self._log = log
        self._diverged = False

    def trace(self):
        return profile_trace(self.cfg.trace)

    def resume(self, device: torch.device | str = "cuda"):
        """(start round, params on ``device``, extras) of the newest state
        file, or (0, None, None)."""
        if self.prefix is None:
            return 0, None, None
        from tpu_mf_torch.io.resume import load_round, resume_round

        rnd = resume_round(self.prefix)
        if rnd == 0:
            return 0, None, None
        params, extras = load_round(self.prefix, device)
        return rnd, params, extras

    def epoch_done(self, rnd: int, params_fn=None, extras_fn=None,
                   **fields):
        """Record a finished round: the divergence warning, the metrics
        line, and on the resume cadence the round's state. ``params_fn``
        and ``extras_fn`` are called only when a state file is written."""
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
        if self.cfg.trace:
            fields.update(self._spans())
        if self.ml is not None:
            self.ml.count_updates(self.n_train)
            self.ml.log(round=rnd, **fields)
        if (self.prefix is not None and params_fn is not None
                and rnd % max(1, self.cfg.resume_every) == 0):
            from tpu_mf_torch.io.resume import save_round

            extras = extras_fn() if extras_fn is not None else {}
            save_round(self.prefix, rnd, params_fn(), **extras)

    def _spans(self) -> dict:
        """With --trace: the spans closed since the last round go to
        ``spans.jsonl``, and the round's metrics line gets its
        ``tmf.epoch`` span's host and device ms, its ``tmf.eval`` span's
        ms and the counts of both spans and the spans inside them."""
        recs = drain()
        write_spans(spans_path(self.cfg.trace), recs)
        out, counts = {}, {}
        for part in ("epoch", "eval"):
            rec = next((r for r in reversed(recs)
                        if r["name"] == f"tmf.{part}"), None)
            if rec is None:
                continue
            out[f"{part}_ms"] = (rec["t1"] - rec["t0"]) / 1e6
            if rec["device_ms"] is not None:
                out[f"{part}_device_ms"] = rec["device_ms"]
            for r in subtree(recs, rec):
                for k, v in r["attrs"].items():
                    if k in COUNTS or k.startswith("groups_"):
                        counts[k] = counts.get(k, 0) + v
        if counts:
            out["counts"] = counts
        return out

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
    return None


def _storage_dtype(cfg: TrainConfig) -> torch.dtype:
    """The tables' storage dtype (``--dtype``)."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]


def train_mf(
    cfg: TrainConfig,
    train_ds: RatingsCOO,
    test_ds: Optional[RatingsCOO] = None,
    params: Optional[MFParams] = None,
    log: Callable[[str], None] = print,
    device: torch.device | str = "cuda",
) -> MFParams:
    """Biased-MF SGD training (reference: run(MF&), src/main.cc:36-52).

    ``params`` (if given) is copied in its dtype, not modified; new tables
    are drawn from a ``torch.Generator`` seeded with ``cfg.seed`` and
    stored in ``cfg.dtype``. With ``cfg.resume`` the newest state of
    ``<cfg.result>.state`` replaces them and the epochs after its round
    run. The fused kernels work on float32 rows and return float32
    tables, as ``tpu_mf``'s do; the batched path keeps the storage dtype."""
    why = _unsupported(cfg)
    if why is not None:
        raise NotImplementedError(f"tpu_mf_torch does not port {why} yet")
    device = torch.device(device)
    if params is None:
        gen = torch.Generator().manual_seed(cfg.seed)
        params = init_mf(train_ds.nu, train_ds.nv, cfg.dim, cfg.gb, gen,
                         device, dtype=_storage_dtype(cfg))
    else:
        params = MFParams(*(t.to(device).clone() for t in params))
    obs = _Observer(cfg, len(train_ds), log)
    start, rparams, _ = obs.resume(device)
    if rparams is not None:
        params = rparams
        log(f"# resumed from round {start} ({obs.prefix})")
    try:
        with obs.trace():
            if cfg.use_pallas and device.type == "cuda":
                if cfg.dim <= MAX_DIM:
                    return _train_mf_fused(cfg, train_ds, test_ds, params,
                                           log, obs, start)
                log(f"# dim {cfg.dim} > {MAX_DIM}: no fused kernel; using "
                    "the batched path")
            sched = [(start + 1, BatchedRunner(train_ds, cfg.batch_size,
                                               cfg.seed))]
            return _run_schedule(cfg, sched, test_ds, params, log, obs,
                                 start)
    finally:
        obs.close()


def _slot_phase_ladder(cfg, mk, log, start=0):
    """``tpu_mf``'s slot phase ladder: ``[(first_epoch, runner), ...]``.

    ``mk(sub=None, striped=False)`` returns a candidate runner; probing its
    envelope uploads nothing (plans reach the device at ``pad``). The
    phases: the striped plan from its own envelope-clearing epoch, a plain
    auto-sub plan for the epochs before that, and below it smaller subs
    (down to 128), each from its own engage epoch until a larger sub's, if
    it covers 2 epochs or more."""
    from tpu_mf_torch.ops.sgd_slot import _SUB_CANDIDATES

    def first_env(r):
        for it in range(start + 1, cfg.iters + 1):
            if r.envelope_ok(cfg.eta_at(it)):
                return it
        return None

    phases = []
    striped = mk(striped=True)
    s2 = first_env(striped)
    first = cfg.iters + 1
    if s2 is not None:
        phases.append((s2, striped))
        first = s2
        if s2 > start + 1:
            log(f"# delta-striped slot columns engage at epoch {s2} "
                f"(eta {cfg.eta_at(s2):g})")
    if first > start + 1:
        plain = mk()
        s1 = first_env(plain)
        if s1 is not None and s1 < first:
            phases.insert(0, (s1, plain))
            first = s1
    if phases and first > start + 2:
        auto_sub = phases[0][1].sub
        for sub in sorted((s for s in _SUB_CANDIDATES if 128 <= s < auto_sub),
                          reverse=True):
            if first <= start + 1:
                break
            r = mk(sub=sub)
            e = first_env(r)
            if e is not None and e <= first - 2:
                log(f"# small-window slot kernel (sub {r.sub}) engages "
                    f"at epoch {e} (eta {cfg.eta_at(e):g})")
                phases.insert(0, (e, r))
                first = e
    return phases


def _mf_runner_schedule(cfg, train_ds, params, log, start=0):
    """``_mf_schedule`` in a ``tmf.plan_build`` span: every plan build,
    statistic and route probe of the schedule, on the host."""
    with span("tmf.plan_build"):
        return _mf_schedule(cfg, train_ds, params, log, start)


def _mf_schedule(cfg, train_ds, params, log, start=0):
    """Epoch-indexed schedule ``[(first_epoch, runner), ...]``; each runner
    serves epochs [first_epoch, next phase's first_epoch).

    The decision tree of ``tpu_mf``'s schedule, in its order:
    1. an item table past ``pallas_eligible``: item-sharded gen-1 epochs
       (``ops/phi_shard.py``), one phase;
    2. the dense-cell runner, from its engagement epoch;
    3. at dim <= 61, the slot-major ladder (``_slot_phase_ladder``) from
       the first epoch whose eta clears its staleness envelope, unless the
       pigeonhole bound ``slot_dup_lower_bound`` rules out every epoch;
    4. before that, the lane-packed runner at dim <= 62, else gen-1.
    Dense takes over from its engagement epoch. On a CUDA device the
    kernels work in bf16, on the CPU in f32."""
    from tpu_mf_torch.ops.sgd_cells import (
        CellEpochRunner,
        pallas_eligible,
        pick_cell_geometry,
    )
    from tpu_mf_torch.ops.sgd_dense import (
        DenseEpochRunner,
        dense_eligible,
        dense_engage_epoch,
    )
    from tpu_mf_torch.ops.sgd_packed import PackedEpochRunner, packed_eligible
    from tpu_mf_torch.ops.sgd_slot import (
        SlotEpochRunner,
        slot_dup_lower_bound,
        slot_eligible,
    )

    device = params.theta.device
    work = "bfloat16" if device.type == "cuda" else "float32"
    n_plans = 2 if cfg.iters > 1 else 1  # between-epoch reshuffling
    if not pallas_eligible(params, cfg.batch_size):
        from tpu_mf_torch.ops.phi_shard import PhiShardedRunner

        runner = PhiShardedRunner(train_ds, dim=cfg.dim, seed=cfg.seed,
                                  n_plans=n_plans, saturate=True, mxu=work,
                                  device=device)
        log(f"# item table exceeds VMEM (nv={train_ds.nv}): item-sharded "
            f"fused epochs, {runner.n_shards} shards, tiles "
            f"{runner.tile_u}x{runner.tile_v}, batch {runner.batch}")
        return [(start + 1, runner)]

    dense_from = None
    if cfg.use_dense and dense_eligible(params, train_ds):
        dense_r = DenseEpochRunner(train_ds, saturate=True, dim=cfg.dim,
                                   device=device, mxu=work)
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

    phases = []
    if slot_eligible(params, cfg.batch_size):
        lb, _ = slot_dup_lower_bound(train_ds, dim=cfg.dim, balance=True)
        if cfg.eta_at(cfg.iters) * lb <= 0.2:
            def mk(sub=None, striped=False):
                return SlotEpochRunner(
                    train_ds, seed=cfg.seed, n_plans=n_plans, dim=cfg.dim,
                    balance=True, saturate=True, striped=striped, sub=sub,
                    mxu=work, device=device)

            phases = _slot_phase_ladder(cfg, mk, log, start)
        if not phases and dense_from is None:
            log("# slot kernel staleness envelope exceeded at every epoch's "
                "eta; using the lane-packed kernel")

    def with_dense(sched):
        if dense_from is None:
            return sched
        return [p for p in sched if p[0] < dense_from] + [
            (dense_from, dense_r)]

    if phases and phases[0][0] <= start + 1:
        return _log_slot_phases(with_dense(phases), cfg, log)
    if phases:
        log(f"# slot kernel envelope clears at epoch {phases[0][0]} "
            f"(eta {cfg.eta_at(phases[0][0]):g}); packed kernel until then")

    last = min([cfg.iters + 1] + [e for e, _ in phases]
               + ([dense_from] if dense_from else [])) - 1
    if packed_eligible(params, cfg.batch_size):
        runner = PackedEpochRunner(
            train_ds, batch=max(8192, cfg.batch_size), seed=cfg.seed,
            n_plans=n_plans, dim=cfg.dim, saturate=True, mxu=work,
            device=device)
        name = "lane-packed"
    else:
        # tpu_mf picks this geometry at every dim that reaches here
        tu, tv, b = pick_cell_geometry(train_ds)
        runner = CellEpochRunner(train_ds, tile_u=tu, tile_v=tv, batch=b,
                                 seed=cfg.seed, n_plans=n_plans, balance=True,
                                 saturate=True, mxu=work, device=device)
        name = "gen-1 cell"
    log(f"# {name} kernel: epochs {start + 1}..{last}, tiles "
        f"{runner.tile_u}x{runner.tile_v}, batch {runner.batch}, "
        f"{n_plans} plan(s) of {runner.plan.u.shape[0]} batches")
    return _log_slot_phases(with_dense([(start + 1, runner)] + phases), cfg,
                            log)


def _log_slot_phases(sched, cfg, log):
    """Log the geometry of each slot phase the schedule keeps."""
    from tpu_mf_torch.ops.sgd_slot import SlotEpochRunner

    ends = [ep - 1 for ep, _ in sched[1:]] + [cfg.iters]
    for (ep, r), last in zip(sched, ends):
        if isinstance(r, SlotEpochRunner):
            log(f"# slot kernel{' (striped)' if r.striped else ''}: epochs "
                f"{ep}..{last}, sub {r.sub}, tiles {r.tile_u}x{r.tile_v}, "
                f"{len(r.plans)} plan(s) of {r.plan.u.shape[0]} batches")
    return sched


def _train_mf_fused(cfg, train_ds, test_ds, params, log, obs,
                    start=0) -> MFParams:
    """MF epochs on the fused kernel schedule (``_mf_runner_schedule``)."""
    sched = _mf_runner_schedule(cfg, train_ds, params, log, start)
    return _run_schedule(cfg, sched, test_ds, params, log, obs, start)


def _run_schedule(cfg, sched, test_ds, params, log, obs,
                  start=0) -> MFParams:
    """Epochs start+1..cfg.iters on the schedule's runners. Tables stay in
    each runner's form (fused tables, or the sharded runner's
    (theta, [phi_k])); ``trim`` gives params for each epoch's eval, each
    handover and each state file."""
    with span("tmf.run", first=start + 1, last=cfg.iters):
        return _epochs(cfg, sched, test_ds, params, log, obs, start)


def _epochs(cfg, sched, test_ds, params, log, obs, start) -> MFParams:
    """The body of ``_run_schedule``, in the spans of its parts: the first
    ``tmf.pad``, each ``tmf.handover`` (its ``tmf.trim`` and ``tmf.pad``),
    ``tmf.epoch`` (the runner's epoch and the device synchronize after
    it), ``tmf.eval`` (its ``tmf.trim`` and the RMSE) and the final
    ``tmf.trim``."""
    dev = params.theta.device
    cuda = dev.type == "cuda"
    if test_ds is not None:  # the test set crosses to the device once
        test_ds = SimpleNamespace(**{
            k: torch.as_tensor(getattr(test_ds, k)).to(dev) for k in "uvr"})
    runner = sched[0][1]
    upcoming = list(sched[1:])
    with span("tmf.pad"):
        tables = runner.pad(params)
    gb = float(params.gb)
    t0 = time.perf_counter()
    for it in range(start + 1, cfg.iters + 1):
        while upcoming and it >= upcoming[0][0]:
            nxt = upcoming.pop(0)[1]
            log(f"# epoch {it}: switching to {type(nxt).__name__}"
                f"{' (striped)' if getattr(nxt, 'striped', False) else ''}")
            with span("tmf.handover", src=type(runner).__name__,
                      dst=type(nxt).__name__):
                with span("tmf.trim"):
                    p = runner.trim(tables)
                with span("tmf.pad"):
                    tables = nxt.pad(p)
                del p
            runner = nxt
        eta = cfg.eta_at(it)
        with span("tmf.epoch", cuda, epoch=it, kernel=type(runner).__name__,
                  eta=eta):
            tables = runner.epoch(tables, eta, cfg.lam, gb, epoch_idx=it)
            if cuda:
                torch.cuda.synchronize(dev)
        elapsed = time.perf_counter() - t0
        t_rmse = None
        if test_ds is not None:
            with span("tmf.eval"):
                with span("tmf.trim"):
                    p = runner.trim(tables)
                t_rmse = rmse(p, test_ds)
                del p
            log(f"iter#{it}\t{elapsed:f}\ttRMSE={t_rmse:f}")
        else:
            log(f"iter#{it}\t{elapsed:f}")
        obs.epoch_done(it, params_fn=lambda: runner.trim(tables), alg="mf",
                       kernel=type(runner).__name__, eta=eta,
                       elapsed=elapsed, tRMSE=t_rmse)
    with span("tmf.trim"):
        return MFParams(*(t.contiguous() for t in runner.trim(tables)))


# ---- DP-SGLD ------------------------------------------------------------------

def _on_device(ds: RatingsCOO, dev) -> SimpleNamespace:
    """A rating set's u, v, r on ``dev`` (crossing once per run)."""
    return SimpleNamespace(**{k: torch.as_tensor(getattr(ds, k)).to(dev)
                              for k in "uvr"})


def _dpmf_runner(cfg: TrainConfig, train_ds: RatingsCOO, state: DPMFState,
                 log: Callable[[str], None], device):
    """The SGLD runner of the rounds, or None for the batched path. With
    ``cfg.use_pallas`` on a CUDA device: the striped slot runner (balanced,
    saturating) at dim <= 58, else the gen-1 runner, as ``tpu_mf`` picks
    them by rank; each wherever its kernel takes the state
    (``sgld_slot_eligible``, ``sgld_cells_eligible``)."""
    from tpu_mf_torch.ops.sgld_cells import SgldCellRunner, sgld_cells_eligible
    from tpu_mf_torch.ops.sgld_slot import SlotSgldRunner, sgld_slot_eligible

    device = torch.device(device)
    if not (cfg.use_pallas and device.type == "cuda"):
        return None
    ntrain = len(train_ds)
    n_plans = 2 if cfg.iters > 1 else 1
    if sgld_slot_eligible(state, ntrain):
        return SlotSgldRunner(train_ds, seed=cfg.seed, dim=cfg.dim,
                              n_plans=n_plans, striped=True, device=device)
    if sgld_cells_eligible(state, ntrain):
        # tiles 512x512 and batches of 8192 (tpu_mf: SGLD steps are tiny,
        # scal << 1, so the wider batch does not move the trajectory)
        return SgldCellRunner(train_ds, tile_u=512, tile_v=512,
                              batch=max(8192, cfg.batch_size), seed=cfg.seed,
                              n_plans=n_plans, device=device)
    log("# fused SGLD ineligible (see sgld_cells_eligible); falling back "
        "to the batched path")
    return None


@dataclasses.dataclass
class _DpmfRun:
    """What the rounds of one ``train_dpmf`` or ``train_dpmf_stream`` run
    share."""

    cfg: TrainConfig
    train_ds: Optional[RatingsCOO]    # None where the rounds stream it
    train: Optional[SimpleNamespace]  # the training set on the device
    test: Optional[SimpleNamespace]   # the test set on the device
    bound: float
    runner: Any                       # SGLD runner, or None: batched path
    log: Callable[[str], None]
    obs: _Observer
    save_fn: Optional[Callable]
    device: torch.device
    t0: float = 0.0
    ntrain: int = 0                   # the training set's ratings
    path: Optional[str] = None        # the streamed training file


def _dpmf_setup(cfg: TrainConfig, train_ds: RatingsCOO,
                test_ds: Optional[RatingsCOO], log, save_fn, device,
                runner) -> _DpmfRun:
    device = torch.device(device)
    return _DpmfRun(
        cfg=cfg, train_ds=train_ds, train=_on_device(train_ds, device),
        test=_on_device(test_ds, device) if test_ds is not None else None,
        bound=dp_bound(cfg.epsilon, cfg.tau, train_ds.nv), runner=runner,
        log=log, obs=_Observer(cfg, len(train_ds), log), save_fn=save_fn,
        device=device, t0=time.perf_counter(), ntrain=len(train_ds))


def _dpmf_extras(state: DPMFState) -> dict:
    """The state file's DP-SGLD extras, ``tpu_mf``'s keys and dtypes (its
    counters are int32; the port's state holds int64)."""
    def host(x, dtype):
        return np.asarray(x.detach().cpu().numpy(), dtype)

    return dict(
        lambda_r=np.float32(float(state.lambda_r)),
        lambda_ub=np.float32(float(state.lambda_ub)),
        lambda_vb=np.float32(float(state.lambda_vb)),
        lambda_u=host(state.lambda_u, np.float32),
        lambda_v=host(state.lambda_v, np.float32),
        gcountu=host(state.gcountu, np.int32),
        gcountv=host(state.gcountv, np.int32),
        gcount=np.int32(int(state.gcount)))


def _dpmf_restore(state: DPMFState, params: MFParams, extras: dict
                  ) -> DPMFState:
    """``state`` with a state file's tables, precisions and counters; the
    inverse frequencies stay ``state``'s (``init_dpmf``'s, from the
    training set)."""
    dev = state.gcount.device

    def f32(k):
        return torch.as_tensor(np.asarray(extras[k], np.float32)).to(dev)

    def i64(k):
        return torch.as_tensor(np.asarray(extras[k], np.int64)).to(dev)

    return state._replace(
        params=params, lambda_r=f32("lambda_r"), lambda_ub=f32("lambda_ub"),
        lambda_vb=f32("lambda_vb"), lambda_u=f32("lambda_u"),
        lambda_v=f32("lambda_v"), gcountu=i64("gcountu"),
        gcountv=i64("gcountv"), gcount=i64("gcount"))


def _round_seed(cfg: TrainConfig, offset: int) -> int:
    return (cfg.seed ^ 0xD1FF) * 1_000_003 + offset


def _dpmf_round(run: _DpmfRun, rnd: int, state: DPMFState) -> DPMFState:
    """One DP-SGLD round (``tpu_mf``'s loop body, in its order): the SGLD
    pass (runner or batched), the noise flush, the train MSE, the Gibbs
    draws, the test RMSE and the round's line, metrics, and the
    checkpoint on the reference's cadence (round >= 100, round % 20 == 0)."""
    cfg, dev = run.cfg, run.device
    ntrain = run.ntrain
    eta_r = cfg.eta_at_cutoff(rnd)

    if run.runner is not None:
        scal = eta_r * ntrain * run.bound * float(state.lambda_r)
        tables = run.runner.pad(state)
        run.runner.epoch(
            tables, int(state.gcount),
            (eta_r, cfg.temp, run.bound, scal, float(state.params.gb)),
            # rounds must not collide in seed space: batch i of a round
            # keys its noise by noise_seed + i
            noise_seed=cfg.seed * 1_000_003 + rnd * run.runner.seed_stride,
            epoch_idx=rnd - 1)
        state = run.runner.unpack(state, tables)
    else:
        u, v, r, w = epoch_batches(run.train_ds, cfg.batch_size, rnd,
                                   cfg.seed ^ 0x5A5A)
        batches = (torch.as_tensor(u.astype(np.int64)).to(dev),
                   torch.as_tensor(v.astype(np.int64)).to(dev),
                   torch.as_tensor(r).to(dev), torch.as_tensor(w).to(dev))
        state = sgld_epoch(state, batches,
                           SgldHyper(eta_r, cfg.temp, run.bound,
                                     float(ntrain)), _round_gen(run, rnd))
    state = finish_noise(state, eta_r, cfg.temp,
                         _round_gen(run, rnd + 500_000))
    # the train SSE drives the lambda_r posterior; the reference's
    # "sample" is the whole training set (model.cc:273-274)
    train_mse = calc_mse(state.params, run.train.u, run.train.v, run.train.r,
                         cfg.eval_batch)
    return _dpmf_finish(run, rnd, state, eta_r, train_mse,
                        type(run.runner).__name__ if run.runner
                        else "batched")


def _round_gen(run: _DpmfRun, offset: int) -> torch.Generator:
    """The round's generator at ``offset`` (noise: round, flush: round +
    500,000), on the run's device."""
    return torch.Generator(device=run.device).manual_seed(
        _round_seed(run.cfg, offset))


def _dpmf_finish(run: _DpmfRun, rnd: int, state: DPMFState, eta_r: float,
                 train_mse: float, kernel: str) -> DPMFState:
    """The end of a DP-SGLD round, after its SGLD pass, noise flush and
    train MSE: the Gibbs draws, the test RMSE and the round's line,
    metrics, and the checkpoint on the reference's cadence (round >= 100,
    round % 20 == 0)."""
    cfg, dev = run.cfg, run.device
    ntrain = run.ntrain
    state = sample_hyper(
        state, train_mse * ntrain, float(ntrain), cfg.hypera, cfg.hyperb,
        np.random.default_rng([_round_seed(cfg, rnd + 1_000_000)
                               & 0xFFFFFFFFFFFF]))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - run.t0
    t_rmse = None
    if run.test is not None:
        t_rmse = rmse(state.params, run.test)
        run.log(f"round #{rnd}\tRMSE={np.sqrt(train_mse):f}\t"
                f"tRMSE={t_rmse:f}\t{elapsed:f}")
    else:
        run.log(f"round #{rnd}\tRMSE={np.sqrt(train_mse):f}\t{elapsed:f}")
    run.obs.epoch_done(
        rnd, params_fn=lambda: state.params,
        extras_fn=lambda: _dpmf_extras(state), alg="dpmf", kernel=kernel,
        eta=eta_r,
        elapsed=elapsed, RMSE=float(np.sqrt(train_mse)), tRMSE=t_rmse,
        lambda_r=float(state.lambda_r))
    if run.save_fn is not None and rnd >= 100 and rnd % 20 == 0:
        run.save_fn(state, rnd)
    return state


def train_dpmf(
    cfg: TrainConfig,
    train_ds: RatingsCOO,
    test_ds: Optional[RatingsCOO] = None,
    state: Optional[DPMFState] = None,
    log: Callable[[str], None] = print,
    save_fn: Optional[Callable[[DPMFState, int], None]] = None,
    device: torch.device | str = "cuda",
) -> DPMFState:
    """DP-SGLD training (reference: run(DPMF&), src/main.cc:55-74): per
    round ``_dpmf_round``, the learning rate eta_at_cutoff(round).

    ``state`` (if given) is copied, not modified; a new state's tables are
    drawn from a ``torch.Generator`` seeded with ``cfg.seed`` and stored in
    ``cfg.dtype``. With ``cfg.resume`` the newest state file's tables,
    precisions and noise counters replace the state's and the rounds after
    its round run. Stability:
    the per-rating step is scal = eta * ntrain * bound * lambda_r, and the
    gen-1 SGLD kernel does not saturate, so a row repeated k times in one
    window (a plan column) takes k steps from the same point. Keep scal
    times the largest per-column repeat of a row near 0.2 (on the
    ML-10M-shape stand-in a column repeats a user up to 149 times; there,
    on an H100, scal 0.05 gave NaN in round 1 and scal 1e-3 trains), and
    raise ``hyperb`` to damp the Gibbs growth of lambda_r."""
    why = _unsupported(cfg)
    if why is not None:
        raise NotImplementedError(f"tpu_mf_torch does not port {why} yet")
    device = torch.device(device)
    if state is None:
        state = init_dpmf(train_ds, cfg.dim, cfg.gb,
                          torch.Generator().manual_seed(cfg.seed), device,
                          dtype=_storage_dtype(cfg))
    else:
        state = DPMFState(MFParams(*(t.to(device).clone()
                                     for t in state.params)),
                          *(t.to(device).clone() for t in state[1:]))
    run = _dpmf_setup(cfg, train_ds, test_ds, log, save_fn, device, None)
    start, rparams, rex = run.obs.resume(device)
    if rparams is not None:
        state = _dpmf_restore(state, rparams, rex)
        log(f"# resumed from round {start} ({run.obs.prefix})")
    run.runner = _dpmf_runner(cfg, train_ds, state, log, device)
    run.t0 = time.perf_counter()
    try:
        with run.obs.trace():
            for rnd in range(start + 1, cfg.iters + 1):
                state = _dpmf_round(run, rnd, state)
    finally:
        run.obs.close()
    return state


# ---- AdaptReg -----------------------------------------------------------------

def _admf_key(cfg: TrainConfig, it: int) -> int:
    """The validation-sample key of epoch ``it``."""
    return (cfg.seed ^ 0xADF0) * 1_000_003 + it


def _admf_runner(cfg: TrainConfig, train_ds: RatingsCOO,
                 valid_ds: RatingsCOO, state: AdaptRegState,
                 log: Callable[[str], None], device):
    """The AdaptReg runner of the epochs, or None for the batched path.
    With ``cfg.use_pallas`` on a CUDA device, ``tpu_mf``'s routing in its
    order: at a slot-eligible rank, the striped, balanced slot runner when
    eta0 clears the pigeonhole bound (``slot_dup_lower_bound``) and then
    the runner's own window duplicates (eta0 * dups <= 0.2); else the
    gen-1 runner (tiles 512, batch max(1024, batch_size)) up to
    ``MAX_DIM``. The plan builds, their statistics and the route probes
    run on the host in a ``tmf.plan_build`` span; the plans reach the
    device at the runner's ``materialize`` (``tmf.plan_upload``)."""
    device = torch.device(device)
    if not (cfg.use_pallas and device.type == "cuda"):
        return None
    with span("tmf.plan_build"):
        return _admf_pick(cfg, train_ds, valid_ds, state, log, device)


def _admf_pick(cfg: TrainConfig, train_ds: RatingsCOO, valid_ds: RatingsCOO,
               state: AdaptRegState, log: Callable[[str], None],
               device: torch.device):
    """The body of ``_admf_runner``: its runner, or None past ``MAX_DIM``."""
    from tpu_mf_torch.ops.adreg_cells import (
        AdRegCellRunner,
        adreg_cells_eligible,
    )
    from tpu_mf_torch.ops.adreg_slot import SlotAdRegRunner, adreg_slot_eligible
    from tpu_mf_torch.ops.sgd_slot import slot_dup_lower_bound

    n_plans = 2 if cfg.iters > 1 else 1  # between-epoch reshuffling
    eta0 = cfg.eta_at(1)
    if adreg_slot_eligible(state):
        lb, _ = slot_dup_lower_bound(train_ds, dim=cfg.dim, balance=True)
        if eta0 * lb <= 0.2:
            runner = SlotAdRegRunner(
                train_ds, valid_ds, seed=cfg.seed, loss=cfg.loss,
                n_plans=n_plans, dim=cfg.dim, striped=True,
                device=device)
            if eta0 * max(runner._dup_max[8], runner._vdup_max[8]) <= 0.2:
                log(f"# slot AdaptReg kernel (striped): sub {runner.sub}, "
                    f"tiles {runner.tile_u}x{runner.tile_v}, {n_plans} "
                    f"plan(s) of {runner.plan.u.shape[0]} batches, "
                    f"{runner.segments} segments")
                return runner
            log("# slot AdaptReg envelope exceeded at eta0; using the gen-1 "
                "fused kernel")
    if adreg_cells_eligible(state):
        runner = AdRegCellRunner(
            train_ds, valid_ds, tile_u=512, tile_v=512,
            batch=max(1024, cfg.batch_size), seed=cfg.seed, loss=cfg.loss,
            n_plans=n_plans, device=device)
        log(f"# gen-1 AdaptReg kernel: tiles 512x512, batch {runner.batch}, "
            f"{n_plans} plan(s) of {runner.plan.u.shape[0]} batches, "
            f"{runner.segments} segments")
        return runner
    log(f"# dim {cfg.dim} > {MAX_DIM}: no fused AdaptReg kernel; using the "
        "batched path")
    return None


def _admf_report(cfg: TrainConfig, it: int, t0: float,
                 params: Callable[[], MFParams],
                 test: Optional[SimpleNamespace], lams, kernel: str,
                 log: Callable[[str], None], obs: _Observer) -> None:
    """Epoch ``it``'s iter# line, its --metrics fields and, on the resume
    cadence, its state (``params()`` and the four lambdas, ``tpu_mf``'s
    keys). The test RMSE is taken in a ``tmf.eval`` span, and ``params()``
    inside it in a ``tmf.trim`` span."""
    elapsed = time.perf_counter() - t0
    t_rmse = None
    if test is not None:
        with span("tmf.eval"):
            with span("tmf.trim"):
                p = params()
            t_rmse = rmse(p, test)
            del p
        log(f"iter#{it}\t{elapsed:f}\ttRMSE={t_rmse:f}")
    else:
        log(f"iter#{it}\t{elapsed:f}")
    obs.epoch_done(it, params_fn=params,
                   extras_fn=lambda: {k: np.float32(float(x))
                                      for k, x in zip(LAMBDAS, lams)},
                   alg="admf", kernel=kernel, eta=cfg.eta_at(it),
                   elapsed=elapsed, tRMSE=t_rmse,
                   **{k: float(x) for k, x in zip(LAMBDAS, lams)})


def _train_admf_fused(cfg: TrainConfig, runner, state: AdaptRegState,
                      test_ds: Optional[RatingsCOO], log, obs, start: int = 0
                      ) -> AdaptRegState:
    """AdaptReg epochs start+1..cfg.iters on a fused runner:
    ``runner.epoch`` per epoch with the epoch's key, plans rotated by
    epoch. In a ``tmf.run`` span, as ``_run_schedule``'s epochs: the
    ``tmf.pad``, each ``tmf.epoch`` (the runner's epoch, its segments'
    spans, and the device synchronize after it), each ``tmf.eval``
    (``_admf_report``) and the final ``tmf.trim``."""
    dev = state.params.theta.device
    cuda = dev.type == "cuda"
    test = _on_device(test_ds, dev) if test_ds is not None else None
    kernel = type(runner).__name__
    with span("tmf.run", first=start + 1, last=cfg.iters):
        with span("tmf.pad"):
            tables = runner.pad(state)
        t0 = time.perf_counter()
        for it in range(start + 1, cfg.iters + 1):
            eta = cfg.eta_at(it)
            with span("tmf.epoch", cuda, epoch=it, kernel=kernel, eta=eta):
                tables = runner.epoch(tables, eta, cfg.eta_reg_at(it),
                                      _admf_key(cfg, it), epoch_idx=it - 1)
                if cuda:
                    torch.cuda.synchronize(dev)
            _admf_report(cfg, it, t0, lambda: runner.trim(tables), test,
                         runner.lams, kernel, log, obs)
        with span("tmf.trim"):
            return runner.state(tables)


def _train_admf_batched(cfg: TrainConfig, train_ds: RatingsCOO,
                        valid_ds: RatingsCOO, test_ds: Optional[RatingsCOO],
                        state: AdaptRegState, log, obs, start: int = 0
                        ) -> AdaptRegState:
    """AdaptReg epochs start+1..cfg.iters on the batched path:
    host-shuffled batches, K validation indices per batch from a generator
    keyed by the epoch."""
    dev = state.params.theta.device
    valid = (torch.as_tensor(valid_ds.u.astype(np.int64)).to(dev),
             torch.as_tensor(valid_ds.v.astype(np.int64)).to(dev),
             torch.as_tensor(valid_ds.r).to(dev, torch.float32))
    test = _on_device(test_ds, dev) if test_ds is not None else None
    t0 = time.perf_counter()
    for it in range(start + 1, cfg.iters + 1):
        u, v, r, w = epoch_batches(train_ds, cfg.batch_size, it,
                                   cfg.seed ^ 0x7E57)
        batches = (torch.as_tensor(u.astype(np.int64)).to(dev),
                   torch.as_tensor(v.astype(np.int64)).to(dev),
                   torch.as_tensor(r).to(dev), torch.as_tensor(w).to(dev))
        gen = torch.Generator(device=dev).manual_seed(
            _admf_key(cfg, it) & 0x7FFF_FFFF_FFFF_FFFF)
        samples = torch.randint(len(valid_ds), (u.shape[0], N_REG_SAMPLES),
                                generator=gen, device=dev)
        state = adreg_epoch(state, batches, valid,
                            AdRegHyper(cfg.eta_at(it), cfg.eta_reg_at(it),
                                       cfg.loss), samples)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        _admf_report(cfg, it, t0, lambda: state.params, test,
                     [getattr(state, k) for k in LAMBDAS], "batched", log,
                     obs)
    return state


def train_admf(
    cfg: TrainConfig,
    train_ds: RatingsCOO,
    valid_ds: RatingsCOO,
    test_ds: Optional[RatingsCOO] = None,
    state: Optional[AdaptRegState] = None,
    log: Callable[[str], None] = print,
    device: torch.device | str = "cuda",
) -> AdaptRegState:
    """Adaptive-regularization training (reference: run(AdaptRegMF&),
    src/main.cc:77-93). The validation set plays the role of the
    reference's shuffled Record vector (plain_read_valid,
    model.cc:390-415); the learning rates are eta_at(epoch) and
    eta_reg_at(epoch).

    ``state`` (if given) is copied in its dtypes, not modified; a new
    state's tables are drawn from a ``torch.Generator`` seeded with
    ``cfg.seed`` and stored in ``cfg.dtype``, all four lambdas at
    ``cfg.lam``. With ``cfg.resume`` the newest state file's tables and
    lambdas replace the state's, its shadows restart as copies of the
    tables, and the epochs after its round run. The fused runners return
    shadows that copy the final tables; the batched path returns its
    shadows as they stand."""
    why = _unsupported(cfg)
    if why is not None:
        raise NotImplementedError(f"tpu_mf_torch does not port {why} yet")
    device = torch.device(device)
    if state is None:
        state = init_admf(train_ds.nu, train_ds.nv, cfg.dim, cfg.lam, cfg.gb,
                          torch.Generator().manual_seed(cfg.seed), device,
                          dtype=_storage_dtype(cfg))
    else:
        state = AdaptRegState(
            MFParams(*(t.to(device).clone() for t in state.params)),
            *(t.to(device).clone() for t in state[1:]))
    obs = _Observer(cfg, len(train_ds), log)
    start, rparams, rex = obs.resume(device)
    if rparams is not None:
        state = with_shadows(rparams, [rex[k] for k in LAMBDAS])
        log(f"# resumed from round {start} ({obs.prefix})")
    try:
        with obs.trace():
            runner = _admf_runner(cfg, train_ds, valid_ds, state, log, device)
            if runner is not None:
                return _train_admf_fused(cfg, runner, state, test_ds, log,
                                         obs, start)
            return _train_admf_batched(cfg, train_ds, valid_ds, test_ds,
                                       state, log, obs, start)
    finally:
        obs.close()


# ---- out-of-core (--stream) ---------------------------------------------------

def _test_on(test_ds: Optional[RatingsCOO], dev) -> Optional[SimpleNamespace]:
    return _on_device(test_ds, dev) if test_ds is not None else None


def train_mf_stream(
    cfg: TrainConfig,
    path: str,
    test_ds: Optional[RatingsCOO] = None,
    params: Optional[MFParams] = None,
    nu: Optional[int] = None,
    nv: Optional[int] = None,
    log: Callable[[str], None] = print,
    device: torch.device | str = "cuda",
) -> MFParams:
    """Out-of-core MF training from an on-disk stream (any format; reference:
    the TBB read pipeline, src/mf.h:6-70), ``tpu_mf``'s route: with
    ``cfg.use_pallas`` on a CUDA device, where ``pallas_eligible`` holds,
    the fused kernel over a ShardStore (``io/stream_fused.py``: tiles
    512x512, batch max(1024, batch_size)); otherwise the per-batch path
    (``io/stream.py``), which re-parses the file every epoch.

    ``params`` (if given) is copied, not modified; new tables are drawn as
    ``train_mf`` draws them, at ``nu`` x ``nv`` or the file's scanned
    dims. ``cfg.resume`` restarts after the newest state file's round."""
    from tpu_mf_torch.data.streamfmt import scan_stats
    from tpu_mf_torch.ops.sgd_cells import pallas_eligible

    why = _unsupported(cfg)
    if why is not None:
        raise NotImplementedError(f"tpu_mf_torch does not port {why} yet")
    device = torch.device(device)
    if params is None:
        if not (nu and nv):
            nu, nv, _ = scan_stats(path)
        params = init_mf(nu, nv, cfg.dim, cfg.gb,
                         torch.Generator().manual_seed(cfg.seed), device,
                         dtype=_storage_dtype(cfg))
    else:
        params = MFParams(*(t.to(device).clone() for t in params))
    obs = _Observer(cfg, 0, log)
    start, rparams, _ = obs.resume(device)
    if rparams is not None:
        params = rparams
        log(f"# resumed from round {start} ({obs.prefix})")
    use_fused = cfg.use_pallas and device.type == "cuda"
    if use_fused and not pallas_eligible(params, cfg.batch_size):
        use_fused = False
        log(f"# --stream: fused kernel ineligible (dim > {MAX_DIM} or item "
            "table beyond 64 MiB); using the per-batch streaming path "
            "(slow). For large catalogs, in-memory training uses "
            "item-sharded fused epochs (ops/phi_shard.py).")
    test = _test_on(test_ds, device)
    try:
        with obs.trace():
            t0 = time.perf_counter()
            if use_fused:
                from tpu_mf_torch.io.stream_fused import FusedStreamTrainer

                trainer = FusedStreamTrainer(
                    path, batch=max(1024, cfg.batch_size), seed=cfg.seed,
                    device=device)
                try:
                    obs.n_train = trainer.n
                    tables = trainer.pad(params)
                    gb = float(params.gb)
                    for it in range(start + 1, cfg.iters + 1):
                        trainer.epoch(tables, cfg.eta_at(it), cfg.lam, gb,
                                      epoch_idx=it)
                        _stream_report(cfg, it, t0, trainer.trim(tables),
                                       test, "FusedStreamTrainer", log, obs)
                    return MFParams(*(t.contiguous()
                                      for t in trainer.trim(tables)))
                finally:
                    trainer.close()

            from tpu_mf_torch.io.stream import streaming_sgd_epoch

            for it in range(start + 1, cfg.iters + 1):
                params, n = streaming_sgd_epoch(
                    params, path, cfg.eta_at(it), cfg.lam,
                    batch_size=cfg.batch_size, fly=cfg.fly)
                obs.n_train = n
                _stream_report(cfg, it, t0, params, test, "stream", log, obs)
            return params
    finally:
        obs.close()


def _stream_report(cfg: TrainConfig, it: int, t0: float, params: MFParams,
                   test: Optional[SimpleNamespace], kernel: str,
                   log: Callable[[str], None], obs: _Observer) -> None:
    """A streamed MF epoch's iter# line, metrics and state file."""
    if params.theta.is_cuda:
        torch.cuda.synchronize(params.theta.device)
    elapsed = time.perf_counter() - t0
    t_rmse = None
    if test is not None:
        t_rmse = rmse(params, test)
        log(f"iter#{it}\t{elapsed:f}\ttRMSE={t_rmse:f}")
    else:
        log(f"iter#{it}\t{elapsed:f}")
    obs.epoch_done(it, params_fn=lambda: params, alg="mf", kernel=kernel,
                   eta=cfg.eta_at(it), elapsed=elapsed, tRMSE=t_rmse)


class _Profile:
    """A streamed training set's shape and counts (``scan_profile``), in
    the form ``init_dpmf`` reads a rating set."""

    def __init__(self, nu, nv, n, user_counts, item_counts):
        self.nu, self.nv, self.n = nu, nv, n
        self._counts = (user_counts, item_counts)

    def __len__(self) -> int:
        return self.n

    def counts(self):
        return self._counts


def _dpmf_stream_round(run: _DpmfRun, rnd: int,
                       state: DPMFState) -> DPMFState:
    """One streamed DP-SGLD round (``tpu_mf``'s train_dpmf_stream loop
    body): the SGLD pass over the file (noise from the round's
    generator), the noise flush, the streamed train MSE for the Gibbs SSE,
    then ``_dpmf_finish``."""
    from tpu_mf_torch.io.stream import streaming_mse, streaming_sgld_round

    cfg = run.cfg
    eta_r = cfg.eta_at_cutoff(rnd)
    state, _ = streaming_sgld_round(
        state, run.path,
        SgldHyper(eta_r, cfg.temp, run.bound, float(run.ntrain)),
        _round_gen(run, rnd), batch_size=cfg.batch_size, fly=cfg.fly)
    state = finish_noise(state, eta_r, cfg.temp,
                         _round_gen(run, rnd + 500_000))
    train_mse = streaming_mse(state.params, run.path)
    return _dpmf_finish(run, rnd, state, eta_r, train_mse, "stream")


def train_dpmf_stream(
    cfg: TrainConfig,
    path: str,
    test_ds: Optional[RatingsCOO] = None,
    log: Callable[[str], None] = print,
    save_fn: Optional[Callable[[DPMFState, int], None]] = None,
    hyper0=None,
    device: torch.device | str = "cuda",
) -> DPMFState:
    """Out-of-core DP-SGLD training from an on-disk stream (reference:
    src/dpmf.h:6-34): ``train_dpmf``'s round with every full-data pass
    streamed, on the per-batch path on one device, as ``tpu_mf``'s. One
    ``scan_profile`` pass gives the dims and the inverse-frequency
    weights; ``hyper0`` (lambda_r, lambda_ub, lambda_vb, lambda_u,
    lambda_v) is a hyper-only warm start (reference: read_hyper,
    model.cc:153-167); ``cfg.resume`` restarts after the newest state
    file's round."""
    why = _unsupported(cfg)
    if why is not None:
        raise NotImplementedError(f"tpu_mf_torch does not port {why} yet")
    run, state = _dpmf_stream_setup(cfg, path, test_ds, log, save_fn,
                                    hyper0, device)
    start, rparams, rex = run.obs.resume(run.device)
    if rparams is not None:
        state = _dpmf_restore(state, rparams, rex)
        log(f"# resumed from round {start} ({run.obs.prefix})")
    run.t0 = time.perf_counter()
    try:
        with run.obs.trace():
            for rnd in range(start + 1, cfg.iters + 1):
                state = _dpmf_stream_round(run, rnd, state)
    finally:
        run.obs.close()
    return state


def _dpmf_stream_setup(cfg: TrainConfig, path: str,
                       test_ds: Optional[RatingsCOO], log, save_fn, hyper0,
                       device) -> tuple[_DpmfRun, DPMFState]:
    """The streamed rounds' shared run and initial state: one
    ``scan_profile`` pass for the dims and the inverse-frequency weights,
    ``init_dpmf``'s tables and precisions, and ``hyper0``'s precisions
    where given."""
    from tpu_mf_torch.data.streamfmt import scan_profile

    device = torch.device(device)
    nu, nv, ntrain, uc, vc, _ = scan_profile(path)
    state = init_dpmf(_Profile(nu, nv, ntrain, uc, vc), cfg.dim, cfg.gb,
                      torch.Generator().manual_seed(cfg.seed), device,
                      dtype=_storage_dtype(cfg))
    if hyper0 is not None:
        f32 = dict(dtype=torch.float32, device=device)
        lr, lub, lvb, lu, lv = hyper0
        state = state._replace(
            lambda_r=torch.tensor(float(lr), **f32),
            lambda_ub=torch.tensor(float(lub), **f32),
            lambda_vb=torch.tensor(float(lvb), **f32),
            lambda_u=torch.as_tensor(np.asarray(lu)).to(**f32),
            lambda_v=torch.as_tensor(np.asarray(lv)).to(**f32))
    run = _DpmfRun(cfg=cfg, train_ds=None, train=None,
                   test=_test_on(test_ds, device),
                   bound=dp_bound(cfg.epsilon, cfg.tau, nv), runner=None,
                   log=log, obs=_Observer(cfg, ntrain, log), save_fn=save_fn,
                   device=device, t0=time.perf_counter(), ntrain=ntrain,
                   path=path)
    return run, state


def _admf_stream_samples(cfg: TrainConfig, it: int, dev):
    """Epoch ``it``'s validation-sample generator, keyed as the batched
    path keys it."""
    return torch.Generator(device=dev).manual_seed(
        _admf_key(cfg, it) & 0x7FFF_FFFF_FFFF_FFFF)


def train_admf_stream(
    cfg: TrainConfig,
    path: str,
    valid_ds: RatingsCOO,
    test_ds: Optional[RatingsCOO] = None,
    log: Callable[[str], None] = print,
    device: torch.device | str = "cuda",
) -> AdaptRegState:
    """Out-of-core AdaptReg training from an on-disk stream (reference:
    src/admf.h:6-46), on the per-batch path on one device, as
    ``tpu_mf``'s; the validation set stays in memory (it is small). Each
    epoch's K validation indices per batch come from
    ``_admf_stream_samples``; ``cfg.resume`` restarts after the newest
    state file's round, shadows copied from its tables."""
    from tpu_mf_torch.data.streamfmt import scan_stats
    from tpu_mf_torch.io.stream import streaming_adreg_epoch

    why = _unsupported(cfg)
    if why is not None:
        raise NotImplementedError(f"tpu_mf_torch does not port {why} yet")
    device = torch.device(device)
    nu, nv, ntrain = scan_stats(path)
    state = init_admf(nu, nv, cfg.dim, cfg.lam, cfg.gb,
                      torch.Generator().manual_seed(cfg.seed), device,
                      dtype=_storage_dtype(cfg))
    obs = _Observer(cfg, ntrain, log)
    start, rparams, rex = obs.resume(device)
    if rparams is not None:
        state = with_shadows(rparams, [rex[k] for k in LAMBDAS])
        log(f"# resumed from round {start} ({obs.prefix})")
    valid = (torch.as_tensor(valid_ds.u.astype(np.int64)).to(device),
             torch.as_tensor(valid_ds.v.astype(np.int64)).to(device),
             torch.as_tensor(valid_ds.r).to(device, torch.float32))
    test = _test_on(test_ds, device)
    t0 = time.perf_counter()
    try:
        with obs.trace():
            for it in range(start + 1, cfg.iters + 1):
                state, _ = streaming_adreg_epoch(
                    state, path, valid,
                    AdRegHyper(cfg.eta_at(it), cfg.eta_reg_at(it), cfg.loss),
                    _admf_stream_samples(cfg, it, device),
                    batch_size=cfg.batch_size, fly=cfg.fly)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                _admf_report(cfg, it, t0, lambda: state.params, test,
                             [getattr(state, k) for k in LAMBDAS], "stream",
                             log, obs)
            return state
    finally:
        obs.close()
