"""The driver of ``--alg dpmf``: jobs of DP-SGLD rounds as
``tpu_mf_torch.train.loop.train_dpmf`` trains them. Set-up builds the
rounds' shared state and the SGLD runner once (``loop._dpmf_setup``,
``loop._dpmf_runner``: gen-1 plans built and uploaded); a job starts from
a copy of the seed's initial state and runs rounds 1 to ``job_epochs``
through ``loop._dpmf_round``, ``train_dpmf``'s loop body. The check runs
the plain reference (``reference_dpmf.py``) for one job.
"""

from __future__ import annotations

import re
import time

from mfbench import check, gen, reference_dpmf
from mfbench.spec import train_config
from mfbench.work.dpmf import round_work

NUMBERS = check.NUMBERS + ("hyper_gap",)
ROUND_LINE = re.compile(
    r"^round #(\d+)\tRMSE=\S+(?:\ttRMSE=(\S+))?\t([0-9.eE+-]+)$")
HYPER = ("lambda_r", "lambda_ub", "lambda_vb", "lambda_u", "lambda_v")
REF_HYPER = dict(zip(HYPER, ("r", "ub", "vb", "u", "v")))
FLAGS = ("eta", "gam", "mineta", "temp", "hypera", "hyperb", "epsilon",
         "tau")


def parse(line: str):
    """(round, elapsed, logged test RMSE or None) of a ``round #`` line."""
    m = ROUND_LINE.match(line)
    if m is None:
        return None
    rmse = None if m.group(2) is None else float(m.group(2))
    return int(m.group(1)), float(m.group(3)), rmse


def draw(spec: dict, seed: int, device) -> tuple:
    """(train, test, tables0, gb, cfg, route): the ratings and initial
    tables of ``seed``, the training mean, the program's ``TrainConfig``
    and the one route the reference follows, the gen-1 SGLD plans."""
    import numpy as np

    cfg_file = spec["config"]
    train, test = gen.generate(cfg_file, seed, device)
    gb = float(np.float32(train.r.mean(dtype=np.float64)))
    cfg = train_config(spec, seed % (2 ** 31), gb,
                       int(spec["traffic"]["job_epochs"]))
    tables0 = gen.init_tables(train.nu, train.nv, int(cfg_file["dim"]), seed,
                              device, float(cfg_file.get("init_scale", 1e-2)))
    return train, test, tables0, gb, cfg, [(1, "sgld-cells")]


def setup(spec: dict, drawn: tuple, win, device):
    """The rounds' state and runner, built once; a job returns its final
    tables, leaves round 1's tables of job 0 in ``win.snap1`` and each
    round's precisions in ``win.rec``."""
    import torch

    from tpu_mf_torch.data.coo import RatingsCOO
    from tpu_mf_torch.models.dpmf import DPMFState, init_dpmf
    from tpu_mf_torch.models.mf import MFParams
    from tpu_mf_torch.ops.sgld_cells import SgldCellRunner
    from tpu_mf_torch.train import loop

    train, test, tables0, gb, cfg, _ = drawn
    train_coo = RatingsCOO(train.u, train.v, train.r, train.nu, train.nv)
    test_coo = RatingsCOO(test.u, test.v, test.r, test.nu, test.nv)
    # init_dpmf's precisions, inverse frequencies and counters; the
    # benchmark's tables
    state0 = init_dpmf(train_coo, cfg.dim, gb,
                       torch.Generator().manual_seed(cfg.seed), device,
                       dtype=loop._storage_dtype(cfg))
    state0 = state0._replace(params=MFParams(
        *(tables0[k].to(state0.params.theta.dtype)
          for k in check.LEAVES), state0.params.gb))
    run = loop._dpmf_setup(cfg, train_coo, test_coo, win.log, None, device,
                           None)
    run.runner = loop._dpmf_runner(cfg, train_coo, state0, win.log, device)
    if not isinstance(run.runner, SgldCellRunner):
        raise NotImplementedError("the reference follows the gen-1 SGLD "
                                  "runner only")
    run.runner.materialize()

    def job():
        state = DPMFState(MFParams(*(t.clone() for t in state0.params)),
                          *(t.clone() for t in state0[1:]))
        rec = []
        win.rec.append(rec)
        run.t0 = time.perf_counter()
        for rnd in range(1, cfg.iters + 1):
            state = loop._dpmf_round(run, rnd, state)
            rec.append(tuple(getattr(state, k) for k in HYPER))
            if rnd == 1 and win.job == 0:
                win.snap1 = {k: getattr(state.params, k).to(
                    "cpu", copy=True).float() for k in check.LEAVES}
        return {k: getattr(state.params, k) for k in check.LEAVES}

    return job


def epoch_work(drawn: tuple, spec: dict) -> dict:
    train, test, _, _, cfg, _ = drawn
    return round_work(train, test, int(spec["config"]["dim"]),
                      4 if cfg.dtype == "float32" else 2)


def flags(spec: dict) -> dict:
    """The trainer's flags the reference reads, from the traffic."""
    tc = spec["traffic"]["train_config"]
    return {k: tc[k] for k in FLAGS}


def hyper_gap(rec: list, ref: dict) -> float:
    """The largest relative gap, over every job and round and each
    element of the five precisions, between the program's and the
    reference's."""
    import numpy as np

    worst = 0.0
    for job in rec:
        for rnd, got in enumerate(job, 1):
            want = ref["hyper"][rnd]
            for name, x in zip(HYPER, got):
                w = want[REF_HYPER[name]].astype(np.float64)
                x = x.detach().double().cpu().numpy()
                worst = max(worst, float(np.max(np.abs(x - w) / np.abs(w))))
    return worst


def compare(spec: dict, drawn: tuple, win, final: dict, test_rmse: float,
            device) -> tuple[dict, dict]:
    """(``check.py``'s four numbers over rounds, and ``hyper_gap``; no
    extra keys): one job of the plain reference against what the jobs
    produced."""
    train, test, tables0, gb, cfg, _ = drawn
    cfg_file = spec["config"]
    ref = reference_dpmf.run_job(
        tables0, train.on(device), test.on(device), gb, cfg.seed,
        flags(spec), int(spec["traffic"]["job_epochs"]), cfg_file["work"],
        cfg_file["dtype"])
    values = check.numbers(win.snap1, final, test_rmse, win.logged(), ref,
                           tables0)
    values["hyper_gap"] = hyper_gap(win.rec, ref)
    return values, {}


def readings(spec: dict, seed: int, device: str = "cuda",
             orders: bool = True) -> list:
    """The stand-ins of ``control.py`` for one seed, as JSON rows (the
    reference in float32 tables is what a sound program is held to):

    - ``control``: the reference with its tables kept in bfloat16 (every
      noise add and apply rounded);
    - ``eager``: the reference giving every touched row one step's noise,
      whatever its lazy count;
    - ``drop_half``: the reference leaving out the second half of every
      column's ratings;
    - ``eval_half``: sound tables whose logged test RMSE at the job's last
      round is taken over half of the test set.

    ``orders`` is not read: the gen-1 SGLD plans have one grouping."""
    import torch

    from mfbench import reference

    del orders
    cfg_file = spec["config"]
    n = int(spec["traffic"]["job_epochs"])
    train, test, tables0, gb, cfg, route = draw(spec, seed, device)
    dtr, dte = train.on(device), test.on(device)
    fl = flags(spec)

    def run(**kw):
        t = time.perf_counter()
        kw.setdefault("storage", cfg_file["dtype"])
        out = reference_dpmf.run_job(tables0, dtr, dte, gb, cfg.seed, fl, n,
                                     cfg_file["work"], **kw)
        return out, time.perf_counter() - t

    ref, ref_s = run()
    rows = [{"seed": seed, "route": reference.describe(route),
             "stand_in": "reference", "seconds": ref_s, "rmse": ref["rmse"],
             "hyper": {r: {k: x.tolist() for k, x in h.items()
                           if k in ("r", "ub", "vb")}
                       for r, h in ref["hyper"].items()}}]

    def logged(r):                       # as the program prints it
        return {e: float(f"{v:f}") for e, v in r.items()}

    def nums(out, rmse=None):
        t = out["tables"]
        vals = check.numbers(t[1], t[n], out["rmse"][n],
                             [logged(rmse or out["rmse"])], ref, tables0)
        rec = [[tuple(torch.as_tensor(out["hyper"][r][REF_HYPER[k]])
                      for k in HYPER) for r in range(1, n + 1)]]
        vals["hyper_gap"] = hyper_gap(rec, ref)
        return vals

    for name, kw in (("control", {"storage": "bfloat16"}),
                     ("eager", {"control": "eager"}),
                     ("drop_half", {"drop_half": True})):
        out, secs = run(**kw)
        rows.append({"seed": seed, "stand_in": name, "seconds": secs,
                     **nums(out)})
        del out
        if device == "cuda":
            torch.cuda.empty_cache()
    half = tuple(x[: x.numel() // 2] for x in dte)
    r_half = dict(ref["rmse"])
    r_half[n] = reference.rmse(ref["tables"][n], gb, *half)
    rows.append({"seed": seed, "stand_in": "eval_half",
                 **nums(ref, r_half)})
    return rows
