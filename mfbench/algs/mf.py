"""The driver of ``--alg mf``: jobs of biased-MF SGD as
``tpu_mf_torch.train.loop.train_mf`` trains them. The schedule's runners
(``_mf_runner_schedule``, plans built and uploaded once) drive jobs of the
traffic's ``job_epochs`` epochs (the reference trainer's ``--iter 15``)
through the epoch loop ``_run_schedule``, each job from the seed's initial
tables. The check trains the plain reference (``reference.py``) for one
job over the same routes (``check.reference_run``).
"""

from __future__ import annotations

import re

from mfbench import check, gen, reference
from mfbench.spec import train_config
from mfbench.work.mf import epoch_work as _epoch_work

NUMBERS = check.NUMBERS
ITER_LINE = re.compile(r"^iter#(\d+)\t([0-9.eE+-]+)(?:\ttRMSE=(\S+))?")


def parse(line: str):
    """(epoch, elapsed, logged test RMSE or None) of an ``iter#`` line."""
    m = ITER_LINE.match(line)
    if m is None:             # the schedule's "# ..." lines
        return None
    rmse = None if m.group(3) is None else float(m.group(3))
    return int(m.group(1)), float(m.group(2)), rmse


def loop_tables(frame) -> dict:
    """The training loop's tables on the device, read from the frame that
    called the log callback (or one above it): its ``runner`` and the
    ``tables`` it trains, as ``runner.trim`` gives them for the epoch's
    eval."""
    f = frame
    while f is not None:
        loc = f.f_locals
        if "runner" in loc and "tables" in loc and hasattr(loc["runner"],
                                                          "trim"):
            p = loc["runner"].trim(loc["tables"])
            return {k: getattr(p, k).detach()
                    for k in ("theta", "phi", "bu", "bv")}
        f = f.f_back
    raise LookupError("no training-loop frame holds runner and tables")


def snapshot(frame) -> dict:
    """Host float32 copies of the loop's tables (``loop_tables``)."""
    tabs = loop_tables(frame)
    return {k: x.to("cpu", copy=True).float() for k, x in tabs.items()}


def draw(spec: dict, seed: int, device) -> tuple:
    """(train, test, tables0, gb, cfg, route) of the cell for ``seed``: the
    ratings and initial tables, the training split's mean, the program's
    ``TrainConfig`` and the routes its schedule takes (``reference.
    route``). Where the traffic asks for ``single_route``, every seed runs
    one route for the whole job: a draw whose schedule changes route within
    the job (on ML-10M, when one row's ratings in one cell keep epoch 1's
    eta past the dense bound, so that gen-1 cells run first) is drawn
    again, from the seed plus 1,000,003 for each try. The program's own
    seed stays ``seed`` in every try."""
    import numpy as np

    cfg_file, tr = spec["config"], spec["traffic"]
    dim, n_ep = int(cfg_file["dim"]), int(tr["job_epochs"])
    for k in range(8):
        data_seed = seed + 1_000_003 * k
        train, test = gen.generate(cfg_file, data_seed, device)
        gb = float(np.float32(train.r.mean(dtype=np.float64)))
        cfg = train_config(spec, seed % (2 ** 31), gb, n_ep)
        route = reference.route(train.nu, train.nv, dim, train.u, train.v,
                                cfg.eta_at, cfg.use_dense, n_ep)
        if len(route) == 1 or not tr.get("single_route", False):
            break
    else:
        raise RuntimeError(f"no draw of seed {seed} runs one route")
    tables0 = gen.init_tables(train.nu, train.nv, dim, data_seed, device,
                              float(cfg_file.get("init_scale", 1e-2)))
    return train, test, tables0, gb, cfg, route


def job_runner(cfg, train_coo, test_coo, params, log):
    """(schedule, job): the runners ``train_mf`` builds for ``cfg`` on the
    fused route, once, and a function that runs one job on them as
    ``train_mf`` does (a copy of the initial tables, the epoch loop,
    epochs 1 to ``cfg.iters``) and returns its final tables."""
    from tpu_mf_torch.models.mf import MFParams
    from tpu_mf_torch.ops.rows import MAX_DIM
    from tpu_mf_torch.train import loop

    if loop._unsupported(cfg) or not cfg.use_pallas or cfg.dim > MAX_DIM:
        raise NotImplementedError("the harness drives the fused route only")
    sched = loop._mf_runner_schedule(cfg, train_coo, params, log)
    obs = loop._Observer(cfg, len(train_coo), log)

    def job():
        p = MFParams(*(t.clone() for t in params))
        return loop._run_schedule(cfg, sched, test_coo, p, log, obs)

    return sched, job


def setup(spec: dict, drawn: tuple, win, device):
    """The schedule, built once; a job returns its final tables, and the
    first job's epoch-1 tables come from the loop's frame (``snapshot``)."""
    import torch

    from tpu_mf_torch.data.coo import RatingsCOO
    from tpu_mf_torch.models.mf import MFParams

    train, test, tables0, gb, cfg, _ = drawn
    params = MFParams(tables0["theta"], tables0["phi"], tables0["bu"],
                      tables0["bv"], torch.tensor(gb, device=device))
    win.snap = snapshot
    _, run_job = job_runner(
        cfg, RatingsCOO(train.u, train.v, train.r, train.nu, train.nv),
        RatingsCOO(test.u, test.v, test.r, test.nu, test.nv), params,
        win.log)

    def job():
        p = run_job()
        return {k: getattr(p, k) for k in check.LEAVES}

    return job


def epoch_work(drawn: tuple, spec: dict) -> dict:
    train, test, _, _, cfg, _ = drawn
    return _epoch_work(train, test, int(spec["config"]["dim"]),
                       4 if cfg.dtype == "float32" else 2)


def compare(spec: dict, drawn: tuple, win, final: dict, test_rmse: float,
            device) -> tuple[dict, dict]:
    """(the four numbers of ``check.py``, {"groupings": the reference's}):
    one job of the plain reference over the draw's routes against what the
    jobs produced."""
    train, test, tables0, gb, cfg, route = drawn
    cfg_file = spec["config"]
    ref = check.reference_run(
        route, tables0, train.on(device), test.on(device), gb,
        int(cfg_file["dim"]), cfg.seed, cfg.eta_at, cfg.lam,
        cfg_file["work"], cfg_file["dtype"],
        int(spec["traffic"]["job_epochs"]))
    values = check.numbers(win.snap1, final, test_rmse, win.logged(), ref,
                           tables0)
    return values, {"groupings": ref["groupings"]}


def readings(spec: dict, seed: int, device: str = "cuda",
             orders: bool = True) -> list:
    """The stand-ins of ``control.py`` for one seed, as JSON rows:

    - ``control``: the reference with its tables kept in bfloat16 (each
      apply rounded), the lower precision a later change would be tempted
      by;
    - ``drop_half``: the reference leaving out the second half of every
      window's ratings;
    - ``eval_half``: sound tables whose logged test RMSE at the job's last
      epoch is taken over half of the test set (an answer altered where it
      is produced);
    - ``reorder`` (window routes): the reference in another seed's update
      order (other shuffles of the same ratings into the same windows);
    - ``retile``: the reference on gen-1 windows of its own (``retiled``):
      what a reference that did not follow the route would read."""
    import time

    import torch

    cfg_file = spec["config"]
    n_ep = int(spec["traffic"]["job_epochs"])
    train, test, tables0, gb, cfg, route = draw(spec, seed, device)
    dim, run_seed = int(cfg_file["dim"]), cfg.seed
    dtr, dte = train.on(device), test.on(device)
    names = {name for _, name in route}

    def run(storage, drop_half=False, order_seed=run_seed, how=route):
        t = time.perf_counter()
        if how == "retile":
            out = retiled(tables0, dtr, dte, gb, run_seed, cfg, cfg_file,
                          n_ep, "sharded" in names)
        else:
            out = check.reference_run(how, tables0, dtr, dte, gb, dim,
                                      order_seed, cfg.eta_at, cfg.lam,
                                      cfg_file["work"], storage, n_ep,
                                      drop_half=drop_half)
        return out, time.perf_counter() - t

    ref, ref_s = run(cfg_file["dtype"])
    rows = [{"seed": seed, "route": reference.describe(route),
             "stand_in": "reference",
             "seconds": ref_s, "rmse": ref["rmse"],
             "groupings": ref["groupings"]}]

    def logged(r):                       # as the program prints it
        return {e: float(f"{v:f}") for e, v in r.items()}

    def nums(out):
        t = out["tables"]
        return check.numbers(t[1], t[n_ep], out["rmse"][n_ep],
                             [logged(out["rmse"])], ref, tables0)

    st = cfg_file["dtype"]
    stand_ins = [("control", "bfloat16", False, run_seed, route),
                 ("drop_half", st, True, run_seed, route)]
    if orders:
        stand_ins.append(("retile", st, False, run_seed, "retile"))
    if orders and names != {"dense"}:
        stand_ins.append(("reorder", st, False, run_seed + 1, route))
    for name, storage, drop, order, how in stand_ins:
        out, secs = run(storage, drop, order, how)
        rows.append({"seed": seed, "stand_in": name, "seconds": secs,
                     **nums(out)})
        del out
        if device == "cuda":
            torch.cuda.empty_cache()
    half = tuple(x[: x.numel() // 2] for x in dte)
    r_half = dict(ref["rmse"])
    r_half[n_ep] = reference.rmse(ref["tables"][n_ep], gb, *half)
    t = ref["tables"]
    rows.append({"seed": seed, "stand_in": "eval_half",
                 **check.numbers(t[1], t[n_ep], ref["rmse"][n_ep],
                                 [logged(r_half)], ref, tables0)})
    return rows


def retiled(tables0, train, test, gb, seed, cfg, cfg_file, n_ep,
            sharded: bool) -> dict:
    """One job of the reference on gen-1 windows of its own: tiles of
    256 x 256 and columns of 1024 (4096 x 2048 and 512, unsharded, at a
    catalog the program shards)."""
    u, v, r = train
    nu, nv = tables0["theta"].shape[0], tables0["phi"].shape[0]
    tu, tv, sub = (4096, 2048, 512) if sharded else (256, 256, 1024)
    plans = [[reference.cell_plan(u, v, r, tu, tv, sub, seed + p)]
             for p in (0, 1)]
    tr = reference.Trainer(tables0, plans, reference.cdiv(nu, tu) * tu,
                           reference.cdiv(nv, tv) * tv, "window", gb,
                           cfg_file["work"], cfg_file["dtype"])
    tables, rmses = {}, {}
    for e in range(1, n_ep + 1):
        tr.epoch(e, cfg.eta_at(e), cfg.lam)
        t = tr.tables()
        rmses[e] = reference.rmse(t, gb, *test)
        if e in (1, n_ep):
            tables[e] = t
    return {"tables": tables, "rmse": rmses}
