"""The driver of ``--alg admf``: jobs of AdaptReg epochs as
``tpu_mf_torch.train.loop.train_admf`` trains them on a card. Set-up
builds the runner once as ``train_admf`` does (``loop._admf_runner``: the
gen-1 ``AdRegCellRunner``, its two plans built, then uploaded by
``materialize``); a job starts from a copy of the seed's initial state
(tables, their shadows, all four lambdas at ``--lambda``) and runs epochs
1 to ``job_epochs`` through ``loop._train_admf_fused``, the CLI's loop.
The check runs the plain reference (``reference_admf.py``) for one job.

The configuration's ``valid_frac`` of the training split, drawn by seed,
is the validation set (``split_valid``); the rest trains.

In a traced run the span recorder (``tpu_mf_torch.train.metrics``) is on
for the warm-up jobs after the first alone, and each such job's spans are
drained into its ``win.rec`` entry before its end, so that no span's
profiler range falls inside the window; ``span_ms`` reads them.
"""

from __future__ import annotations

import contextlib
import statistics

import numpy as np

from mfbench import check, gen, reference, reference_admf
from mfbench.algs.mf import parse, snapshot
from mfbench.spec import train_config
from mfbench.work.admf import epoch_work as _epoch_work

NUMBERS = check.NUMBERS + ("lam_gap",)
ROUTE = "adreg-cells"
FLAGS = ("eta", "gam", "eta_reg", "loss")


def split_valid(train, frac: float, seed: int, device):
    """(train, valid): a seeded ``frac`` of the ratings (rounded) and the
    rest, disjoint, each in the order it had."""
    import torch

    n = len(train)
    k = int(round(n * frac))
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) ^ 0x7A11D)
    pick = torch.zeros(n, dtype=torch.bool, device=device)
    pick[torch.randperm(n, generator=g, device=device)[:k]] = True
    pick = pick.cpu().numpy()

    def part(m):
        return gen.Ratings(u=train.u[m], v=train.v[m], r=train.r[m],
                           nu=train.nu, nv=train.nv)

    return part(~pick), part(pick)


def draw(spec: dict, seed: int, device) -> tuple:
    """(train, test, tables0, gb, cfg, route, valid): the ratings and
    initial tables of ``seed``, the training mean, the program's
    ``TrainConfig``, the one route the reference follows (the gen-1
    AdaptReg runner) and the validation set."""
    cfg_file = spec["config"]
    train, test = gen.generate(cfg_file, seed, device)
    train, valid = split_valid(train, float(cfg_file["valid_frac"]), seed,
                               device)
    gb = float(np.float32(train.r.mean(dtype=np.float64)))
    cfg = train_config(spec, seed % (2 ** 31), gb,
                       int(spec["traffic"]["job_epochs"]))
    tables0 = gen.init_tables(train.nu, train.nv, int(cfg_file["dim"]), seed,
                              device, float(cfg_file.get("init_scale", 1e-2)))
    return train, test, tables0, gb, cfg, [(1, ROUTE)], valid


def describe_runner(runner) -> dict:
    """What the result line says of the runner: its family, tiles, batch,
    and per plan its batches, segments and walk."""
    return {"runner": type(runner).__name__,
            "tiles": [runner.tile_u, runner.tile_v], "batch": runner.batch,
            "batches": [int(p.u.shape[0]) for p in runner.plans],
            "segments": list(runner._segs),
            "walks": [runner.route(i) for i in range(len(runner.plans))]}


def setup(spec: dict, drawn: tuple, win, device):
    """The runner, built once; a job returns its final tables, and keeps in
    its ``win.rec`` entry each epoch's lambdas, each epoch's segment
    launches by walk, and (traced warm-up jobs after the first) its
    spans. The first job's epoch-1 tables come from the loop's frame
    (``snapshot``)."""
    import torch

    from tpu_mf_torch.data.coo import RatingsCOO
    from tpu_mf_torch.models.admf import AdaptRegState, with_shadows
    from tpu_mf_torch.models.mf import MFParams
    from tpu_mf_torch.ops.adreg_cells import AdRegCellRunner, adreg_segment
    from tpu_mf_torch.train import loop, metrics

    train, test, tables0, gb, cfg, _, valid = drawn

    def coo(x):
        return RatingsCOO(x.u, x.v, x.r, x.nu, x.nv)

    train_coo, test_coo = coo(train), coo(test)
    state0 = with_shadows(
        MFParams(*(tables0[k] for k in check.LEAVES),
                 torch.tensor(gb, dtype=torch.float32, device=device)),
        (cfg.lam,) * 4)
    obs = loop._Observer(cfg, len(train), win.log)
    runner = loop._admf_runner(cfg, train_coo, coo(valid), state0, win.log,
                               device)
    if not isinstance(runner, AdRegCellRunner):
        raise NotImplementedError("the reference follows the gen-1 AdaptReg "
                                  "runner only")
    runner.materialize()
    desc = describe_runner(runner)
    win.snap = snapshot

    def job():
        state = AdaptRegState(MFParams(*(t.clone() for t in state0.params)),
                              *(t.clone() for t in state0[1:]))
        rec = {"runner": desc, "lams": [], "walks": [], "spans": None}
        win.rec.append(rec)
        seen = dict(adreg_segment.walks)

        def log(line):
            win.log(line)
            if parse(line) is not None:
                rec["lams"].append(runner.lams.clone())
                now = dict(adreg_segment.walks)
                rec["walks"].append({w: now[w] - seen[w] for w in now})
                seen.update(now)

        traced = win.profile and win.t_open is None and win.job >= 1
        with (metrics.recording() if traced
              else contextlib.nullcontext()) as spans:
            state = loop._train_admf_fused(cfg, runner, state, test_coo, log,
                                           obs)
        rec["spans"] = spans
        return {k: getattr(state.params, k) for k in check.LEAVES}

    return job


def epoch_work(drawn: tuple, spec: dict) -> dict:
    train, test, _, _, cfg, _, _ = drawn
    return _epoch_work(train, test, int(spec["config"]["dim"]),
                       4 if cfg.dtype == "float32" else 2,
                       reference_admf.SEGMENTS, reference_admf.K)


def span_ms(win, name: str) -> list:
    """Per recorded epoch (a ``tmf.epoch`` span of a job whose spans were
    kept), the summed device ms of the spans named ``name`` inside it."""
    out = []
    for rec in win.rec if win is not None else []:
        spans = rec["spans"] or []
        for ep in spans:
            if ep["name"] != "tmf.epoch":
                continue
            ms = [r["device_ms"] for r in spans
                  if r["parent"] == ep["id"] and r["name"] == name]
            if ms and None not in ms:
                out.append(sum(ms))
    return out


def median_span_ms(ctx, name: str):
    """The median of ``span_ms`` over the traced run's recorded epochs, or
    None where none was recorded."""
    ms = span_ms(ctx.window, name)
    return statistics.median(ms) if ms else None


def flags(spec: dict) -> dict:
    """The trainer's flags the reference reads, from the traffic."""
    tc = spec["traffic"]["train_config"]
    return {k: tc[k] for k in FLAGS}


def lam_gap(jobs: list, ref: dict, lam0: float) -> float:
    """The largest gap, over every job and epoch and each of the four
    lambdas, between the program's lambda and the reference's, relative to
    the lambda's scale in the reference's job: the largest value it takes
    there, its start ``lam0`` included. (Relative to the value itself, a
    lambda near its clamp at 0 would read any rounding as a large gap.)"""
    want = np.stack([ref["lams"][e] for e in sorted(ref["lams"])])
    scale = np.maximum(np.abs(want).max(0), lam0)
    gaps = [0.0]
    for job in jobs:
        got = np.stack([x.detach().double().cpu().numpy() for x in job])
        gaps.append(float(np.max(np.abs(got - want) / scale)))
    return max(gaps) if all(g == g for g in gaps) else float("nan")


def _reference(spec, drawn, device, **kw) -> dict:
    train, test, tables0, gb, cfg, _, valid = drawn
    cfg_file = spec["config"]
    kw.setdefault("storage", cfg_file["dtype"])
    return reference_admf.run_job(
        tables0, (cfg.lam,) * 4, train.on(device), valid.on(device),
        test.on(device), gb, cfg.seed, flags(spec),
        int(spec["traffic"]["job_epochs"]), cfg_file["work"], **kw)


def compare(spec: dict, drawn: tuple, win, final: dict, test_rmse: float,
            device) -> tuple[dict, dict]:
    """(``check.py``'s four numbers and ``lam_gap``, {"adreg": the runner,
    its plans as the reference rebuilt them and the segment launches by
    walk}): one job of the plain reference against what the jobs
    produced. Raises where the runner's plans are not the ones the
    reference rebuilt, or where an epoch on the card did not launch its
    plan's segments on the tile walk, one launch each."""
    tables0 = drawn[2]
    ref = _reference(spec, drawn, device)
    values = check.numbers(win.snap1, final, test_rmse, win.logged(), ref,
                           tables0)
    values["lam_gap"] = lam_gap([r["lams"] for r in win.rec], ref,
                                drawn[4].lam)
    desc = win.rec[0]["runner"]
    rebuilt = {"batches": [p["batches"] for p in ref["plans"]],
               "segments": [p["segments"] for p in ref["plans"]]}
    if {k: desc[k] for k in rebuilt} != rebuilt:
        raise RuntimeError(f"the runner's plans {desc} are not the "
                           f"reference's {rebuilt}")
    walks = [w for r in win.rec for w in r["walks"]]
    if any(sum(w.values()) for w in walks):    # launched: on a card
        n_plans = len(desc["segments"])
        want = [{"tile": desc["segments"][e % n_plans], "grid": 0}
                for r in win.rec for e in range(len(r["walks"]))]
        if walks != want or set(desc["walks"]) != {"tile"}:
            raise RuntimeError(f"epochs launched {walks} on plans routed "
                               f"{desc['walks']}, not {want} on the tile "
                               f"walk")
    return values, {"adreg": {**desc, "reference": rebuilt,
                              "epochs": len(walks),
                              "launches": {w: sum(x[w] for x in walks)
                                           for w in walks[0]}}}


def readings(spec: dict, seed: int, device: str = "cuda",
             orders: bool = True) -> list:
    """The stand-ins of ``control.py`` for one seed, as JSON rows (the
    reference in float32 tables is what a sound program is held to):

    - ``control``: the reference with its tables kept in bfloat16 (each
      apply rounded);
    - ``frozen``: the reference with its lambdas frozen (every
      hypergradient step skipped);
    - ``one_segment``: one segment, and one step, an epoch instead of 8;
    - ``drop_half``: the reference leaving out the second half of every
      column's ratings;
    - ``eval_half``: sound tables whose logged test RMSE at the job's last
      epoch is taken over half of the test set.

    ``orders`` is not read: the gen-1 AdaptReg plans have one grouping."""
    import time

    import torch

    del orders
    n = int(spec["traffic"]["job_epochs"])
    drawn = draw(spec, seed, device)
    tables0 = drawn[2]

    def run(**kw):
        t = time.perf_counter()
        out = _reference(spec, drawn, device, **kw)
        return out, time.perf_counter() - t

    ref, ref_s = run()
    rows = [{"seed": seed, "route": reference.describe(drawn[5]),
             "stand_in": "reference", "seconds": ref_s, "rmse": ref["rmse"],
             "plans": ref["plans"],
             "lams": {e: x.tolist() for e, x in ref["lams"].items()}}]

    def logged(r):                       # as the program prints it
        return {e: float(f"{v:f}") for e, v in r.items()}

    def nums(out, rmse=None):
        t = out["tables"]
        vals = check.numbers(t[1], t[n], out["rmse"][n],
                             [logged(rmse or out["rmse"])], ref, tables0)
        vals["lam_gap"] = lam_gap(
            [[torch.as_tensor(out["lams"][e]) for e in range(1, n + 1)]], ref,
            drawn[4].lam)
        return vals

    for name, kw in (("control", {"storage": "bfloat16"}),
                     ("frozen", {"control": "frozen"}),
                     ("one_segment", {"segments": 1}),
                     ("drop_half", {"drop_half": True})):
        out, secs = run(**kw)
        rows.append({"seed": seed, "stand_in": name, "seconds": secs,
                     **nums(out)})
        del out
        if device == "cuda":
            torch.cuda.empty_cache()
    test = drawn[1].on(device)
    half = tuple(x[: x.numel() // 2] for x in test)
    r_half = dict(ref["rmse"])
    r_half[n] = reference.rmse(ref["tables"][n], drawn[3], *half)
    rows.append({"seed": seed, "stand_in": "eval_half", **nums(ref, r_half)})
    return rows
