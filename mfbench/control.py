"""The check's control and planted faults, at a cell's own size, on the
card: readings that set the upper end of each limit in
``limits/<cell>.json``.

    python3 mfbench/control.py --workload <cell> --seeds 11,12,13

For each seed it makes the cell's ratings and initial tables, trains the
plain reference in the configuration's precision for one job (what a
sound program is held to), and reads the check's numbers (``check.py``)
of what stands in the program's place, for one job:

- ``control``: the reference with its tables kept in bfloat16 (each
  apply rounded), the lower precision a later change would be tempted by;
- ``drop_half``: the reference leaving out the second half of every
  window's ratings;
- ``eval_half``: sound tables whose logged test RMSE at the job's last
  epoch is taken over half of the test set (an answer altered where it
  is produced);
- ``reorder`` (window routes): the reference in another seed's update
  order (other shuffles of the same ratings into the same windows);
- ``retile``: the reference on gen-1 windows of its own (``retiled``):
  what a reference that did not follow the route would read.

A step that returns its state unchanged reads 1 on both norm gaps and
needs no run. One JSON line per seed and stand-in.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(spec: dict, seed: int, device: str = "cuda",
             orders: bool = True) -> list:
    import torch

    from mfbench import check, reference
    from mfbench.run import draw

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
    from mfbench import reference

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--orders", type=int, choices=(0, 1), default=1,
                    help="also read the reorder and retile stand-ins")
    args = ap.parse_args(argv)
    from mfbench.run import setup_env

    setup_env()
    import torch

    from mfbench.spec import cell_spec

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    spec = cell_spec(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        for row in readings(spec, seed, orders=bool(args.orders)):
            print(json.dumps({"workload": args.workload, **row}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
