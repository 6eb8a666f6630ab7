"""The comparison that decides ``correct`` for a training cell.

A job is the trainer's epochs (or rounds) 1 to E (the traffic's
``job_epochs``). What the program's jobs produced is held against the
plain reference of the cell's driver (``algs/<alg>.py: compare``;
``reference.py`` for SGD, run by ``reference_run``, so every grouping of
columns the job's epochs pick is in the comparison; ``reference_dpmf.py``
for DP-SGLD, which adds its own numbers) trained from the same ratings
and initial tables for one whole job:

- ``loss_gap``: the largest gap, over every job of the run (warm-up and
  timed) and every epoch of it, between the test RMSE the program logged
  and the reference's own;
- ``grad1_gap``: the first step's gradient as the update applies it
  (epoch 1's change of each table, from the first warm-up job): by the
  worst table, the gap between the program's norm and the reference's,
  over the reference's norm of that table or of the median table, the
  larger;
- ``change_gap``: the same of the change after the whole job, from the
  tables the last timed job returned;
- ``eval_gap``: the gap between the test RMSE that last job logged at
  epoch E and that of the tables it returned, summed in float64 (the
  eval layer, judged on its own).

Tables whose reference change is under a thousandth of the median
table's are left out of the two norm gaps (none is, at these shapes).
"""

from __future__ import annotations

import torch

from mfbench import reference

LEAVES = ("theta", "phi", "bu", "bv")
NUMBERS = ("loss_gap", "grad1_gap", "change_gap", "eval_gap")


def leaf_gap(prog: dict, ref: dict, base: dict) -> float:
    """Worst table's |norm(prog - base) - norm(ref - base)| over the larger
    of its reference norm and the median table's."""
    dev = base["theta"].device
    p = {k: float(torch.linalg.vector_norm(
        (prog[k].to(dev) - base[k]).double())) for k in LEAVES}
    r = {k: float(torch.linalg.vector_norm((ref[k] - base[k]).double()))
         for k in LEAVES}
    med = sorted(r.values())
    med = 0.5 * (med[1] + med[2])
    keep = [k for k in LEAVES if r[k] >= 1e-3 * med]
    return max(abs(p[k] - r[k]) / max(r[k], med) for k in keep)


def reference_run(phases: list, tables0: dict, train, test, gb: float,
                  dim: int, seed: int, eta_at, lam: float, work: str,
                  storage: str, epochs: int, drop_half: bool = False
                  ) -> dict:
    """One job of the reference over the routes ``phases`` (``reference.
    route``), handing the tables on where a route takes over: {"tables":
    {1: .., epochs: ..}, "rmse": {epoch: test RMSE}, "groupings": {epoch:
    ["theta/phi groups", ..]}}."""
    tables, rmses, used = {}, {}, {}
    upcoming = list(phases)
    tr, t = None, tables0
    for e in range(1, epochs + 1):
        if upcoming and e >= upcoming[0][0]:
            name = upcoming.pop(0)[1]
            if tr is not None:
                used.update(tr.used)
            tr = reference.build(name, t, train, gb, dim, seed, work,
                                 storage, drop_half=drop_half)
        tr.epoch(e, eta_at(e), lam)
        t = tr.tables()
        rmses[e] = reference.rmse(t, gb, *test)
        if e in (1, epochs):
            tables[e] = t
    used.update(tr.used)
    del tr
    return {"tables": tables, "rmse": rmses,
            "groupings": {e: sorted(f"{a}/{b}" for a, b in g)
                          for e, g in sorted(used.items())}}


def numbers(snap1: dict, final: dict, final_rmse: float, logged: list,
            ref: dict, tables0: dict) -> dict:
    """The four numbers of the module docstring: ``snap1`` the first
    job's tables after epoch 1, ``final`` and ``final_rmse`` the last
    job's returned tables and their test RMSE, ``logged`` each job's
    {epoch: logged test RMSE}."""
    epochs = max(ref["tables"])
    rr = ref["rmse"]
    return {
        "loss_gap": max(abs(x - rr[e]) for job in logged
                        for e, x in job.items()),
        "grad1_gap": leaf_gap(snap1, ref["tables"][1], tables0),
        "change_gap": leaf_gap(final, ref["tables"][epochs], tables0),
        "eval_gap": abs(logged[-1][epochs] - final_rmse),
    }


def judge(values: dict, limits: dict | None, names=NUMBERS
          ) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers ``names``; a
    number without a value or a limit, or not finite, is not correct."""
    out, ok = {}, True
    for name in names:
        v = values.get(name)
        lim = None if limits is None else limits.get(name, {}).get("limit")
        out[name] = {"value": v, "limit": lim}
        if v is None or lim is None or not (v == v) or v > lim:
            ok = False
    return ok, out
