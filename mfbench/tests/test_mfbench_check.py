"""CPU tests of the check that decides ``correct``: the plain reference
follows each route's update order, the control and the planted faults
fail the limits, and a whole run with the timed path broken underneath
comes out not correct.

The program runs here through its fused schedule with the plain versions
in place of the kernels (float32 working type), at a tiny scale, with
jobs of 5 epochs."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mfbench import check, gen, reference, run
from mfbench.algs import mf
from mfbench.spec import train_config
from mfbench.tests.cpu_route import limits, tiny_spec

# (cell, scale): each route at a tiny scale that keeps it
ROUTES = {
    "ml10m-d128.mf": dict(nu=4000, nv=1000, ratings=60000),
    "ml10m-d128.mf-nodense": dict(nu=4000, nv=1000, ratings=60000),
    "yahoo-r1-d128.mf": dict(nu=3000, nv=140000, ratings=150000),
}
WANT = {"ml10m-d128.mf": "dense@1", "ml10m-d128.mf-nodense": "cells@1",
        "yahoo-r1-d128.mf": "sharded@1"}


def _run(cell, seed=3000000021):
    sp = tiny_spec(cell, **ROUTES[cell])
    return run.run_cell(sp, seed, 0.2, False, device="cpu")


@pytest.mark.parametrize("cell", sorted(ROUTES))
def test_reference_follows_the_route(cell):
    out = _run(cell)
    assert out["route"] == WANT[cell]
    assert out["correct"], out["checks"]
    v = {k: c["value"] for k, c in out["checks"].items()}
    # float32 on both sides, the same order: rounding alone
    assert v["grad1_gap"] < 1e-6 and v["change_gap"] < 1e-6
    assert v["loss_gap"] < 2e-6 and v["eval_gap"] < 2e-6


def test_reference_follows_a_late_dense_route():
    """Where one row's ratings in one cell keep epoch 1's eta past the
    dense bound, the program runs gen-1 cells first and the dense cells
    from the first epoch that clears it; the reference hands over the same
    way."""
    from tpu_mf_torch.data.coo import RatingsCOO
    from tpu_mf_torch.models.mf import MFParams

    sp = tiny_spec("ml10m-d128.mf", **ROUTES["ml10m-d128.mf"])
    cfg = sp["config"]
    train, test = gen.generate(cfg, 3000000043, "cpu")
    extra = 300                  # 300 ratings of user 0 in item tile 0
    rng = np.random.default_rng(0)
    train = gen.Ratings(
        np.concatenate([train.u, np.zeros(extra, np.int32)]),
        np.concatenate([train.v, rng.integers(0, 64, extra, np.int32)]),
        np.concatenate([train.r, np.full(extra, 4.0, np.float32)]),
        train.nu, train.nv)
    dim, n = int(cfg["dim"]), sp["traffic"]["job_epochs"]
    t0 = gen.init_tables(train.nu, train.nv, dim, 3000000043, "cpu")
    gb = float(np.float32(train.r.mean()))
    c = train_config(sp, 7, gb, n)
    route = reference.route(train.nu, train.nv, dim, train.u, train.v,
                            c.eta_at, c.use_dense, n)
    assert route == [(1, "cells"), (2, "dense")]
    win = run.Window(seconds=0.0, warmup_jobs=1, warmup_seconds=0.0,
                     parse=mf.parse, snap=mf.snapshot)
    params = MFParams(t0["theta"], t0["phi"], t0["bu"], t0["bv"],
                      torch.tensor(gb))
    sched, job = mf.job_runner(
        c, RatingsCOO(train.u, train.v, train.r, train.nu, train.nv),
        RatingsCOO(test.u, test.v, test.r, test.nu, test.nv), params,
        win.log)
    assert [e for e, _ in sched] == [1, 2]
    final = job()
    win.job_done()
    final = {k: getattr(final, k) for k in check.LEAVES}
    dte = test.on("cpu")
    ref = check.reference_run(route, t0, train.on("cpu"), dte, gb, dim, 7,
                              c.eta_at, c.lam, "float32", "float32", n)
    v = check.numbers(win.snap1, final, reference.rmse(final, gb, *dte),
                      win.logged(), ref, t0)
    assert v["grad1_gap"] < 1e-6 and v["change_gap"] < 1e-6, v
    assert v["loss_gap"] < 2e-6 and v["eval_gap"] < 2e-6, v


def _dense_runner():
    from tpu_mf_torch.ops.sgd_dense import DenseEpochRunner
    return DenseEpochRunner


def test_fault_state_unchanged(monkeypatch):
    cls = _dense_runner()
    monkeypatch.setattr(cls, "epoch", lambda self, tables, *a, **k: tables)
    out = _run("ml10m-d128.mf")
    assert not out["correct"]
    assert out["checks"]["grad1_gap"]["value"] == pytest.approx(1.0)


def test_fault_half_the_batch(monkeypatch):
    """Each cell's second half of ratings left out (W and S zeroed on its
    later item rows), as a kernel that drops half its work would."""
    cls = _dense_runner()
    real = cls.epoch

    def half(self, tables, eta, lam, gb, epoch_idx=0):
        cells = self.cells
        tv = cells.s.shape[3]
        s, w = cells.s.clone(), cells.w.clone()
        cells.s[..., tv // 2:] = 0
        cells.w[..., tv // 2:] = 0
        try:
            return real(self, tables, eta, lam, gb, epoch_idx)
        finally:
            cells.s.copy_(s)
            cells.w.copy_(w)

    monkeypatch.setattr(cls, "epoch", half)
    out = _run("ml10m-d128.mf")
    assert not out["correct"], out["checks"]


def test_fault_answer_altered(monkeypatch):
    """The eval's answer altered where it is produced: the test RMSE taken
    over half of the test set."""
    from tpu_mf_torch.train import loop

    real = loop.rmse

    def half(params, ds, chunk=1 << 20):
        n = len(ds.u) // 2
        sub = type("T", (), {"u": ds.u[:n], "v": ds.v[:n], "r": ds.r[:n]})
        return real(params, sub, chunk)

    monkeypatch.setattr(loop, "rmse", half)
    out = _run("ml10m-d128.mf")
    assert not out["correct"]
    assert out["checks"]["eval_gap"]["value"] > \
        out["checks"]["eval_gap"]["limit"]


@pytest.mark.parametrize("cell", sorted(ROUTES))
def test_control_fails_the_limits(cell):
    """The control, the reference with its tables kept in bfloat16, at a
    test's scale in the cell's stated working type: it fails one of the
    cell's limits (on the card it is read at the cell's own scale)."""
    sp = tiny_spec(cell, **ROUTES[cell])
    sp["config"]["work"] = "bfloat16"
    cfg = sp["config"]
    train, test = gen.generate(cfg, 3000000023, "cpu")
    dim = int(cfg["dim"])
    t0 = gen.init_tables(train.nu, train.nv, dim, 3000000023, "cpu")
    gb = float(np.float32(train.r.mean()))
    n = sp["traffic"]["job_epochs"]
    c = train_config(sp, 7, gb, n)
    dtr, dte = train.on("cpu"), test.on("cpu")
    route = reference.route(train.nu, train.nv, dim, train.u, train.v,
                            c.eta_at, c.use_dense, n)
    args = (route, t0, dtr, dte, gb, dim, 7, c.eta_at, c.lam, "bfloat16")
    ref = check.reference_run(*args, "float32", n)
    ctl = check.reference_run(*args, "bfloat16", n)
    vals = check.numbers(ctl["tables"][1], ctl["tables"][n], ctl["rmse"][n],
                         [{e: float(f"{x:f}") for e, x in ctl["rmse"].items()}],
                         ref, t0)
    ok, _ = check.judge(vals, limits(cell))
    assert not ok, vals


def test_judge_needs_every_limit():
    vals = dict.fromkeys(check.NUMBERS, 0.0)
    assert not check.judge(vals, None)[0]
    lim = {k: {"limit": 1.0} for k in check.NUMBERS}
    assert check.judge(vals, lim)[0]
    vals["eval_gap"] = float("nan")
    assert not check.judge(vals, lim)[0]


@pytest.mark.parametrize("tg,pg", [(1, 1), (8, 8), (8, 1), (1, 8), (2, 4),
                                   (4, 2)])
def test_levels_follow_program_order_at_every_grouping(tg, pg):
    """The reference's levelled windows against the program's plain gen-1
    epoch at fixed groupings, on the program's own balanced plans."""
    from tpu_mf_torch.data.coo import RatingsCOO
    from tpu_mf_torch.models.mf import MFParams
    from tpu_mf_torch.ops.sgd_cells import CellEpochRunner, pick_cell_geometry

    cfg = tiny_spec("ml10m-d128.mf-nodense", nu=2000, nv=900,
                    ratings=40000, dim=64)["config"]
    train, _ = gen.generate(cfg, 3000000031, "cpu")
    t0 = gen.init_tables(train.nu, train.nv, 64, 3000000031, "cpu")
    ds = RatingsCOO(train.u, train.v, train.r, train.nu, train.nv)
    tu, tv, b = pick_cell_geometry(ds)
    runner = CellEpochRunner(ds, tile_u=tu, tile_v=tv, batch=b, seed=9,
                             n_plans=2, balance=True, saturate=True,
                             mxu="float32", theta_groups=tg, phi_groups=pg,
                             device="cpu")
    tabs = runner.pad(MFParams(t0["theta"], t0["phi"], t0["bu"], t0["bv"],
                               torch.tensor(3.5)))
    ref = reference.build("cells", t0, train.on("cpu"), 3.5, 64, 9,
                          "float32", "float32")
    ref.groups = (tg, pg)
    for e in (1, 2):
        tabs = runner.epoch(tabs, 0.02 / e, 0.005, 3.5, epoch_idx=e)
        ref.epoch(e, 0.02 / e, 0.005)
    got = runner.trim(tabs)
    want = ref.tables()
    for k in ("theta", "phi", "bu", "bv"):
        torch.testing.assert_close(getattr(got, k), want[k], rtol=1e-5,
                                   atol=1e-6)
