"""CPU tests of the DP-SGLD cell: the traffic's ``alg`` picks its driver,
the plain DP-SGLD reference's pass is the program's plain gen-1 SGLD
round, the controls and planted faults fail the limits, a whole run on
the program's plain path comes out correct and one with the timed path
broken underneath does not, and the round's work counts.

The program runs here on its gen-1 SGLD runner with the plain round in
place of the kernel, at a tiny scale, with jobs of 5 rounds, at the eta
that gives the cell's step scal = eta * ntrain * lambda_r."""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import pytest
import torch

from mfbench import check, gen, reference_dpmf, run, spec as S
from mfbench.algs import dpmf
from mfbench.gen import Ratings
from mfbench.tests.cpu_route import limits, tiny_spec
from mfbench.work.dpmf import round_work

CELL = "ml10m-d128.dpmf"
SCALE = dict(nu=1500, nv=1100, ratings=30000, dim=64)


def _spec():
    sp = tiny_spec(CELL, **SCALE)
    sp["config"]["work"] = "bfloat16"
    tc = sp["traffic"]["train_config"]
    full = S.cell_spec(CELL)["config"]
    n_full = full["ratings"] * (1 - full["test_frac"])
    n = SCALE["ratings"] * (1 - sp["config"]["test_frac"])
    tc["eta"] = tc["eta"] * n_full / n
    return sp


def test_traffic_alg_picks_its_driver(tmp_path):
    for path in (S.PKG / "traffic").glob("*.json"):
        alg = S._json(path)["alg"]
        drv = S.driver(alg)
        assert drv is S.driver(alg)
        assert drv.__name__ == f"mfbench.algs.{alg}"
        for name in ("NUMBERS", "parse", "draw", "setup", "epoch_work",
                     "compare", "readings"):
            assert hasattr(drv, name), (alg, name)
    (tmp_path / "algs").mkdir()
    with pytest.raises(FileNotFoundError, match=r"algs/admf\.py"):
        S.driver("admf", tmp_path)


def test_round_lines_parse():
    assert dpmf.parse("round #3\tRMSE=0.912000\ttRMSE=0.934500\t1.250000") \
        == (3, 1.25, 0.9345)
    assert dpmf.parse("round #1\tRMSE=0.912000\t0.5") == (1, 0.5, None)
    assert dpmf.parse("iter#3\t1.25\ttRMSE=0.9") is None
    assert dpmf.parse("# fused SGLD ineligible") is None


def _port_round(train: Ratings, t0: dict, gb: float, seed: int, hyper,
                rnd: int = 1):
    """The program's gen-1 SGLD runner, one round on the CPU (the plain
    round): (tables, stamps, seed stride)."""
    from tpu_mf_torch.data.coo import RatingsCOO
    from tpu_mf_torch.models.dpmf import init_dpmf
    from tpu_mf_torch.models.mf import MFParams
    from tpu_mf_torch.ops.sgld_cells import SgldCellRunner

    ds = RatingsCOO(train.u, train.v, train.r, train.nu, train.nv)
    state = init_dpmf(ds, t0["theta"].shape[1], gb,
                      torch.Generator().manual_seed(0), "cpu")
    state = state._replace(params=MFParams(
        *(t0[k].clone() for k in check.LEAVES), state.params.gb))
    runner = SgldCellRunner(ds, tile_u=512, tile_v=512, batch=8192,
                            seed=seed, n_plans=2, device="cpu")
    tables = runner.pad(state)
    eta, temp = hyper
    scal = eta * len(ds) * 1.0 * float(state.lambda_r)
    runner.epoch(tables, 0, (eta, temp, 1.0, scal, gb),
                 noise_seed=seed * 1_000_003 + rnd * runner.seed_stride,
                 epoch_idx=rnd - 1)
    out = runner.unpack(state, tables)
    return out, runner.seed_stride


@pytest.mark.parametrize("temp", [0.0, 1.0])
def test_reference_pass_is_the_program_plain_round(temp):
    """The reference's SGLD pass (levels, hashed normals, lazy counts from
    the plan) against the program's ``sgld_cell_epoch_reference`` on one
    seeded plan, both in the bfloat16 working type."""
    sp = _spec()
    fl = dpmf.flags(sp)
    fl["temp"] = temp
    cfg = sp["config"]
    train, _ = gen.generate(cfg, 3000000071, "cpu")
    t0 = gen.init_tables(train.nu, train.nv, 64, 3000000071, "cpu")
    gb = float(np.float32(train.r.mean()))
    seed = 3000000071 % 2 ** 31
    port, stride = _port_round(train, t0, gb, seed, (fl["eta"], temp))
    tr = reference_dpmf.Trainer(t0, train.on("cpu"), gb, seed, fl,
                                "bfloat16")
    plan, _ = tr.sgld(1)
    assert tr.stride == stride
    want = tr.tables()
    for k in check.LEAVES:
        torch.testing.assert_close(want[k], getattr(port.params, k),
                                   rtol=1e-5, atol=1e-6)
        # the pass moved every table beyond rounding
        assert float((want[k] - t0[k]).abs().max()) > 1e-4
    torch.testing.assert_close(plan.last_u, port.gcountu[:train.nu])
    torch.testing.assert_close(plan.last_v, port.gcountv[:train.nv])
    assert plan.n_real == len(train) == int(port.gcount)


def test_controls_and_faults_fail_the_limits():
    """The control (tables kept in bfloat16), eager noise, half of every
    column left out and the eval over half the test set, each read as the
    cell's ``control.py`` reads them, fail the cell's limits at a test's
    scale (on the card they are read at the cell's own)."""
    rows = dpmf.readings(_spec(), 3000000073, "cpu")
    names = {r["stand_in"] for r in rows}
    assert names == {"reference", "control", "eager", "drop_half",
                     "eval_half"}
    lim = limits(CELL)
    for r in rows[1:]:
        ok, got = check.judge(r, lim, dpmf.NUMBERS)
        assert not ok, (r["stand_in"], got)


def _cpu_runner(monkeypatch):
    """``_dpmf_runner`` on the CPU: the gen-1 runner it builds on a card,
    whose round is the plain one there."""
    from tpu_mf_torch.ops.sgld_cells import SgldCellRunner
    from tpu_mf_torch.train import loop

    def runner(cfg, train_ds, state, log, device):
        return SgldCellRunner(train_ds, tile_u=512, tile_v=512,
                              batch=max(8192, cfg.batch_size), seed=cfg.seed,
                              n_plans=2, device=device)

    monkeypatch.setattr(loop, "_dpmf_runner", runner)
    return SgldCellRunner


def _run(seed=3000000079):
    return run.run_cell(_spec(), seed, 0.2, False, device="cpu")


def test_a_run_on_the_plain_round_is_correct(monkeypatch):
    _cpu_runner(monkeypatch)
    out = _run()
    assert out["route"] == "sgld-cells@1"
    assert out["correct"], out["checks"]
    assert out["epochs"]["close_job"] > out["epochs"]["open_job"] >= 1
    v = {k: c["value"] for k, c in out["checks"].items()}
    assert set(v) == set(dpmf.NUMBERS)
    assert max(v.values()) < 2e-6, v


def test_fault_state_unchanged(monkeypatch):
    cls = _cpu_runner(monkeypatch)
    monkeypatch.setattr(cls, "epoch", lambda self, tables, *a, **k: tables)
    assert not _run()["correct"]


def test_fault_half_the_batch(monkeypatch):
    """The second half of every column's slots left out (w zeroed), the
    clocks kept: a kernel that drops half its work."""
    cls = _cpu_runner(monkeypatch)
    real = cls.epoch

    def half(self, tables, *a, **k):
        for plan in self.materialize()._dev:
            plan.cells.w[..., plan.cells.w.shape[-1] // 2:] = 0
        return real(self, tables, *a, **k)

    monkeypatch.setattr(cls, "epoch", half)
    out = _run()
    assert not out["correct"], out["checks"]


def test_fault_answer_altered(monkeypatch):
    """The round's test RMSE taken over half of the test set."""
    from tpu_mf_torch.train import loop

    _cpu_runner(monkeypatch)
    real = loop.rmse

    def half(params, ds, chunk=1 << 20):
        n = len(ds.u) // 2
        sub = type("T", (), {"u": ds.u[:n], "v": ds.v[:n], "r": ds.r[:n]})
        return real(params, sub, chunk)

    monkeypatch.setattr(loop, "rmse", half)
    out = _run()
    assert not out["correct"]
    assert out["checks"]["eval_gap"]["value"] > \
        out["checks"]["eval_gap"]["limit"]


def test_round_work_by_hand():
    # 3 training ratings on users {0, 2}, items {1}; 2 test ratings on
    # users {1}, items {0, 1}; 3 users, 2 items, dim 4, float32 tables
    train = Ratings(np.array([0, 2, 2], np.int32), np.array([1, 1, 1],
                    np.int32), np.ones(3, np.float32), 3, 2)
    test = Ratings(np.array([1, 1], np.int32), np.array([0, 1], np.int32),
                   np.ones(2, np.float32), 3, 2)
    w = round_work(train, test, 4, 4)
    row = 5 * 4
    sgld = 12 * 3 + 2 * row * 3 + 2 * 8 * 3
    flush = 2 * (row + 8) * 5
    mse = 12 * 3 + row * 3
    evals = 12 * 2 + row * 3
    assert w["bytes"] == sgld + flush + mse + evals
    assert w["model_flops"] == 6 * 6 * 3
    assert w["ops"] == 6 * 6 * 3 + 4 * 5 * 3 + 2 * 6 * 2


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.'); "
            "import mfbench.reference_dpmf; "
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'tpu_mf_torch', 'tpu_mf', 'jax', 'jaxlib', 'flax'}; "
            "print(sorted(bad)); sys.exit(1 if bad else 0)")
    done = subprocess.run([sys.executable, "-c", code], cwd=S.ROOT,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stdout + done.stderr
