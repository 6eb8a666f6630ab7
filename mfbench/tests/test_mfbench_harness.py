"""CPU tests of the benchmark harness: cells resolve from their files, a
new cell needs only new files, work counts, the window's arithmetic, a
harness job against ``train_mf``, the import rule, and the exit without
a card."""

from __future__ import annotations

import ast
import json
import shutil
import sys
import types

import numpy as np
import pytest
import torch

from mfbench import run, spec as S
from mfbench.algs import mf
from mfbench.gen import Ratings
from mfbench.work.mf import epoch_work

CELLS = [w["name"] for w in S.load_benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_config_and_trainer(cell):
    import dataclasses

    from tpu_mf_torch.config import TrainConfig
    from tpu_mf_torch.train import loop

    sp = S.cell_spec(cell)
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    assert set(sp["traffic"]["train_config"]) <= fields
    assert hasattr(loop, f"train_{sp['traffic']['alg']}")
    for key in ("nu", "nv", "ratings", "test_frac", "generator", "dim",
                "dtype", "work"):
        assert key in sp["config"]
    assert sp["limits"] is not None
    names = {m["name"] for m in sp["end_to_end"]}
    assert {"setup_s", "updates_per_s"} <= names
    assert sp["per_layer"]
    for m in sp["per_layer"]:
        assert callable(S.reader(m["name"]))


def test_every_traffic_file_names_a_trainer():
    from tpu_mf_torch.train import loop

    for path in (S.PKG / "traffic").glob("*.json"):
        tr = json.loads(path.read_text())
        assert tr["name"] == path.stem
        assert hasattr(loop, f"train_{tr['alg']}")


def test_new_cell_is_files_only(tmp_path):
    """A configuration, a traffic mix, a limits file and a metric reader
    added as files, and entries in BENCHMARK.json, make a new cell; no
    file of the harness changes."""
    root = tmp_path / "checkout"
    shutil.copytree(S.PKG, root / "mfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = S.load_benchmark()
    pkg = root / "mfbench"
    cfg = json.loads((pkg / "configs" / "ml10m-d128.json").read_text())
    cfg["name"], cfg["dim"] = "ml10m-d64", 64
    (pkg / "configs" / "ml10m-d64.json").write_text(json.dumps(cfg))
    tr = json.loads((pkg / "traffic" / "mf.json").read_text())
    tr["name"] = "mf-late"
    tr["warmup_jobs"] = 4
    (pkg / "traffic" / "mf-late.json").write_text(json.dumps(tr))
    (pkg / "limits" / "ml10m-d64.mf-late.json").write_text(
        (pkg / "limits" / "ml10m-d128.mf.json").read_text())
    (pkg / "metrics" / "epochs_in_window.py").write_text(
        "def read(ctx):\n    return float(ctx.trace_epochs) or None\n")
    bench["configs"].append({"name": "ml10m-d64", "source": "x",
                             "file": "mfbench/configs/ml10m-d64.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "ml10m-d64.mf-late",
                               "config": "ml10m-d64", "traffic": "mf-late",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "epochs_in_window", "unit": "epochs",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "updates_per_s",
                               "workloads": ["ml10m-d64.mf-late"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    sp = S.cell_spec("ml10m-d64.mf-late", S.load_benchmark(root), pkg,
                     root)
    assert sp["config"]["dim"] == 64 and sp["traffic"]["warmup_jobs"] == 4
    assert sp["limits"] is not None
    assert [m["name"] for m in sp["per_layer"]][-1] == "epochs_in_window"
    read = S.reader("epochs_in_window", pkg)
    assert read(types.SimpleNamespace(trace_epochs=7)) == 7.0
    # the cells already there are as they were
    assert S.cell_spec(CELLS[0]) == S.cell_spec(
        CELLS[0], S.load_benchmark(root), pkg, root)


def test_work_counts_by_hand():
    # 3 training ratings on users {0, 2}, items {1}; 2 test ratings on
    # users {1}, items {0, 1}; dim 4, float32 tables
    train = Ratings(np.array([0, 2, 2], np.int32), np.array([1, 1, 1],
                    np.int32), np.ones(3, np.float32), 3, 2)
    test = Ratings(np.array([1, 1], np.int32), np.array([0, 1], np.int32),
                   np.ones(2, np.float32), 3, 2)
    w = epoch_work(train, test, 4, 4)
    row = 5 * 4
    assert w["bytes"] == 12 * 3 + 2 * row * 3 + 12 * 2 + row * 3
    assert w["model_flops"] == 6 * 6 * 3
    assert w["ops"] == 6 * 6 * 3 + 2 * 6 * 2


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _jobs(win, clock, ends, epochs=3, step=0.1):
    """Feed ``win`` jobs of ``epochs`` epoch lines ending at ``ends``;
    True once a job end closed the window."""
    for end in ends:
        for ep in range(1, epochs + 1):
            clock.t = end - step * (epochs - ep)
            win.log(f"iter#{ep}\t{clock.t - 100.0:f}\ttRMSE=0.9")
        clock.t = end
        if win.job_done():
            return True
    return False


def test_window_rate_is_all_work_over_all_time(monkeypatch):
    """The window opens at the warm-up's last job end and closes at the
    first job end at least ``seconds`` later: the job that straddles the
    limit is in, and the rate is its jobs' epochs over its seconds."""
    clock = _Clock()
    monkeypatch.setattr(run.time, "perf_counter", clock)
    snaps = []
    win = run.Window(seconds=1.0, warmup_jobs=1, warmup_seconds=0.35,
                     parse=mf.parse,
                     snap=lambda frame: snaps.append(clock.t) or {})
    assert _jobs(win, clock, [100.3, 100.6, 101.0, 101.45, 101.7, 102.3],
                 step=0.1)
    # warm-up: job 0 ends 0.2 s after the first epoch line, job 1 0.5 s
    assert win.open_job == 2 and win.t_open == pytest.approx(100.6)
    # 101.45 < 101.6 <= 101.7: the fifth job straddles the limit and closes
    assert win.close_job == 5 and win.t_close == pytest.approx(101.7)
    jobs = win.close_job - win.open_job
    assert 3 * jobs / (win.t_close - win.t_open) == pytest.approx(9 / 1.1)
    # epoch 1 of the first job is copied, once; every job's lines are kept
    assert snaps == [pytest.approx(100.1)]
    assert len(win.logged()) == 5 and win.logged()[-1] == {1: 0.9, 2: 0.9,
                                                           3: 0.9}


def test_warmup_seconds_start_after_epoch_1(monkeypatch):
    """A first epoch that builds the kernels does not move the window."""
    opened = []
    for first in (0.05, 9.0):
        clock = _Clock()
        monkeypatch.setattr(run.time, "perf_counter", clock)
        win = run.Window(seconds=100.0, warmup_jobs=1, warmup_seconds=0.28,
                         parse=mf.parse, snap=lambda frame: {})
        t1 = 100.0 + first
        _jobs(win, clock, [t1 + 0.1 + 0.15 * j for j in range(8)],
              step=0.05)
        opened.append(win.open_job)
    assert opened == [3, 3]


def test_warmup_jobs_are_whole(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(run.time, "perf_counter", clock)
    win = run.Window(seconds=0.5, warmup_jobs=3, warmup_seconds=0.0,
                     parse=mf.parse, snap=lambda frame: {})
    assert _jobs(win, clock, [101.0 + 0.2 * j for j in range(10)])
    assert win.open_job == 3 and win.close_job == 6


def test_a_draw_that_changes_route_is_drawn_again(monkeypatch):
    """With ``single_route``, a draw whose schedule would run gen-1 cells
    before the dense ones is drawn again from the next derived seed; the
    program's seed stays the run's."""
    from mfbench import reference
    from mfbench.tests.cpu_route import tiny_spec

    seen = []

    def route(nu, nv, dim, u, v, eta_at, use_dense, epochs):
        seen.append(int(u[:50].sum()))
        return [(1, "cells"), (2, "dense")] if len(seen) == 1 else \
            [(1, "dense")]

    monkeypatch.setattr(reference, "route", route)
    sp = tiny_spec("ml10m-d128.mf")
    assert sp["traffic"]["single_route"]
    train, _, t0, _, cfg, r = mf.draw(sp, 3000000047, "cpu")
    assert r == [(1, "dense")] and len(seen) == 2 and seen[0] != seen[1]
    assert cfg.seed == 3000000047 % 2 ** 31
    from mfbench import gen
    want, _ = gen.generate(sp["config"], 3000000047 + 1_000_003, "cpu")
    np.testing.assert_array_equal(train.u, want.u)
    sp["traffic"]["single_route"] = False
    seen.clear()
    assert mf.draw(sp, 3000000047, "cpu")[5] == [(1, "cells"), (2, "dense")]


JOB_CASES = {
    "dense": (dict(nu=4000, nv=1000, n=60000, seed=1), True),
    "gen-1": (dict(nu=4000, nv=1000, n=60000, seed=2), False),
    "sharded": (dict(nu=3000, nv=140000, n=100000, seed=3), True),
}


@pytest.mark.parametrize("case", sorted(JOB_CASES))
def test_a_harness_job_is_a_train_mf_run(case):
    """The harness builds the schedule once and runs jobs on it; each job
    ends with the tables ``train_mf`` (its fused route) ends with at the
    same ``--iter``, so runners keep no state from one job to the next."""
    from tpu_mf_torch.config import TrainConfig
    from tpu_mf_torch.data.coo import synthetic_ratings
    from tpu_mf_torch.models.mf import init_mf

    from mfbench.tests.cpu_route import fused_on_cpu

    kw, dense = JOB_CASES[case]
    ds = synthetic_ratings(kw["nu"], kw["nv"], kw["n"], seed=kw["seed"])
    test = synthetic_ratings(kw["nu"], kw["nv"], 2000, seed=kw["seed"] + 9)
    cfg = TrainConfig(dim=64, iters=3, use_dense=dense, seed=5)
    params = init_mf(ds.nu, ds.nv, 64, 3.0, torch.Generator().manual_seed(0),
                     "cpu")
    lines = []
    want = fused_on_cpu(cfg, ds, test, params, lines.append)
    _, job = mf.job_runner(cfg, ds, test, params, lines.append)
    for _ in range(2):
        got = job()
        for k in ("theta", "phi", "bu", "bv"):
            torch.testing.assert_close(getattr(got, k), getattr(want, k),
                                       rtol=0, atol=0)
    assert sum(x.startswith("iter#3") for x in lines) == 3


FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_mf"}


def _imports(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_import_rule_by_whole_top_level_name():
    files = sorted(S.PKG.rglob("*.py"))
    assert files
    for path in files:
        assert not (_imports(path) & FORBIDDEN), path
    # the port's name begins with the JAX package's: a whole-name compare
    assert "tpu_mf_torch" not in FORBIDDEN
    assert not (_imports(S.PKG / "reference.py")
                & (FORBIDDEN | {"tpu_mf_torch"}))
    assert "tpu_mf_torch" in _imports(S.PKG / "run.py")


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpu_mf_torch_fake", types.ModuleType("x"))
    assert "tpu_mf" not in run.forbidden_modules() or "tpu_mf" in sys.modules
    monkeypatch.setitem(sys.modules, "jaxlib.fake", types.ModuleType("y"))
    assert "jaxlib" in run.forbidden_modules()


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELLS[0], "--seed", "3000000017",
                     "--seconds", "1"]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_readers_find_nothing_without_a_trace():
    ctx = run.Context(spec={}, window=None, epoch_work={
        "bytes": 1, "ops": 1, "model_flops": 1}, schedule_s=None)
    for m in ("eval_ms", "kernel_roofline", "mfu", "idle_share",
              "schedule_s"):
        assert S.reader(m)(ctx) is None


@pytest.mark.cuda
def test_a_cell_on_the_card():
    """One short run of the first cell on the card: a result line, correct
    (run on the chip: ``python -m pytest --noconftest mfbench/tests``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    sp = S.cell_spec(CELLS[0])
    out = run.run_cell(sp, 3000000019, 1.0, False)
    assert out["epochs"]["close_job"] > out["epochs"]["open_job"]
    assert out["correct"], out["checks"]
