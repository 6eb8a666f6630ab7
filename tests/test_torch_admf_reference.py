"""The benchmark's AdaptReg cell on the CPU at a small size: the plain
reference (``mfbench/reference_admf.py``) against the port's gen-1
AdaptReg runner (``AdRegCellRunner`` on CPU tensors, whose segments run
``adreg_segment_reference``) and its hypergradient step
(``hypergrad_ext_rows``); the controls against the cell's limits; the
driver's validation split (``mfbench/algs/admf.py``); the reference's
imports; the spans of the port's AdaptReg loop; the readers of the two
span metrics; and a whole run of the cell on the plain runner, sound and
with a fault planted underneath."""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import pytest
import torch

from mfbench import check, reference_admf as ra, run, spec as S
from mfbench.algs import admf
from mfbench.gen import Ratings
from mfbench.tests.cpu_route import limits, tiny_spec
from mfbench.work.admf import epoch_work
from tpu_mf_torch.data.coo import RatingsCOO
from tpu_mf_torch.models.admf import with_shadows
from tpu_mf_torch.models.mf import MFParams
from tpu_mf_torch.ops import adreg_cells as tac
from tpu_mf_torch.ops.adreg_cells import AdRegCellRunner
from tpu_mf_torch.train import loop
from tpu_mf_torch.train import metrics as tm

CELL = "ml10m-d128-valid.admf"
SEED = 3000000011
SMALL = dict(nu=300, nv=200, ratings=6000, dim=16)
TILES = dict(tile=64, batch=256)   # 5 x 4 tiles, ~24 batches a plan


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the recorder off and drained, on one
    CPU thread (small ops slow down many-fold when the workers' threads
    contend for the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tm.disable()
    tm.drain()
    yield
    tm.disable()
    tm.drain()
    torch.set_num_threads(threads)


def small_spec(work="bfloat16", **scale):
    sp = tiny_spec(CELL, **(scale or SMALL))
    sp["config"]["work"] = work
    return sp


def coo(x: Ratings) -> RatingsCOO:
    return RatingsCOO(x.u, x.v, x.r, x.nu, x.nv)


def state0(tables0, gb, lam):
    return with_shadows(MFParams(*(tables0[k] for k in check.LEAVES),
                                 torch.tensor(gb)), (lam,) * 4)


def small_runner(drawn, work="bfloat16", n_plans=2):
    train, _, _, _, cfg, _, valid = drawn
    return AdRegCellRunner(coo(train), coo(valid), tile_u=TILES["tile"],
                           tile_v=TILES["tile"], batch=TILES["batch"],
                           seed=cfg.seed, mxu=work, n_plans=n_plans,
                           device="cpu")


@pytest.mark.parametrize("work", ["float32", "bfloat16"])
def test_reference_epochs_are_the_runner_epochs(work):
    """Three epochs of the reference (two plans in turn, 8 segments, the
    program's validation draws) against ``AdRegCellRunner``'s on CPU
    tensors: the tables to 1e-5 and the four lambdas to 1e-5 (relative),
    after every epoch; the plans' batches and segments alike."""
    sp = small_spec(work)
    drawn = admf.draw(sp, SEED, "cpu")
    train, test, t0, gb, cfg, _, valid = drawn
    runner = small_runner(drawn, work)
    tables = runner.pad(state0(t0, gb, cfg.lam))
    tr = ra.Trainer(t0, (cfg.lam,) * 4, train.on("cpu"), valid.on("cpu"), gb,
                    cfg.seed, admf.flags(sp), work, **TILES)
    assert [p.n_batches for p in tr.plans] == [p.u.shape[0]
                                               for p in runner.plans]
    assert [len(p.segments) for p in tr.plans] == runner._segs == [8, 8]
    for e in (1, 2, 3):
        tables = runner.epoch(tables, cfg.eta_at(e), cfg.eta_reg_at(e),
                              loop._admf_key(cfg, e), epoch_idx=e - 1)
        tr.epoch(e)
        got, want = runner.trim(tables), tr.tables()
        for k in check.LEAVES:
            torch.testing.assert_close(getattr(got, k), want[k], rtol=1e-5,
                                       atol=1e-5)
        torch.testing.assert_close(runner.lams, tr.lams, rtol=1e-5, atol=0)
    # the epochs moved the tables and the bias lambdas beyond rounding
    assert float((want["bu"] - t0["bu"]).abs().max()) > 1e-2
    assert float((tr.lams[2:] - cfg.lam).abs().min()) > 1e-4


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_step_is_hypergrad_ext_rows(seed):
    """The reference's hypergradient step against the program's on seeded
    fused rows (the program's rows are wider: lanes past dim + 2 are
    zero), with a lambda driven to its clamp at 0."""
    g = torch.Generator().manual_seed(seed)
    dim, k = 16, ra.K
    rows = [torch.randn(k, dim + 2, generator=g) * 0.3 for _ in range(4)]
    rows[2][:, dim] = 1.0        # old user biases: lam_bu's step is > 0
    sr = 9.0 + torch.randn(k, generator=g)
    lams = torch.tensor([5e-3, 4e-3, 1e-9, 6e-3])
    visits = torch.tensor(4000.0)
    want = ra.hyper_step(lams, *rows, sr, 0.02, 2e-3, visits, 3.1, dim)
    wide = [torch.cat([x, torch.zeros(k, 128 - dim - 2)], 1) for x in rows]
    got = tac.hypergrad_ext_rows(*wide, sr, lams, 0.02, 2e-3, visits, 3.1,
                                 dim)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    assert float(want[2]) == 0.0 and float(want.min()) == 0.0
    assert bool((want != lams).all())


@pytest.mark.parametrize("stand_in", ["frozen", "one_segment"])
def test_controls_fail_the_limits(stand_in):
    """Frozen lambdas (every step skipped) and one segment an epoch, each
    against the sound reference over a 5-epoch job at the cell's step size,
    read ``lam_gap`` above the cell's limit and are not correct."""
    sp = small_spec()
    # a segment's step at the cell's size: its user-visits grow with the
    # ratings, so eta_reg grows by the ratio of the cell's to these
    full = S.cell_spec(CELL)["config"]
    tc = sp["traffic"]["train_config"]
    tc["eta_reg"] *= full["ratings"] / SMALL["ratings"]
    drawn = admf.draw(sp, SEED, "cpu")
    train, test, t0, gb, cfg, _, valid = drawn
    kw = {"frozen": {"control": "frozen"},
          "one_segment": {"segments": 1}}[stand_in]

    def job(**more):
        return ra.run_job(t0, (cfg.lam,) * 4, train.on("cpu"),
                          valid.on("cpu"), test.on("cpu"), gb, cfg.seed,
                          admf.flags(sp), 5, "bfloat16", **TILES, **more)

    ref, out = job(), job(**kw)
    vals = check.numbers(out["tables"][1], out["tables"][5], out["rmse"][5],
                         [out["rmse"]], ref, t0)
    vals["lam_gap"] = admf.lam_gap(
        [[torch.as_tensor(out["lams"][e]) for e in range(1, 6)]], ref,
        cfg.lam)
    lim = limits(CELL)
    assert vals["lam_gap"] > lim["lam_gap"]["limit"], vals
    assert not check.judge(vals, lim, admf.NUMBERS)[0]


def test_driver_split():
    """The validation set is the configured share of the training split,
    disjoint from the rest (together they are the split), and the same for
    the same seed; another seed draws another."""
    sp = small_spec()
    full = S.cell_spec(CELL)["config"]
    assert full["valid_frac"] == 0.05
    n_train = int(full["ratings"] * (1 - full["test_frac"]))
    assert (n_train - round(n_train * 0.05), round(n_train * 0.05)) == (
        8_550_000, 450_000)
    a = admf.draw(sp, SEED, "cpu")
    b = admf.draw(sp, SEED, "cpu")
    c = admf.draw(sp, SEED + 1, "cpu")
    train, test, valid = a[0], a[1], a[6]
    n = int(SMALL["ratings"] * (1 - sp["config"]["test_frac"]))
    assert len(valid) == round(n * 0.05) and len(train) + len(valid) == n
    assert len(test) == SMALL["ratings"] - n

    def keys(x):
        return set(zip(x.u.tolist(), x.v.tolist(), x.r.tolist()))

    assert not keys(train) & keys(valid)
    assert len(keys(train) | keys(valid)) == n
    for x, y in ((a[0], b[0]), (a[6], b[6])):
        np.testing.assert_array_equal(x.u, y.u)
        np.testing.assert_array_equal(x.r, y.r)
    assert keys(valid) != keys(c[6])


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.'); "
            "import mfbench.reference_admf; "
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'tpu_mf_torch', 'tpu_mf', 'jax', 'jaxlib', 'flax'}; "
            "print(sorted(bad)); sys.exit(1 if bad else 0)")
    done = subprocess.run([sys.executable, "-c", code], cwd=S.ROOT,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stdout + done.stderr


@pytest.mark.parametrize("on", [True, False])
def test_admf_loop_spans(on):
    """With the recorder on, one epoch of ``_train_admf_fused`` records
    the loop's spans and, inside its ``tmf.epoch``, 8 ``tmf.adreg_segment``
    spans (segments 0-7, the plan's walk) and 8 ``tmf.hyper_step`` spans of
    64 validation rows each; off, it records nothing."""
    sp = small_spec()
    drawn = admf.draw(sp, SEED, "cpu")
    train, test, t0, gb, cfg, _, _ = drawn
    cfg.iters = 1
    runner = small_runner(drawn, n_plans=1)
    log: list = []
    if on:
        tm.enable()
    loop._train_admf_fused(cfg, runner, state0(t0, gb, cfg.lam), coo(test),
                           log.append, loop._Observer(cfg, len(train),
                                                      log.append))
    tm.disable()
    recs = tm.drain()
    assert [x.split("\t")[0] for x in log] == ["iter#1"]
    if not on:
        assert recs == []
        return
    names = [r["name"] for r in recs]
    for name in ("tmf.run", "tmf.pad", "tmf.plan_upload", "tmf.epoch",
                 "tmf.eval"):
        assert names.count(name) == 1, name
    assert names.count("tmf.trim") == 2          # the eval's and the last
    ep = next(r for r in recs if r["name"] == "tmf.epoch")
    assert ep["attrs"]["kernel"] == "AdRegCellRunner"
    seg = [r for r in recs if r["name"] == "tmf.adreg_segment"]
    hyp = [r for r in recs if r["name"] == "tmf.hyper_step"]
    assert [r["attrs"]["segment"] for r in seg] == list(range(8))
    assert [r["attrs"]["segment"] for r in hyp] == list(range(8))
    assert {r["attrs"]["walk"] for r in seg} == {runner.route(0)}
    assert all(r["attrs"]["valid_rows"] == 64 for r in hyp)
    assert all(r["parent"] == ep["id"] for r in seg + hyp)
    assert all(r["device_ms"] is None for r in recs)   # no card


def _ctx(spans_by_job, work=None):
    win = run.Window(seconds=1, warmup_jobs=3, warmup_seconds=1)
    win.rec = [{"spans": s} for s in spans_by_job]
    return run.Context(spec={}, window=win, schedule_s=None,
                       epoch_work=work or {"segment_bytes": 3.35e9,
                                           "segment_ops": 1.0})


def _epoch(i, seg_ms, hyp_ms):
    out = [{"name": "tmf.epoch", "id": i, "parent": None, "device_ms": 9.0}]
    out += [{"name": "tmf.adreg_segment", "id": 100 * i + s, "parent": i,
             "device_ms": x} for s, x in enumerate(seg_ms)]
    out += [{"name": "tmf.hyper_step", "id": 100 * i + 50 + s, "parent": i,
             "device_ms": x} for s, x in enumerate(hyp_ms)]
    return out


@pytest.mark.parametrize("metric", ["adreg_walk_roofline", "hyper_step_ms"])
def test_span_readers(metric):
    """The readers take the median recorded epoch's summed span ms (jobs
    whose spans were kept), and read nothing where no job kept spans (the
    untraced jobs, or a program without the spans)."""
    read = S.reader(metric)
    jobs = [None,
            _epoch(1, [100.0] * 8, [0.1] * 8) + _epoch(2, [125.0] * 8,
                                                        [0.2] * 8),
            _epoch(3, [150.0] * 8, [0.4] * 8)]
    got = read(_ctx(jobs))
    # least time 1 ms (3.35 GB at 3.35 TB/s); median epoch 1,000 ms
    want = {"adreg_walk_roofline": 0.1, "hyper_step_ms": 1.6}[metric]
    assert got == pytest.approx(want)
    assert read(_ctx([None, None])) is None
    assert read(_ctx([None, []])) is None
    assert read(run.Context(spec={}, window=None, epoch_work={},
                            schedule_s=None)) is None


def test_epoch_work_by_hand():
    # 3 training ratings on users {0, 2}, items {1}; 2 test ratings on
    # user {1}, items {0, 1}; dim 4, float32 tables, 2 steps of 3 records
    train = Ratings(np.array([0, 2, 2], np.int32), np.array([1, 1, 1],
                    np.int32), np.ones(3, np.float32), 3, 2)
    test = Ratings(np.array([1, 1], np.int32), np.array([0, 1], np.int32),
                   np.ones(2, np.float32), 3, 2)
    w = epoch_work(train, test, 4, 4, 2, 3)
    row = 5 * 4
    walks = 12 * 3 + 2 * row * 3
    steps = 2 * (12 * 3 + 4 * 3 * row)
    evals = 12 * 2 + row * 3
    assert w["segment_bytes"] == walks
    assert w["bytes"] == walks + steps + evals
    assert w["segment_ops"] == w["model_flops"] == 6 * 6 * 3
    assert w["ops"] == 6 * 6 * 3 + 2 * 3 * (2 * 6 + 4 * 4 + 8) + 2 * 6 * 2


def _cpu_runner(monkeypatch):
    """``_admf_runner`` on the CPU: the gen-1 runner it builds on a card
    (tiles 512, batches of 4,096, two plans), whose segments run the plain
    version here."""
    def runner(cfg, train_ds, valid_ds, state, log, device):
        with tm.span("tmf.plan_build"):
            return AdRegCellRunner(train_ds, valid_ds, tile_u=512, tile_v=512,
                                   batch=max(1024, cfg.batch_size),
                                   seed=cfg.seed, loss=cfg.loss, n_plans=2,
                                   device=device)

    monkeypatch.setattr(loop, "_admf_runner", runner)


def _run(seed=3000000079):
    sp = small_spec(nu=1500, nv=1100, ratings=30000, dim=64)
    sp["traffic"]["job_epochs"] = 3
    return run.run_cell(sp, seed, 0.2, False, device="cpu")


def test_a_run_on_the_plain_runner_is_correct(monkeypatch):
    _cpu_runner(monkeypatch)
    out = _run()
    assert out["route"] == "adreg-cells@1"
    assert out["correct"], out["checks"]
    assert out["epochs"]["close_job"] > out["epochs"]["open_job"] >= 3
    ad = out["extras"]["adreg"]
    assert ad["runner"] == "AdRegCellRunner" and ad["segments"] == [8, 8]
    assert ad["reference"] == {"batches": ad["batches"],
                               "segments": ad["segments"]}
    v = {k: c["value"] for k, c in out["checks"].items()}
    assert set(v) == set(admf.NUMBERS)
    assert max(v.values()) < 1e-6, v


@pytest.mark.parametrize("fault", ["frozen", "drop_half"])
def test_a_run_with_a_fault_underneath_is_not_correct(monkeypatch, fault):
    """The program's hypergradient steps skipped, or the second half of
    every column's slots left out (w zeroed): not correct."""
    _cpu_runner(monkeypatch)
    if fault == "frozen":
        monkeypatch.setattr(tac, "hypergrad_ext_rows",
                            lambda *a, **k: a[5])
    else:
        real = AdRegCellRunner.epoch

        def half(self, tables, *a, **k):
            for plan in self.materialize()._dev:
                plan.w[..., plan.w.shape[-1] // 2:] = 0
            return real(self, tables, *a, **k)

        monkeypatch.setattr(AdRegCellRunner, "epoch", half)
    out = _run()
    assert not out["correct"], out["checks"]
