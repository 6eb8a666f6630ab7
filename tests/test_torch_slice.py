"""The --alg mf slice of the PyTorch port end to end on the CPU, against
tpu_mf on the same numpy-made tables."""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_mf.data.coo import RatingsCOO, synthetic_ratings
from tpu_mf.data.textfmt import write_raw
from tpu_mf.io.checkpoint import load_mf_binary as jax_load_mf_binary
from tpu_mf.io.checkpoint import save_mf_binary as jax_save_mf_binary
from tpu_mf.models.mf import MFParams as JaxParams
from tpu_mf.ops.pallas_sgd_dense import DenseEpochRunner as JaxDenseRunner
from tpu_mf.train.loop import train_mf as jax_train_mf
from tpu_mf_torch.config import TrainConfig
from tpu_mf_torch.models.mf import params_from_numpy, params_to_numpy
from tpu_mf_torch.train import train_mf
from tpu_mf_torch.train.loop import _Observer, _train_mf_fused

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def data(seed=0):
    ds = synthetic_ratings(200, 150, 6000, rank=3, noise=0.2, seed=seed)
    return ds.split(0.1, seed=seed + 1)


def np_tables(nu, nv, dim, gb, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1e-2, (nu, dim)).astype(np.float32),
            rng.normal(0, 1e-2, (nv, dim)).astype(np.float32),
            rng.normal(0, 1e-2, nu).astype(np.float32),
            rng.normal(0, 1e-2, nv).astype(np.float32), np.float32(gb))


def trmse(lines):
    return [float(x.split("tRMSE=")[1]) for x in lines if "tRMSE=" in x]


def test_train_mf_cpu_matches_jax():
    """The CPU path (batched sgd_epoch over host-shuffled batches) against
    tpu_mf.train_mf(device_shuffle=False), 3 epochs at dim 8: per-epoch
    tRMSE and final tables within 1e-5 (f32; duplicate-row scatter sums
    in another order)."""
    tr, te = data()
    cfg = TrainConfig(dim=8, iters=3, eta=0.02, lam=5e-3, batch_size=512,
                      gb=tr.mean_rating(), seed=0)
    tabs = np_tables(tr.nu, tr.nv, 8, cfg.gb)
    jlog, tlog = [], []
    want = jax_train_mf(cfg, tr, te, JaxParams(*(jnp.asarray(t) for t in tabs)),
                        log=jlog.append, device_shuffle=False)
    got = train_mf(cfg, tr, te, params_from_numpy(*tabs, device="cpu"),
                   log=tlog.append, device="cpu")
    assert len(trmse(tlog)) == 3
    np.testing.assert_allclose(trmse(tlog), trmse(jlog), rtol=0, atol=1e-5)
    for a, b in zip(params_to_numpy(got)[:4], want[:4]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)


def test_fused_schedule_on_cpu_matches_pallas_loop():
    """_train_mf_fused on CPU tensors (the dense epoch's plain version, f32)
    against a loop over tpu_mf's interpret-mode DenseEpochRunner with the
    same eta_at, lam and gb: tables within 1e-4 after 3 epochs."""
    tr, te = data()
    cfg = TrainConfig(dim=8, iters=3, eta=0.01, lam=5e-3,
                      gb=tr.mean_rating(), seed=0)
    tabs = np_tables(tr.nu, tr.nv, 8, cfg.gb)
    log = []
    got = _train_mf_fused(cfg, tr, te, params_from_numpy(*tabs, device="cpu"),
                          log.append, _Observer(cfg, len(tr), log.append))
    assert log[0].startswith("# dense-cell kernel from epoch 1")

    jr = JaxDenseRunner(tr, seed=0, saturate=True, dim=8, mxu="float32",
                        interpret=True)
    tables = jr.pad(JaxParams(*(jnp.asarray(t) for t in tabs)))
    for it in range(1, 4):
        tables = jr.epoch(tables, cfg.eta_at(it), cfg.lam, float(cfg.gb))
    want = jr.trim(tables)
    for a, b in zip(params_to_numpy(got)[:4], want[:4]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-4)
    assert len(trmse(log)) == 3 and np.all(np.isfinite(trmse(log)))


def test_fused_schedule_runs_batched_epochs_before_dense():
    """At an eta above the dense window bound the epochs before engagement
    run the lane-packed kernel at dim 8 (the batched path no longer runs
    them), and the log says so by name; dense takes over after it."""
    tr, _ = data()
    cfg = TrainConfig(dim=8, iters=3, eta=0.04, gam=2.0, gb=tr.mean_rating())
    log = []
    params = params_from_numpy(*np_tables(tr.nu, tr.nv, 8, cfg.gb),
                               device="cpu")
    _train_mf_fused(cfg, tr, None, params, log.append,
                    _Observer(cfg, len(tr), log.append))
    assert any(x.startswith("# lane-packed kernel: epochs 1..1, tiles "
                            "1024x1024, batch 8192") for x in log), log
    assert not any("batched path" in x for x in log), log
    assert "# epoch 2: switching to DenseEpochRunner" in log


def slot_data():
    """The data of tests/test_slot_kernel.py::test_pick_mf_runners_switch_
    schedule: zipfy enough that the slot envelope clears epochs late."""
    return synthetic_ratings(400, 250, 30000, rank=3, seed=8, zipf=1.2)


def big_catalog():
    """nv past pallas_eligible at dim 64 (fused item table > 64 MiB)."""
    rng = np.random.default_rng(0)
    return RatingsCOO(u=rng.integers(0, 200, 3000),
                      v=rng.integers(0, 140_000, 3000),
                      r=rng.uniform(1, 5, 3000), nu=200, nv=140_000)


# name: (dataset, TrainConfig options, the port's expected log line)
SCHEDULES = {
    "dim64_no_dense": (lambda: data()[0], dict(dim=64, use_dense=False),
                       "# gen-1 cell kernel: epochs 1..3"),
    "dim128_no_dense": (lambda: data()[0], dict(dim=128, use_dense=False),
                        "# gen-1 cell kernel: epochs 1..3"),
    "dim64_gen1_then_dense": (lambda: data()[0],
                              dict(dim=64, eta=0.04, gam=2.0),
                              "# gen-1 cell kernel: epochs 1..1"),
    "dim8_packed_slot": (lambda: data()[0], dict(dim=8, eta=0.04, gam=2.0),
                         "# lane-packed kernel: epochs 1..1"),
    # packed epoch 1, then slot at sub 192, 384 and striped 512
    "dim8_ladder": (slot_data, dict(dim=8, iters=6, eta=0.002,
                                    use_dense=False),
                    "# small-window slot kernel (sub 192) engages at epoch 2"),
    # the same ladder probed, but dense engages first and drops it
    "dim8_ladder_then_dense": (slot_data, dict(dim=8, iters=6, eta=0.002),
                               "# dense-cell kernel engages at epoch 2"),
    # an eta the slot envelope never clears: packed all the way
    "dim16_packed_only": (slot_data, dict(dim=16, iters=3, eta=0.02,
                                          use_dense=False),
                          "# slot kernel staleness envelope exceeded"),
    "item_sharded": (big_catalog, dict(dim=64),
                     "# item table exceeds VMEM (nv=140000): item-sharded "
                     "fused epochs, 2 shards, tiles 512x2040, batch 4096"),
}
# runner families: what tpu_mf runs, and what the port runs in its place
KINDS = {"PallasEpochRunner": "gen-1", "CellEpochRunner": "gen-1",
         "DenseEpochRunner": "dense", "PackedEpochRunner": "packed",
         "SlotEpochRunner": "slot", "PhiShardedRunner": "sharded",
         "BatchedRunner": "batched"}


def phases(sched):
    """[(first epoch, family, tile_u, tile_v, batch, sub, striped,
    shards)]."""
    out = []
    for ep, r in sched:
        kind = KINDS[type(r).__name__]
        geom = ((None,) * 6 if kind == "batched" else
                (r.tile_u, r.tile_v, getattr(r, "batch", None),
                 getattr(r, "sub", None), getattr(r, "striped", None),
                 getattr(r, "n_shards", None)))
        out.append((ep, kind) + geom)
    return out


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_schedule_matches_tpu_mf(case):
    """_mf_runner_schedule on CPU tensors picks tpu_mf's runner family,
    engagement epochs and geometry, including the pallas_eligible test
    that comes before dense (item-sharded catalogs)."""
    from tpu_mf.train.loop import _mf_runner_schedule as jax_schedule
    from tpu_mf_torch.train.loop import _mf_runner_schedule

    make, opts, line = SCHEDULES[case]
    ds = make()
    cfg = TrainConfig(**{"iters": 3, "gb": 3.0, **opts})
    tabs = np_tables(ds.nu, ds.nv, cfg.dim, cfg.gb)
    want = jax_schedule(cfg, ds, JaxParams(*(jnp.asarray(t) for t in tabs)),
                        lambda _: None)
    log = []
    got = _mf_runner_schedule(cfg, ds, params_from_numpy(*tabs, device="cpu"),
                              log.append)
    assert phases(got) == phases(want)
    assert any(x.startswith(line) for x in log), log


def jax_loop(runners, tabs, cfg):
    """tpu_mf's fused loop over given (first epoch, runner) phases."""
    (_, runner), upcoming = runners[0], list(runners[1:])
    tables = runner.pad(JaxParams(*(jnp.asarray(t) for t in tabs)))
    for it in range(1, cfg.iters + 1):
        if upcoming and it >= upcoming[0][0]:
            nxt = upcoming.pop(0)[1]
            tables = nxt.pad(runner.trim(tables))
            runner = nxt
        tables = runner.epoch(tables, cfg.eta_at(it), cfg.lam, float(cfg.gb),
                              epoch_idx=it)
    return [np.asarray(x) for x in runner.trim(tables)[:4]]


def jax_gen1(tr, cfg):
    from tpu_mf.ops.pallas_sgd import PallasEpochRunner, pick_cell_geometry

    tu, tv, b = pick_cell_geometry(tr)
    return PallasEpochRunner(tr, tile_u=tu, tile_v=tv, batch=b, seed=cfg.seed,
                             n_plans=2, balance=True, saturate=True,
                             mxu="float32", interpret=True)


def test_fused_gen1_schedule_on_cpu_matches_pallas_loop():
    """_train_mf_fused at dim 64 with use_dense=False on CPU tensors (the
    gen-1 epoch's plain version, f32, two rotated plans) against tpu_mf's
    interpret-mode PallasEpochRunner with the same eta_at, lam and gb:
    tables within 1e-4 after 3 epochs (f32 sums in other orders, over 3
    epochs of tpu_mf's 2e-5 per-epoch tolerance)."""
    tr, te = data()
    cfg = TrainConfig(dim=64, iters=3, use_dense=False, gb=tr.mean_rating())
    tabs = np_tables(tr.nu, tr.nv, 64, cfg.gb)
    log = []
    got = _train_mf_fused(cfg, tr, te, params_from_numpy(*tabs, device="cpu"),
                          log.append, _Observer(cfg, len(tr), log.append))
    assert log[0].startswith("# gen-1 cell kernel: epochs 1..3"), log
    want = jax_loop([(1, jax_gen1(tr, cfg))], tabs, cfg)
    for a, b in zip(params_to_numpy(got)[:4], want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    rm = trmse(log)
    assert len(rm) == 3 and np.all(np.isfinite(rm)) and rm[-1] < rm[0]


def test_gen1_to_dense_handover_matches_pallas_loop():
    """gen-1 carries epoch 1, dense engages at epoch 2: the handover goes
    through trim (inverting the balance maps) and dense's pad. Against the
    same phases of tpu_mf's interpret-mode runners: tables within 1e-4."""
    tr, te = data()
    cfg = TrainConfig(dim=64, iters=3, eta=0.04, gam=2.0, gb=tr.mean_rating())
    tabs = np_tables(tr.nu, tr.nv, 64, cfg.gb)
    log = []
    got = _train_mf_fused(cfg, tr, te, params_from_numpy(*tabs, device="cpu"),
                          log.append, _Observer(cfg, len(tr), log.append))
    assert "# epoch 2: switching to DenseEpochRunner" in log, log
    dense = JaxDenseRunner(tr, seed=0, saturate=True, dim=64, mxu="float32",
                           interpret=True)
    want = jax_loop([(1, jax_gen1(tr, cfg)), (2, dense)], tabs, cfg)
    for a, b in zip(params_to_numpy(got)[:4], want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


def jax_twin(runner, tr, cfg):
    """tpu_mf's interpret-mode, f32 runner of the same family, plans and
    options as a runner of the port's dim-8 schedule."""
    from tpu_mf.ops.pallas_sgd_packed import PackedEpochRunner
    from tpu_mf.ops.pallas_sgd_slot import SlotEpochRunner

    common = dict(seed=cfg.seed, saturate=True, mxu="float32", interpret=True)
    kind = KINDS[type(runner).__name__]
    if kind == "packed":
        return PackedEpochRunner(tr, batch=runner.batch, n_plans=2,
                                 dim=cfg.dim, **common)
    if kind == "slot":
        return SlotEpochRunner(tr, n_plans=2, dim=cfg.dim, balance=True,
                               striped=runner.striped, sub=runner.sub,
                               **common)
    assert kind == "dense", kind
    return JaxDenseRunner(tr, dim=cfg.dim, **common)


@pytest.mark.parametrize("case", ["packed_slot_stripe", "packed_dense"])
def test_ladder_handovers_match_pallas_loop(case):
    """_train_mf_fused at dim 8 on CPU tensors through the ladder's
    handovers (packed -> plain slot sub 256 -> striped sub 512, with
    use_dense=False; packed -> dense), each through trim (inverting the
    serpentine maps) and the next runner's pad. Against the same phases of
    tpu_mf's interpret-mode runners: tables within 1e-4 (f32 sums in other
    orders over up to 5 epochs of the 2e-5 per-epoch tolerance)."""
    from tpu_mf_torch.train.loop import _mf_runner_schedule

    if case == "packed_slot_stripe":
        tr, te = slot_data().split(0.1, seed=1)
        opts = dict(iters=5, eta=0.002, use_dense=False)
        switches = ["# epoch 3: switching to SlotEpochRunner",
                    "# epoch 5: switching to SlotEpochRunner (striped)"]
    else:
        tr, te = data()
        opts = dict(iters=3, eta=0.04, gam=2.0)
        switches = ["# epoch 2: switching to DenseEpochRunner"]
    cfg = TrainConfig(dim=8, gb=tr.mean_rating(), **opts)
    tabs = np_tables(tr.nu, tr.nv, 8, cfg.gb)
    log = []
    got = _train_mf_fused(cfg, tr, te, params_from_numpy(*tabs, device="cpu"),
                          log.append, _Observer(cfg, len(tr), log.append))
    assert [x for x in log if "switching" in x] == switches, log
    sched = _mf_runner_schedule(cfg, tr, params_from_numpy(*tabs,
                                                           device="cpu"),
                                lambda _: None)
    assert sched[0][0] == 1 and KINDS[type(sched[0][1]).__name__] == "packed"
    want = jax_loop([(ep, jax_twin(r, tr, cfg)) for ep, r in sched], tabs,
                    cfg)
    for a, b in zip(params_to_numpy(got)[:4], want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    rm = trmse(log)
    assert len(rm) == cfg.iters and np.all(np.isfinite(rm)) and rm[-1] < rm[0]


def write_data(tmp_path):
    tr, te = data()
    write_raw(str(tmp_path / "train.csv"), tr)
    write_raw(str(tmp_path / "test.csv"), te)
    return ["--train", str(tmp_path / "train.csv"),
            "--test", str(tmp_path / "test.csv"), "--nu", "200", "--nv", "150",
            "--dim", "8", "--iter", "2", "--eta", "0.01"]


def test_cli_checkpoint_is_reference_binary(tmp_path, capsys):
    """The CLI writes {result}_{iters} in the reference's binary layout:
    tpu_mf reads it, and tpu_mf's writer gives the same bytes back."""
    from tpu_mf_torch.cli import main

    args = write_data(tmp_path) + ["--device", "cpu",
                                   "--result", str(tmp_path / "m")]
    assert main(args) == 0
    out = capsys.readouterr().out
    assert len(trmse(out.splitlines())) == 2
    path = tmp_path / "m_2"
    params, lam = jax_load_mf_binary(str(path))
    assert params.theta.shape == (200, 8) and lam == np.float32(5e-3)
    jax_save_mf_binary(str(tmp_path / "again"), params, lam)
    assert path.read_bytes() == (tmp_path / "again").read_bytes()


def test_cli_metrics_and_trace(tmp_path):
    """--metrics appends one JSON line per epoch; --trace writes a
    torch.profiler trace, turns the span recorder on and writes its
    records to spans.jsonl beside the trace (every epoch's tmf.epoch and
    tmf.eval in the loop's tmf.run, each as a range of the trace too), and
    each metrics line carries its epoch's span ms."""
    import json

    from tpu_mf_torch.cli import main
    from tpu_mf_torch.train import metrics as tm

    metrics, trace = tmp_path / "m.jsonl", tmp_path / "trace"
    assert main(write_data(tmp_path) + [
        "--device", "cpu", "--metrics", str(metrics),
        "--trace", str(trace)]) == 0
    rows = [json.loads(x) for x in metrics.read_text().splitlines()]
    assert [r["round"] for r in rows] == [1, 2]
    assert all(r["updates_per_sec"] > 0 and r["tRMSE"] > 0 for r in rows)
    assert (trace / "trace.json").stat().st_size > 0
    assert not tm.enabled() and tm.drain() == []
    spans = [json.loads(x)
             for x in (trace / "spans.jsonl").read_text().splitlines()]
    names = [r["name"] for r in sorted(spans, key=lambda r: r["t0"])]
    assert names == ["tmf.run", "tmf.pad"] + [
        "tmf.epoch", "tmf.eval", "tmf.trim"] * 2 + ["tmf.trim"]
    (run,) = [r for r in spans if r["name"] == "tmf.run"]
    assert all(r["run"] == run["id"] for r in spans)
    epochs = [r for r in spans if r["name"] == "tmf.epoch"]
    evals = [r for r in spans if r["name"] == "tmf.eval"]
    for row, ep, ev in zip(rows, epochs, evals):
        assert ep["attrs"]["epoch"] == row["round"]
        assert row["epoch_ms"] == (ep["t1"] - ep["t0"]) / 1e6 > 0
        assert row["eval_ms"] == (ev["t1"] - ev["t0"]) / 1e6 > 0
        assert "epoch_device_ms" not in row  # no CUDA events on the CPU
    text = (trace / "trace.json").read_text()
    assert all(f'"name": "{n}"' in text for n in set(names))


def test_cli_metrics_rate_counts_from_the_loop_start(tmp_path, monkeypatch):
    """A metrics line's updates_per_sec is the updates so far over the
    epoch loop's elapsed seconds (the clock of the iter# lines): a second
    spent building the schedule before the loop is not counted."""
    import json
    import time

    from tpu_mf_torch.cli import main
    from tpu_mf_torch.train import loop

    init = loop.BatchedRunner.__init__

    def slow_init(self, *a, **k):
        time.sleep(1.0)
        init(self, *a, **k)

    monkeypatch.setattr(loop.BatchedRunner, "__init__", slow_init)
    metrics = tmp_path / "m.jsonl"
    assert main(write_data(tmp_path) + [
        "--device", "cpu", "--metrics", str(metrics)]) == 0
    rows = [json.loads(x) for x in metrics.read_text().splitlines()]
    n = len(data()[0])
    assert [r["round"] for r in rows] == [1, 2]
    for k, r in enumerate(rows, 1):
        assert r["t"] - r["elapsed"] >= 1.0  # the logger opened before
        assert r["updates_per_sec"] == round(k * n / r["elapsed"])


def test_port_runs_without_jax(tmp_path):
    """A fresh interpreter in which tpu_mf cannot be imported runs the CPU
    slice through the CLI (--alg mf, --alg dpmf and --alg admf, each also
    with --stream; --alg mf with --resume: 2 epochs, then resumed to 3;
    --measure 1) and the fused dim-8
    schedule (packed, then dense), a fused AdaptReg epoch pair, one mega,
    one free-column and one item-sharded epoch on CPU tensors, and imports
    neither JAX nor any module of tpu_mf."""
    args = write_data(tmp_path) + ["--device", "cpu"]
    dp_args = args + ["--alg", "dpmf", "--eta", "2e-5", "--hyperb", "1000",
                      "--result", str(tmp_path / "dp")]
    ad_args = args + ["--alg", "admf", "--valid", str(tmp_path / "test.csv"),
                      "--result", str(tmp_path / "ad")]
    rs_args = args + ["--result", str(tmp_path / "rs"), "--resume"]
    st_args = [args + ["--stream"], dp_args + ["--stream"],
               ad_args + ["--stream"]]
    ms_args = args + ["--measure", "1"]
    code = f"""
import sys
sys.modules["tpu_mf"] = None  # any import of the JAX package fails
import torch
torch.set_num_threads(1)  # as the test processes: no oversubscription
from tpu_mf_torch.cli import main
from tpu_mf_torch.config import TrainConfig
from tpu_mf_torch.data.coo import synthetic_ratings
from tpu_mf_torch.models.mf import init_mf
from tpu_mf_torch.train.loop import _Observer, _train_mf_fused
import torch
assert main({args!r}) == 0
assert main({dp_args!r}) == 0
assert main({ad_args!r}) == 0
assert main({rs_args!r}) == 0
assert main({rs_args!r} + ["--iter", "3"]) == 0
for a in {st_args!r}:
    assert main(a) == 0
assert main({ms_args!r}) == 0
tr, te = synthetic_ratings(200, 150, 6000, rank=3, noise=0.2,
                           seed=0).split(0.1, seed=1)
cfg = TrainConfig(dim=8, iters=2, eta=0.04, gam=2.0, gb=tr.mean_rating())
params = init_mf(tr.nu, tr.nv, 8, cfg.gb, torch.Generator().manual_seed(0),
                 "cpu")
_train_mf_fused(cfg, tr, te, params, print, _Observer(cfg, len(tr), print))
from tpu_mf_torch.models.admf import init_admf
from tpu_mf_torch.ops.adreg_cells import AdRegCellRunner
from tpu_mf_torch.train.loop import _train_admf_fused
acfg = TrainConfig(alg="admf", dim=8, iters=2, eta=0.01, gb=tr.mean_rating())
_train_admf_fused(acfg, AdRegCellRunner(tr, te, tile_u=64, tile_v=64,
                                        batch=512, n_plans=2, device="cpu"),
                  init_admf(tr.nu, tr.nv, 8, acfg.lam, acfg.gb,
                            torch.Generator().manual_seed(0), "cpu"),
                  te, print, _Observer(acfg, len(tr), print))
from tpu_mf_torch.ops.sgd_free import FreeEpochRunner
from tpu_mf_torch.ops.sgd_mega import MegaEpochRunner
for runner in (MegaEpochRunner(tr, dim=8, tile_u=64, tile_v=64, batch=256,
                               mxu="float32", device="cpu"),
               FreeEpochRunner(tr, batch=512, mxu="float32", device="cpu")):
    tabs = runner.epoch(runner.pad(params), 0.01, cfg.lam, cfg.gb)
    out = runner.trim(tabs)
    assert out.theta.shape == params.theta.shape
    assert bool(torch.isfinite(out.theta).all())
    assert not torch.equal(out.theta, params.theta)
from tpu_mf_torch.ops.phi_shard import PhiShardedRunner
sr = PhiShardedRunner(tr, dim=8, tile_u=64, tile_v=64, batch=256,
                      budget=128 * 128 * 4, nb_round=4, mxu="float32",
                      device="cpu")
assert sr.n_shards >= 2
out = sr.trim(sr.epoch(sr.pad(params), 0.01, cfg.lam, cfg.gb))
assert bool(torch.isfinite(out.phi).all())
assert not torch.equal(out.phi, params.phi)
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "tpu_mf" or m.startswith("tpu_mf.")]
assert bad == ["tpu_mf"] and sys.modules["tpu_mf"] is None, bad
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.count("iter#2") == 8
    assert proc.stdout.count("iter#3") == 1
    assert f"# resumed from round 2 ({tmp_path / 'rs'}.state)" in proc.stdout
    assert (tmp_path / "rs_3").stat().st_size > 0
    assert "# lane-packed kernel: epochs 1..1" in proc.stdout
    assert proc.stdout.count("round #2\t") == 2
    assert proc.stdout.count("recall@10=") == 1
    assert (tmp_path / "dp_2").stat().st_size > 0
    assert (tmp_path / "ad_2").stat().st_size > 0


def test_cli_cuda_without_gpu_fails(tmp_path):
    """--device cuda on a machine without a GPU exits non-zero instead of
    training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from tpu_mf_torch.cli import main

    assert main(write_data(tmp_path) + ["--device", "cuda"]) != 0


def test_entry_points_default_to_cuda():
    """train_mf, train_dpmf, train_admf, their streamed counterparts,
    init_dpmf, init_admf, the checkpoint loaders, every runner, the
    streamed trainer, the Prefetcher and the grid tool run on the card
    unless the caller asks for the CPU."""
    import inspect

    from tpu_mf_torch.io.stream import Prefetcher
    from tpu_mf_torch.io.stream_fused import FusedStreamTrainer
    from tpu_mf_torch.tools.grid import build_parser as grid_parser
    from tpu_mf_torch.train.loop import (
        train_admf_stream,
        train_dpmf_stream,
        train_mf_stream,
    )

    from tpu_mf_torch.io.checkpoint import load_dpmf_binary, load_mf_binary
    from tpu_mf_torch.models.admf import init_admf
    from tpu_mf_torch.models.dpmf import init_dpmf
    from tpu_mf_torch.ops.adreg_cells import AdRegCellRunner
    from tpu_mf_torch.ops.adreg_slot import SlotAdRegRunner
    from tpu_mf_torch.ops.sgd_cells import CellEpochRunner
    from tpu_mf_torch.ops.sgd_dense import DenseEpochRunner
    from tpu_mf_torch.ops.sgd_free import FreeEpochRunner
    from tpu_mf_torch.ops.sgd_mega import MegaEpochRunner
    from tpu_mf_torch.ops.sgd_packed import PackedEpochRunner
    from tpu_mf_torch.ops.sgd_slot import SlotEpochRunner
    from tpu_mf_torch.ops.sgld_cells import SgldCellRunner
    from tpu_mf_torch.ops.sgld_slot import SlotSgldRunner
    from tpu_mf_torch.train import train_admf, train_dpmf

    for fn in (train_mf, train_dpmf, train_admf, init_dpmf, init_admf,
               load_mf_binary, load_dpmf_binary, CellEpochRunner,
               DenseEpochRunner, PackedEpochRunner, SlotEpochRunner,
               MegaEpochRunner, FreeEpochRunner, SgldCellRunner,
               SlotSgldRunner, AdRegCellRunner, SlotAdRegRunner,
               train_mf_stream, train_dpmf_stream, train_admf_stream,
               FusedStreamTrainer, Prefetcher):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert grid_parser().get_default("device") == "cuda"


@pytest.mark.parametrize("flag", [["--stream"], ["--measure", "1"]])
def test_cli_stream_and_measure_modes_run(tmp_path, capsys, flag):
    """--stream trains out of core (the per-batch path on the CPU) and
    --measure 1 prints the ranking line after training, each on --device
    cpu: finite, falling tRMSE over 2 epochs, and for --measure 1 recall,
    precision and ndcg at 10 in [0, 1] over the test set's users."""
    from tpu_mf_torch.cli import main

    assert main(write_data(tmp_path) + ["--device", "cpu", "--eta", "0.05"]
                + flag) == 0
    lines = capsys.readouterr().out.splitlines()
    rm = trmse(lines)
    assert len(rm) == 2 and np.isfinite(rm).all() and rm[1] < rm[0]
    ranking = [x for x in lines if x.startswith("recall@10=")]
    if flag[0] == "--measure":
        (line,) = ranking
        fields = dict(f.split("=") for f in line.split("\t"))
        assert set(fields) == {"recall@10", "precision@10", "ndcg@10",
                               "n_users"}
        assert all(0.0 <= float(fields[k]) <= 1.0 for k in
                   ("recall@10", "precision@10", "ndcg@10"))
        assert int(fields["n_users"]) > 50
    else:
        assert not ranking


def test_cli_stream_mesh_raises(tmp_path):
    """--stream --mesh 2 raises NotImplementedError naming the ROADMAP item
    that ports multi-device training."""
    from tpu_mf_torch.cli import main

    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        main(write_data(tmp_path) + ["--device", "cpu", "--stream",
                                     "--mesh", "2"])


def test_cli_stream_infers_dims_without_loading(tmp_path, capsys,
                                                monkeypatch):
    """The stream path never loads the training set whole: without
    --nu/--nv its dims come from one scan, and read_any sees only the
    test file (tpu_mf's test_cli_stream_infers_dims_without_loading)."""
    import tpu_mf_torch.data.textfmt as textfmt
    from tpu_mf_torch.cli import main

    real, calls = textfmt.read_any, []

    def spy(path, **kw):
        calls.append(path)
        return real(path, **kw)

    monkeypatch.setattr(textfmt, "read_any", spy)
    args = write_data(tmp_path)
    for flag in ("--nu", "--nv"):
        i = args.index(flag)
        del args[i:i + 2]
    assert main(args + ["--device", "cpu", "--eta", "0.03", "--stream"]) == 0
    assert calls == [str(tmp_path / "test.csv")]
    assert capsys.readouterr().out.count("tRMSE=") == 2


def test_grid_runs_the_port_on_cpu(tmp_path, capsys):
    """tools/grid.py drives the port's trainers over the product of its
    axes on --device cpu: one header a grid point, each followed by its
    epochs' lines; --device cuda without a GPU exits non-zero."""
    from tpu_mf_torch.tools.grid import main as grid

    args = write_data(tmp_path)
    keep = {a: args[args.index(a) + 1] for a in ("--train", "--test")}
    base = [x for k, v in keep.items() for x in (k, v)] + [
        "--iter", "2", "--dim", "4,8", "--eta", "0.01", "--bias", "3.0"]
    assert grid(base + ["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    heads = [x for x in lines if x.startswith("### mf ")]
    assert len(heads) == 2
    assert "_dim4_" in heads[0] and "_dim8_" in heads[1]
    assert len(trmse(lines)) == 4
    if not torch.cuda.is_available():
        assert grid(base) != 0
