"""CUDA-only tests of the PyTorch port: the hand-written kernels against
their plain PyTorch versions on the card. They skip where no GPU is present.

This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tpu_mf_torch.config import TrainConfig
from tpu_mf_torch.data.coo import RatingsCOO, synthetic_ratings
from tpu_mf_torch.models.mf import (MFParams, calc_mse, calc_mse_reference,
                                    params_from_numpy, rmse)
from tpu_mf_torch.ops import adreg_cells as tac
from tpu_mf_torch.ops import adreg_slot as tas
from tpu_mf_torch.ops import rating_sse as rs
from tpu_mf_torch.ops import sgd_cells as tc
from tpu_mf_torch.ops import sgd_dense as td
from tpu_mf_torch.ops import sgd_free as tf
from tpu_mf_torch.ops import sgd_mega as tm
from tpu_mf_torch.ops import sgd_packed as tpk
from tpu_mf_torch.ops import sgd_slot as tsl
from tpu_mf_torch.ops.phi_shard import PhiShardedRunner
from tpu_mf_torch.ops.rows import pad_params, split_params
from tpu_mf_torch.train import train_mf
from tpu_mf_torch.train.metrics import recording, span


def np_tables(nu, nv, dim, seed, gb):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1e-1, (nu, dim)).astype(np.float32),
            rng.normal(0, 1e-1, (nv, dim)).astype(np.float32),
            rng.normal(0, 1e-1, nu).astype(np.float32),
            rng.normal(0, 1e-1, nv).astype(np.float32), np.float32(gb))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# (users, items, tu, tv, k_cells): a 3x5 grid of ragged tiles, a 2x3 grid
# of full-size 256x256 cells, one row of cells, one column of cells
DENSE_GRIDS = {"72x128, 3x5": (200, 600, 72, 128, 5),
               "256x256, 2x3": (512, 768, 256, 256, 3),
               "72x128, 1x5": (72, 600, 72, 128, 5),
               "72x128, 3x1": (200, 128, 72, 128, 1)}
# every walk the route can pick: the diagonal walk takes both working types
# and every case; the wavefront walk bf16, where plan_dense_walk takes the
# cell shape, dim and W type (all but dims 130 and 300, and dim 64 on
# 256x256 cells with bf16 W)
DENSE_WALKS = [("float32", 1e-4, "diagonal"), ("bfloat16", 2e-3, "diagonal"),
               ("bfloat16", 2e-3, "wavefront")]


def dense_cases():
    cases = []
    for mxu, atol, walk in DENSE_WALKS:
        for w_dtype in ("int8", "working type"):
            for grid in sorted(DENSE_GRIDS):
                for dim in (8, 64, 130, 300):
                    _, _, tu, tv, _ = DENSE_GRIDS[grid]
                    wd = torch.int8 if w_dtype == "int8" else torch.bfloat16
                    if walk == "wavefront" and td.plan_dense_walk(
                            tu, tv, dim, torch.bfloat16, wd) is None:
                        continue
                    cases.append(pytest.param(
                        mxu, atol, walk, w_dtype, grid, dim,
                        id=f"{mxu}-{walk}-{w_dtype}-{grid}-{dim}"))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("mxu,atol,walk,w_dtype,grid,dim", dense_cases())
def test_dense_kernel_matches_reference(cuda, mxu, atol, walk, w_dtype, grid,
                                        dim):
    """Three epochs back to back on one runner (the walk's counters are
    numbered across epochs), against the plain version. Tolerances: in f32
    only the order of the f32 sums differs; in bf16 both sides round E to
    bf16 from f32 values that may differ in the last bit, one bf16 step of
    E times eta per flipped element. Dims 8 to 300 are rows of one to three
    128-lane groups."""
    nu, nv, tu, tv, k = DENSE_GRIDS[grid]
    ds = synthetic_ratings(nu, nv, nu * nv // 8, rank=3, noise=0.3, seed=5)
    tabs = np_tables(ds.nu, ds.nv, dim, seed=6, gb=3.0)
    r = td.DenseEpochRunner(ds, tile_u=tu, tile_v=tv, k_cells=k, mxu=mxu,
                            device=cuda)
    cells = r.cells
    if w_dtype == "working type":  # W as datasets with > 127 duplicates get it
        cells = cells._replace(w=cells.w.to(r.work_dtype))
    base = r.pad(params_from_numpy(*tabs, device=cuda))
    ref = tuple(t.clone() for t in base)
    before, walks = td.dense_epoch.launches, dict(td.dense_epoch.walks)
    for it in range(3):
        eta = 0.02 / (1 + it)
        td.dense_epoch_reference(*ref, cells, eta, 0.005, 3.0, 10.0, r.dim)
        td.dense_epoch(*base, cells, eta, 0.005, 3.0, 10.0, r.dim, walk=walk)
    torch.cuda.synchronize()
    assert td.dense_epoch.launches == before + 3
    assert td.dense_epoch.walks[walk] == walks[walk] + 3
    for a, b in zip(base, ref):
        assert float((a - b).abs().max()) <= atol
    start = r.pad(params_from_numpy(*tabs, device=cuda))
    assert float((base[0] - start[0]).abs().max()) > 1e-3  # it trained


@pytest.mark.cuda
@pytest.mark.parametrize("mxu,dim,walk", [
    ("bfloat16", 64, "wavefront"), ("bfloat16", 300, "diagonal"),
    ("float32", 64, "diagonal")])
def test_dense_epoch_takes_the_routed_walk(cuda, mxu, dim, walk):
    """Without ``walk``, dense_epoch launches the walk dense_route names:
    the wavefront walk for bf16 rows whose lanes fit on chip, the diagonal
    walk for wider rows and the f32 parity type."""
    ds = synthetic_ratings(200, 600, 15000, rank=3, noise=0.3, seed=7)
    tabs = np_tables(ds.nu, ds.nv, dim, seed=8, gb=3.0)
    r = td.DenseEpochRunner(ds, tile_u=72, tile_v=128, k_cells=5, mxu=mxu,
                            device=cuda)
    assert td.dense_route(72, 128, dim, r.work_dtype, r.cells.w.dtype) == walk
    base = r.pad(params_from_numpy(*tabs, device=cuda))
    walks = dict(td.dense_epoch.walks)
    r.epoch(base, 0.02, 0.005, 3.0)
    torch.cuda.synchronize()
    assert td.dense_epoch.walks[walk] == walks[walk] + 1
    assert all(torch.isfinite(t).all() for t in base)


@pytest.mark.cuda
def test_train_mf_on_gpu_runs_the_kernel(cuda):
    """train_mf on a CUDA device takes the dense kernel from epoch 1 and the
    test RMSE falls."""
    ds = synthetic_ratings(600, 400, 30000, rank=3, noise=0.2, seed=1)
    tr, te = ds.split(0.1, seed=2)
    cfg = TrainConfig(dim=16, iters=3, eta=0.005, gb=tr.mean_rating())
    log = []
    before = td.dense_epoch.launches
    train_mf(cfg, tr, te, log=log.append, device=cuda)
    assert log[0].startswith("# dense-cell kernel from epoch 1"), log
    assert td.dense_epoch.launches == before + 3
    rm = [float(x.split("tRMSE=")[1]) for x in log if "tRMSE=" in x]
    assert np.all(np.isfinite(rm)) and rm[-1] < rm[0], rm


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [40, 130])
@pytest.mark.parametrize("groups", ["8/8", "adaptive"])
@pytest.mark.parametrize("mxu,atol", [
    # f32 working type: the same f32 terms, summed by atomics in another
    # order; the error feeds through the later columns of the epoch
    ("float32", 1e-4),
    # bf16: a rounding of a row, of t*p or of err*p may flip where the f32
    # value rounded differs in its last bit; one bf16 step of an update
    ("bfloat16", 2e-3),
])
def test_cell_kernel_matches_reference(cuda, mxu, atol, groups, dim):
    """cell_epoch against cell_epoch_reference on the card, saturating, with
    ragged tiles (96 x 80), rows of one (dim 40) and two (dim 130) lane
    groups, pinned and adaptive groups (eta small enough for windows of 2+
    columns on both sides)."""
    ds = synthetic_ratings(500, 400, 40000, rank=3, noise=0.3, seed=5,
                           zipf=1.0, zipf_q=20.0)
    tabs = np_tables(ds.nu, ds.nv, dim, seed=6, gb=3.0)
    fixed = dict(theta_groups=8, phi_groups=8) if groups == "8/8" else {}
    r = tc.CellEpochRunner(ds, tile_u=96, tile_v=80, batch=1024, seed=7,
                           mxu=mxu, saturate=True, device=cuda, **fixed)
    eta = 0.05 if groups == "8/8" else 0.2 / max(r._dup_max[2],
                                                  r._vdup_max[2])
    tg, pg = r.pick_theta_groups(eta), r.pick_phi_groups(eta)
    if groups == "8/8":
        assert (tg, pg) == (8, 8)
    else:
        assert max(tg, pg) <= 2, (tg, pg)
    base = r.pad(params_from_numpy(*tabs, device=cuda))
    ref = tuple(t.clone() for t in base)
    before = tc.cell_epoch.launches
    tc.cell_epoch_reference(*ref, r._dev[0], eta, 0.005, 3.0,
                            max(1.0, 0.2 / eta), r.dim, tg, pg,
                            r.work_dtype, True, r.mxu_pred)
    r.epoch(base, eta, 0.005, 3.0)
    torch.cuda.synchronize()
    assert tc.cell_epoch.launches == before + 1
    for a, b in zip(base, ref):
        assert float((a - b).abs().max()) <= atol
    start = r.pad(params_from_numpy(*tabs, device=cuda))
    assert float((base[0] - start[0]).abs().max()) > 1e-3  # it trained


@pytest.mark.cuda
def test_train_mf_no_dense_runs_gen1(cuda):
    """train_mf(use_dense=False) on a CUDA device runs the gen-1 kernel
    from epoch 1, once per epoch, and the test RMSE falls."""
    ds = synthetic_ratings(600, 400, 30000, rank=3, noise=0.2, seed=1)
    tr, te = ds.split(0.1, seed=2)
    cfg = TrainConfig(dim=64, iters=3, eta=0.005, use_dense=False,
                      gb=tr.mean_rating())
    log = []
    before, dense_before = tc.cell_epoch.launches, td.dense_epoch.launches
    train_mf(cfg, tr, te, log=log.append, device=cuda)
    assert log[0].startswith("# gen-1 cell kernel: epochs 1..3"), log
    assert tc.cell_epoch.launches == before + 3
    assert td.dense_epoch.launches == dense_before
    rm = [float(x.split("tRMSE=")[1]) for x in log if "tRMSE=" in x]
    assert np.all(np.isfinite(rm)) and rm[-1] < rm[0], rm


@pytest.mark.cuda
@pytest.mark.parametrize("use_dense,kernel", [(True, "DenseEpochRunner"),
                                              (False, "CellEpochRunner")])
def test_train_mf_spans_time_the_epochs_on_the_card(cuda, use_dense,
                                                     kernel):
    """With the recorder on, train_mf on a CUDA device records each epoch
    as a tmf.epoch span with CUDA event milliseconds inside its host span,
    one kernel launch counted on it (and on gen-1 its grouping), and the
    uploads in the first pad."""
    ds = synthetic_ratings(600, 400, 30000, rank=3, noise=0.2, seed=1)
    tr, te = ds.split(0.1, seed=2)
    cfg = TrainConfig(dim=64, iters=3, eta=0.005, use_dense=use_dense,
                      gb=tr.mean_rating())
    with recording() as recs:
        train_mf(cfg, tr, te, log=lambda _: None, device=cuda)
    epochs = sorted((r for r in recs if r["name"] == "tmf.epoch"),
                    key=lambda r: r["t0"])
    assert [r["attrs"]["epoch"] for r in epochs] == [1, 2, 3]
    for r in epochs:
        assert r["attrs"]["kernel"] == kernel
        assert r["attrs"]["launches"] == 1
        assert 0 < r["device_ms"] <= (r["t1"] - r["t0"]) / 1e6 + 0.05
        if not use_dense:
            assert sum(v for k, v in r["attrs"].items()
                       if k.startswith("groups_")) == 1
    (pad,) = [r for r in recs if r["name"] == "tmf.pad"]
    ups = [r for r in recs if r["name"] == "tmf.plan_upload"]
    assert len(ups) == 1 and ups[0]["parent"] == pad["id"]
    assert [r["name"] for r in recs if r["parent"] is None] == [
        "tmf.plan_build", "tmf.run"]


# csrc/cell_sgd.cu's tile walk: (tile_u, tile_v, batch, dim) of a plan
# whose applies cover whole tiles, as the grid walk's, and of one whose
# groups hold fewer slots than the tiles have rows, so the walk claims the
# touched rows slot by slot (the Yahoo geometry's case; rows past 157
# lanes at dim 170)
CELL_WALK_PLANS = {"rows": (96, 80, 1024, 40), "claimed": (512, 256, 512, 170)}
# (theta, phi) groups: equal, unequal both ways, whole batches
CELL_WALK_GROUPS = [(8, 8), (4, 4), (4, 8), (8, 4), (2, 2), (1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("walk", ["tile", "grid"])
@pytest.mark.parametrize("groups", CELL_WALK_GROUPS,
                         ids=[f"{t}x{p}" for t, p in CELL_WALK_GROUPS])
@pytest.mark.parametrize("case", sorted(CELL_WALK_PLANS))
@pytest.mark.parametrize("mxu,atol", [("float32", 1e-4), ("bfloat16", 2e-3)])
def test_cell_walks_match_reference(cuda, mxu, atol, case, groups, walk):
    """Both walks of csrc/cell_sgd.cu against cell_epoch_reference on the
    card, saturating, at every kind of grouping, on plans padded with
    all-padding batches (nb_round): the tolerances of
    test_cell_kernel_matches_reference; the launch counts on its walk."""
    tu, tv, batch, dim = CELL_WALK_PLANS[case]
    ds = synthetic_ratings(1500, 1000, 40000, rank=3, noise=0.3, seed=5,
                           zipf=1.0, zipf_q=20.0)
    tabs = np_tables(ds.nu, ds.nv, dim, seed=6, gb=3.0)
    tg, pg = groups
    r = tc.CellEpochRunner(ds, tile_u=tu, tile_v=tv, batch=batch, seed=7,
                           mxu=mxu, theta_groups=tg, phi_groups=pg,
                           saturate=True, nb_round=16, device=cuda)
    eta = 0.05
    base = r.pad(params_from_numpy(*tabs, device=cuda))
    ref = tuple(t.clone() for t in base)
    tc.cell_epoch_reference(*ref, r._dev[0], eta, 0.005, 3.0,
                            max(1.0, 0.2 / eta), r.dim, tg, pg,
                            r.work_dtype, True, r.mxu_pred)
    before = dict(tc.cell_epoch.walks)
    r.epoch(base, eta, 0.005, 3.0, walk=walk)
    r.epoch(base, eta, 0.005, 3.0, walk=walk)  # counters: a second launch
    torch.cuda.synchronize()
    assert tc.cell_epoch.walks[walk] == before[walk] + 2
    again = tuple(t.clone() for t in ref)
    tc.cell_epoch_reference(*again, r._dev[0], eta, 0.005, 3.0,
                            max(1.0, 0.2 / eta), r.dim, tg, pg,
                            r.work_dtype, True, r.mxu_pred)
    for a, b in zip(base, again):
        assert float((a - b).abs().max()) <= atol
    assert float((base[0] - ref[0]).abs().max()) > 1e-3  # it trained
    slices = r.walk_counters._slices
    assert slices is None or not slices.any()  # left zero


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["packed", "slot", "stripe", "mega",
                                    "sharded"])
def test_cell_tile_walk_on_every_plan_family(cuda, family):
    """The tile walk of csrc/cell_sgd.cu, forced, on the packed, slot,
    striped-slot and mega window plans and on an item-sharded epoch (the
    shards' runners on one set of counters) against the plain version on
    the card, f32, 8/8 and eta 0.02's groups."""
    ds = synthetic_ratings(500, 400, 40000, rank=3, noise=0.3, seed=5,
                           zipf=1.0, zipf_q=20.0)
    dim = 8 if family in ("packed", "slot", "stripe") else 40
    tabs = np_tables(ds.nu, ds.nv, dim, seed=6, gb=3.0)
    if family == "sharded":
        r = PhiShardedRunner(ds, dim=dim, tile_u=96, tile_v=80, batch=1024,
                             budget=80 * 128 * 4, mxu="float32", device=cuda)
        assert r.n_shards == 5
        assert len({id(i.walk_counters) for i in r.inners}) == 1
        runners = r.inners
    elif family == "mega":
        r = tm.MegaEpochRunner(ds, dim=dim, tile_u=128, tile_v=128,
                               batch=1024, mxu="float32", saturate=True,
                               device=cuda)
        runners = [r]
    else:
        r = LADDER[family](ds, seed=7, dim=dim, mxu="float32",
                           saturate=True, device=cuda)
        runners = [r]
    for eta in (0.2, 0.02):
        got = r.pad(params_from_numpy(*tabs, device=cuda))
        want = r.pad(params_from_numpy(*tabs, device=cuda))
        wants = (list(zip([want[0]] * len(runners), want[1]))
                 if family == "sharded" else [want])
        for inner, (theta, phi) in zip(runners, wants):
            tc.cell_epoch_reference(
                theta, phi, inner._dev[0], eta, 0.005, 3.0,
                max(1.0, 0.2 / eta), dim, inner.pick_theta_groups(eta),
                inner.pick_phi_groups(eta), inner.work_dtype,
                inner.saturate, inner.mxu_pred)
        r.epoch(got, eta, 0.005, 3.0, walk="tile")
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max())
                  for a, b in zip(r.trim(got), r.trim(want)))
        assert err <= 1e-4, (eta, err)


@pytest.mark.cuda
@pytest.mark.parametrize("mxu,atol", [("float32", 1e-4), ("bfloat16", 2e-3)])
def test_phi_sharded_runner_matches_reference(cuda, mxu, atol):
    """One item-sharded epoch at the Yahoo stand-in's tiles (4096 x 2040,
    batch 4096) on a corner of 2 x 3 tiles at 100x its rating density,
    one item tile a shard (3 shards, 3 launches), against each shard's
    sub-epoch through the plain version on the card, theta chained."""
    rng = np.random.default_rng(8)
    nu, nv, n = 2 * 4096, 3 * 2040, 150_000
    ds = RatingsCOO(u=rng.integers(0, nu, n), v=rng.integers(0, nv, n),
                       r=rng.uniform(1, 5, n), nu=nu, nv=nv)
    r = PhiShardedRunner(ds, dim=128, tile_u=4096, tile_v=2040, batch=4096,
                         budget=2040 * 256 * 4, mxu=mxu, device=cuda)
    assert r.n_shards == 3
    tabs = np_tables(nu, nv, 128, seed=9, gb=3.0)
    got = r.pad(params_from_numpy(*tabs, device=cuda))
    want = r.pad(params_from_numpy(*tabs, device=cuda))
    eta = 0.02
    for inner, phi_k in zip(r.inners, want[1]):
        tc.cell_epoch_reference(want[0], phi_k, inner._dev[0], eta, 0.005,
                                3.0, max(1.0, 0.2 / eta), 128,
                                inner.pick_theta_groups(eta),
                                inner.pick_phi_groups(eta), inner.work_dtype,
                                inner.saturate, inner.mxu_pred)
    before = tc.cell_epoch.launches
    r.epoch(got, eta, 0.005, 3.0)
    torch.cuda.synchronize()
    assert tc.cell_epoch.launches == before + 3
    err = max(float((a - b).abs().max())
              for a, b in zip(r.trim(got), r.trim(want)))
    assert err <= atol, err
    start = r.trim(r.pad(params_from_numpy(*tabs, device=cuda)))
    assert float((r.trim(got).phi - start.phi).abs().max()) > 1e-3


# per algorithm: TrainConfig options and the trainer
RESUME_RUNS = {
    "mf": dict(dim=64, eta=0.005),
    "dpmf": dict(alg="dpmf", dim=8, eta=2e-5, hyperb=1000.0),
    "admf": dict(alg="admf", dim=8, eta=0.005, eta_reg=0.05),
}


def train_any(cfg, tr, te, device, log=lambda _: None):
    from tpu_mf_torch.train import train_admf, train_dpmf

    if cfg.alg == "dpmf":
        return train_dpmf(cfg, tr, te, log=log, device=device).params
    if cfg.alg == "admf":
        return train_admf(cfg, tr, te, te, log=log, device=device).params
    return train_mf(cfg, tr, te, log=log, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("alg", sorted(RESUME_RUNS))
def test_resume_round_trip_on_gpu(cuda, tmp_path, alg):
    """Each algorithm on the card (dense at dim 64; slot SGLD and the
    AdaptReg kernel at dim 8): 2 rounds with --resume, then resumed to 3,
    against 3 uninterrupted rounds: the resumed run starts at round 3 and
    ends within one bf16 step of an update (the kernels' atomics sum in no
    fixed order; the fused AdaptReg runners read no shadows)."""
    ds = synthetic_ratings(600, 400, 30000, rank=3, noise=0.2, seed=1)
    tr, te = ds.split(0.1, seed=2)
    opts = dict(RESUME_RUNS[alg], gb=tr.mean_rating(), resume=True)
    want = train_any(TrainConfig(iters=3, result=str(tmp_path / "w"),
                                 **opts), tr, te, cuda)
    part = str(tmp_path / "p")
    train_any(TrainConfig(iters=2, result=part, **opts), tr, te, cuda)
    log = []
    got = train_any(TrainConfig(iters=3, result=part, **opts), tr, te, cuda,
                    log.append)
    assert f"# resumed from round 2 ({part}.state)" in log
    rounds = [x.split("\t")[0] for x in log
              if x.startswith(("iter#", "round #"))]
    assert rounds == ["round #3" if alg == "dpmf" else "iter#3"]
    for a, b in zip(got[:4], want[:4]):
        assert float((a.float() - b.float()).abs().max()) <= 2e-3


LADDER = {
    "packed": lambda ds, **kw: tpk.PackedEpochRunner(ds, batch=1024, **kw),
    "slot": lambda ds, **kw: tsl.SlotEpochRunner(ds, sub=64, balance=True,
                                                 **kw),
    "stripe": lambda ds, **kw: tsl.SlotEpochRunner(ds, sub=128, balance=True,
                                                   striped=True, **kw),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [8, 40])
@pytest.mark.parametrize("groups", ["8/8", "adaptive"])
@pytest.mark.parametrize("family", sorted(LADDER))
@pytest.mark.parametrize("mxu,atol", [("float32", 1e-4), ("bfloat16", 2e-3)])
def test_ladder_kernel_matches_reference(cuda, mxu, atol, family, groups,
                                         dim):
    """cell_epoch on the packed, plain-slot and striped-slot window plans
    against cell_epoch_reference on the card (mxu_pred off), saturating,
    at P 8 (dim 8) and P 2 (dim 40), pinned and adaptive groups; the
    tolerances of test_cell_kernel_matches_reference."""
    ds = synthetic_ratings(500, 400, 40000, rank=3, noise=0.3, seed=5,
                           zipf=1.0, zipf_q=20.0)
    tabs = np_tables(ds.nu, ds.nv, dim, seed=6, gb=3.0)
    fixed = dict(theta_groups=8, phi_groups=8) if groups == "8/8" else {}
    r = LADDER[family](ds, seed=7, dim=dim, mxu=mxu, saturate=True,
                       device=cuda, **fixed)
    eta = 0.05 if groups == "8/8" else 0.2 / max(r._dup_max[2],
                                                  r._vdup_max[2])
    tg, pg = r.pick_theta_groups(eta), r.pick_phi_groups(eta)
    if groups == "8/8":
        assert (tg, pg) == (8, 8)
    else:
        assert max(tg, pg) <= 2, (tg, pg)
    base = r.pad(params_from_numpy(*tabs, device=cuda))
    ref = tuple(t.clone() for t in base)
    before, fam_before = tc.cell_epoch.launches, type(r).launches
    tc.cell_epoch_reference(*ref, r._dev[0], eta, 0.005, 3.0,
                            max(1.0, 0.2 / eta), r.dim, tg, pg,
                            r.work_dtype, True, False)
    r.epoch(base, eta, 0.005, 3.0)
    torch.cuda.synchronize()
    assert tc.cell_epoch.launches == before + 1
    assert type(r).launches == fam_before + 1
    for a, b in zip(base, ref):
        assert float((a - b).abs().max()) <= atol
    start = r.pad(params_from_numpy(*tabs, device=cuda))
    assert float((base[0] - start[0]).abs().max()) > 1e-3  # it trained


@pytest.mark.cuda
def test_train_mf_dim8_no_dense_runs_the_ladder(cuda):
    """train_mf(dim 8, use_dense=False) on a CUDA device: the packed
    runner carries epochs 1-2 and the slot runners (plain, then striped)
    epochs 3-5, one launch each, and the test RMSE falls."""
    ds = synthetic_ratings(400, 250, 30000, rank=3, seed=8, zipf=1.2)
    tr, te = ds.split(0.1, seed=1)
    cfg = TrainConfig(dim=8, iters=5, eta=0.002, use_dense=False,
                      gb=tr.mean_rating())
    log = []
    counts = (tpk.PackedEpochRunner, tsl.SlotEpochRunner, tc.CellEpochRunner,
              td.dense_epoch)
    before = [c.launches for c in counts]
    train_mf(cfg, tr, te, log=log.append, device=cuda)
    assert [c.launches - b for c, b in zip(counts, before)] == [2, 3, 0, 0]
    assert "# epoch 5: switching to SlotEpochRunner (striped)" in log, log
    rm = [float(x.split("tRMSE=")[1]) for x in log if "tRMSE=" in x]
    assert np.all(np.isfinite(rm)) and rm[-1] < rm[0], rm


def np_dpmf_state(ds, dim, seed, gb=3.0, stamps=0):
    """A DPMF state from numpy (tables, precisions near tpu_mf's inits, the
    inverse frequencies of ds, counters at ``stamps``)."""
    from tpu_mf_torch.models.dpmf import inverse_frequency

    theta, phi, bu, bv, gbv = np_tables(ds.nu, ds.nv, dim, seed, gb)
    ur, vr = inverse_frequency(ds)
    rng = np.random.default_rng(seed + 1)
    return dict(theta=theta, phi=phi, bu=bu, bv=bv, gb=gbv, lambda_r=1.0,
                lambda_ub=100.0, lambda_vb=80.0,
                lambda_u=rng.uniform(50, 150, dim),
                lambda_v=rng.uniform(50, 150, dim), ur=ur, vr=vr,
                gcountu=np.full(ds.nu + 1, stamps),
                gcountv=np.full(ds.nv + 1, stamps), gcount=stamps)


def sgld_hyper(ds, temp, scal=0.02, gb=3.0):
    """(eta, temp, bound, scal, gb) with eta such that scal is the step at
    lambda_r = 1."""
    eta = scal / len(ds)
    return (eta, temp, 1.0, scal, gb)


def held(got, want, atol):
    """Tables within atol, stamps equal as integers."""
    for a, b in zip(got[:2], want[:2]):
        assert float((a - b).abs().max()) <= atol
    for a, b in zip(got[2:], want[2:]):
        assert torch.equal(a, b)


@pytest.mark.cuda
# dim 300: past tpu_mf's 251, routed to this kernel all the same
@pytest.mark.parametrize("dim", [8, 128, 300])
@pytest.mark.parametrize("temp", [0.0, 1.0])
@pytest.mark.parametrize("mxu,atol", [
    # f32: the same terms, summed by atomics in another order
    ("float32", 1e-4),
    # bf16: a row or an err*p rounding may flip where the f32 value differs
    # in its last bit; one bf16 step of an update
    ("bfloat16", 2e-3),
])
def test_sgld_cell_kernel_matches_reference(cuda, mxu, atol, temp, dim):
    """sgld_cell_epoch against sgld_cell_epoch_reference on the card (the
    same counter-based normals on both sides), ragged tiles (96 x 80),
    zipfy data, stamps offset past 2^31; stamps equal as integers."""
    from tpu_mf_torch.models.dpmf import dpmf_state_from_numpy
    from tpu_mf_torch.ops import sgld_cells as tg

    ds = synthetic_ratings(500, 400, 40000, rank=3, noise=0.3, seed=5,
                           zipf=1.0, zipf_q=20.0)
    base = (1 << 31) + 5
    state = dpmf_state_from_numpy(np_dpmf_state(ds, dim, 6, stamps=base),
                                  cuda)
    r = tg.SgldCellRunner(ds, tile_u=96, tile_v=80, batch=1024, seed=7,
                          mxu=mxu, device=cuda)
    hyper = sgld_hyper(ds, temp)
    got = r.pad(state)
    want = tuple(t.clone() for t in got)
    tg.sgld_cell_epoch_reference(*want, *r.invf, r.lam, r._dev[0], base,
                                 hyper, dim, 11, r.work_dtype)
    before, fam = tg.sgld_cell_epoch.launches, tg.SgldCellRunner.launches
    r.epoch(got, base, hyper, noise_seed=11)
    torch.cuda.synchronize()
    assert tg.sgld_cell_epoch.launches == before + 1
    assert tg.SgldCellRunner.launches == fam + 1
    held(got, want, atol)
    start = r.pad(state)
    assert float((got[0] - start[0]).abs().max()) > 1e-3  # it trained
    assert int(got[2].max()) == base + len(ds)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [8, 26])
@pytest.mark.parametrize("temp", [0.0, 1.0])
@pytest.mark.parametrize("plan,noise_every", [("plain", 8), ("striped", 1)])
@pytest.mark.parametrize("mxu,atol", [("float32", 1e-4), ("bfloat16", 2e-3)])
def test_slot_sgld_kernel_matches_reference(cuda, mxu, atol, plan,
                                            noise_every, temp, dim):
    """sgld_slot_epoch against sgld_slot_epoch_reference on the card (the
    same ring on both sides), plain and striped plans with the serpentine
    balance map, saturating, at P 8 (dim 8) and P 4 (dim 26); stamps equal
    as integers. The tolerances of test_sgld_cell_kernel_matches_reference."""
    from tpu_mf_torch.models.dpmf import dpmf_state_from_numpy
    from tpu_mf_torch.ops import sgld_slot as tss

    ds = synthetic_ratings(500, 400, 40000, rank=3, noise=0.3, seed=5,
                           zipf=1.0, zipf_q=20.0)
    state = dpmf_state_from_numpy(np_dpmf_state(ds, dim, 6, stamps=3), cuda)
    striped = plan == "striped"
    r = tss.SlotSgldRunner(ds, sub=64 if striped else 32, seed=7, mxu=mxu,
                           dim=dim, striped=striped, noise_every=noise_every,
                           device=cuda)
    hyper = sgld_hyper(ds, temp, scal=0.05)
    ring = tss.slot_ring(13, r.tile_u, r.tile_v, cuda)
    cap = tss.saturation_cap(hyper[3])
    got = r.pad(state)
    want = tuple(t.clone() for t in got)
    tss.sgld_slot_epoch_reference(*want, *r.invf, r.lam, r._dev[0], 3, hyper,
                                  dim, 13, ring, r.pack, noise_every, cap,
                                  r.work_dtype)
    before, fam = tss.sgld_slot_epoch.launches, tss.SlotSgldRunner.launches
    r.epoch(got, 3, hyper, noise_seed=13, ring=ring)
    torch.cuda.synchronize()
    assert tss.sgld_slot_epoch.launches == before + 1
    assert tss.SlotSgldRunner.launches == fam + 1
    held(got, want, atol)
    start = r.pad(state)
    assert float((got[0] - start[0]).abs().max()) > 1e-3  # it trained


def adreg_sets(loss):
    """(train, valid) for the AdaptReg kernels: zipfy train, uniform valid;
    with loss 1 the ratings are 1 above the mean and 0 below."""
    ds = synthetic_ratings(500, 400, 40000, rank=3, noise=0.3, seed=5,
                           zipf=1.0, zipf_q=20.0)
    valid = synthetic_ratings(500, 400, 2000, rank=3, noise=0.3, seed=6)
    if loss:
        ds, valid = (dataclasses.replace(
            d, r=(d.r > ds.mean_rating()).astype(np.float32))
            for d in (ds, valid))
    return ds, valid


def np_admf_state(ds, dim, lam, gb, device):
    from tpu_mf_torch.models.admf import with_shadows

    params = params_from_numpy(*np_tables(ds.nu, ds.nv, dim, 6, gb), device)
    return with_shadows(params, (lam,) * 4)


ADREG = {
    "gen1": lambda ds, va, dim, **kw: tac.AdRegCellRunner(
        ds, va, tile_u=96, tile_v=80, batch=1024, **kw),
    "slot": lambda ds, va, dim, **kw: tas.SlotAdRegRunner(
        ds, va, sub=32, dim=dim, **kw),
    "stripe": lambda ds, va, dim, **kw: tas.SlotAdRegRunner(
        ds, va, sub=64, dim=dim, striped=True, **kw),
}
# name: (loss, eta * lam); "negbase": eta * lam = 1.5, a negative decay base
ADREG_CASES = {"lsq": (0, 1e-3), "logistic": (1, 1e-3), "negbase": (0, 1.5)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ADREG_CASES))
# gen-1 at one (dim 40) and three (dim 300) lane groups, at 8/8; slot
# plans at P 8 (dim 8) and P 4 (dim 26): plain ones at windows of 2+
# columns, striped ones at the groups eta 0.05 picks
@pytest.mark.parametrize("family,dim", [
    ("gen1", 40), ("gen1", 300), ("slot", 8), ("slot", 26), ("stripe", 8),
    ("stripe", 26)])
@pytest.mark.parametrize("mxu,atol", [
    # f32: the same terms, summed by atomics in another order
    ("float32", 1e-4),
    # bf16: a row or an err*p rounding may flip where the f32 value differs
    # in its last bit; one bf16 step of an update
    ("bfloat16", 2e-3),
])
def test_adreg_kernel_epoch_matches_reference(cuda, mxu, atol, family, dim,
                                              case):
    """A whole segmented AdaptReg epoch (segments, hypergradient steps) of
    each runner family with the kernel against the same epoch through the
    plain version on the card, the same validation draws on both sides:
    tables within atol, the lambdas within 1% of how far they moved. The
    kernel's epoch makes no host sync (the lambdas stay on the card)."""
    loss, eta_lam = ADREG_CASES[case]
    ds, va = adreg_sets(loss)
    r = ADREG[family](ds, va, dim, seed=7, mxu=mxu, loss=loss, device=cuda)
    if family == "gen1":
        eta = 0.05
    elif family == "slot":
        eta = 0.2 / max(r._dup_max[2], r._vdup_max[2])
        assert max(r.pick_theta_groups(eta), r.pick_phi_groups(eta)) <= 2
    else:
        eta = 0.05
    state = np_admf_state(ds, dim, eta_lam / eta, 0.0 if loss else 3.0,
                          cuda)
    got = r.pad(state)
    lam0 = r.lams.clone()
    want = tuple(t.clone() for t in got)
    r.epoch(want, eta, 0.5, 3, reference=True)
    lam_want, r.lams = r.lams, lam0.clone()
    before, fam = tac.adreg_segment.launches, type(r).launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        r.epoch(got, eta, 0.5, 3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert r.segments >= 2
    assert tac.adreg_segment.launches == before + r.segments
    assert type(r).launches == fam + r.segments
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= atol
    moved = float((lam_want - lam0).abs().max())
    assert moved > 0
    assert float((r.lams - lam_want).abs().max()) <= 1e-2 * moved + 1e-7
    start = r.pad(state)
    assert float((got[0] - start[0]).abs().max()) > 1e-3  # it trained


@pytest.mark.cuda
@pytest.mark.parametrize("dim,family", [(8, "slot"), (64, "gen1")])
def test_train_admf_on_gpu_runs_the_kernel(cuda, dim, family):
    """train_admf on a CUDA device: the striped slot runner (dim 8) or the
    gen-1 runner (dim 64) carries every epoch, one launch per segment, and
    the test RMSE falls; the lambdas stay >= 0."""
    from tpu_mf_torch.train import train_admf
    from tpu_mf_torch.train.loop import _admf_runner

    ds = synthetic_ratings(600, 400, 30000, rank=3, noise=0.2, seed=1)
    tr, rest = ds.split(0.2, seed=2)
    va, te = rest.split(0.5, seed=3)
    cfg = TrainConfig(alg="admf", dim=dim, iters=3, eta=0.005, eta_reg=0.05,
                      gb=tr.mean_rating())
    state = np_admf_state(tr, dim, cfg.lam, cfg.gb, cuda)
    probe = _admf_runner(cfg, tr, va, state, lambda _: None, cuda)
    want = sum(probe._segs[it % len(probe.plans)] for it in range(3))
    fams = {"slot": tas.SlotAdRegRunner, "gen1": tac.AdRegCellRunner}
    assert type(probe) is fams[family]
    before = {k: c.launches for k, c in fams.items()}
    log = []
    out = train_admf(cfg, tr, va, te, log=log.append, device=cuda)
    assert {k: c.launches - before[k] for k, c in fams.items()} == {
        k: want if k == family else 0 for k in fams}
    rm = [float(x.split("tRMSE=")[1]) for x in log if "tRMSE=" in x]
    assert np.all(np.isfinite(rm)) and rm[-1] < rm[0], rm
    assert min(float(x) for x in out[5:]) >= 0


@pytest.mark.cuda
@pytest.mark.parametrize("walk", ["tile"])
@pytest.mark.parametrize("case", sorted(ADREG_CASES))
@pytest.mark.parametrize("family,dim", [("gen1", 40), ("slot", 8),
                                        ("stripe", 26)])
@pytest.mark.parametrize("mxu,atol", [("float32", 1e-4), ("bfloat16", 2e-3)])
def test_adreg_walks_match_reference(cuda, mxu, atol, family, dim, case,
                                     walk):
    """The tile walk of csrc/adreg_cells.cu (its only walk) on a whole
    segmented epoch against the plain version (the tolerances of
    test_adreg_kernel_epoch_matches_reference): gen-1 plans padded to whole
    segments (the last batch all padding, and padding columns at each user
    tile's end), slot plans at 2+ column windows, striped plans at the
    groups eta 0.05 picks; the launches count on the walk, none on the
    grid key."""
    loss, eta_lam = ADREG_CASES[case]
    ds, va = adreg_sets(loss)
    r = ADREG[family](ds, va, dim, seed=7, mxu=mxu, loss=loss, device=cuda)
    eta = 0.05
    if family == "slot":
        eta = 0.2 / max(r._dup_max[2], r._vdup_max[2])
    plan = r.materialize()._dev[0]
    if family == "gen1":
        w = plan.w.sum(2).cpu().numpy()
        assert (w[-1] == 0).any()  # the last batch has padding columns
    state = np_admf_state(ds, dim, eta_lam / eta, 0.0 if loss else 3.0,
                          cuda)
    got = r.pad(state)
    lam0 = r.lams.clone()
    want = tuple(t.clone() for t in got)
    r.epoch(want, eta, 0.5, 3, reference=True)
    lam_want, r.lams = r.lams, lam0.clone()
    before = dict(tac.adreg_segment.walks)
    r.epoch(got, eta, 0.5, 3)
    torch.cuda.synchronize()
    assert tac.adreg_segment.walks == {**before,
                                       walk: before[walk] + r.segments}
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= atol
    moved = float((lam_want - lam0).abs().max())
    assert float((r.lams - lam_want).abs().max()) <= 1e-2 * moved + 1e-7


@pytest.mark.cuda
@pytest.mark.parametrize("walk", ["tile", "grid"])
@pytest.mark.parametrize("temp", [0.0, 1.0])
@pytest.mark.parametrize("family,dim", [("gen1", 8), ("gen1", 128),
                                        ("slot", 8), ("stripe", 26)])
@pytest.mark.parametrize("mxu,atol", [("float32", 1e-4), ("bfloat16", 2e-3)])
def test_sgld_walks_match_reference(cuda, mxu, atol, family, dim, temp,
                                    walk):
    """Each SGLD walk of csrc/sgld_cells.cu forced on one round against the
    plain version (the same normals or ring on both sides; the tolerances
    of test_sgld_cell_kernel_matches_reference), stamps equal as integers;
    the launch counts on the forced walk."""
    from tpu_mf_torch.models.dpmf import dpmf_state_from_numpy
    from tpu_mf_torch.ops import sgld_cells as tg
    from tpu_mf_torch.ops import sgld_slot as tss

    ds = synthetic_ratings(500, 400, 40000, rank=3, noise=0.3, seed=5,
                           zipf=1.0, zipf_q=20.0)
    state = dpmf_state_from_numpy(np_dpmf_state(ds, dim, 6, stamps=3), cuda)
    if family == "gen1":
        r = tg.SgldCellRunner(ds, tile_u=96, tile_v=80, batch=1024, seed=7,
                              mxu=mxu, device=cuda)
        hyper = sgld_hyper(ds, temp)
        fn = tg.sgld_cell_epoch
    else:
        r = tss.SlotSgldRunner(ds, sub=64 if family == "stripe" else 32,
                               seed=7, mxu=mxu, dim=dim,
                               striped=family == "stripe",
                               noise_every=1 if family == "stripe" else 8,
                               device=cuda)
        hyper = sgld_hyper(ds, temp, scal=0.05)
        ring = tss.slot_ring(13, r.tile_u, r.tile_v, cuda)
        fn = tss.sgld_slot_epoch
    got = r.pad(state)
    want = tuple(t.clone() for t in got)
    plan = r._dev[0]
    if family == "gen1":
        tg.sgld_cell_epoch_reference(*want, *r.invf, r.lam, plan, 3, hyper,
                                     dim, 13, r.work_dtype)
        before = dict(fn.walks)
        r.epoch(got, 3, hyper, noise_seed=13, walk=walk)
    else:
        tss.sgld_slot_epoch_reference(
            *want, *r.invf, r.lam, plan, 3, hyper, dim, 13, ring, r.pack,
            r.noise_every, tss.saturation_cap(hyper[3]), r.work_dtype)
        before = dict(fn.walks)
        r.epoch(got, 3, hyper, noise_seed=13, ring=ring, walk=walk)
    torch.cuda.synchronize()
    assert fn.walks[walk] == before[walk] + 1
    held(got, want, atol)
    start = r.pad(state)
    assert float((got[0] - start[0]).abs().max()) > 1e-3  # it trained


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["adreg", "sgld", "slot_sgld"])
def test_tile_walk_on_clusters_of_16(cuda, family):
    """The tile walk on clusters of 16 blocks (the wide windows' size,
    past the portable 8) against the plain version, f32: a gen-1 AdaptReg
    epoch, a gen-1 and a slot SGLD round at temp 1."""
    from tpu_mf_torch.models.dpmf import dpmf_state_from_numpy
    from tpu_mf_torch.ops import sgld_cells as tg
    from tpu_mf_torch.ops import sgld_slot as tss

    ds, va = adreg_sets(0)
    if family == "adreg":
        r = ADREG["gen1"](ds, va, 40, seed=7, mxu="float32", loss=0,
                          device=cuda)
        r.materialize()
        r.walks = [w._replace(cluster=16) for w in r.walks]
        state = np_admf_state(ds, 40, 0.02, 3.0, cuda)
        got = r.pad(state)
        lam0 = r.lams.clone()
        want = tuple(t.clone() for t in got)
        r.epoch(want, 0.05, 0.5, 3, reference=True)
        r.lams = lam0
        r.epoch(got, 0.05, 0.5, 3)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert float((a - b).abs().max()) <= 1e-4
        return
    state = dpmf_state_from_numpy(np_dpmf_state(ds, 8, 6, stamps=3), cuda)
    if family == "sgld":
        r = tg.SgldCellRunner(ds, tile_u=96, tile_v=80, batch=1024, seed=7,
                              mxu="float32", device=cuda)
    else:
        r = tss.SlotSgldRunner(ds, sub=32, seed=7, mxu="float32", dim=8,
                               device=cuda)
    r.materialize()
    r._dev = [p._replace(walk=p.walk._replace(cluster=16)) for p in r._dev]
    hyper = sgld_hyper(ds, 1.0, scal=0.05)
    got = r.pad(state)
    want = tuple(t.clone() for t in got)
    if family == "sgld":
        tg.sgld_cell_epoch_reference(*want, *r.invf, r.lam, r._dev[0], 3,
                                     hyper, 8, 13)
        r.epoch(got, 3, hyper, noise_seed=13, walk="tile")
    else:
        ring = tss.slot_ring(13, r.tile_u, r.tile_v, cuda)
        tss.sgld_slot_epoch_reference(
            *want, *r.invf, r.lam, r._dev[0], 3, hyper, 8, 13, ring, r.pack,
            r.noise_every, tss.saturation_cap(hyper[3]))
        r.epoch(got, 3, hyper, noise_seed=13, ring=ring, walk="tile")
    torch.cuda.synchronize()
    held(got, want, 1e-4)


@pytest.mark.cuda
def test_tile_walk_launch_failures_raise(cuda):
    """A tile walk the card cannot launch raises: clusters of 32 blocks
    (past the 16 a cluster can hold), a walk on another device's counters,
    and no walk at all."""
    from tpu_mf_torch.ops import tile_walk as tw

    ds, va = adreg_sets(0)
    r = ADREG["gen1"](ds, va, 40, seed=7, mxu="float32", loss=0,
                      device=cuda)
    tabs = r.pad(np_admf_state(ds, 40, 0.02, 3.0, cuda))
    walk = r.walks[0]
    for bad, err in ((walk._replace(cluster=32), RuntimeError),
                     (walk._replace(counters=tw.TileWalkCounters(1, 1, "cpu")),
                      ValueError)):
        with pytest.raises(err):
            tac.adreg_segment(*tabs, r._dev[0], 0, r.seg_len(), 0.05, r.lams,
                              r.gb, 40, walk=bad)
            torch.cuda.synchronize()
    with pytest.raises(ValueError, match="tile walk"):
        tac.adreg_segment(*tabs, r._dev[0], 0, r.seg_len(), 0.05, r.lams,
                          r.gb, 40)


def zipf_free_data():
    """3 x 4 tiles of 128 with zipfy heads, sub 128 (no sentinel column)."""
    return synthetic_ratings(380, 500, 40000, rank=3, noise=0.3, seed=5,
                             zipf=1.0, zipf_q=20.0)


def sentinel_free_data():
    """One item tile: the last batch's sentinel columns share item tile 0
    with its real columns."""
    return synthetic_ratings(300, 100, 3100, rank=3, noise=0.3, seed=5)


@pytest.mark.cuda
@pytest.mark.parametrize("walk", ["tile"])
@pytest.mark.parametrize("saturate", [False, True])
@pytest.mark.parametrize("data,groups", [
    ("zipf", (8, 8)), ("zipf", (1, 1)), ("zipf", (2, 4)),
    ("sentinel", (1, 1)), ("sentinel", (8, 2))])
@pytest.mark.parametrize("mxu,mxu_pred,atol", [
    ("float32", True, 1e-4), ("bfloat16", True, 2e-3),
    ("bfloat16", False, 2e-3)])
def test_free_kernel_matches_reference(cuda, mxu, mxu_pred, atol, data,
                                       groups, saturate, walk):
    """free_epoch (csrc/free_cells.cu) on its tile walk against
    free_epoch_reference on the card, at dim 40, per-column user and item
    tiles, pinned groups, with saturation on and off, and on a plan whose
    trailing sentinel columns hold a tile's last touch; the window-plan
    tolerances of test_cell_kernel_matches_reference."""
    ds = zipf_free_data() if data == "zipf" else sentinel_free_data()
    tabs = np_tables(ds.nu, ds.nv, 40, seed=6, gb=3.0)
    r = tf.FreeEpochRunner(ds, batch=1024 if data == "zipf" else 256,
                           mxu=mxu, saturate=saturate, groups_u=groups[0],
                           groups_v=groups[1], mxu_pred=mxu_pred,
                           device=cuda)
    if data == "sentinel":
        assert (r.plan.w.sum(axis=1) == 0).any()
    base = r.pad(params_from_numpy(*tabs, device=cuda))
    ref = tuple(t.clone() for t in base)
    before, runs = tf.free_epoch.launches, tf.FreeEpochRunner.launches
    tf.free_epoch_reference(*ref, r._dev[0], 0.02, 0.005, 3.0, 10.0, r.dim,
                            *groups, r.work_dtype, saturate, mxu_pred)
    assert r.route() == walk
    r.epoch(base, 0.02, 0.005, 3.0)
    torch.cuda.synchronize()
    assert tf.free_epoch.launches == before + 1
    assert tf.FreeEpochRunner.launches == runs + 1
    for a, b in zip(base, ref):
        assert float((a - b).abs().max()) <= atol
    start = r.pad(params_from_numpy(*tabs, device=cuda))
    assert float((base[1] - start[1]).abs().max()) > 1e-3  # it trained


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_free_walk_counters_across_launches(cuda, cluster):
    """Four epochs on the tile walk over two rotated plans that share one
    TileWalkCounters, nothing cleared between launches, at each cluster
    size: every launch takes the next generation and the ticket moves by
    the launch's units plus clusters; the tables stay within the f32
    window-plan tolerance of the plain version's four epochs."""
    ds = zipf_free_data()
    tabs = np_tables(ds.nu, ds.nv, 40, seed=6, gb=3.0)
    r = tf.FreeEpochRunner(ds, batch=1024, mxu="float32", n_plans=2,
                           device=cuda).materialize()
    cnt = r._counters
    assert all(p.walk.counters is cnt for p in r._dev)
    r._dev = [p._replace(walk=p.walk._replace(cluster=cluster))
              for p in r._dev]
    got = r.pad(params_from_numpy(*tabs, device=cuda))
    want = tuple(t.clone() for t in got)
    for it in range(4):
        eta = 0.02 / (1 + it)
        gen, base = cnt.gen, cnt.ticket_base
        plan = r._dev[it % 2]
        tf.free_epoch_reference(*want, plan, eta, 0.005, 3.0,
                                max(1.0, 0.2 / eta), r.dim,
                                r.pick_theta_groups(eta),
                                r.pick_phi_groups(eta), r.work_dtype,
                                r.saturate, r.mxu_pred)
        r.epoch(got, eta, 0.005, 3.0, epoch_idx=it)
        torch.cuda.synchronize()
        units = plan.walk.walks[0].n_units
        assert cnt.gen == gen + 1
        assert 1 <= cnt.ticket_base - base - units <= min(units, 132)
        # every cluster drew one ticket past the last unit
        assert int(cnt.counters[-1]) & 0xFFFFFFFF == cnt.ticket_base
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_free_walk_launch_failures_raise(cuda):
    """A free tile walk the card cannot launch raises and counts nothing:
    clusters of 32 blocks (past the 16 a cluster can hold) and a walk on
    another device's counters."""
    from tpu_mf_torch.ops import tile_walk as tw

    r = tf.FreeEpochRunner(zipf_free_data(), batch=1024, device=cuda)
    theta, phi = r.pad(params_from_numpy(*np_tables(380, 500, 40, 6, 3.0),
                                         device=cuda))
    plan = r._dev[0]
    args = (0.02, 0.005, 3.0, 10.0, 40, 8, 8)
    before = tf.free_epoch.launches
    for bad, err in ((plan.walk._replace(cluster=32), RuntimeError),
                     (plan.walk._replace(
                         counters=tw.TileWalkCounters(1, 1, "cpu")),
                      ValueError)):
        with pytest.raises(err):
            tf.free_epoch(theta, phi, plan._replace(walk=bad), *args)
            torch.cuda.synchronize()
    assert tf.free_epoch.launches == before


@pytest.mark.cuda
def test_free_kernel_rejects_malformed_launches(cuda):
    """A wrong dtype, shape or device raises ValueError and launches
    nothing."""
    r = tf.FreeEpochRunner(zipf_free_data(), batch=1024, device=cuda)
    theta, phi = r.pad(params_from_numpy(*np_tables(380, 500, 40, 6, 3.0),
                                         device=cuda))
    plan = r._dev[0]
    args = (0.02, 0.005, 3.0, 10.0, 40, 8, 8)
    before = tf.free_epoch.launches
    for t, p, pl in ((theta.half(), phi, plan), (theta[:-1], phi, plan),
                     (theta, phi.cpu(), plan),
                     (theta, phi, plan._replace(r=plan.r.double())),
                     (theta, phi, plan._replace(u=plan.u[:, :4]))):
        with pytest.raises(ValueError):
            tf.free_epoch(t, p, pl, *args)
    assert tf.free_epoch.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("groups", ["8/8", "adaptive"])
@pytest.mark.parametrize("dim,pack", [(8, 8), (64, 1)])
@pytest.mark.parametrize("mxu,atol", [("float32", 1e-4), ("bfloat16", 2e-3)])
def test_mega_kernel_matches_reference(cuda, mxu, atol, dim, pack, groups):
    """MegaEpochRunner on csrc/cell_sgd.cu against cell_epoch_reference on
    the card, at pack 8 (tiles 256) and pack 1 (tiles 128, mxu_pred on),
    with all-sentinel pad batches (mega 5), saturating, pinned and
    adaptive groups; the tolerances of test_cell_kernel_matches_reference."""
    ds = synthetic_ratings(500, 400, 40000, rank=3, noise=0.3, seed=5,
                           zipf=1.0, zipf_q=20.0)
    tabs = np_tables(ds.nu, ds.nv, dim, seed=6, gb=3.0)
    fixed = dict(theta_groups=8, phi_groups=8) if groups == "8/8" else {}
    tile = 256 if pack == 8 else 128
    r = tm.MegaEpochRunner(ds, dim=dim, tile_u=tile, tile_v=tile, batch=1024,
                           seed=7, mega=5, mxu=mxu, saturate=True,
                           device=cuda, **fixed)
    assert r.pack == pack and r.mxu_pred == (pack == 1)
    unpadded = tpk.prepare_cells_packed(ds, tile, tile, 1024, 7, pack)
    assert r.plan.u.shape[0] > unpadded.u.shape[0]  # pad batches
    eta = 0.05 if groups == "8/8" else 0.19 / max(r._dup_max[2],
                                                   r._vdup_max[2])
    tg, pg = r.pick_theta_groups(eta), r.pick_phi_groups(eta)
    assert (tg, pg) == (8, 8) if groups == "8/8" else max(tg, pg) <= 2
    base = r.pad(params_from_numpy(*tabs, device=cuda))
    ref = tuple(t.clone() for t in base)
    before, runs = tc.cell_epoch.launches, tm.MegaEpochRunner.launches
    tc.cell_epoch_reference(*ref, r._dev[0], eta, 0.005, 3.0,
                            max(1.0, 0.2 / eta), r.dim, tg, pg,
                            r.work_dtype, True, r.mxu_pred)
    r.epoch(base, eta, 0.005, 3.0)
    torch.cuda.synchronize()
    assert tc.cell_epoch.launches == before + 1
    assert tm.MegaEpochRunner.launches == runs + 1
    for a, b in zip(base, ref):
        assert float((a - b).abs().max()) <= atol
    start = r.pad(params_from_numpy(*tabs, device=cuda))
    assert float((base[0] - start[0]).abs().max()) > 1e-3  # it trained


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [(8, 8), (2, 4), (1, 1)],
                         ids=lambda g: f"{g[0]}/{g[1]}")
@pytest.mark.parametrize("mxu,atol", [("float32", 1e-4), ("bfloat16", 2e-3)])
def test_cell_kernel_at_groups(cuda, mxu, atol, groups):
    """cell_epoch against cell_epoch_reference at pinned groups 8/8, 2/4
    and 1/1 (steps of 1, 2 and 8 columns), on a gen-1 plan whose
    consecutive batches share a user tile and whose consecutive columns
    share an item tile; the tolerances of
    test_cell_kernel_matches_reference."""
    ds = synthetic_ratings(500, 400, 40000, rank=3, noise=0.3, seed=5,
                           zipf=1.0, zipf_q=20.0)
    tg, pg = groups
    r = tc.CellEpochRunner(ds, tile_u=96, tile_v=80, batch=1024, seed=7,
                           mxu=mxu, saturate=True, theta_groups=tg,
                           phi_groups=pg, device=cuda)
    gu, gv = r.plan.gu, r.plan.gv
    assert (gu[1:] == gu[:-1]).any() and (gv[:, 1:] == gv[:, :-1]).any()
    base = r.pad(params_from_numpy(*np_tables(ds.nu, ds.nv, 40, 6, 3.0),
                                   device=cuda))
    ref = tuple(t.clone() for t in base)
    eta = 0.02
    assert (r.pick_theta_groups(eta), r.pick_phi_groups(eta)) == groups
    tc.cell_epoch_reference(*ref, r._dev[0], eta, 0.005, 3.0, 10.0, r.dim,
                            tg, pg, r.work_dtype, True, r.mxu_pred)
    before = tc.cell_epoch.launches
    r.epoch(base, eta, 0.005, 3.0)
    torch.cuda.synchronize()
    assert tc.cell_epoch.launches == before + 1
    for a, b in zip(base, ref):
        assert float((a - b).abs().max()) <= atol


def stream_file(tmp_path):
    """A proto-frame training file of 300 x 200, 16k ratings."""
    from tpu_mf_torch.data.proto import write_block_frames

    ds = synthetic_ratings(300, 200, 16000, rank=3, noise=0.2, seed=8)
    path = str(tmp_path / "train.pb")
    write_block_frames(path, ds)
    return path, ds


@pytest.mark.cuda
@pytest.mark.parametrize("mxu,atol", [("float32", 1e-4), ("bfloat16", 2e-3)])
def test_fused_stream_trainer_on_gpu_matches_cpu(cuda, tmp_path, mxu, atol):
    """FusedStreamTrainer on cuda (one cell_sgd launch per shard, plans
    staged by the Prefetcher on its side stream) against the same trainer
    on the CPU (the kernel's plain version), 2 epochs over 3+ shards; the
    kernel's tolerances, carried by the second epoch."""
    from tpu_mf_torch.io.stream_fused import FusedStreamTrainer

    path, ds = stream_file(tmp_path)
    kw = dict(tile_u=32, tile_v=32, batch=256, mem_limit=4000, seed=2,
              mxu=mxu)
    gpu = FusedStreamTrainer(path, device=cuda, **kw)
    cpu = FusedStreamTrainer(path, device="cpu", **kw)
    assert gpu.store.n_shards >= 3
    tabs = np_tables(gpu.nu, gpu.nv, 16, 3, float(ds.r.mean()))
    tg = gpu.pad(params_from_numpy(*tabs, device=cuda))
    tcpu = cpu.pad(params_from_numpy(*tabs, device="cpu"))
    before, runs = tc.cell_epoch.launches, FusedStreamTrainer.launches
    with recording() as recs:
        for it in (1, 2):
            gpu.epoch(tg, 0.02 / it, 0.01, float(tabs[4]), epoch_idx=it)
            cpu.epoch(tcpu, 0.02 / it, 0.01, float(tabs[4]), epoch_idx=it)
    torch.cuda.synchronize()
    assert tc.cell_epoch.launches == before + 2 * gpu.store.n_shards
    assert FusedStreamTrainer.launches == runs + 2 * gpu.store.n_shards
    for a, b in zip(gpu.trim(tg)[:4], cpu.trim(tcpu)[:4]):
        assert float((a.cpu() - b).abs().max()) <= atol
    gpu_subs = [r for r in recs if r["name"] == "tmf.sub_epoch"
                and r["device_ms"] is not None]
    assert len(gpu_subs) == 2 * gpu.store.n_shards
    assert all(r["device_ms"] >= 0 for r in gpu_subs)
    gpu.close()
    cpu.close()


@pytest.mark.cuda
def test_prefetcher_side_stream_under_allocator_pressure(cuda):
    """Items staged on the Prefetcher's side stream arrive intact while
    the consumer's stream is busy and the caching allocator recycles
    memory: each batch is read on the consumer's stream after a long
    kernel, the staged tensors are dropped, and new allocations churn
    between batches; every sum equals the source's."""
    from tpu_mf_torch.io.stream import Prefetcher

    rng = np.random.default_rng(0)
    src = [rng.integers(0, 1000, 1 << 20).astype(np.int64)
           for _ in range(24)]
    pf = Prefetcher(iter(src), fly=4, device=cuda)
    sums = []
    busy = torch.randn(2048, 2048, device=cuda)
    for x in pf:
        for _ in range(8):  # keep the consumer's stream busy
            busy = busy @ busy
            busy /= busy.norm()
        sums.append(x.sum())
        del x
        junk = [torch.empty(1 << 20, dtype=torch.int64, device=cuda)
                .fill_(-1) for _ in range(4)]
        del junk
    pf.close()
    torch.cuda.synchronize()
    assert [int(s) for s in sums] == [int(a.sum()) for a in src]


@pytest.mark.cuda
def test_streamed_mf_raises_when_the_kernel_cannot_build(cuda, tmp_path,
                                                         monkeypatch):
    """A streamed --alg mf run on cuda whose kernel cannot be built raises;
    it does not carry on per batch or on the CPU."""
    from tpu_mf_torch.train.loop import train_mf_stream

    path, _ = stream_file(tmp_path)

    def fail():
        raise RuntimeError("nvcc failed on cell_sgd.cu")

    monkeypatch.setattr(tc, "_cell_lib", fail)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        train_mf_stream(TrainConfig(dim=16, iters=1), path, device=cuda,
                        log=lambda _: None)


# ---- csrc/rating_sse.cu: the rating-set SSE of calc_mse -------------------

def sse_tables(dev, nu, nv, dim, dtype=torch.float32, seed=0):
    """Tables with test-RMSE-like residuals, made on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return (0.3 * torch.randn(*shape, generator=g, device=dev)).to(dtype)

    return MFParams(normal(nu, dim), normal(nv, dim), normal(nu), normal(nv),
                    torch.tensor(3.5, device=dev))


def sse_ratings(dev, nu, nv, n, seed=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    u = torch.randint(0, nu, (n,), generator=g, device=dev, dtype=torch.int32)
    v = torch.randint(0, nv, (n,), generator=g, device=dev, dtype=torch.int32)
    r = 1.0 + 4.0 * torch.rand(n, generator=g, device=dev)
    return u, v, r


# Kernel against plain version: both take each product in the storage type
# and sum the dot product and residual in float32, in different orders (a
# few float32 steps of a residual); the plain version sums each chunk's
# squared errors in float32 (~log2(chunk) steps). So 5e-6 relative.
SSE_RTOL = 5e-6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dim", [8, 64, 128, 30])
def test_rating_sse_matches_plain(cuda, dtype, dim):
    """One launch against ``calc_mse_reference`` on the same tables:
    16-byte loads at dims 8-128 (groups of 2-32 lanes), element loads at
    dim 30; n not a multiple of the 256 ratings of a block."""
    p = sse_tables(cuda, 3000, 2000, dim, getattr(torch, dtype))
    u, v, r = sse_ratings(cuda, 3000, 2000, 300_001)
    got, want = calc_mse(p, u, v, r), calc_mse_reference(p, u, v, r)
    assert abs(got - want) <= SSE_RTOL * want
    assert rs.sse_layout(p.theta, p.phi).vec == (dim != 30)


@pytest.mark.cuda
@pytest.mark.parametrize("runner", ["dense", "gen-1", "sharded"])
def test_rating_sse_reads_trimmed_views(cuda, runner):
    """The tables the runners' ``trim`` returns at dim 128 (``split_params``
    views of 256-lane fused rows; the gen-1 runner's after its balance
    maps, the item-sharded runner's after its maps and the shards'
    concatenation) are read in place: the same bits as their contiguous
    copies, and the plain version's sum."""
    nu, nv, dim = 5000, 3000, 128
    p = sse_tables(cuda, nu, nv, dim)
    rng = np.random.default_rng(7)
    mu = rng.permutation(nu + 120)[:nu] if runner != "dense" else None
    mv = rng.permutation(nv + 72)[:nv] if runner != "dense" else None
    th, ph = pad_params(p, nu + 120, nv + 72, mu, mv)
    if runner == "sharded":
        ph = torch.cat(torch.split(ph, 1024), 0)
    view = split_params(th, ph, nu, nv, dim, p.gb, mu, mv)
    assert view.theta.stride(0) == 256 and view.bu.stride(0) == 256
    copy = MFParams(*(t.contiguous() for t in view))
    u, v, r = sse_ratings(cuda, nu, nv, 200_000)
    got = calc_mse(view, u, v, r)
    assert got == calc_mse(copy, u, v, r)
    want = calc_mse_reference(copy, u, v, r)
    assert abs(got - want) <= SSE_RTOL * want


@pytest.mark.cuda
def test_rating_sse_at_the_dpmf_train_size(cuda):
    """The DP-SGLD train set's size at ML-10M, dim 128 (9M ratings over
    69,878 x 10,677 rows, views of fused tables): the plain version's sum,
    the same bits from two launches, and host int64 ids the bits of device
    int32 ones."""
    nu, nv, dim, n = 69_878, 10_677, 128, 9_000_000
    p = sse_tables(cuda, nu, nv, dim)
    th, ph = pad_params(p, nu, nv)
    view = split_params(th, ph, nu, nv, dim, p.gb)
    u, v, r = sse_ratings(cuda, nu, nv, n)
    first = rs.rating_sse(*view, u, v, r)
    second = rs.rating_sse(*view, u, v, r)
    assert torch.equal(first, second) and float(first[1]) == 0.0
    want = calc_mse_reference(view, u, v, r)
    assert abs(float(first[0]) / n - want) <= SSE_RTOL * want
    host = (u.cpu().numpy().astype(np.int64),
            v.cpu().numpy().astype(np.int64), r.cpu().numpy())
    assert calc_mse(view, *host) == float(first[0]) / n


@pytest.mark.cuda
def test_calc_mse_counts_one_launch_a_call(cuda):
    """Each ``calc_mse`` (and ``rmse``) on CUDA tables is one launch, on the
    kernel wrapper's count and in the innermost open span; an id outside
    the tables raises."""
    p = sse_tables(cuda, 300, 200, 16)
    u, v, r = sse_ratings(cuda, 300, 200, 5000)
    before = rs.rating_sse.launches
    with recording() as recs:
        with span("tmf.eval"):
            calc_mse(p, u, v, r)
            rmse(p, SimpleNamespace(u=u, v=v, r=r))
    assert rs.rating_sse.launches == before + 2
    assert recs[0]["attrs"]["launches"] == 2
    bad = u.clone()
    bad[4321] = 300
    with pytest.raises(IndexError):
        calc_mse(p, bad, v, r)


@pytest.mark.cuda
@pytest.mark.parametrize("alg", ["mf", "mf-nodense", "dpmf", "admf"])
def test_training_loops_launch_once_an_eval(cuda, alg):
    """Every test RMSE of an epoch, and each round's train MSE in dpmf, is
    one launch of ``csrc/rating_sse.cu``: 3 epochs launch 3 times (dense,
    gen-1 at dim 64, AdaptReg), 3 DP-SGLD rounds 6 times."""
    ds = synthetic_ratings(600, 400, 30000, rank=3, noise=0.2, seed=1)
    tr, te = ds.split(0.1, seed=2)
    opts = dict(RESUME_RUNS[alg.split("-")[0]], gb=tr.mean_rating())
    if alg == "mf-nodense":
        opts["use_dense"] = False
    before = rs.rating_sse.launches
    train_any(TrainConfig(iters=3, **opts), tr, te, cuda)
    assert rs.rating_sse.launches - before == (6 if alg == "dpmf" else 3)
