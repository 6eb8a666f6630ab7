"""Item-sharded epochs of the PyTorch port (tpu_mf_torch/ops/phi_shard.py)
against tpu_mf's PhiShardedRunner: the geometry, the shard split and the
balance maps bit for bit (the Yahoo shape included), every inner plan bit
for bit at a budget that forces K >= 2, and sharded epochs against tpu_mf's
interpret-mode runner from the same numpy-made tables."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_mf.data.coo import RatingsCOO, synthetic_ratings
from tpu_mf.models.mf import MFParams as JaxParams
from tpu_mf.ops import phi_shard as jps
from tpu_mf.ops.pallas_sgd import _tile_balance_map as jax_balance_map
from tpu_mf_torch.config import TrainConfig
from tpu_mf_torch.models.mf import params_from_numpy, params_to_numpy
from tpu_mf_torch.ops import phi_shard as tps
from tpu_mf_torch.ops.sgd_cells import _tile_balance_map

torch.set_num_threads(1)

# a 128-lane f32 row budget of 128 rows: 2 item tiles of 64 a shard
# (tests/test_phi_shard.py:23)
TINY_BUDGET = 128 * 128 * 4


class Shape:
    """Only what the geometry chooser reads: nu, nv and the rating count."""

    def __init__(self, nu, nv, n):
        self.nu, self.nv, self.n = nu, nv, n

    def __len__(self):
        return self.n


# the reference's Yahoo workload (tpu_mf/ops/phi_shard.py:6; 90% of the
# 20M-rating stand-in of bench.py:315 for training), the ML-10M shape, a
# Netflix-like shape and a small catalog
SHAPES = {"yahoo": Shape(1_000_990, 624_961, 18_000_000),
          "ml10m": Shape(69_878, 10_677, 9_000_000),
          "netflix": Shape(480_189, 17_770, 100_000_000),
          "small": Shape(300, 260, 4000)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_geometry_and_shard_split_bit_equal(shape):
    """pick_cell_geometry_large, and phi_shard_tiles at every row width
    and three budgets, give tpu_mf's numbers; the Yahoo stand-in takes
    tiles 4096x2040, batch 4096, 18 shards at dim 128 and 9 at dim 64."""
    ds = SHAPES[shape]
    geo = tps.pick_cell_geometry_large(ds)
    assert geo == jps.pick_cell_geometry_large(ds)
    _, tv, _ = geo
    nv_pad = -(-ds.nv // tv) * tv
    for dim in (8, 64, 125, 128, 300, 2048):
        for budget in (tps.PHI_SHARD_BUDGET, 8 << 20, TINY_BUDGET):
            assert (tps.phi_shard_tiles(nv_pad, tv, dim, budget)
                    == jps.phi_shard_tiles(nv_pad, tv, dim, budget))
    assert tps.PHI_SHARD_BUDGET == jps.PHI_SHARD_BUDGET
    if shape == "yahoo":
        assert geo == (4096, 2040, 4096)
        assert tps.phi_shard_tiles(nv_pad, tv, 128)[1] == 18
        assert tps.phi_shard_tiles(nv_pad, tv, 64)[1] == 9


@pytest.mark.parametrize("shape", ["yahoo", "small"])
def test_balance_maps_bit_equal(shape):
    """The serpentine maps of both axes at the shape's tiles, on zipfy
    per-row counts (ties included), give tpu_mf's labels."""
    ds = SHAPES[shape]
    tu, tv, _ = tps.pick_cell_geometry_large(ds)
    rng = np.random.default_rng(5)
    for n, tile in ((ds.nu, tu), (ds.nv, tv)):
        counts = np.minimum(rng.zipf(1.3, n), 50_000)
        got = _tile_balance_map(counts, tile)
        want = jax_balance_map(counts, tile)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


def small(seed=2):
    return synthetic_ratings(300, 260, 4000, rank=3, seed=seed, zipf=0.8)


def np_tables(nu, nv, dim, seed=1, gb=3.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1e-1, (nu, dim)).astype(np.float32),
            rng.normal(0, 1e-1, (nv, dim)).astype(np.float32),
            rng.normal(0, 1e-1, nu).astype(np.float32),
            rng.normal(0, 1e-1, nv).astype(np.float32), np.float32(gb))


# tpu_mf's runner options of tests/test_phi_shard.py:93 (nb_round 4), with
# two rotated plans
KW = dict(dim=8, tile_u=64, tile_v=64, batch=256, seed=3, budget=TINY_BUDGET,
          n_plans=2, nb_round=4)


def test_inner_plans_bit_equal():
    """K >= 2 shards: the maps, the padded sizes and every inner plan
    (u, v, r, w, gu, gv of both rotated plans) equal tpu_mf's; every rating
    lands in one shard; the default geometry is the large-catalog pick."""
    ds = small()
    jr = jps.PhiShardedRunner(ds, mxu="float32", interpret=True, **KW)
    tr = tps.PhiShardedRunner(ds, mxu="float32", device="cpu", **KW)
    assert tr.n_shards == jr.n_shards >= 2
    for name in ("nu_pad", "nv_pad", "shard_rows", "tile_u", "tile_v",
                 "batch", "n_slots"):
        assert getattr(tr, name) == getattr(jr, name), name
    np.testing.assert_array_equal(tr._map_u, jr._map_u)
    np.testing.assert_array_equal(tr._map_v, jr._map_v)
    for ti, ji in zip(tr.inners, jr.inners):
        assert len(ti.plans) == len(ji.plans) == 2
        for tp, jp_ in zip(ti.plans, ji.plans):
            for f in ("u", "v", "r", "w", "gu", "gv"):
                a, b = getattr(tp, f), getattr(jp_, f)
                np.testing.assert_array_equal(a, b, err_msg=f)
                assert a.dtype == b.dtype, f
            assert (tp.n_gu, tp.n_gv, tp.n_real) == (jp_.n_gu, jp_.n_gv,
                                                     jp_.n_real)
    assert sum(int(i.plans[0].w.sum()) for i in tr.inners) == len(ds)
    d = tps.PhiShardedRunner(ds, dim=8, budget=TINY_BUDGET, device="cpu")
    assert (d.tile_u, d.tile_v, d.batch) == jps.pick_cell_geometry_large(ds)


# working type: (atol, epochs). f32: the same f32 terms summed in another
# order (the gen-1 tolerance of tests/test_torch_cells.py); bf16: a rounding
# may flip where the f32 value rounded differs in its last bit between the
# two sums' orders, one bf16 step of a delta
SHARDED_EPOCHS = {"float32": 2e-5, "bfloat16": 1e-4}


@pytest.mark.parametrize("mxu", sorted(SHARDED_EPOCHS))
def test_sharded_epochs_match_tpu_mf(mxu):
    """Two sharded epochs (plans rotated, adaptive groups, saturation) on
    CPU tensors against tpu_mf's interpret-mode runner from the same
    tables: every table within the working type's tolerance, and each
    shard's groups equal."""
    atol = SHARDED_EPOCHS[mxu]
    ds = small()
    tabs = np_tables(ds.nu, ds.nv, 8)
    jr = jps.PhiShardedRunner(ds, mxu=mxu, interpret=True, **KW)
    tr = tps.PhiShardedRunner(ds, mxu=mxu, device="cpu", **KW)
    jt = jr.pad(JaxParams(*(jnp.asarray(t) for t in tabs)))
    tt = tr.pad(params_from_numpy(*tabs, device="cpu"))
    assert len(tt[1]) == tr.n_shards
    for it in (1, 2):
        eta = 0.03 / it
        for ti, ji in zip(tr.inners, jr.inners):
            assert (ti.pick_theta_groups(eta), ti.pick_phi_groups(eta)) == (
                ji.pick_theta_groups(eta), ji.pick_phi_groups(eta))
        jt = jr.epoch(jt, eta, 0.01, 3.0, epoch_idx=it)
        tt = tr.epoch(tt, eta, 0.01, 3.0, epoch_idx=it)
    got, want = params_to_numpy(tr.trim(tt)), jr.trim(jt)
    for a, b, t in zip(got[:4], want[:4], tabs):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=atol)
        assert np.abs(a - t).max() > 10 * atol  # it trained
    assert got[4] == float(want.gb)


def big_catalog():
    """nv past pallas_eligible at dim 64 (the fused item table > 64 MiB);
    tests/test_torch_slice.py's big_catalog."""
    rng = np.random.default_rng(0)
    return RatingsCOO(u=rng.integers(0, 200, 3000),
                      v=rng.integers(0, 140_000, 3000),
                      r=rng.uniform(1, 5, 3000), nu=200, nv=140_000)


def test_schedule_picks_the_sharded_runner_and_logs_tpu_mf_line():
    """Past pallas_eligible the schedule is one sharded phase from the
    first epoch (from the resumed round's next one too), with tpu_mf's log
    line word for word and tpu_mf's geometry and shard count."""
    from tpu_mf.train.loop import _mf_runner_schedule as jax_schedule
    from tpu_mf_torch.train.loop import _mf_runner_schedule

    ds = big_catalog()
    cfg = TrainConfig(dim=64, iters=3, gb=3.0)
    tabs = np_tables(ds.nu, ds.nv, 64)
    for start in (0, 2):
        jlog, tlog = [], []
        want = jax_schedule(cfg, ds,
                            JaxParams(*(jnp.asarray(t) for t in tabs)),
                            jlog.append, start)
        got = _mf_runner_schedule(cfg, ds,
                                  params_from_numpy(*tabs, device="cpu"),
                                  tlog.append, start)
        assert tlog == jlog and len(got) == len(want) == 1
        (ep, r), (jep, jr) = got[0], want[0]
        assert ep == jep == start + 1
        assert type(r) is tps.PhiShardedRunner
        assert (r.n_shards, r.tile_u, r.tile_v, r.batch, r.shard_rows) == (
            jr.n_shards, jr.tile_u, jr.tile_v, jr.batch, jr.shard_rows)
        assert len(r.inners[0].plans) == 2
