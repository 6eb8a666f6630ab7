"""Dense-cell epoch of the PyTorch port against tpu_mf's Pallas kernel
(interpret mode, f32), on the same numpy-made tables and datasets."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_mf.data.coo import RatingsCOO, synthetic_ratings
from tpu_mf.models.mf import MFParams as JaxParams
from tpu_mf.ops import pallas_sgd_dense as jd
from tpu_mf_torch.models.mf import params_from_numpy, params_to_numpy
from tpu_mf_torch.ops import sgd_dense as td

torch.set_num_threads(1)


def np_tables(nu, nv, dim, seed, gb):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1e-1, (nu, dim)).astype(np.float32),
            rng.normal(0, 1e-1, (nv, dim)).astype(np.float32),
            rng.normal(0, 1e-1, nu).astype(np.float32),
            rng.normal(0, 1e-1, nv).astype(np.float32), np.float32(gb))


def run_both(ds, tabs, tiles, eta, lam, saturate):
    """One epoch through each package's DenseEpochRunner (f32 working type),
    as tests/test_dense_kernel.py runs tpu_mf's."""
    tu, tv, k = tiles
    gb = float(tabs[4])
    jr = jd.DenseEpochRunner(ds, tile_u=tu, tile_v=tv, k_cells=k,
                             mxu="float32", interpret=True, saturate=saturate)
    jt = jr.pad(JaxParams(*(jnp.asarray(t) for t in tabs)))
    want = jr.trim(jr.epoch(jt, eta, lam, gb))
    tr = td.DenseEpochRunner(ds, tile_u=tu, tile_v=tv, k_cells=k,
                             mxu="float32", saturate=saturate, device="cpu")
    tt = tr.pad(params_from_numpy(*tabs, device="cpu"))
    got = tr.trim(tr.epoch(tt, eta, lam, gb))
    return params_to_numpy(got)[:4], [np.asarray(x) for x in want[:4]]


@pytest.mark.parametrize("saturate", [False, True])
@pytest.mark.parametrize("tiles", [(16, 16, 4), (8, 16, 2)])
def test_dense_epoch_matches_pallas(saturate, tiles):
    """Several user and item tiles (4x4 and 8x4 cell grids, item axis padded
    by k_cells), so the diagonal order must reproduce the TPU's row-major
    walk. atol 2e-5: f32 throughout; the two sides sum the tile products in
    different orders (and the port takes dphi from E^T, not S^T/W^T)."""
    ds = synthetic_ratings(60, 40, 1500, rank=3, noise=0.2, seed=0)
    tabs = np_tables(ds.nu, ds.nv, 8, seed=1, gb=3.0)
    got, want = run_both(ds, tabs, tiles, 0.03, 0.01, saturate)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)


def test_dense_duplicate_pairs_match_pallas():
    """k duplicate (u, v) ratings in one cell: S and W hold the sum and the
    multiplicity. Tolerance as above."""
    u = np.array([0, 0, 0, 1, 2, 2, 9, 9], np.int32)
    v = np.array([1, 1, 1, 2, 0, 0, 12, 12], np.int32)
    r = np.array([4.0, 3.0, 5.0, 2.0, 1.0, 3.5, 4.5, 1.5], np.float32)
    ds = RatingsCOO(u=u, v=v, r=r, nu=16, nv=16)
    tabs = np_tables(16, 16, 4, seed=2, gb=2.0)
    got, want = run_both(ds, tabs, (8, 8, 1), 0.05, 0.02, False)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)


def test_dense_plan_and_cells_match():
    """Plan stats equal tpu_mf's; the cell matrices built on the device
    equal DensePlan.host_matrices() exactly (integer counts, f32 sums of
    at most a few ratings)."""
    ds = synthetic_ratings(100, 80, 4000, rank=2, seed=4)
    jp = jd.prepare_dense(ds, 32, 32, 2)
    tp = td.prepare_dense(ds, 32, 32, 2)
    for f in ("n_gu", "n_gv", "n_gvp", "max_ku", "max_kv", "mean_ku",
              "mean_kv", "max_w", "wless", "n_real"):
        assert getattr(tp, f) == getattr(jp, f), f
    np.testing.assert_array_equal(tp.flat, jp.flat.astype(np.int64))
    s, w, st, wt = jp.host_matrices()
    cells = td.densify(tp, torch.float32, "cpu")
    np.testing.assert_array_equal(cells.s.numpy(), s)
    np.testing.assert_array_equal(cells.w.to(torch.float32).numpy(), w)
    assert cells.w.dtype == torch.int8  # max_w <= 127
    np.testing.assert_array_equal(cells.ku.numpy(), w.sum(3))
    np.testing.assert_array_equal(cells.kv.numpy(), wt.sum(3))
    np.testing.assert_array_equal(np.swapaxes(s, 2, 3), st)


def test_dense_schedule_rules_match():
    """dense_engage_epoch and dense_eligible give tpu_mf's answers on the
    shapes of tests/test_dense_kernel.py::test_dense_schedule_engagement,
    so both packages engage the dense kernel at the same epoch."""
    from tpu_mf.config import TrainConfig

    ds = synthetic_ratings(400, 250, 30000, rank=3, seed=8, zipf=1.2)
    assert td.pick_dense_tiles(ds.nu, ds.nv) == jd.pick_dense_tiles(
        ds.nu, ds.nv)
    tu, tv = td.pick_dense_tiles(ds.nu, ds.nv)
    jp, tp = jd.prepare_dense(ds, tu, tv), td.prepare_dense(ds, tu, tv)
    maxk = max(jp.max_ku, jp.max_kv)
    for dim, eta in ((64, 5.0 / maxk), (8, 3.0 / maxk), (8, 20.0 / maxk)):
        cfg = TrainConfig(dim=dim, iters=6, eta=eta, gam=1.0)
        for start in (0, 2):
            assert (td.dense_engage_epoch(cfg.eta_at, 6, dim, tp, start)
                    == jd.dense_engage_epoch(cfg.eta_at, 6, dim, jp, start))
        assert td.pick_k_cells(9, dim) == jd.pick_k_cells(9, dim)
    big = RatingsCOO(u=np.zeros(1, np.int32), v=np.zeros(1, np.int32),
                     r=np.ones(1, np.float32), nu=480_189, nv=17_770)
    for d in (ds, big):
        for dim in (8, 64, 300, 4000):
            tabs = np_tables(2, 2, dim, seed=0, gb=0.0)
            assert td.dense_eligible(params_from_numpy(*tabs, device="cpu"),
                                     d) == jd.dense_eligible(
                JaxParams(*(jnp.asarray(t) for t in tabs)), d)
