"""Gen-1 cell-plan epochs of the PyTorch port against tpu_mf's Pallas
kernel (interpret mode), on the same numpy-made tables and datasets: the
plan builders bit for bit, the plain epoch to float tolerance, and the plan
cache across the two packages."""

import os
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_mf.data.coo import synthetic_ratings
from tpu_mf.models.mf import MFParams as JaxParams
from tpu_mf.ops import pallas_sgd as jp
from tpu_mf.ops import pallas_sgd_packed as jpk
from tpu_mf.ops import pallas_sgd_slot as jsl
from tpu_mf.ops import plan_cache as jcache
from tpu_mf_torch.models.mf import params_from_numpy, params_to_numpy
from tpu_mf_torch.ops import plan_cache as tcache
from tpu_mf_torch.ops import sgd_cells as tc
from tpu_mf_torch.ops import sgd_packed as tpk
from tpu_mf_torch.ops import sgd_slot as tsl

torch.set_num_threads(1)


def np_tables(nu, nv, dim, seed, gb):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1e-1, (nu, dim)).astype(np.float32),
            rng.normal(0, 1e-1, (nv, dim)).astype(np.float32),
            rng.normal(0, 1e-1, nu).astype(np.float32),
            rng.normal(0, 1e-1, nv).astype(np.float32), np.float32(gb))


def zipfy(nu, nv, n, seed, q):
    return synthetic_ratings(nu, nv, n, rank=3, noise=0.1, seed=seed,
                             zipf=1.0, zipf_q=q, zipf_u=1.0, zipf_uq=q)


PLAN_SHAPES = {
    "uniform": (lambda: synthetic_ratings(300, 200, 5000, seed=0),
                (128, 128, 256)),
    "zipfy": (lambda: zipfy(600, 400, 30000, 21, 5.0), (128, 96, 512)),
    "ragged": (lambda: synthetic_ratings(130, 70, 1500, seed=7),
               (64, 32, 128)),
}


def assert_plans_equal(a, b):
    for name in jp.CellPlan._fields:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=name)
            assert x.dtype == y.dtype, name
        else:
            assert x == y, name


@pytest.mark.parametrize("shape", sorted(PLAN_SHAPES))
def test_plan_builders_bit_equal(shape):
    """prepare_cells, balance_cells, _apply_flags, _dup_stats, pad_plan_nb
    and pick_cell_geometry give tpu_mf's arrays exactly."""
    make, (tu, tv, b) = PLAN_SHAPES[shape]
    ds = make()
    assert_plans_equal(tc.prepare_cells(ds, tu, tv, b, seed=3),
                       jp.prepare_cells(ds, tu, tv, b, seed=3))
    tds, tmu, tmv = tc.balance_cells(ds, tu, tv)
    jds, jmu, jmv = jp.balance_cells(ds, tu, tv)
    for x, y in ((tmu, jmu), (tmv, jmv), (tds.u, jds.u), (tds.v, jds.v),
                 (tds.r, jds.r)):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype
    assert (tds.nu, tds.nv) == (jds.nu, jds.nv)
    plan = tc.prepare_cells(tds, tu, tv, b, seed=5)
    assert_plans_equal(plan, jp.prepare_cells(jds, tu, tv, b, seed=5))
    for g in (1, 2, 4):
        np.testing.assert_array_equal(tc._apply_flags(plan.gv, g),
                                      jp._apply_flags(plan.gv, g))
    assert tc._dup_stats(plan.u, tu) == jp._dup_stats(plan.u, tu)
    assert tc._dup_stats(plan.v, tv) == jp._dup_stats(plan.v, tv)
    nb = plan.u.shape[0] + 3
    assert_plans_equal(tc.pad_plan_nb(plan, nb), jp.pad_plan_nb(plan, nb))
    assert tc.pick_cell_geometry(ds) == jp.pick_cell_geometry(ds)
    assert tc.pick_cell_geometry(ds, 128) == jp.pick_cell_geometry(ds, 128)


def test_routing_predicates_match():
    """pallas_eligible, packed_eligible and slot_eligible give tpu_mf's
    answers across dims and catalog sizes (they read only the shapes)."""
    for dim in (8, 13, 14, 29, 30, 61, 62, 64, 126, 253, 300, 2048):
        for nv in (150, 40_000, 50_000, 131_072, 131_073, 140_000, 600_000):
            p = types.SimpleNamespace(theta=np.empty((0, dim)),
                                      phi=np.empty((nv, 0)))
            assert tc.pallas_eligible(p, 4096) == jp.pallas_eligible(p, 4096)
            assert (tpk.packed_eligible(p, 4096)
                    == jpk.packed_eligible(p, 4096))
            assert tsl.slot_eligible(p, 4096) == jsl.slot_eligible(p, 4096)
    big = types.SimpleNamespace(theta=np.empty((0, 4000)),
                                phi=np.empty((10, 0)))
    assert not tc.pallas_eligible(big, 4096)


# (dataset, dim, runner options, eta, epochs, atol). atol 2e-5 (3e-5 at
# dim 300, three lane groups): the float32 working type on both sides, sums
# of the same f32 terms in another order, the tolerances of
# tests/test_pallas_sgd.py for the same cases.
EPOCH_CASES = {
    # tests/test_pallas_sgd.py:50, groups pinned: fully sequential windows
    "groups_8_8": (lambda: synthetic_ratings(300, 200, 4000, rank=3, seed=2),
                   8, dict(tile_u=128, tile_v=128, batch=256, seed=3,
                           theta_groups=8, phi_groups=8), 0.05, 1, 2e-5),
    # adaptive groups at a small eta: theta windows of 2 columns, one phi
    # window of 8 with deferred ap applies
    "adaptive": (lambda: synthetic_ratings(400, 200, 6000, rank=3, seed=9),
                 8, dict(tile_u=128, tile_v=128, batch=512, seed=11),
                 0.015, 1, 2e-5),
    # tests/test_pallas_sgd.py:227, warm eta on zipfy heads: the cap binds
    "saturate": (lambda: zipfy(300, 200, 8000, 33, 2.0), 8,
                 dict(tile_u=128, tile_v=128, batch=512, seed=34,
                      saturate=True, theta_groups=8, phi_groups=8),
                 0.1, 1, 2e-5),
    # tests/test_pallas_sgd.py:184, relabeled ids through pad/trim
    "balance": (lambda: zipfy(300, 200, 5000, 21, 5.0), 8,
                dict(tile_u=128, tile_v=128, batch=256, seed=22,
                     balance=True, saturate=True), 0.05, 1, 2e-5),
    # tests/test_pallas_sgd.py:119, two lane groups with mxu_pred
    "dim128": (lambda: synthetic_ratings(200, 150, 1500, rank=3, seed=12),
               128, dict(tile_u=128, tile_v=128, batch=256, seed=13,
                         theta_groups=8, phi_groups=8), 0.03, 1, 2e-5),
    # tests/test_pallas_sgd.py:264, three lane groups, mxu_pred off
    "dim300": (lambda: synthetic_ratings(120, 90, 1500, rank=3, seed=7),
               300, dict(tile_u=64, tile_v=64, batch=128, seed=8,
                         theta_groups=8, phi_groups=8), 0.02, 1, 3e-5),
    # two shuffled plans rotated over two epochs, adaptive groups (4/4,
    # then 1/1 as eta halves)
    "two_plans": (lambda: synthetic_ratings(300, 200, 4000, rank=3, seed=2),
                  8, dict(tile_u=128, tile_v=128, batch=256, seed=3,
                          n_plans=2, saturate=True), 0.03, 2, 2e-5),
}


@pytest.mark.parametrize("case", sorted(EPOCH_CASES))
def test_cell_epoch_matches_pallas(case):
    """CellEpochRunner epochs (plain version, f32) against tpu_mf's
    PallasEpochRunner(mxu="float32", interpret=True) on the same plans."""
    make, dim, kw, eta, epochs, atol = EPOCH_CASES[case]
    ds = make()
    tabs = np_tables(ds.nu, ds.nv, dim, seed=1, gb=3.0)
    jr = jp.PallasEpochRunner(ds, mxu="float32", interpret=True, **kw)
    tr = tc.CellEpochRunner(ds, mxu="float32", device="cpu", **kw)
    jt = jr.pad(JaxParams(*(jnp.asarray(t) for t in tabs)))
    tt = tr.pad(params_from_numpy(*tabs, device="cpu"))
    assert tr.mxu_pred == jr.mxu_pred
    groups = set()
    for it in range(1, epochs + 1):
        e = eta / it
        g = (tr.pick_theta_groups(e), tr.pick_phi_groups(e))
        assert g == (jr.pick_theta_groups(e), jr.pick_phi_groups(e))
        groups.add(g)
        jt = jr.epoch(jt, e, 0.01, 3.0, epoch_idx=it)
        tt = tr.epoch(tt, e, 0.01, 3.0, epoch_idx=it)
    if case == "adaptive":
        assert groups == {(4, 1)}
    if case == "two_plans":
        assert groups == {(4, 4), (1, 1)}
    got, want = params_to_numpy(tr.trim(tt))[:4], jr.trim(jt)[:4]
    for a, b, t in zip(got, want, tabs):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=atol)
        assert np.abs(a - t).max() > 10 * atol  # it trained
    th, ph = (x.numpy() for x in tt)
    np.testing.assert_array_equal(th[tr._map_u if tr._map_u is not None
                                     else slice(ds.nu), dim + 1], 1.0)
    np.testing.assert_array_equal(ph[:, dim + 2], 0.0)


def test_cell_epoch_bf16_matches_pallas():
    """The bf16 working type against tpu_mf's interpret-mode bf16 kernel
    (rows, t*p and the scatter operands rounded to bf16, f32 sums). atol
    1e-4: a rounding may flip where the f32 value rounded differs in its
    last bit between the two sums' orders, one bf16 step of a delta."""
    ds = synthetic_ratings(300, 200, 4000, rank=3, seed=2)
    tabs = np_tables(ds.nu, ds.nv, 8, seed=1, gb=3.0)
    kw = dict(tile_u=128, tile_v=128, batch=256, seed=3)
    jr = jp.PallasEpochRunner(ds, mxu="bfloat16", interpret=True, **kw)
    tr = tc.CellEpochRunner(ds, mxu="bfloat16", device="cpu", **kw)
    jt = jr.epoch(jr.pad(JaxParams(*(jnp.asarray(t) for t in tabs))),
                  0.05, 0.01, 3.0)
    tt = tr.epoch(tr.pad(params_from_numpy(*tabs, device="cpu")),
                  0.05, 0.01, 3.0)
    for a, b in zip(params_to_numpy(tr.trim(tt))[:4], jr.trim(jt)[:4]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-4)


def test_balance_pad_trim_roundtrip_is_exact():
    """pad then trim through the balance maps gives the tables back bit
    for bit (tpu_mf's test_balance_roundtrip_and_training, part a); with
    nb_round the rotated plans share one batch count, as tpu_mf's do."""
    ds = zipfy(600, 400, 30000, 21, 5.0)
    tabs = np_tables(ds.nu, ds.nv, 8, seed=4, gb=3.0)
    kw = dict(tile_u=128, tile_v=128, batch=256, seed=22, balance=True,
              n_plans=2, nb_round=16)
    r = tc.CellEpochRunner(ds, device="cpu", **kw)
    back = params_to_numpy(r.trim(r.pad(params_from_numpy(*tabs,
                                                          device="cpu"))))
    for a, b in zip(back[:4], tabs[:4]):
        np.testing.assert_array_equal(a, b)
    jr = jp.PallasEpochRunner(ds, mxu="float32", interpret=True, **kw)
    for got, want in zip(r.plans, jr.plans):
        assert got.u.shape[0] % 16 == 0
        assert_plans_equal(got, want)


def test_cell_epoch_rejects_bad_groups_and_devices():
    ds = synthetic_ratings(100, 80, 500, seed=0)
    with pytest.raises(ValueError):
        tc.CellEpochRunner(ds, tile_u=32, tile_v=32, batch=64, theta_groups=3,
                           device="cpu")
    r = tc.CellEpochRunner(ds, tile_u=32, tile_v=32, batch=64, device="cpu")
    tables = r.pad(params_from_numpy(*np_tables(100, 80, 8, 0, 3.0),
                                     device="cpu"))
    plan = r._dev[0]
    with pytest.raises(ValueError):
        tc.cell_epoch(*tables, plan, 0.01, 0.01, 3.0, 20.0, 8, 8, 3)
    meta = tuple(t.to("meta") for t in tables)
    with pytest.raises(ValueError):
        tc.cell_epoch(*meta, plan, 0.01, 0.01, 3.0, 20.0, 8, 8, 8)


def test_plan_cache_shared_with_tpu_mf(tmp_path, monkeypatch):
    """A plan the port caches is read back equal, and tpu_mf reads the same
    file (and the port reads tpu_mf's): same variable, key and layout."""
    monkeypatch.setenv("TPU_MF_PLAN_CACHE", str(tmp_path))
    monkeypatch.setattr(tcache, "MIN_RATINGS", 100)
    monkeypatch.setattr(jcache, "MIN_RATINGS", 100)
    ds = synthetic_ratings(100, 80, 2000, seed=0)
    first = tc.prepare_cells(ds, 32, 32, 64, seed=1)
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].startswith("cell.")
    assert_plans_equal(tc.prepare_cells(ds, 32, 32, 64, seed=1), first)
    assert_plans_equal(jp.prepare_cells(ds, 32, 32, 64, seed=1), first)
    assert os.listdir(tmp_path) == files  # tpu_mf hit the port's entry
    jfirst = jp.prepare_cells(ds, 32, 32, 64, seed=2)
    assert len(os.listdir(tmp_path)) == 2
    assert_plans_equal(tc.prepare_cells(ds, 32, 32, 64, seed=2), jfirst)
    monkeypatch.setenv("TPU_MF_PLAN_CACHE", "0")
    assert tcache.cache_dir() is None
