"""The free-column family of the PyTorch port against tpu_mf's
FreeEpochRunner in interpret mode, on the same numpy-made tables and
datasets: the plans, the geometry, the predicates and the window
statistics bit for bit, the apply flags, epochs through the plain version
to float tolerance, the runner's whole pad / epochs / trim path, and the
column replay where tpu_mf's kernel drops deferred deltas (ROADMAP Queue 3
item 8)."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mf.data.coo import synthetic_ratings
from tpu_mf.models.mf import MFParams as JaxParams
from tpu_mf.models.mf import rmse as jax_rmse
from tpu_mf.ops import pallas_sgd_free as jf
from tpu_mf.ops.sgd import sgd_batch_update
from tpu_mf_torch.models.mf import params_from_numpy, params_to_numpy, rmse
from tpu_mf_torch.ops import sgd_cells as tc
from tpu_mf_torch.ops import sgd_free as tf

torch.set_num_threads(1)
ETA, LAM = 2e-2, 5e-3


def np_tables(nu, nv, dim, seed, gb=2.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1e-1, (nu, dim)).astype(np.float32),
            rng.normal(0, 1e-1, (nv, dim)).astype(np.float32),
            rng.normal(0, 1e-1, nu).astype(np.float32),
            rng.normal(0, 1e-1, nv).astype(np.float32), np.float32(gb))


def assert_plans_equal(a, b):
    assert type(a).__name__ == type(b).__name__ and a._fields == b._fields
    for name in b._fields:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=name)
            assert x.dtype == y.dtype, name
        else:
            assert x == y, name


class Sized(SimpleNamespace):
    """A dataset's shape alone: what the geometry picker reads."""

    def __len__(self):
        return self.n


def pallas_data():
    """tests/test_pallas_free.py's data: 3 x 2 tiles of 128, no sentinel
    column shares a tile with a real one."""
    return synthetic_ratings(300, 200, 4000, seed=5)


def sentinel_data():
    """One item tile (n_gv 1): the last batch's 5 sentinel columns share
    item tile 0 with its real columns."""
    return synthetic_ratings(300, 100, 3100, seed=5)


def runners(ds, **kw):
    kw = dict(dict(tile_u=128, tile_v=128, batch=256, seed=0,
                   mxu="float32"), **kw)
    return (tf.FreeEpochRunner(ds, device="cpu", **kw),
            jf.FreeEpochRunner(ds, interpret=True, **kw))


def run_both(tr, jr, tabs, etas, lam=LAM):
    gb = float(tabs[4])
    tt = tr.pad(params_from_numpy(*tabs, device="cpu"))
    jt = jr.pad(JaxParams(*(jnp.asarray(t) for t in tabs)))
    for it, eta in enumerate(etas):
        tt = tr.epoch(tt, eta, lam, gb, epoch_idx=it)
        jt = jr.epoch(jt, eta, lam, gb, epoch_idx=it)
    return tr.trim(tt), jr.trim(jt)


def assert_close(got, want, tabs, atol):
    for a, b, t in zip(got[:4], want[:4], tabs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=atol)
        assert np.abs(a.numpy() - t).max() > 10 * min(atol, 1e-3)  # trained


@pytest.mark.parametrize("balance", [False, True])
def test_free_plans_bit_equal(balance):
    """prepare_cells_free and the runner's plans and balance maps (two
    rotated plans) are tpu_mf's in every field."""
    ds = synthetic_ratings(500, 300, 9000, seed=3, zipf=0.8)
    assert_plans_equal(tf.prepare_cells_free(ds, 128, 128, 512, seed=1),
                       jf.prepare_cells_free(ds, 128, 128, 512, seed=1))
    tr, jr = runners(ds, balance=balance, n_plans=2, batch=None)
    assert tr.batch == jr.batch
    for p, q in zip(tr.plans, jr.plans, strict=True):
        assert_plans_equal(p, q)
    for a, b in ((tr._map_u, jr._map_u), (tr._map_v, jr._map_v)):
        if balance:
            np.testing.assert_array_equal(a, b)
        else:
            assert a is None and b is None


def test_free_geometry_predicates_and_stats_match():
    """pick_free_geometry, free_eligible and _global_dup_stats (the
    runner's adaptive group statistics) give tpu_mf's answers."""
    for nu, nv, n in ((2000, 1000, 50000), (300, 200, 4000),
                      (69_878, 10_677, 9_000_000)):
        ds = Sized(nu=nu, nv=nv, n=n)
        for tiles in ((128, 128), (256, 128)):
            assert (tf.pick_free_geometry(ds, *tiles)
                    == jf.pick_free_geometry(ds, *tiles)), (ds, tiles)
    for nu in (69_878, 480_189):
        for nv in (10_677, 17_770):
            for dim in (8, 64, 125, 253, 254, 300):
                assert (tf.free_eligible(nu, nv, dim)
                        == jf.free_eligible(nu, nv, dim))
    for ds in (pallas_data(), sentinel_data(),
               synthetic_ratings(600, 400, 20000, seed=8, zipf=1.2)):
        tr, jr = runners(ds, n_plans=2)
        assert (tr._dup_max, tr._vdup_max) == (jr._dup_u, jr._dup_v)
        for p in tr.plans:
            for ids, g, tile, n_t in ((p.u, p.gu, p.tile_u, p.n_gu),
                                      (p.v, p.gv, p.tile_v, p.n_gv)):
                assert (tf._global_dup_stats(ids, g, tile, n_t)
                        == jf._global_dup_stats(ids, g, tile, n_t))
        for eta in (0.2, 0.05, 0.01, 2e-3, 5e-4, 1e-4):
            assert tr.pick_theta_groups(eta) == jr._pick(
                eta, jr._dup_u, None, "theta")
            assert tr.pick_phi_groups(eta) == jr._pick(
                eta, jr._dup_v, None, "phi")


@pytest.mark.parametrize("data", [pallas_data, sentinel_data])
def test_free_flags_match_on_real_columns(data):
    """Each side's apply flags are tpu_mf's on every column that holds a
    real slot; on sentinel columns tpu_mf zeroes them and the port keeps
    _apply_flags' answer (ROADMAP Queue 3 item 8)."""
    tr, jr = runners(data(), n_plans=2)
    for p, fu, fv in zip(tr.plans, jr.flags_u, jr.flags_v, strict=True):
        real = p.w.sum(axis=1) > 0
        for side, g, want in (("u", p.gu, fu), ("v", p.gv, fv)):
            got = tf.free_flags(g)
            for k in tc.GROUPS:
                np.testing.assert_array_equal(got[k][real], want[k][real],
                                              err_msg=f"{side} {k}")
                assert got[k].dtype == np.int32
                if k == 8:
                    assert got[k].all()


# (groups_u, groups_v) x saturation on test_pallas_free.py's data, 2 epochs,
# f32: atol 2e-5, the gen-1 tolerance (the same f32 terms summed in another
# order)
@pytest.mark.parametrize("saturate", [False, True])
@pytest.mark.parametrize("groups", [(8, 8), (1, 1), (8, 1), (2, 4)])
def test_free_epochs_match_pallas(groups, saturate):
    tabs = np_tables(300, 200, 8, seed=1)
    tr, jr = runners(pallas_data(), saturate=saturate, groups_u=groups[0],
                     groups_v=groups[1])
    got, want = run_both(tr, jr, tabs, [ETA, ETA / 2])
    assert_close(got, want, tabs, 2e-5)


def test_free_epoch_bf16_matches_pallas():
    """The bf16 working type with mxu_pred on (the runner's defaults), at
    adaptive groups, saturating: atol 2e-2 (a rounding may flip where the
    two sums' f32 values differ in their last bit; two epochs carry it)."""
    tabs = np_tables(300, 200, 8, seed=2)
    tr, jr = runners(pallas_data(), mxu="bfloat16")
    assert tr.mxu_pred and jr.mxu_pred
    got, want = run_both(tr, jr, tabs, [ETA, ETA / 2])
    assert_close(got, want, tabs, 2e-2)


def column_replay(runner, tabs, cols_per_window):
    """tpu_mf's batched update over each window's columns, concatenated, on
    global (relabeled) ids: the sequential semantics of the free plan."""
    plan = runner.plan
    nu_pad, nv_pad = plan.n_gu * plan.tile_u, plan.n_gv * plan.tile_v
    mu, mv = runner._map_u, runner._map_v
    th, ph, bu, bv, gb = tabs
    out = JaxParams(jnp.zeros((nu_pad, th.shape[1])).at[mu].set(th),
                    jnp.zeros((nv_pad, th.shape[1])).at[mv].set(ph),
                    jnp.zeros(nu_pad).at[mu].set(bu),
                    jnp.zeros(nv_pad).at[mv].set(bv), jnp.float32(gb))
    real = plan.w > 0
    gu = plan.u + plan.gu[:, None, :] * plan.tile_u
    gv = plan.v + plan.gv[:, None, :] * plan.tile_v
    for i in range(plan.u.shape[0]):
        for c in range(0, 8, cols_per_window):
            cols = slice(c, c + cols_per_window)

            def flat(a):
                return jnp.asarray(np.ascontiguousarray(a[i][:, cols].T)
                                   .reshape(-1))

            batch = (flat(np.where(real, gu, 0).astype(np.int32)),
                     flat(np.where(real, gv, 0).astype(np.int32)),
                     flat(plan.r), flat(plan.w))
            out = sgd_batch_update(out, batch, jnp.float32(ETA),
                                   jnp.float32(LAM))
    return (np.asarray(out.theta)[mu], np.asarray(out.phi)[mv],
            np.asarray(out.bu)[mu], np.asarray(out.bv)[mv])


def test_free_sentinel_columns_flush_like_the_replay():
    """ROADMAP Queue 3 item 8. At groups 1/1 the last batch's 5 sentinel
    columns hold the last touch of item tile 0 in their window. The port
    flushes the tile there and matches the column replay at 2e-5; tpu_mf's
    kernel masks their flags, never applies the window's item deltas, and
    ends more than 1e-4 from the replay on phi (5.35e-4 here): the
    difference is the reference's."""
    tabs = np_tables(300, 100, 8, seed=1)
    tr, jr = runners(sentinel_data(), balance=True, saturate=False,
                     groups_u=1, groups_v=1, mxu_pred=False)
    plan = tr.plan
    sentinel = plan.w.sum(axis=1) == 0
    assert plan.n_gv == 1 and sentinel.sum() == 5 and sentinel[-1].any()
    got, want = run_both(tr, jr, tabs, [ETA])
    ref = column_replay(tr, tabs, 8)
    for a, b in zip(params_to_numpy(got)[:4], ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)
    assert float(np.abs(np.asarray(want.phi) - ref[1]).max()) > 1e-4


@pytest.mark.parametrize("groups", [(8, 8), (1, 1), (2, 4)])
def test_free_reference_equals_one_tile_window_plan(groups):
    """free_epoch_reference against window_reference (cell_epoch_reference)
    on free_window_plan's conversion of the same plan, at 1e-6: one user
    tile over the whole table gives the same epoch."""
    ds = sentinel_data()
    tabs = np_tables(ds.nu, ds.nv, 8, seed=4)
    tr, _ = runners(ds, saturate=True)
    free = tr.pad(params_from_numpy(*tabs, device="cpu"))
    cells = tuple(t.clone() for t in free)
    window = tc.upload_plan(tf.free_window_plan(tr.plan), "cpu")
    tf.free_epoch_reference(*free, tr._dev[0], ETA, LAM, 2.0, 10.0, 8,
                            *groups, mxu_pred=False)
    tc.cell_epoch_reference(*cells, window, ETA, LAM, 2.0, 10.0, 8, *groups,
                            mxu_pred=False)
    for a, b in zip(free, cells):
        assert float((a - b).abs().max()) <= 1e-6
    assert float((free[1] - tr.pad(params_from_numpy(
        *tabs, device="cpu"))[1]).abs().max()) > 1e-3


def test_free_whole_path_matches_pallas():
    """pad, 3 epochs at a decaying eta over two rotated plans (the runner's
    defaults: picked batch, balance, saturation, adaptive groups), trim:
    tables within 2e-5 of tpu_mf's runner, test RMSE within 1e-5."""
    ds = synthetic_ratings(400, 250, 12000, rank=4, seed=7, noise=0.1)
    tr_ds, te_ds = ds.split(0.1, seed=1)
    tabs = np_tables(ds.nu, ds.nv, 8, seed=5, gb=tr_ds.mean_rating())
    tr, jr = runners(tr_ds, batch=None, n_plans=2)
    eta0 = 0.3 / max(tr._dup_max[2], tr._vdup_max[2])
    etas = [eta0 / it for it in (1, 2, 3)]
    assert len({(tr.pick_theta_groups(e), tr.pick_phi_groups(e))
                for e in etas}) > 1
    got, want = run_both(tr, jr, tabs, etas)
    assert_close(got, want, tabs, 2e-5)
    assert abs(rmse(got, te_ds) - jax_rmse(want, te_ds)) <= 1e-5


def test_free_epoch_rejects_malformed_launches():
    """Wrong groups, working type, dtype or shape raise ValueError before
    anything runs, on any device."""
    tr, _ = runners(pallas_data())
    theta, phi = tr.pad(params_from_numpy(*np_tables(300, 200, 8, 1),
                                          device="cpu"))
    plan = tr.materialize()._dev[0]
    args = (0.02, 0.005, 2.0, 10.0, 8)
    before = (theta.clone(), phi.clone())
    for t, p, g, work in ((theta.double(), phi, (8, 8), torch.float32),
                          (theta[:-1], phi, (8, 8), torch.float32),
                          (theta, phi[:, :64], (8, 8), torch.float32),
                          (theta, phi, (3, 8), torch.float32),
                          (theta, phi, (8, 8), torch.float16)):
        with pytest.raises(ValueError):
            tf.free_epoch(t, p, plan, *args, *g, work=work)
    assert torch.equal(theta, before[0]) and torch.equal(phi, before[1])
    with pytest.raises(ValueError):
        tf.free_epoch(theta, phi, plan._replace(gu=plan.gu.long()), *args,
                      8, 8)
