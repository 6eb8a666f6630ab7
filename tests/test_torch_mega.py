"""The mega family of the PyTorch port (padded packed plans on the
window-plan kernel) against tpu_mf's MegaEpochRunner in interpret mode, on
the same numpy-made tables and datasets: the predicates and the padding
bit for bit, the weights the TPU reads from sentinel ids, the adaptive
group picks, epochs through the plain version to float tolerance, and the
runner's whole pad / epochs / trim path."""

import warnings
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mf.data.coo import synthetic_ratings
from tpu_mf.models.mf import MFParams as JaxParams
from tpu_mf.models.mf import rmse as jax_rmse
from tpu_mf.ops import pallas_sgd_mega as jm
from tpu_mf.ops import pallas_sgd_packed as jpk
from tpu_mf_torch.models.mf import MFParams, params_from_numpy, rmse
from tpu_mf_torch.ops import sgd_mega as tm

torch.set_num_threads(1)


def np_tables(nu, nv, dim, seed, gb=3.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1e-1, (nu, dim)).astype(np.float32),
            rng.normal(0, 1e-1, (nv, dim)).astype(np.float32),
            rng.normal(0, 1e-1, nu).astype(np.float32),
            rng.normal(0, 1e-1, nv).astype(np.float32), np.float32(gb))


def assert_plans_equal(a, b):
    assert a._fields == b._fields
    for name in b._fields:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=name)
            assert x.dtype == y.dtype, name
        else:
            assert x == y, name


def run_both(tr, jr, tabs, etas, lam=0.02, gb=3.0):
    """The same epochs through both runners from the same tables; returns
    the trimmed (port, tpu_mf) tables as numpy."""
    tt = tr.pad(params_from_numpy(*tabs, device="cpu"))
    jt = jr.pad(JaxParams(*(jnp.asarray(t) for t in tabs)))
    for it, eta in enumerate(etas):
        tt = tr.epoch(tt, eta, lam, gb, epoch_idx=it)
        jt = jr.epoch(jt, eta, lam, gb, epoch_idx=it)
    got = tr.trim(tt)
    return got, jr.trim(jt)


def assert_close(got, want, tabs, atol):
    for a, b, t in zip(got[:4], want[:4], tabs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=atol)
        assert np.abs(a.numpy() - t).max() > 10 * min(atol, 1e-3)  # trained


def test_mega_predicates_and_padding_match():
    """mega_packing_factor over dims 1-130, _pad_plan_nb for mega 1-8 (nb
    already a multiple among them) and mega_eligible on a grid of shapes
    give tpu_mf's answers."""
    for dim in range(1, 131):
        assert tm.mega_packing_factor(dim) == jm.mega_packing_factor(dim)
    ds = synthetic_ratings(300, 200, 6000, seed=1, zipf=0.7)
    plan = jpk.prepare_cells_packed(ds, 128, 128, 256, 3, 8)  # 28 batches
    nb = plan.u.shape[0]
    assert any(nb % m == 0 for m in range(2, 9))
    for mega in range(1, 9):
        got = tm._pad_plan_nb(plan, mega)
        assert_plans_equal(got, jm._pad_plan_nb(plan, mega))
        assert got.u.shape[0] % mega == 0
    for nu in (69_878, 480_189, 2_000_000):
        for nv in (10, 126, 10_677, 17_770):
            for dim in (8, 30, 62, 64, 100, 125, 126):
                for batch in (2048, 8192):
                    p = SimpleNamespace(theta=SimpleNamespace(shape=(nu, dim)),
                                        phi=SimpleNamespace(shape=(nv, dim)))
                    assert (tm.mega_eligible(p, batch)
                            == jm.mega_eligible(p, batch)), (nu, nv, dim)


@pytest.mark.parametrize("dim,kw", [
    (8, dict(n_plans=2)),
    (16, dict(pack=1, tile_u=64, tile_v=64, mega=4)),
    (64, dict(tile_u=128, tile_v=128, batch=128)),
])
def test_mega_plans_weight_by_sentinel(dim, kw):
    """Every plan the runner builds equals tpu_mf's (padding included), and
    a slot's weight, which the TPU reads from its sentinel ids, is w: w > 0
    exactly where u is not the sentinel (and then v is not either)."""
    ds = synthetic_ratings(500, 300, 15000, rank=3, seed=2, zipf=0.8)
    kw = dict(dict(tile_u=64, tile_v=64, batch=64, seed=7), **kw)
    tr = tm.MegaEpochRunner(ds, dim=dim, device="cpu", **kw)
    jr = jm.MegaEpochRunner(ds, dim=dim, interpret=True, **kw)
    assert tr.mega == jr.mega and len(tr.plans) == len(jr.plans)
    for p, q in zip(tr.plans, jr.plans):
        assert_plans_equal(p, q)
        real = p.u != p.tile_u
        np.testing.assert_array_equal(p.w > 0, real)
        np.testing.assert_array_equal(p.v != p.tile_v, real)
        assert p.u.shape[0] % tr.mega == 0


@pytest.mark.parametrize("dim", [8, 64])
def test_mega_group_picks_match(dim):
    """The adaptive group picks of the port's runner are tpu_mf's at every
    eta, on the same padded plans (two rotated, saturating)."""
    ds = synthetic_ratings(600, 300, 20000, rank=3, seed=dim, zipf=1.0)
    kw = dict(tile_u=64, tile_v=64, batch=256, seed=1, n_plans=2,
              saturate=True)
    tr = tm.MegaEpochRunner(ds, dim=dim, device="cpu", **kw)
    jr = jm.MegaEpochRunner(ds, dim=dim, interpret=True, **kw)
    assert (tr._dup_max, tr._vdup_max) == (jr._dup_max, jr._vdup_max)
    assert tr.mxu_pred == jr.mxu_pred == (dim == 64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for eta in (0.2, 0.05, 0.01, 2e-3, 5e-4, 1e-4, 1e-5):
            assert tr.pick_theta_groups(eta) == jr.pick_theta_groups(eta)
            assert tr.pick_phi_groups(eta) == jr.pick_phi_groups(eta)


# the cases of tests/test_mega_kernel.py against tpu_mf's mega runner, 2
# epochs each: f32 atol 2e-5, the gen-1 tolerance of test_torch_cells.py
# (the same f32 terms summed in another order); bf16 atol 2e-2 (a rounding
# may flip where the two sums' f32 values differ in their last bit, and the
# flip is carried by two epochs of later updates)
EPOCH_CASES = {
    "dim8_mega4": (dict(seed=0, n=20000, nu=700, nv=400, zipf=0.7), 8,
                   dict(tile_u=128, tile_v=128, batch=64, seed=3, mega=4,
                        theta_groups=8, phi_groups=8), "float32", 2e-5),
    "dim30_mega2": (dict(seed=0, n=20000, nu=700, nv=400, zipf=0.7), 30,
                    dict(tile_u=64, tile_v=64, batch=64, seed=3, mega=2,
                         theta_groups=8, phi_groups=8), "float32", 2e-5),
    "pack1_dim16": (dict(seed=1, n=30000, nu=900, nv=500, zipf=0.7), 16,
                    dict(tile_u=64, tile_v=64, batch=64, seed=5, pack=1,
                         mega=4, theta_groups=8, phi_groups=8), "float32",
                    2e-5),
    "deferred_padded": (dict(seed=2, n=15000, nu=600, nv=300, zipf=0.8), 8,
                        dict(tile_u=64, tile_v=64, batch=64, seed=7,
                             n_plans=2, mega=8), "float32", 2e-5),
    "pack1_bf16": (dict(seed=1, n=30000, nu=900, nv=500, zipf=0.7), 16,
                   dict(tile_u=64, tile_v=64, batch=64, seed=5, pack=1,
                        mega=4, theta_groups=8, phi_groups=8), "bfloat16",
                   2e-2),
}


@pytest.mark.parametrize("case", sorted(EPOCH_CASES))
def test_mega_epochs_match_pallas(case):
    """Two epochs of the port's runner (the plain version) against tpu_mf's
    interpret-mode mega kernel from the same tables. The deferred case
    takes the eta whose windows span 2+ columns on both sides, rotates two
    plans and pads them to a multiple of 8 batches."""
    d, dim, kw, mxu, atol = EPOCH_CASES[case]
    ds = synthetic_ratings(d["nu"], d["nv"], d["n"], rank=4, seed=d["seed"],
                           zipf=d["zipf"])
    tabs = np_tables(ds.nu, ds.nv, dim, seed=9)
    tr = tm.MegaEpochRunner(ds, dim=dim, mxu=mxu, device="cpu", **kw)
    jr = jm.MegaEpochRunner(ds, dim=dim, mxu=mxu, interpret=True, **kw)
    eta = 0.05
    if case == "deferred_padded":
        eta = 0.19 / max(tr._dup_max[4], tr._vdup_max[4])
        assert max(tr.pick_theta_groups(eta), tr.pick_phi_groups(eta)) <= 4
        assert any((p.u[-1] == p.tile_u).all() for p in tr.plans)  # padded
    got, want = run_both(tr, jr, tabs, [eta, eta])
    assert_close(got, want, tabs, atol)


def test_mega_limits():
    """dim 125 runs at pack 1; dim 126 is refused (the limit the packing
    code sets), and so are the TPU's layout options and mxu_pred on packed
    rows."""
    ds = synthetic_ratings(200, 100, 3000, seed=3)
    r = tm.MegaEpochRunner(ds, dim=125, batch=64, device="cpu")
    assert (r.pack, r.tile_u, r.mxu_pred) == (1, 512, True)
    tabs = np_tables(ds.nu, ds.nv, 125, seed=1)
    t = r.epoch(r.pad(params_from_numpy(*tabs, device="cpu")), 0.01, 0.01,
                3.0)
    assert t[0].shape[1] == 128 and bool(torch.isfinite(t[0]).all())
    with pytest.raises(ValueError, match="dim <= 125"):
        tm.MegaEpochRunner(ds, dim=126, device="cpu")
    with pytest.raises(ValueError, match="pack 1"):
        tm.MegaEpochRunner(ds, dim=8, mxu_pred=True, device="cpu")
    for opt in ("interpret", "scatter_dg"):
        with pytest.raises(TypeError):
            tm.MegaEpochRunner(ds, dim=8, device="cpu", **{opt: True})


def test_mega_whole_path_matches_pallas():
    """pad, 3 epochs at a decaying eta over two rotated plans (adaptive
    groups, saturating), trim: the tables within 2e-5 of tpu_mf's runner
    and the test RMSE within 1e-5."""
    ds = synthetic_ratings(600, 300, 15000, rank=3, seed=4, zipf=0.8)
    tr_ds, te_ds = ds.split(0.1, seed=1)
    tabs = np_tables(ds.nu, ds.nv, 8, seed=5, gb=tr_ds.mean_rating())
    kw = dict(tile_u=64, tile_v=64, batch=128, seed=2, n_plans=2,
              saturate=True, mxu="float32")
    tr = tm.MegaEpochRunner(tr_ds, dim=8, device="cpu", **kw)
    jr = jm.MegaEpochRunner(tr_ds, dim=8, interpret=True, **kw)
    eta0 = 0.4 / max(tr._dup_max[2], tr._vdup_max[2])
    etas = [eta0 / it for it in (1, 2, 3)]
    assert len({(tr.pick_theta_groups(e), tr.pick_phi_groups(e))
                for e in etas}) > 1
    gb = float(tabs[4])
    got, want = run_both(tr, jr, tabs, etas, lam=5e-3, gb=gb)
    assert_close(got, want, tabs, 2e-5)
    assert abs(rmse(got, te_ds) - jax_rmse(want, te_ds)) <= 1e-5
    assert isinstance(got, MFParams)
