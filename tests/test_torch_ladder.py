"""The rank-8 ladder of the PyTorch port (lane-packed and slot-major plans
on the window-plan kernel) against tpu_mf's Pallas kernels in interpret
mode, on the same numpy-made tables and datasets: the plan builders, sub
pickers, balance maps and window statistics bit for bit, one epoch of each
converted plan through the plain version to float tolerance, and the
schedule's lazy staging."""

import os
import warnings
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mf.data.coo import synthetic_ratings
from tpu_mf.models.mf import MFParams as JaxParams
from tpu_mf.ops import pallas_sgd_packed as jpk
from tpu_mf.ops import pallas_sgd_slot as jsl
from tpu_mf.ops import plan_cache as jcache
from tpu_mf_torch.models.mf import params_from_numpy, params_to_numpy
from tpu_mf_torch.ops import plan_cache as tcache
from tpu_mf_torch.ops import sgd_cells as tc
from tpu_mf_torch.ops import sgd_packed as tpk
from tpu_mf_torch.ops import sgd_slot as tsl

torch.set_num_threads(1)
ETAS = (0.2, 0.05, 0.01, 2e-3, 5e-4, 1e-4, 1e-5)


def zipfy(nu, nv, n, seed, z):
    return synthetic_ratings(nu, nv, n, rank=3, noise=0.1, seed=seed,
                             zipf=z, zipf_q=2.0, zipf_u=z, zipf_uq=2.0)


def np_tables(nu, nv, dim, seed, gb):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1e-1, (nu, dim)).astype(np.float32),
            rng.normal(0, 1e-1, (nv, dim)).astype(np.float32),
            rng.normal(0, 1e-1, nu).astype(np.float32),
            rng.normal(0, 1e-1, nv).astype(np.float32), np.float32(gb))


def assert_plans_equal(a, b):
    assert type(a).__name__ == type(b).__name__
    assert a._fields == b._fields
    for name in b._fields:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=name)
            assert x.dtype == y.dtype, name
        else:
            assert x == y, name


def assert_window_plan_holds(wp, ds):
    """Every rating of ds sits once in the window plan's real slots, with
    its own ids (tile + tile-local id) and rating; padded slots have w 0."""
    real = wp.w > 0
    b, _, k = np.nonzero(real)
    got = Counter(zip((wp.gu[b] * wp.tile_u + wp.u[real]).tolist(),
                      (wp.gv[b, k] * wp.tile_v + wp.v[real]).tolist(),
                      wp.r[real].tolist()))
    assert got == Counter(zip(ds.u.tolist(), ds.v.tolist(), ds.r.tolist()))
    assert wp.u.dtype == wp.v.dtype == np.int32
    assert wp.r.dtype == wp.w.dtype == np.float32
    assert np.all(wp.r[~real] == 0)


@pytest.mark.parametrize("pack", [8, 4, 2])
def test_packed_plans_bit_equal(pack):
    """prepare_cells_packed, packing_factor and packed_eligible give
    tpu_mf's answers; the packed plan is a window plan as it stands."""
    ds = zipfy(300, 200, 6000, seed=pack, z=1.0)
    tile = 16 * pack
    plan = tpk.prepare_cells_packed(ds, tile, tile, 256, seed=3, pack=pack)
    assert_plans_equal(plan, jpk.prepare_cells_packed(ds, tile, tile, 256,
                                                      seed=3, pack=pack))
    assert_window_plan_holds(plan, ds)
    for dim in range(1, 70):
        assert tpk.packing_factor(dim) == jpk.packing_factor(dim)
        assert tsl.slot_packing_factor(dim) == jsl.slot_packing_factor(dim)


@pytest.mark.parametrize("balance", [False, True])
@pytest.mark.parametrize("pack", [8, 4, 2])
def test_slot_plans_bit_equal(pack, balance):
    """The balance maps (within and across tiles), the bucket counts, both
    sub pickers, the plain and striped plans, slot_col_ids and
    slot_dup_lower_bound give tpu_mf's arrays exactly; both converted plans
    hold every rating once."""
    ds = zipfy(300, 200, 8000, seed=10 + pack, z=0.8 + 0.2 * (pack // 4))
    tile = 16 * pack
    for cross in (False, True):
        got = tsl.balance_dataset(ds, tile, tile, pack, cross_tile=cross)
        want = jsl.balance_dataset(ds, tile, tile, pack, cross_tile=cross)
        for x, y in zip(got[1:] + (got[0].u, got[0].v, got[0].r),
                        want[1:] + (want[0].u, want[0].v, want[0].r)):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
        assert (got[0].nu, got[0].nv) == (want[0].nu, want[0].nv)
    if balance:
        ds = tsl.balance_dataset(ds, tile, tile, pack, cross_tile=True)[0]
    bc = tsl._slot_bucket_counts(ds, tile, tile, pack)
    np.testing.assert_array_equal(bc, jsl._slot_bucket_counts(ds, tile, tile,
                                                              pack))
    sub = tsl.pick_sub(bc, pack)
    n_gv = -(-ds.nv // tile)
    sub_s = tsl.pick_sub_stripe(bc, pack, n_gv)
    assert sub == jsl.pick_sub(bc, pack)
    assert sub_s == jsl.pick_sub_stripe(bc, pack, n_gv)
    for s in jsl._SUB_CANDIDATES:  # the pickers' score ties and edges
        one = np.zeros_like(bc)
        one[::max(1, s)] = s
        assert tsl.pick_sub(one, pack) == jsl.pick_sub(one, pack)
        assert (tsl.pick_sub_stripe(one, pack, n_gv)
                == jsl.pick_sub_stripe(one, pack, n_gv))
    for striped, sb in ((False, sub), (True, sub_s)):
        build_t = tsl.prepare_cells_stripe if striped else tsl.prepare_cells_slot
        build_j = jsl.prepare_cells_stripe if striped else jsl.prepare_cells_slot
        plan = build_t(ds, tile, tile, sb, 5, pack)
        assert_plans_equal(plan, build_j(ds, tile, tile, sb, 5, pack))
        for ids in (plan.u, plan.v):
            np.testing.assert_array_equal(tsl.slot_col_ids(ids, pack),
                                          jsl.slot_col_ids(ids, pack))
        assert_window_plan_holds(tsl.to_window_plan(plan, striped), ds)
    for kw in (dict(pack=pack, tile_u=tile, tile_v=tile),
               dict(pack=pack, tile_u=tile, tile_v=tile, sub=64),
               dict(dim=8, balance=balance)):
        assert (tsl.slot_dup_lower_bound(ds, **kw)
                == jsl.slot_dup_lower_bound(ds, **kw))


RUNNERS = {
    # family: (port runner, tpu_mf runner, options)
    "packed": (tpk.PackedEpochRunner, jpk.PackedEpochRunner,
               dict(batch=1024)),
    "slot": (tsl.SlotEpochRunner, jsl.SlotEpochRunner, dict(balance=True)),
    "stripe": (tsl.SlotEpochRunner, jsl.SlotEpochRunner,
               dict(balance=True, striped=True)),
}


@pytest.mark.parametrize("dim", [8, 40])
@pytest.mark.parametrize("family", sorted(RUNNERS))
def test_group_picks_and_envelope_match(family, dim):
    """The adaptive group picks and envelope_ok of the port's runners are
    tpu_mf's at every eta, on the same plans (two rotated, saturating).
    The plain slot plan's item labels are its user lanes' slots
    (slot_col_ids); the port keeps them, so it picks tpu_mf's groups."""
    tr, jr, kw = RUNNERS[family]
    ds = zipfy(500, 300, 20000, seed=dim, z=1.2)
    got = tr(ds, seed=1, n_plans=2, dim=dim, saturate=True, mxu="float32",
             device="cpu", **kw)
    want = jr(ds, seed=1, n_plans=2, dim=dim, saturate=True, mxu="float32",
              interpret=True, **kw)
    assert (got._dup_max, got._vdup_max) == (want._dup_max, want._vdup_max)
    assert getattr(got, "sub", None) == getattr(want, "sub", None)
    for a, b in zip(got.plans, want.plans):
        assert_plans_equal(a, b)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for eta in ETAS:
            assert got.pick_theta_groups(eta) == want.pick_theta_groups(eta)
            assert got.pick_phi_groups(eta) == want.pick_phi_groups(eta)
            if family != "packed":
                assert got.envelope_ok(eta) == want.envelope_ok(eta)
    assert got._dev == []  # probing uploaded nothing


# (family, dim, dataset, runner options, eta, working type, atol):
# f32 atol 2e-5, the gen-1 tolerance of tests/test_torch_cells.py (the same
# f32 terms summed in another order); bf16 atol 1e-4 (a rounding may flip
# where the two sums' f32 values differ in their last bit)
def _ds_small(seed):
    return zipfy(300, 200, 6000, seed=seed, z=0.8)


EPOCH_CASES = {
    "packed_8_8": ("packed", 8, _ds_small(1),
                   dict(batch=512, theta_groups=8, phi_groups=8), 0.05,
                   "float32", 2e-5),
    "packed_adaptive": ("packed", 8, _ds_small(2),
                        dict(batch=512, saturate=True), None, "float32",
                        2e-5),
    "packed_p2": ("packed", 40, _ds_small(3),
                  dict(batch=256, theta_groups=8, phi_groups=8), 0.05,
                  "float32", 2e-5),
    "packed_bf16": ("packed", 8, _ds_small(1),
                    dict(batch=512, theta_groups=8, phi_groups=8), 0.05,
                    "bfloat16", 1e-4),
    "slot_8_8": ("slot", 8, _ds_small(4),
                 dict(sub=32, theta_groups=8, phi_groups=8), 0.02,
                 "float32", 2e-5),
    "slot_adaptive": ("slot", 8, _ds_small(5),
                      dict(sub=32, balance=True, saturate=True), None,
                      "float32", 2e-5),
    "slot_p4": ("slot", 16, _ds_small(6),
                dict(sub=32, theta_groups=8, phi_groups=8), 0.02,
                "float32", 2e-5),
    "slot_bf16": ("slot", 8, _ds_small(4),
                  dict(sub=32, theta_groups=8, phi_groups=8), 0.02,
                  "bfloat16", 1e-4),
    "stripe_8_8": ("stripe", 8, _ds_small(7),
                   dict(sub=64, balance=True, theta_groups=8, phi_groups=8),
                   0.02, "float32", 2e-5),
    "stripe_adaptive": ("stripe", 8, _ds_small(8),
                        dict(sub=64, saturate=True), None, "float32", 2e-5),
    "stripe_bf16": ("stripe", 8, _ds_small(7),
                    dict(sub=64, balance=True, theta_groups=8, phi_groups=8),
                    0.02, "bfloat16", 1e-4),
}


@pytest.mark.parametrize("case", sorted(EPOCH_CASES))
def test_converted_epoch_matches_pallas(case):
    """One epoch of each converted plan through cell_epoch_reference
    (mxu_pred off) against tpu_mf's interpret-mode _run_packed_epoch /
    _run_slot_epoch on the same plan, compared after trim. Adaptive cases
    take the eta at which the windows span 2+ columns on both sides."""
    family, dim, ds, kw, eta, mxu, atol = EPOCH_CASES[case]
    tr_cls, jr_cls, base = RUNNERS[family]
    kw = {**base, **kw}
    tabs = np_tables(ds.nu, ds.nv, dim, seed=9, gb=3.0)
    jr = jr_cls(ds, seed=3, dim=dim, mxu=mxu, interpret=True, **kw)
    tr = tr_cls(ds, seed=3, dim=dim, mxu=mxu, device="cpu", **kw)
    if eta is None:
        eta = 0.2 / max(tr._dup_max[4], tr._vdup_max[4])
    groups = (tr.pick_theta_groups(eta), tr.pick_phi_groups(eta))
    assert groups == (jr.pick_theta_groups(eta), jr.pick_phi_groups(eta))
    if "adaptive" in case:
        assert max(groups) <= 4, groups
    else:
        assert groups == (8, 8)
    jt = jr.epoch(jr.pad(JaxParams(*(jnp.asarray(t) for t in tabs))), eta,
                  0.01, 3.0, epoch_idx=1)
    tt = tr.epoch(tr.pad(params_from_numpy(*tabs, device="cpu")), eta, 0.01,
                  3.0, epoch_idx=1)
    assert not tr.mxu_pred
    got, want = params_to_numpy(tr.trim(tt))[:4], jr.trim(jt)[:4]
    for a, b, t in zip(got, want, tabs):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=atol)
        assert np.abs(a - t).max() > 10 * atol  # it trained


def test_probing_uploads_nothing(monkeypatch):
    """The slot ladder builds and probes candidate runners without staging
    a plan on the device; a scheduled runner stages its plans at pad."""
    from tpu_mf_torch.config import TrainConfig
    from tpu_mf_torch.train.loop import _slot_phase_ladder

    uploads = []
    real = tc.upload_plan
    monkeypatch.setattr(tc, "upload_plan",
                        lambda *a: uploads.append(1) or real(*a))
    ds = zipfy(400, 250, 30000, seed=8, z=1.2)
    made = []

    def mk(sub=None, striped=False):
        made.append(tsl.SlotEpochRunner(ds, n_plans=2, dim=8, balance=True,
                                        saturate=True, sub=sub,
                                        striped=striped, mxu="float32",
                                        device="cpu"))
        return made[-1]

    cfg = TrainConfig(dim=8, iters=6, eta=0.002)
    phases = _slot_phase_ladder(cfg, mk, lambda _: None)
    assert len(made) > len(phases) >= 2 and not uploads
    phases[0][1].pad(params_from_numpy(*np_tables(ds.nu, ds.nv, 8, 0, 3.0),
                                       device="cpu"))
    assert len(uploads) == 2


def test_plan_cache_shares_ladder_kinds(tmp_path, monkeypatch):
    """Packed, slot and striped plans the port caches are tpu_mf's entries:
    same kind names, keys and npz layout, read back by either package."""
    monkeypatch.setenv("TPU_MF_PLAN_CACHE", str(tmp_path))
    monkeypatch.setattr(tcache, "MIN_RATINGS", 100)
    monkeypatch.setattr(jcache, "MIN_RATINGS", 100)
    ds = synthetic_ratings(100, 80, 2000, seed=0)
    builds = ((tpk.prepare_cells_packed, jpk.prepare_cells_packed,
               (64, 64, 128, 1, 8), "packed."),
              (tsl.prepare_cells_slot, jsl.prepare_cells_slot,
               (64, 64, 32, 1, 8), "slot."),
              (tsl.prepare_cells_stripe, jsl.prepare_cells_stripe,
               (64, 64, 32, 1, 8), "stripe."))
    for port, ref, args, prefix in builds:
        before = set(os.listdir(tmp_path))
        first = port(ds, *args)
        (new,) = set(os.listdir(tmp_path)) - before
        assert new.startswith(prefix)
        assert_plans_equal(port(ds, *args), first)
        assert_plans_equal(ref(ds, *args), first)
        assert set(os.listdir(tmp_path)) == before | {new}
