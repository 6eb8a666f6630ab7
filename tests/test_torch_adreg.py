"""The AdaptReg ops of the PyTorch port on the CPU, against tpu_mf on the
same numpy-made inputs: the batched update and epoch, the gen-1 and slot
segment steps (the kernel's plain version plus the hypergradient) against
tpu_mf's interpret-mode Pallas kernels, and both fused runners over 3
epochs. tpu_mf's validation draws (jax.random) are injected into the port,
whose own draws come from a torch.Generator."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_mf.data.coo import synthetic_ratings
from tpu_mf.models.admf import init_admf as jax_init_admf
from tpu_mf.ops import adreg as jax_adreg
from tpu_mf.ops import pallas_adreg as jpa
from tpu_mf.ops import pallas_adreg_slot as jps
from tpu_mf_torch.data.coo import RatingsCOO
from tpu_mf_torch.models.admf import admf_state_from_numpy, admf_state_to_numpy
from tpu_mf_torch.ops import adreg as ta
from tpu_mf_torch.ops import adreg_cells as tac
from tpu_mf_torch.ops.adreg_slot import SlotAdRegRunner

torch.set_num_threads(1)
K = 64
TABLES = ("theta", "phi", "bu", "bv")
SHADOWS = ("theta_old", "phi_old", "bu_old", "bv_old")
LAMBDAS = ("lam_u", "lam_v", "lam_bu", "lam_bv")


def port(ds):
    return RatingsCOO(ds.u, ds.v, ds.r, ds.nu, ds.nv)


def data(seed=0, n=4000, binary=False):
    """(train, valid) tpu_mf rating sets: zipfy train, uniform valid; with
    ``binary`` the ratings are 1 above the mean and 0 below (the logistic
    loss's targets)."""
    sets = (synthetic_ratings(300, 200, n, rank=3, seed=seed, zipf=1.1),
            synthetic_ratings(300, 200, 300, rank=3, seed=seed + 1))
    if not binary:
        return sets
    return tuple(dataclasses.replace(
        d, r=(d.r > d.mean_rating()).astype(np.float32)) for d in sets)


def arrays_of(js) -> dict:
    """A tpu_mf AdaptRegState as host arrays keyed by field."""
    out = {k: np.asarray(getattr(js.params, k)) for k in TABLES + ("gb",)}
    out.update({k: np.asarray(getattr(js, k)) for k in SHADOWS + LAMBDAS})
    return out


def jax_state(ds, dim, lam, seed=0, gb=3.0, bias=None):
    """tpu_mf's init_admf state with biases of N(0, 0.1) (not init-sized,
    so the bias hypergradients move) or all ``bias``."""
    js = jax_init_admf(jax.random.PRNGKey(seed), ds.nu, ds.nv, dim, lam=lam,
                       gb=gb)
    rng = np.random.default_rng(seed)

    def b(n):
        x = rng.normal(0, 0.1, n) if bias is None else np.full(n, bias)
        return jnp.asarray(x.astype(np.float32))

    bu, bv = b(ds.nu), b(ds.nv)
    return js._replace(params=js.params._replace(bu=bu, bv=bv),
                       bu_old=jnp.copy(bu), bv_old=jnp.copy(bv))


def draws(key, n, nvalid):
    """tpu_mf's K validation indices for fold_in(key, i), i < n."""
    return np.stack([np.asarray(jax.random.randint(
        jax.random.fold_in(key, i), (K,), 0, nvalid)) for i in range(n)])


def held(got: dict, want: dict, atol, keys):
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=k)


# ---- the batched path ---------------------------------------------------------

# name: (loss, initial lambdas, eta_reg, state options); "clamp": tiny
# lambdas, gb 1 (most errors positive) and positive biases, so the bias
# lambdas' steps are negative and end at the clamp at 0
BATCHED = {"lsq": (0, 0.02, 0.5, {}), "logistic": (1, 0.02, 0.5, {}),
           "clamp": (0, 1e-4, 1.0, dict(gb=1.0, bias=0.1))}


@pytest.mark.parametrize("case", sorted(BATCHED))
def test_batched_update_matches_tpu_mf(case):
    """adreg_batch_update over 3 batches (the last with padded slots)
    against tpu_mf's with the same validation draws: tables, shadows and
    lambdas within 1e-6."""
    loss, lam, eta_reg, opts = BATCHED[case]
    ds, valid = data(binary=loss == 1)
    js = jax_state(ds, 8, lam, **({"gb": 0.0} if loss else {}), **opts)
    st = admf_state_from_numpy(arrays_of(js), "cpu")
    jvalid = tuple(jnp.asarray(x) for x in (valid.u, valid.v, valid.r))
    tvalid = tuple(torch.as_tensor(np.asarray(x)) for x in
                   (valid.u.astype(np.int64), valid.v.astype(np.int64),
                    valid.r))
    u, v, r, w = ds.to_batches(256, shuffle_seed=3)
    w = w.copy()
    w[2, 200:] = 0.0  # padded slots
    key = jax.random.PRNGKey(4)
    samples = draws(key, 3, len(valid))
    for i in range(3):
        kb = jax.random.fold_in(key, i)
        js = jax_adreg.adreg_batch_update(
            js, tuple(jnp.asarray(x[i]) for x in (u, v, r, w)), jvalid,
            jax_adreg.AdRegHyper(jnp.float32(0.05), jnp.float32(eta_reg),
                                 loss), kb)
        st = ta.adreg_batch_update(
            st, (torch.as_tensor(u[i].astype(np.int64)),
                 torch.as_tensor(v[i].astype(np.int64)),
                 torch.as_tensor(r[i]), torch.as_tensor(w[i])), tvalid,
            ta.AdRegHyper(0.05, eta_reg, loss), torch.as_tensor(samples[i]))
    got, want = admf_state_to_numpy(st), arrays_of(js)
    held(got, want, 1e-6, TABLES + SHADOWS + LAMBDAS)
    moved = max(abs(float(got[k]) - lam) for k in LAMBDAS)
    assert moved > 1e-6 * 100, moved
    if case == "clamp":
        assert min(float(got[k]) for k in LAMBDAS) == 0.0


def test_adreg_epoch_matches_tpu_mf():
    """adreg_epoch over the batches of an epoch (tpu_mf's lax.scan, its
    fold_in(key, batch) draws injected) within 1e-6."""
    ds, valid = data()
    js = jax_state(ds, 8, 0.02)
    st = admf_state_from_numpy(arrays_of(js), "cpu")
    u, v, r, w = ds.to_batches(512, shuffle_seed=5)
    key = jax.random.PRNGKey(6)
    jvalid = tuple(jnp.asarray(x) for x in (valid.u, valid.v, valid.r))
    js = jax_adreg.adreg_epoch(
        js, tuple(jnp.asarray(x) for x in (u, v, r, w)), jvalid,
        (jnp.float32(0.02), jnp.float32(0.05)), 0, key)
    st = ta.adreg_epoch(
        st, (torch.as_tensor(u.astype(np.int64)),
             torch.as_tensor(v.astype(np.int64)), torch.as_tensor(r),
             torch.as_tensor(w)),
        tuple(torch.as_tensor(x) for x in (valid.u.astype(np.int64),
                                           valid.v.astype(np.int64),
                                           valid.r)),
        ta.AdRegHyper(0.02, 0.05, 0),
        torch.as_tensor(draws(key, u.shape[0], len(valid))))
    held(admf_state_to_numpy(st), arrays_of(js), 1e-6,
         TABLES + SHADOWS + LAMBDAS)


# ---- the gen-1 segment step -----------------------------------------------------

# name: (dim, mxu, loss, lam, atol); "negbase": eta * lam = 1.5 > 1, a
# negative decay base (its sign flips with the parity of k)
GEN1 = {"f32": (8, "float32", 0, 0.02, 2e-5),
        "logistic": (8, "float32", 1, 0.02, 2e-5),
        "negbase": (8, "float32", 0, 30.0, 2e-5),
        "bf16": (8, "bfloat16", 1, 0.02, 1e-4),
        "dim300": (300, "float32", 0, 0.02, 3e-5)}


def seg_hyper(eta, gb):
    return jnp.asarray([eta, gb], jnp.float32)


@pytest.mark.parametrize("case", sorted(GEN1))
def test_gen1_segment_step_matches_tpu_mf(case):
    """adreg_segment_step (the plain version, CPU) on the first segment of
    a gen-1 plan against tpu_mf's _run_adreg_seg_step in interpret mode,
    with the same validation draws: tables within the case's atol, lambdas
    within 1e-6 after moving by more than 100x that."""
    dim, mxu, loss, lam, atol = GEN1[case]
    ds, valid = data(binary=loss == 1)
    js = jax_state(ds, dim, lam, gb=0.0 if loss else 3.0)
    kw = dict(tile_u=64, tile_v=64, batch=128, segments=3, seed=2, mxu=mxu,
              loss=loss)
    jr = jpa.PallasAdRegRunner(ds, valid, interpret=True, **kw)
    pt = tac.AdRegCellRunner(port(ds), port(valid), device="cpu", **kw)
    for a, b in zip(jr.plans, pt.plans):
        for f in ("u", "v", "r", "w", "gu", "gv"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    tj = jr.pad(js)
    tp = pt.pad(admf_state_from_numpy(arrays_of(js), "cpu"))
    pt.materialize()
    b = jr.bundles[0]
    assert (pt.segments, pt.seg_len()) == (jr.segments, jr.seg_len)
    np.testing.assert_array_equal(pt._visits[0].numpy(), b["visits_per_seg"])
    eta, eta_reg, key = 0.05, 0.5, jax.random.PRNGKey(5)
    t0, t1, lj = jpa._run_adreg_seg_step(
        tj[0], tj[1], jr.lams, key, np.int32(0), *jr.valid, b["gu"][0],
        b["gv"][0], b["u"][0], b["v"][0], b["ut"][0], b["vt"][0], b["r"][0],
        b["w"][0], seg_hyper(eta, jr.gb), jnp.float32(eta),
        jnp.float32(eta_reg), jnp.asarray(b["visits_per_seg"]), tile_u=64,
        tile_v=64, batch=128, dim=dim, n_gu=b["n_gu"], n_gv=b["n_gv"],
        mxu=mxu, interpret=True, loss=loss, n_samples=K)
    lams0 = pt.lams.clone()
    lp = tac.adreg_segment_step(
        tp, pt.lams, pt._dev[0], 0, pt.seg_len(), pt._valid,
        torch.as_tensor(draws(key, 1, len(valid))[0]), eta, eta_reg,
        pt._visits[0][0], pt.gb, dim, 8, 8, pt.work_dtype, loss)
    np.testing.assert_allclose(tp[0].numpy(), np.asarray(t0), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(tp[1].numpy(), np.asarray(t1), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), rtol=0, atol=1e-6)
    assert float((lp - lams0).abs().max()) > 1e-4
    assert float((tp[0] - pt.pad(admf_state_from_numpy(
        arrays_of(js), "cpu"))[0]).abs().max()) > 1e-3  # it trained


def test_build_adreg_lamvec_matches_tpu_mf():
    lams = np.asarray([0.1, 0.2, 0.3, 0.4], np.float32)
    for dim in (8, 300):
        want = np.asarray(jpa.build_adreg_lamvec(dim, jnp.asarray(lams)))
        got = tac.build_adreg_lamvec(dim, torch.as_tensor(lams),
                                     want.shape[1])
        np.testing.assert_array_equal(got.numpy(), want)


def test_adreg_segment_rejects_bad_arguments():
    ds, valid = data()
    pt = tac.AdRegCellRunner(port(ds), port(valid), tile_u=64, tile_v=64,
                             batch=128, segments=3, mxu="float32",
                             device="cpu")
    js = jax_state(ds, 8, 0.02)
    th, ph = pt.pad(admf_state_from_numpy(arrays_of(js), "cpu"))
    plan = pt._dev[0]
    args = (0.05, pt.lams, 3.0, 8)
    with pytest.raises(ValueError, match="outside"):
        tac.adreg_segment(th, ph, plan, 0, plan.u.shape[0] + 1, *args)
    with pytest.raises(ValueError, match="groups"):
        tac.adreg_segment(th, ph, plan, 0, 1, *args, theta_groups=3)
    with pytest.raises(ValueError, match="loss"):
        tac.adreg_segment(th, ph, plan, 0, 1, *args, loss=2)
    with pytest.raises(ValueError, match="loss"):
        tac.AdRegCellRunner(port(ds), port(valid), loss=2, device="cpu")


# ---- the slot segment step ------------------------------------------------------

# name: (striped, theta groups, phi groups, mxu, atol)
SLOT = {"plain_8/8": (False, 8, 8, "float32", 2e-5),
        "striped_8/8": (True, 8, 8, "float32", 2e-5),
        "striped_2/4": (True, 2, 4, "float32", 2e-5),
        "plain_2/4_bf16": (False, 2, 4, "bfloat16", 1e-4)}


@pytest.mark.parametrize("case", sorted(SLOT))
def test_slot_segment_step_matches_tpu_mf(case):
    """adreg_segment_step on a slot plan's window columns (plain and
    striped, serpentine balance maps, so the validation ids ride the maps)
    against tpu_mf's _run_slot_adreg_seg_step in interpret mode, at 8/8
    groups and at windows of 4 (theta) and 2 (phi) columns."""
    striped, tg, pg, mxu, atol = SLOT[case]
    ds, valid = data()
    dim = 8
    js = jax_state(ds, dim, 0.02)
    kw = dict(sub=16, segments=3, seed=2, mxu=mxu, dim=dim, tile=64,
              striped=striped, theta_groups=tg, phi_groups=pg)
    jr = jps.SlotAdRegRunner(ds, valid, interpret=True, balance=True, **kw)
    pt = SlotAdRegRunner(port(ds), port(valid), device="cpu", **kw)
    np.testing.assert_array_equal(pt.plans[0].u, jr.plans[0].u)
    np.testing.assert_array_equal(pt.plans[0].v, jr.plans[0].v)
    tj = jr.pad(js)
    tp = pt.pad(admf_state_from_numpy(arrays_of(js), "cpu"))
    pt.materialize()
    b = jr.bundles[0]
    np.testing.assert_array_equal(pt._visits[0].numpy(), b["visits_per_seg"])
    eta = 0.18 / max(jr._dup_max[8], jr._vdup_max[8])
    eta_reg, key = 3.0, jax.random.PRNGKey(8)
    t0, t1, lj = jps._run_slot_adreg_seg_step(
        tj[0], tj[1], jr.lams, key, np.int32(0), *jr.valid, b["gu"][0],
        b["gv"][0], b["flags"][pg][0], b["uv"][0], b["uvt"][0], b["r"][0],
        seg_hyper(eta, jr.gb), jnp.float32(eta), jnp.float32(eta_reg),
        jnp.asarray(b["visits_per_seg"]), tile_u=64, tile_v=64, sub=16,
        dim=dim, pack=jr.pack, n_gu=b["n_gu"], n_gv=b["n_gv"], mxu=mxu,
        interpret=True, theta_groups=tg, phi_groups=pg, loss=0, n_samples=K,
        striped=striped)
    lams0 = pt.lams.clone()
    lp = tac.adreg_segment_step(
        tp, pt.lams, pt._dev[0], 0, pt.seg_len(), pt._valid,
        torch.as_tensor(draws(key, 1, len(valid))[0]), eta, eta_reg,
        pt._visits[0][0], pt.gb, dim, tg, pg, pt.work_dtype, 0)
    pt.lams = lp
    jr.lams = lj
    for a, c in zip(pt.trim(tp)[:4], jr.trim((t0, t1))[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=0,
                                   atol=atol)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), rtol=0, atol=1e-6)
    assert float((lp - lams0).abs().max()) > 1e-4


# ---- whole runners ----------------------------------------------------------------

def runner_pair(kind, ds, valid, mxu="float32"):
    """tpu_mf's interpret-mode runner and the port's CPU runner, two
    rotated plans, at test sizes."""
    if kind == "gen1":
        kw = dict(tile_u=64, tile_v=64, batch=128, segments=3, seed=2,
                  mxu=mxu, n_plans=2, loss=1)
        return (jpa.PallasAdRegRunner(ds, valid, interpret=True, **kw),
                tac.AdRegCellRunner(port(ds), port(valid), device="cpu",
                                    **kw))
    kw = dict(sub=16, segments=3, seed=2, mxu=mxu, dim=8, tile=64,
              striped=True, n_plans=2)
    return (jps.SlotAdRegRunner(ds, valid, interpret=True, balance=True,
                                **kw),
            SlotAdRegRunner(port(ds), port(valid), device="cpu", **kw))


def epoch_samples(jr, key, epoch_idx, nvalid):
    segs = jr.bundles[epoch_idx % len(jr.bundles)]["segments"]
    return draws(key, segs, nvalid)


@pytest.mark.parametrize("kind", ["gen1", "slot"])
def test_runners_match_tpu_mf_over_3_epochs(kind):
    """3 epochs of AdRegCellRunner (logistic) / the striped, balanced
    SlotAdRegRunner on CPU tensors against tpu_mf's runners in interpret
    mode: the same plans (bit-equal), the same validation draws; tables
    within 1e-4, lambdas within 1e-6; trim and state agree."""
    ds, valid = data(binary=kind == "gen1")
    js = jax_state(ds, 8, 0.02, gb=0.0 if kind == "gen1" else 3.0)
    jr, pt = runner_pair(kind, ds, valid)
    for a, b in zip(jr.plans, pt.plans):
        np.testing.assert_array_equal(a.u, b.u)
        np.testing.assert_array_equal(a.v, b.v)
    tj = jr.pad(js)
    tp = pt.pad(admf_state_from_numpy(arrays_of(js), "cpu"))
    for it in range(1, 4):
        eta = (0.05 if kind == "gen1"
               else 0.18 / max(jr._dup_max[8], jr._vdup_max[8])) / it
        key = jax.random.fold_in(jax.random.PRNGKey(7), it)
        tj = jr.epoch(tj, eta, 0.3, key, epoch_idx=it - 1)
        tp = pt.epoch(tp, eta, 0.3, 0, epoch_idx=it - 1,
                      samples=epoch_samples(jr, key, it - 1, len(valid)))
    for a, b in zip(pt.trim(tp)[:4], jr.trim(tj)[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4)
    np.testing.assert_allclose(pt.lams.numpy(), np.asarray(jr.lams), rtol=0,
                               atol=1e-6)
    got = admf_state_to_numpy(pt.state(tp))
    want = arrays_of(jr.state(tj, js))
    held(got, want, 1e-4, TABLES + SHADOWS)
    held(got, want, 1e-6, LAMBDAS)
    for t, s in zip(TABLES, SHADOWS):  # shadows copy the final tables
        np.testing.assert_array_equal(got[s], got[t])
    assert pt.state(tp).theta_old.data_ptr() != pt.state(tp).params.theta.data_ptr()
    assert type(pt).launches == 0  # CPU tensors: no kernel launch
