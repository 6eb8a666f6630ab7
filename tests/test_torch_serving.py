"""Serving and ranking evaluation of the PyTorch port on the CPU, against
tpu_mf on the same numpy-made tables: score_all_items, recommend_topk with
seen-item masks (padding and repeated ids included) and ranking_metrics.
The tables are drawn from a continuous distribution, so no scores tie in
or at a user's top k, and torch.topk and lax.top_k must name the same
items."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_mf.data.coo import synthetic_ratings
from tpu_mf.models import eval as jeval
from tpu_mf.models import serving as jserving
from tpu_mf.models.mf import MFParams as JaxParams
from tpu_mf_torch.data.coo import RatingsCOO
from tpu_mf_torch.models import eval as teval
from tpu_mf_torch.models import serving as tserving
from tpu_mf_torch.models.mf import params_from_numpy

torch.set_num_threads(1)


def tables(nu, nv, dim, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.3, (nu, dim)).astype(np.float32),
            rng.normal(0, 0.3, (nv, dim)).astype(np.float32),
            rng.normal(0, 0.1, nu).astype(np.float32),
            rng.normal(0, 0.1, nv).astype(np.float32), np.float32(3.2))


def pair(tabs):
    return (JaxParams(*(jnp.asarray(x) for x in tabs)),
            params_from_numpy(*tabs, device="cpu"))


def port(ds):
    return RatingsCOO(ds.u, ds.v, ds.r, ds.nu, ds.nv)


def test_score_all_items_matches():
    """(B, nv) scores of a user batch, repeats included, within 1e-5, and
    against a float64 product."""
    tabs = tables(120, 300, 16, seed=1)
    jp, tp = pair(tabs)
    users = np.array([0, 5, 5, 119, 42, 7], np.int32)
    got = tserving.score_all_items(tp, torch.as_tensor(users)).numpy()
    want = np.asarray(jserving.score_all_items(jp, jnp.asarray(users)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    f64 = [x.astype(np.float64) for x in tabs]
    ref = (f64[0][users] @ f64[1].T + f64[2][users, None] + f64[3][None]
           + f64[4])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert got.dtype == np.float32


@pytest.mark.parametrize("masked", [False, True])
def test_recommend_topk_matches_on_tie_free_scores(masked):
    """Top-10 ids equal tpu_mf's and scores within 1e-5; with a seen mask
    the seen items are gone, while padding slots (mask 0, id 0 or a real
    item) and repeated ids change nothing beyond their items."""
    tabs = tables(64, 200, 8, seed=2)
    jp, tp = pair(tabs)
    users = np.arange(0, 64, 3, dtype=np.int32)
    rng = np.random.default_rng(3)
    seen = rng.integers(0, 200, (len(users), 12)).astype(np.int32)
    seen[:, 5] = seen[:, 4]                       # a repeated id
    mask = (rng.random(seen.shape) < 0.7).astype(np.float32)
    mask[:, 4:6] = 1.0
    mask[:, -2:] = 0.0                            # padding
    seen[::2, -1] = 0                             # padding on item 0
    kw_j, kw_t = {}, {}
    if masked:
        kw_j = dict(seen_v=jnp.asarray(seen), seen_mask=jnp.asarray(mask))
        kw_t = dict(seen_v=torch.as_tensor(seen),
                    seen_mask=torch.as_tensor(mask))
    ji, jv = jserving.recommend_topk(jp, jnp.asarray(users), 10, **kw_j)
    ti, tv = tserving.recommend_topk(tp, torch.as_tensor(users), 10, **kw_t)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    scores = tserving.score_all_items(tp, torch.as_tensor(users)).numpy()
    top = -np.sort(-scores, axis=1)[:, :11]
    assert (np.diff(top, axis=1) < 0).all()  # no ties in or at the top 10
    if masked:
        for b in range(len(users)):
            banned = set(seen[b][mask[b] > 0].tolist())
            assert not banned & set(ti[b].tolist())
            order = [int(i) for i in np.argsort(-scores[b])
                     if int(i) not in banned][:10]
            assert ti[b].tolist() == order


def rating_sets(seed=0):
    ds = synthetic_ratings(150, 120, 6000, rank=3, noise=0.2, seed=seed,
                           zipf=1.0)
    return ds.split(0.2, seed=seed + 1)


@pytest.mark.parametrize("case", ["train_mask", "no_train", "truncated",
                                  "min_rating"])
def test_ranking_metrics_match(case):
    """recall / precision / ndcg at 10 within 1e-6 of tpu_mf's, the user
    and truncation counts equal: with the train items masked, without a
    train set, with max_seen truncating long histories, and with only
    high test ratings as positives."""
    train, test = rating_sets()
    tabs = tables(train.nu, train.nv, 8, seed=4)
    jp, tp = pair(tabs)
    kw = dict(k=10, user_batch=40)
    if case != "no_train":
        kw["train_ds"] = train
    if case == "truncated":
        kw["max_seen"] = 20
    if case == "min_rating":
        kw["min_rating"] = float(np.median(test.r))
    want = jeval.ranking_metrics(jp, test, **kw)
    if "train_ds" in kw:
        kw["train_ds"] = port(train)
    got = teval.ranking_metrics(tp, port(test), **kw)
    assert set(got) == set(want)
    for key in ("recall@k", "precision@k", "ndcg@k"):
        assert abs(got[key] - float(want[key])) <= 1e-6, key
    for key in ("k", "n_users", "n_truncated"):
        assert got[key] == want[key], key
    if case == "truncated":
        assert got["n_truncated"] > 0
    assert got["n_users"] > 50
