"""Batched SGD path of the PyTorch port against tpu_mf and the sequential
oracle, on the same numpy-made tables."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests.oracle import sgd_sequential
from tpu_mf.data.coo import epoch_batches, synthetic_ratings
from tpu_mf.models.mf import MFParams as JaxParams
from tpu_mf.ops.sgd import sgd_epoch as jax_sgd_epoch
from tpu_mf_torch.models.mf import params_from_numpy, params_to_numpy
from tpu_mf_torch.ops.sgd import sgd_epoch

torch.set_num_threads(1)


def np_tables(nu, nv, dim, seed=0, gb=3.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1e-2, (nu, dim)).astype(np.float32),
            rng.normal(0, 1e-2, (nv, dim)).astype(np.float32),
            rng.normal(0, 1e-2, nu).astype(np.float32),
            rng.normal(0, 1e-2, nv).astype(np.float32), np.float32(gb))


def torch_batches(u, v, r, w):
    return (torch.as_tensor(u.astype(np.int64)),
            torch.as_tensor(v.astype(np.int64)),
            torch.as_tensor(r), torch.as_tensor(w))


@pytest.mark.parametrize("batch", [64, 448])
def test_sgd_epoch_matches_jax(batch):
    """Same batches, same order of operations per batch; only the order in
    which duplicate-row scatter-adds are summed differs, so f32 agreement
    to 1e-6 is expected. The tail batch is padded (w = 0 slots)."""
    tabs = np_tables(60, 40, 8)
    ds = synthetic_ratings(60, 40, 3000, rank=3, seed=1)
    eta, lam = 0.05, 0.01
    u, v, r, w = epoch_batches(ds, batch, 1, 0)
    assert w.min() == 0.0  # padding is exercised

    jp = jax_sgd_epoch(JaxParams(*(jnp.asarray(t) for t in tabs)),
                       tuple(jnp.asarray(x) for x in (u, v, r, w)),
                       jnp.float32(eta), jnp.float32(lam))
    tp = sgd_epoch(params_from_numpy(*tabs, device="cpu"),
                   torch_batches(u, v, r, w), eta, lam)
    for a, b in zip(params_to_numpy(tp)[:4], jp[:4]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)


def test_sgd_batch_one_matches_sequential_oracle():
    """B=1 is the reference's sequential update (src/mf.h:94-109). The
    oracle runs in float64, the port in float32: 1e-5 covers the f32
    rounding of 200 small updates."""
    tabs = np_tables(11, 7, 4)
    ds = synthetic_ratings(11, 7, 200, seed=2)
    eta, lam = 0.05, 0.01
    want = sgd_sequential(*tabs[:4], float(tabs[4]), ds.u, ds.v, ds.r,
                          eta, lam)
    n = len(ds)
    got = sgd_epoch(params_from_numpy(*tabs, device="cpu"),
                    torch_batches(ds.u.reshape(n, 1), ds.v.reshape(n, 1),
                                  ds.r.reshape(n, 1),
                                  np.ones((n, 1), np.float32)), eta, lam)
    for a, b in zip(params_to_numpy(got)[:4], want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
