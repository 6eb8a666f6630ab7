"""The port's own copies of tpu_mf's JAX-free modules (``config``,
``data``) and helpers (``ops/common.py::distinct_counts``) against their
originals: the same datasets, splits, batches, configuration, parsed files
and counts, bit for bit."""

import dataclasses

import numpy as np
import pytest

from tpu_mf import config as jconfig
from tpu_mf.data import coo as jcoo
from tpu_mf.data import proto as jproto
from tpu_mf.data import textfmt as jtext
from tpu_mf_torch import config as tconfig
from tpu_mf_torch.data import coo as tcoo
from tpu_mf_torch.data import textfmt as ttext

GEN = [
    dict(nu=50, nv=40, n=500, seed=0),
    dict(nu=300, nv=200, n=4000, rank=3, noise=0.2, seed=7, zipf=1.0,
         zipf_q=5.0, zipf_u=0.8, zipf_uq=2.0),
    dict(nu=69, nv=107, n=3000, rank=8, seed=3, noise=0.76, bias_std=0.38,
         zipf=1.0, zipf_q=50.0, signal=1.0, gb=3.5),
]


def assert_coo_equal(a, b):
    for name in "uvr":
        x, y = getattr(a, name), getattr(b, name)
        np.testing.assert_array_equal(x, y, err_msg=name)
        assert x.dtype == y.dtype, name
    assert (a.nu, a.nv) == (b.nu, b.nv)


@pytest.mark.parametrize("case", range(len(GEN)))
def test_synthetic_split_and_batches_bit_equal(case):
    """synthetic_ratings, split, shuffled, counts and epoch_batches give
    tpu_mf's arrays for the same arguments and seeds."""
    kw = GEN[case]
    got, want = tcoo.synthetic_ratings(**kw), jcoo.synthetic_ratings(**kw)
    assert_coo_equal(got, want)
    assert got.mean_rating() == want.mean_rating()
    for x, y in zip(got.counts(), want.counts()):
        np.testing.assert_array_equal(x, y)
    for seed in (0, 5):
        for x, y in zip(got.split(0.1, seed=seed), want.split(0.1, seed=seed)):
            assert_coo_equal(x, y)
        assert_coo_equal(got.shuffled(seed), want.shuffled(seed))
    for batch, epoch, seed in ((128, 1, 0), (1000, 3, 9)):
        for x, y in zip(tcoo.epoch_batches(got, batch, epoch, seed),
                        jcoo.epoch_batches(want, batch, epoch, seed)):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
    with pytest.raises(ValueError):
        tcoo.RatingsCOO(u=[0, 5], v=[0, 1], r=[1.0, 2.0], nu=5, nv=2)


def test_train_config_matches():
    """TrainConfig's fields, types and defaults, and its three schedules,
    are tpu_mf's."""
    got = [(f.name, f.type, f.default) for f in
           dataclasses.fields(tconfig.TrainConfig)]
    want = [(f.name, f.type, f.default) for f in
            dataclasses.fields(jconfig.TrainConfig)]
    assert got == want
    for kw in ({}, dict(eta=0.05, gam=0.5, eta_reg=0.01, mineta=1e-3)):
        a, b = tconfig.TrainConfig(**kw), jconfig.TrainConfig(**kw)
        for r in range(1, 30):
            assert a.eta_at(r) == b.eta_at(r)
            assert a.eta_at_cutoff(r) == b.eta_at_cutoff(r)
            assert a.eta_reg_at(r) == b.eta_reg_at(r)


def test_read_any_matches(tmp_path):
    """read_any detects and parses raw, userwise, MovieLens ('::', tab and
    comma) and protobuf frame files as tpu_mf's reader does."""
    ds = jcoo.synthetic_ratings(60, 40, 700, seed=2)
    jtext.write_raw(str(tmp_path / "raw.txt"), ds)
    jtext.write_userwise(str(tmp_path / "userwise.txt"), ds)
    jproto.write_block_frames(str(tmp_path / "frames.bin"), ds,
                              users_per_block=7)
    for name, sep in (("ml10m.dat", "::"), ("u.data", "\t"),
                      ("plain.csv", ",")):
        with open(tmp_path / name, "w") as f:
            for u, v, r in zip(ds.u, ds.v, ds.r):
                f.write(f"{u + 1}{sep}{v + 1}{sep}{r:.9g}{sep}0\n")
    paths = sorted(tmp_path.iterdir())
    assert len(paths) == 6
    for path in paths:
        assert ttext.detect_format(str(path)) == jtext.detect_format(str(path))
        for kw in ({}, dict(nu=80, nv=60)):
            assert_coo_equal(ttext.read_any(str(path), **kw),
                             jtext.read_any(str(path), **kw))
    assert ttext.detect_format(str(tmp_path / "frames.bin")) == "proto"


@pytest.mark.parametrize("shape", [(7, 64), (3, 5, 40)])
def test_distinct_counts_bit_equal(shape):
    """ops/common.py's distinct_counts (host-side AdaptReg visit counts)
    gives tpu_mf's counts, padded slots excluded."""
    from tpu_mf.ops.common import distinct_counts as jax_distinct_counts
    from tpu_mf_torch.ops.common import distinct_counts

    rng = np.random.default_rng(len(shape))
    ids = rng.integers(0, 30, shape).astype(np.int32)
    real = rng.random(shape) < 0.7
    got, want = distinct_counts(ids, real), jax_distinct_counts(ids, real)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == shape[:-1]
