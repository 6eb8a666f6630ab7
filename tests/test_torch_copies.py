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


def rating_files(tmp_path, ds):
    """ds written in every format the readers take: raw, userwise, proto
    frames (7 users a block) and MovieLens '::', tab and comma files."""
    jtext.write_raw(str(tmp_path / "raw.txt"), ds)
    jtext.write_userwise(str(tmp_path / "userwise.txt"), ds)
    jproto.write_block_frames(str(tmp_path / "frames.bin"), ds,
                              users_per_block=7)
    for name, sep in (("ml10m.dat", "::"), ("u.data", "\t"),
                      ("plain.csv", ",")):
        with open(tmp_path / name, "w") as f:
            for u, v, r in zip(ds.u, ds.v, ds.r):
                f.write(f"{u}{sep}{v}{sep}{r:.9g}{sep}0\n")
    return sorted(str(p) for p in tmp_path.iterdir())


@pytest.mark.parametrize("chunk", [1, 257, 1 << 18])
def test_streamfmt_matches(tmp_path, chunk):
    """data/streamfmt.py: iter_ratings yields tpu_mf's chunks (same
    boundaries, arrays and dtypes) from all four formats, and scan_stats
    and scan_profile give tpu_mf's dims, counts and rating sum."""
    from tpu_mf.data import streamfmt as jsf
    from tpu_mf_torch.data import streamfmt as tsf

    ds = jcoo.synthetic_ratings(60, 40, 700 if chunk == 1 else 3000, seed=3)
    paths = rating_files(tmp_path, ds)
    assert len(paths) == 6
    for path in paths:
        got = list(tsf.iter_ratings(path, chunk=chunk))
        want = list(jsf.iter_ratings(path, chunk=chunk))
        assert len(got) == len(want) >= 1
        for g, w in zip(got, want):
            for x, y in zip(g, w):
                np.testing.assert_array_equal(x, y)
                assert x.dtype == y.dtype
        assert tsf.scan_stats(path, chunk) == jsf.scan_stats(path, chunk)
        gp, wp = tsf.scan_profile(path, chunk), jsf.scan_profile(path, chunk)
        assert gp[:3] == wp[:3] and gp[5] == wp[5]
        for x, y in zip(gp[3:5], wp[3:5]):
            np.testing.assert_array_equal(x, y)


def test_proto_writers_match(tmp_path):
    """The port's frame writers give tpu_mf's bytes: _write_varint over
    the varint range, serialize_block, and write_block_frames at several
    block sizes (an empty set included)."""
    from tpu_mf_torch.data import proto as tproto

    for value in (0, 1, 127, 128, 300, 2**31 - 1, 2**35 + 5):
        a, b = bytearray(), bytearray()
        tproto._write_varint(a, value)
        jproto._write_varint(b, value)
        assert a == b
    ds = jcoo.synthetic_ratings(60, 40, 900, seed=4)
    order = np.argsort(ds.u, kind="stable")
    u, v, r = ds.u[order], ds.v[order], ds.r[order]
    assert (tproto.serialize_block(u, v, r)
            == jproto.serialize_block(u, v, r))
    empty = jcoo.RatingsCOO(np.zeros(0, np.int32), np.zeros(0, np.int32),
                            np.zeros(0, np.float32), 1, 1)
    for i, (data, upb) in enumerate(((ds, 1000), (ds, 7), (ds, 1),
                                     (empty, 10))):
        a, b = tmp_path / f"t{i}.bin", tmp_path / f"j{i}.bin"
        tproto.write_block_frames(str(a), data, users_per_block=upb)
        jproto.write_block_frames(str(b), data, users_per_block=upb)
        assert a.read_bytes() == b.read_bytes()


def test_native_parser_matches_python(tmp_path):
    """tpu_mf_torch/native: the ctypes frame parser, built with the host
    compiler, reads what the pure-Python parser reads, and its writer
    gives the Python writer's bytes. Skips where no C++ compiler exists."""
    import shutil

    from tpu_mf_torch import native
    from tpu_mf_torch.data import proto as tproto

    if not (shutil.which("c++") or shutil.which("g++")):
        pytest.skip("no host C++ compiler")
    assert native.available()
    ds = jcoo.synthetic_ratings(300, 200, 5000, seed=5)
    path = str(tmp_path / "frames.bin")
    jproto.write_block_frames(path, ds, users_per_block=13)
    u, v, r = native.parse_frames_native(path)
    us, vs, rs = [], [], []
    for payload in tproto.iter_frames(path):
        bu, bv, br = tproto.parse_block(payload)
        us += bu
        vs += bv
        rs += br
    np.testing.assert_array_equal(u, np.asarray(us, np.int32))
    np.testing.assert_array_equal(v, np.asarray(vs, np.int32))
    np.testing.assert_array_equal(r, np.asarray(rs, np.float32))
    assert_coo_equal(tproto.read_block_frames(path, nu=310),
                     jproto.read_block_frames(path, nu=310))
    order = np.argsort(ds.u, kind="stable")
    out = tmp_path / "native.bin"
    assert native.write_frames_native(str(out), ds.u[order], ds.v[order],
                                      ds.r[order], users_per_block=13)
    assert out.read_bytes() == open(path, "rb").read()


@pytest.mark.parametrize("method", ["protobuf", "raw", "userwise"])
@pytest.mark.parametrize("mode", ["convert", "split", "nway", "xlarge"])
def test_prepare_and_xlarge_write_tpu_mf_bytes(tmp_path, method, mode):
    """tools/prepare.py (in-memory convert, held-out split with a
    validation part, the reference's N-way split) and tools/xlarge.py (the
    out-of-core shuffle behind --mem-limit) write tpu_mf's files, byte for
    byte, from the same input and seed."""
    from tpu_mf.tools.prepare import main as jax_prepare
    from tpu_mf_torch.tools.prepare import main as prepare

    ds = jcoo.synthetic_ratings(80, 60, 4000, seed=6)
    src = str(tmp_path / "in.raw")
    jtext.write_raw(src, ds)
    extra = {"convert": [], "split": ["--split", "0.1", "--valid", "0.1"],
             "nway": ["--split", "3"],
             "xlarge": ["--mem-limit", "700", "--split", "0.1"]}[mode]
    for side, fn in (("t", prepare), ("j", jax_prepare)):
        (tmp_path / side).mkdir()
        assert fn(["-r", src, "-w", str(tmp_path / side / "out"),
                   "--method", method, "--size", "9", "--seed", "4"]
                  + extra) == 0
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    assert len(names) == {"convert": 1, "split": 3, "nway": 3,
                          "xlarge": 2}[mode]
    for name in names:
        assert ((tmp_path / "t" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes()), name
