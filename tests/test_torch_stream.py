"""Out-of-core (--stream) training of the PyTorch port on the CPU, against
tpu_mf on the same files and seeds: the ShardStore and the per-shard plans
bit for bit, the workdir plan cache, FusedStreamTrainer epochs against
tpu_mf's interpret-mode kernel, the per-batch streaming epochs, the
streamed loop bodies of all three algorithms, a resumed streamed run, and
the Prefetcher's order, errors and close()."""

import os
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_mf.data.coo import synthetic_ratings
from tpu_mf.data.proto import write_block_frames
from tpu_mf.io import stream as jstream
from tpu_mf.io import stream_fused as jsf
from tpu_mf.models.admf import init_admf as jax_init_admf
from tpu_mf.models.dpmf import DPMFState as JaxDPMFState
from tpu_mf.models.dpmf import dp_bound as jax_dp_bound
from tpu_mf.models.mf import MFParams as JaxParams
from tpu_mf.models.mf import rmse as jax_rmse
from tpu_mf.ops.adreg import AdRegHyper as JaxAdRegHyper
from tpu_mf.ops.gibbs import sample_hyper as jax_sample_hyper
from tpu_mf.ops.pallas_sgd import UV_BASE
from tpu_mf.ops.sgld import SgldHyper as JaxSgldHyper
from tpu_mf.ops.sgld import finish_noise as jax_finish_noise
from tpu_mf_torch.config import TrainConfig
from tpu_mf_torch.data.coo import RatingsCOO
from tpu_mf_torch.io import stream as tstream
from tpu_mf_torch.io import stream_fused as tsf
from tpu_mf_torch.models.admf import admf_state_from_numpy, admf_state_to_numpy
from tpu_mf_torch.models.dpmf import dpmf_state_from_numpy, dpmf_state_to_numpy
from tpu_mf_torch.models.mf import params_from_numpy, params_to_numpy
from tpu_mf_torch.ops.adreg import AdRegHyper
from tpu_mf_torch.ops.sgld import SgldHyper
from tpu_mf_torch.train import loop as tloop
from tpu_mf_torch.train.metrics import recording

torch.set_num_threads(1)
TILE, BATCH, MEM = 32, 128, 3000
TABLES = ("theta", "phi", "bu", "bv")
PRECISIONS = ("lambda_r", "lambda_ub", "lambda_vb", "lambda_u", "lambda_v")
LAMBDAS = ("lam_u", "lam_v", "lam_bu", "lam_bv")


@pytest.fixture(scope="module")
def stream_file(tmp_path_factory):
    """(proto-frame training file, tpu_mf train, tpu_mf test): 200 x 100,
    12k ratings split 80/20, as tpu_mf's own streaming tests."""
    ds = synthetic_ratings(200, 100, 12000, rank=3, noise=0.1, seed=1)
    train, test = ds.split(0.2, seed=2)
    path = str(tmp_path_factory.mktemp("stream") / "train.pb")
    write_block_frames(path, train)
    return path, train, test


def np_tables(nu, nv, dim, seed=0, gb=3.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.1, (nu, dim)).astype(np.float32),
            rng.normal(0, 0.1, (nv, dim)).astype(np.float32),
            rng.normal(0, 0.1, nu).astype(np.float32),
            rng.normal(0, 0.1, nv).astype(np.float32), np.float32(gb))


def jax_params(tabs):
    return JaxParams(*(jnp.asarray(x) for x in tabs))


def held(got, want, atol, what=""):
    for k, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=atol, err_msg=f"{what} field {k}")


def trainers(path, tmp_path, mxu="float32", seed=3, plan_cache=2):
    kw = dict(tile_u=TILE, tile_v=TILE, batch=BATCH, mem_limit=MEM,
              seed=seed, mxu=mxu, plan_cache=plan_cache)
    return (jsf.FusedStreamTrainer(path, interpret=True,
                                   workdir=str(tmp_path / "jax"), **kw),
            tsf.FusedStreamTrainer(path, workdir=str(tmp_path / "port"),
                                   device="cpu", **kw))


# ---- ShardStore and plans -----------------------------------------------------

def test_shard_store_bit_equal(stream_file, tmp_path):
    """The port's ShardStore makes tpu_mf's shards: the same count, tiles
    per shard and dims, and every shard loads the same records in the
    same shuffled order."""
    path, train, _ = stream_file
    js = jsf.ShardStore(path, tile_u=TILE, mem_limit=MEM,
                        workdir=str(tmp_path / "j"))
    ts = tsf.ShardStore(path, tile_u=TILE, mem_limit=MEM,
                        workdir=str(tmp_path / "t"))
    assert ts.n_shards == js.n_shards > 1
    assert (ts.tiles_per_shard, ts.nu, ts.nv, ts.n) == (
        js.tiles_per_shard, js.nu, js.nv, js.n)
    assert ts.n == len(train)
    for s in range(js.n_shards):
        with open(js.paths[s], "rb") as a, open(ts.paths[s], "rb") as b:
            assert a.read() == b.read()
        for seed in (0, 104729 * s + 7):
            a, b = js.load(s, seed), ts.load(s, seed)
            for k in "uvr":
                np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
                assert getattr(a, k).dtype == getattr(b, k).dtype


@pytest.mark.parametrize("plan_cache,epoch", [(2, 0), (2, 1), (0, 3)])
def test_shard_plans_bit_equal(stream_file, tmp_path, plan_cache, epoch):
    """Every shard's gen-1 plan of an epoch is tpu_mf's (variants 0 and 1
    of the cache, and a fresh plan with plan_cache=0): u, v, r, gu, gv bit
    for bit against tpu_mf's decoded uv stream, whose extra batches (its
    pad to 64) are all sentinels."""
    path, _, _ = stream_file
    jt, tt = trainers(path, tmp_path, plan_cache=plan_cache)
    plans = list(tt._plans(epoch))
    assert [s for s, *_ in plans] == list(range(jt.store.n_shards))
    v = epoch % plan_cache if plan_cache else epoch
    sentinel = TILE * UV_BASE + TILE
    for s, plan, cached in plans:
        assert not cached
        gu, gv, uv, r = jt._build_plan(
            s, seed_load=3 + 7919 * v + 104729 * s,
            seed_plan=3 ^ (v * 65537 + s))
        nb = plan.u.shape[0]
        np.testing.assert_array_equal(gu[:nb], plan.gu)
        np.testing.assert_array_equal(gv[:nb], plan.gv)
        np.testing.assert_array_equal(uv[:nb], plan.u * UV_BASE + plan.v)
        np.testing.assert_array_equal(r[:nb], plan.r)
        np.testing.assert_array_equal(plan.w, (plan.u != TILE))
        assert (uv[nb:] == sentinel).all() and (r[nb:] == 0).all()
        assert int(plan.w.sum()) == plan.n_real


def test_plan_cache_reused_and_rejected_when_stale(stream_file, tmp_path):
    """A second pass over the same variant loads the cached plans (the
    same arrays); a trainer of another seed on the same workdir rebuilds
    them; tpu_mf's cache files in that workdir are never read (the port's
    have names of their own)."""
    path, _, _ = stream_file
    wk = str(tmp_path / "wk")
    kw = dict(tile_u=TILE, tile_v=TILE, batch=BATCH, mem_limit=MEM,
              mxu="float32", workdir=wk)
    jt = jsf.FusedStreamTrainer(path, seed=3, interpret=True, **kw)
    list(jt._plans(0))  # tpu_mf's cache files: plan.<shard>.<variant>.npz
    t1 = tsf.FusedStreamTrainer(path, seed=3, device="cpu", **kw)
    first = list(t1._plans(0))
    again = list(t1._plans(2))  # variant 0 again
    assert not any(c for *_, c in first) and all(c for *_, c in again)
    for (_, a, _), (_, b, _) in zip(first, again):
        for k in ("u", "v", "r", "w", "gu", "gv"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        assert a.n_real == b.n_real
    names = sorted(os.listdir(wk))
    assert any(n.startswith("plan.") for n in names)
    assert any(n.startswith("tplan.") for n in names)
    t2 = tsf.FusedStreamTrainer(path, seed=99, device="cpu", **kw)
    other = list(t2._plans(0))
    assert not any(c for *_, c in other)
    assert any(not np.array_equal(a.u, b.u)
               for (_, a, _), (_, b, _) in zip(first, other))


@pytest.mark.parametrize("mxu,atol", [("float32", 2e-5), ("bfloat16", 1e-4)])
def test_fused_stream_epochs_match_tpu_mf(stream_file, tmp_path, mxu, atol):
    """Two multi-shard FusedStreamTrainer epochs (plan variants 1 and 0)
    on CPU tensors (the kernel's plain version, 8/8 groups, no
    saturation) against tpu_mf's in interpret mode from the same tables."""
    path, train, test = stream_file
    jt, tt = trainers(path, tmp_path, mxu=mxu)
    assert tt.store.n_shards > 1
    tabs = np_tables(tt.nu, tt.nv, 8, seed=4, gb=train.mean_rating())
    jtab = jt.pad(jax_params(tabs))
    ttab = tt.pad(params_from_numpy(*tabs, device="cpu"))
    gb = float(tabs[4])
    with recording() as recs:
        for it in (1, 2):
            jtab = jt.epoch(jtab, 0.02 / it, 0.01, gb, epoch_idx=it)
            tt.epoch(ttab, 0.02 / it, 0.01, gb, epoch_idx=it)
    got, want = params_to_numpy(tt.trim(ttab)), jt.trim(jtab)
    held(got[:4], want[:4], atol, mxu)
    assert np.abs(got[0] - tabs[0]).max() > 1e-3  # it trained
    assert [r["attrs"]["epoch"] for r in recs
            if r["name"] == "tmf.sub_epoch"] == (
        [1] * tt.store.n_shards + [2] * tt.store.n_shards)
    assert tsf.FusedStreamTrainer.launches == 0  # CPU: no kernel launch
    tt.close()
    jt.close()


def test_fused_stream_trainer_passes_the_streamed_options(stream_file,
                                                         tmp_path,
                                                         monkeypatch):
    """Each shard's launch passes tpu_mf's _run_epoch options explicitly:
    8/8 groups, no saturation, t*p rounded to the working type."""
    path, _, _ = stream_file
    _, tt = trainers(path, tmp_path, mxu="bfloat16")
    seen = []

    def fake(*args, **kw):
        seen.append(kw)

    fake.launches = 0
    monkeypatch.setattr(tsf, "cell_epoch", fake)
    tabs = tt.pad(params_from_numpy(*np_tables(tt.nu, tt.nv, 8), "cpu"))
    tt.epoch(tabs, 0.01, 0.01, 3.0)
    assert len(seen) == tt.store.n_shards
    assert all(kw == dict(theta_groups=8, phi_groups=8, work=torch.bfloat16,
                          saturate=False, mxu_pred=True) for kw in seen)


# ---- the per-batch streaming path ---------------------------------------------

def test_streaming_sgd_epoch_and_mse_match(stream_file):
    """streaming_sgd_epoch (in place) and streaming_mse against tpu_mf's
    on the same file and tables, within 1e-6, and the real-rating count."""
    path, train, _ = stream_file
    tabs = np_tables(train.nu, train.nv, 8, seed=5, gb=train.mean_rating())
    jp, n_j = jstream.streaming_sgd_epoch(jax_params(tabs), path, 0.03, 0.01,
                                          batch_size=1000, fly=3)
    tp, n_t = tstream.streaming_sgd_epoch(params_from_numpy(*tabs, "cpu"),
                                          path, 0.03, 0.01, batch_size=1000,
                                          fly=3)
    assert n_t == n_j == len(train)
    held(params_to_numpy(tp)[:4], jp[:4], 1e-6, "sgd")
    mse_j = jstream.streaming_mse(jp, path, batch_size=3000)
    mse_t = tstream.streaming_mse(tp, path, batch_size=3000)
    assert abs(mse_t - mse_j) <= 1e-6, (mse_t, mse_j)


def jax_dp_state(tabs, path, dim):
    """tpu_mf's train_dpmf_stream initial state (loop.py:719-736) on the
    numpy tables."""
    nu, nv, ntrain, uc, vc, _ = jstream_profile(path)
    return JaxDPMFState(
        params=jax_params(tabs), lambda_r=jnp.float32(1.0),
        lambda_ub=jnp.float32(1e2), lambda_vb=jnp.float32(1e2),
        lambda_u=jnp.full((dim,), 1e2, jnp.float32),
        lambda_v=jnp.full((dim,), 1e2, jnp.float32),
        ur=jnp.asarray((ntrain / np.maximum(uc, 1)).astype(np.float32)),
        vr=jnp.asarray((ntrain / np.maximum(vc, 1)).astype(np.float32)),
        gcountu=jnp.zeros(nu + 1, jnp.int32),
        gcountv=jnp.zeros(nv + 1, jnp.int32), gcount=jnp.int32(0)), ntrain


def jstream_profile(path):
    from tpu_mf.data.streamfmt import scan_profile

    return scan_profile(path)


def dp_arrays(js) -> dict:
    p = js.params
    out = {k: np.asarray(getattr(p, k)) for k in TABLES + ("gb",)}
    out.update({k: np.asarray(getattr(js, k)) for k in PRECISIONS + (
        "ur", "vr", "gcountu", "gcountv", "gcount")})
    return out


def test_streaming_sgld_round_at_temp_0_matches(stream_file):
    """streaming_sgld_round at temp 0 against tpu_mf's: tables within 1e-6,
    the lazy-noise counters exactly."""
    path, train, _ = stream_file
    tabs = np_tables(train.nu, train.nv, 8, seed=6, gb=train.mean_rating())
    js, ntrain = jax_dp_state(tabs, path, 8)
    st = dpmf_state_from_numpy(dp_arrays(js), "cpu")
    f32 = jnp.float32
    js, n_j = jstream.streaming_sgld_round(
        js, path, JaxSgldHyper(f32(5e-6), f32(0.0), f32(1.0), f32(ntrain)),
        jax.random.PRNGKey(1), batch_size=1000, fly=2)
    st, n_t = tstream.streaming_sgld_round(
        st, path, SgldHyper(5e-6, 0.0, 1.0, float(ntrain)),
        torch.Generator().manual_seed(1), batch_size=1000, fly=2)
    assert n_t == n_j == ntrain
    got, want = dpmf_state_to_numpy(st), dp_arrays(js)
    held([got[k] for k in TABLES], [want[k] for k in TABLES], 1e-6, "sgld")
    for k in ("gcountu", "gcountv", "gcount"):
        np.testing.assert_array_equal(got[k], want[k].astype(np.int64))
    assert np.abs(got["theta"] - tabs[0]).max() > 1e-4  # it moved


def jax_draws(key, n_batches, n_valid):
    """tpu_mf's validation draws of a streamed epoch: randint of
    fold_in(key, i) per batch i (ops/adreg.py)."""
    return np.stack([np.asarray(jax.random.randint(
        jax.random.fold_in(key, i), (64,), 0, n_valid))
        for i in range(n_batches)]).astype(np.int64)


def adreg_pair(train, valid, dim=8, lam=0.02, seed=0):
    js = jax_init_admf(jax.random.PRNGKey(seed), train.nu, train.nv, dim,
                       lam=lam, gb=float(train.mean_rating()))
    return js, admf_state_from_numpy(ad_arrays(js), "cpu")


def ad_arrays(js) -> dict:
    out = {k: np.asarray(getattr(js.params, k)) for k in TABLES + ("gb",)}
    out.update({k: np.asarray(getattr(js, k)) for k in (
        "theta_old", "phi_old", "bu_old", "bv_old") + LAMBDAS})
    return out


def valid_tensors(valid):
    return (torch.as_tensor(valid.u.astype(np.int64)),
            torch.as_tensor(valid.v.astype(np.int64)),
            torch.as_tensor(valid.r))


def test_streaming_adreg_epoch_matches_with_injected_draws(stream_file):
    """streaming_adreg_epoch with tpu_mf's fold_in(key, batch) draws
    injected against tpu_mf's: tables, shadows and lambdas within 1e-6."""
    path, train, test = stream_file
    js, st = adreg_pair(train, test)
    key = jax.random.PRNGKey(7)
    n_batches = -(-len(train) // 1000)
    draws = jax_draws(key, n_batches, len(test))
    js, _ = jstream.streaming_adreg_epoch(
        js, path, tuple(jnp.asarray(x) for x in (test.u, test.v, test.r)),
        JaxAdRegHyper(jnp.float32(0.02), jnp.float32(0.05), 0), key,
        batch_size=1000, fly=2)
    st, n = tstream.streaming_adreg_epoch(
        st, path, valid_tensors(test), AdRegHyper(0.02, 0.05, 0),
        lambda i: torch.as_tensor(draws[i]), batch_size=1000, fly=2)
    assert n == len(train)
    got, want = admf_state_to_numpy(st), ad_arrays(js)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    assert abs(float(got["lam_u"]) - 0.02) > 1e-6  # the lambdas moved


def test_adreg_generator_draws_one_per_batch(stream_file):
    """With a generator, streaming_adreg_epoch draws K indices per batch
    in batch order: the same as a callable that makes those draws."""
    path, train, test = stream_file
    _, st1 = adreg_pair(train, test)
    _, st2 = adreg_pair(train, test)
    gen = torch.Generator().manual_seed(11)
    seq = [torch.randint(len(test), (64,), generator=gen) for _ in range(10)]
    hyper = AdRegHyper(0.02, 0.05, 0)
    st1, _ = tstream.streaming_adreg_epoch(
        st1, path, valid_tensors(test), hyper,
        torch.Generator().manual_seed(11), batch_size=1000)
    st2, _ = tstream.streaming_adreg_epoch(
        st2, path, valid_tensors(test), hyper, lambda i: seq[i],
        batch_size=1000)
    a, b = admf_state_to_numpy(st1), admf_state_to_numpy(st2)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---- the streamed loops -------------------------------------------------------

def test_train_mf_stream_matches_tpu_mf(stream_file):
    """train_mf_stream on the CPU (the per-batch path, as tpu_mf's on its
    CPU backend) from tables carried across: the final tables within 1e-5
    and the iter# lines' tRMSE within 1e-5."""
    from tpu_mf.config import TrainConfig as JaxConfig
    from tpu_mf.train.loop import train_mf_stream as jax_train_mf_stream

    path, train, test = stream_file
    kw = dict(dim=8, iters=2, eta=0.03, lam=0.01, batch_size=1000,
              gb=float(train.mean_rating()))
    tabs = np_tables(train.nu, train.nv, 8, seed=8, gb=kw["gb"])
    jlog, tlog = [], []
    want = jax_train_mf_stream(JaxConfig(**kw), path, test_ds=test,
                               params=jax_params(tabs), log=jlog.append)
    got = tloop.train_mf_stream(
        TrainConfig(**kw), path, test_ds=RatingsCOO(test.u, test.v, test.r,
                                                    test.nu, test.nv),
        params=params_from_numpy(*tabs, "cpu"), log=tlog.append,
        device="cpu")
    held(params_to_numpy(got)[:4], want[:4], 1e-5, "train_mf_stream")
    rm = [[float(x.split("tRMSE=")[1]) for x in lg if "tRMSE=" in x]
          for lg in (tlog, jlog)]
    assert len(rm[0]) == 2
    np.testing.assert_allclose(rm[0], rm[1], rtol=0, atol=1e-5)


def test_dpmf_stream_rounds_match_tpu_mf_loop_body(stream_file):
    """_dpmf_stream_round over 2 rounds at temp 0 against tpu_mf's
    train_dpmf_stream loop body (loop.py:796-824), tpu_mf's Gibbs draws
    carried into the port's state between rounds: tables, counters and
    the round lines' RMSE / tRMSE within 1e-5."""
    path, train, test = stream_file
    cfg = TrainConfig(alg="dpmf", dim=8, iters=2, eta=5e-6, temp=0.0,
                      hyperb=1000.0, gb=float(train.mean_rating()), seed=3,
                      batch_size=1000)
    tabs = np_tables(train.nu, train.nv, 8, seed=9, gb=cfg.gb)
    js, ntrain = jax_dp_state(tabs, path, 8)
    log = []
    run, st = tloop._dpmf_stream_setup(
        cfg, path, RatingsCOO(test.u, test.v, test.r, test.nu, test.nv),
        log.append, None, None, "cpu")
    np.testing.assert_array_equal(st.ur.numpy(), np.asarray(js.ur))
    st = dpmf_state_from_numpy(dp_arrays(js), "cpu")
    bound = jax_dp_bound(cfg.epsilon, cfg.tau, train.nv)
    key = jax.random.PRNGKey(cfg.seed ^ 0xD1FF)
    f32 = jnp.float32
    for rnd in (1, 2):
        eta_r = cfg.eta_at_cutoff(rnd)
        js, _ = jstream.streaming_sgld_round(
            js, path, JaxSgldHyper(f32(eta_r), f32(cfg.temp), f32(bound),
                                   f32(ntrain)),
            jax.random.fold_in(key, rnd), batch_size=cfg.batch_size,
            fly=cfg.fly)
        js = jax_finish_noise(js, f32(eta_r), f32(cfg.temp),
                              jax.random.fold_in(key, rnd + 500_000))
        mse = jstream.streaming_mse(js.params, path)
        js = jax_sample_hyper(js, f32(mse * ntrain), f32(ntrain),
                              f32(cfg.hypera), f32(cfg.hyperb),
                              jax.random.fold_in(key, rnd + 1_000_000))
        st = tloop._dpmf_stream_round(run, rnd, st)
        got, want = dpmf_state_to_numpy(st), dp_arrays(js)
        held([got[k] for k in TABLES], [want[k] for k in TABLES], 1e-5,
             f"round {rnd}")
        for k in ("gcountu", "gcountv", "gcount"):
            np.testing.assert_array_equal(got[k], want[k].astype(np.int64))
        f = log[-1].split("\t")
        assert f[0] == f"round #{rnd}"
        np.testing.assert_allclose(
            [float(f[1].split("=")[1]), float(f[2].split("=")[1])],
            [np.sqrt(mse), float(jax_rmse(js.params, test))], rtol=0,
            atol=1e-5)
        st = st._replace(**{k: torch.as_tensor(want[k]) for k in PRECISIONS})


def test_train_admf_stream_matches_tpu_mf(stream_file, monkeypatch):
    """train_admf_stream on the CPU against tpu_mf's (the per-batch path),
    tpu_mf's initial state and validation draws carried in: tables and
    lambdas within 1e-5 and the iter# lines."""
    from tpu_mf.config import TrainConfig as JaxConfig
    from tpu_mf.train.loop import train_admf_stream as jax_train_admf_stream

    path, train, test = stream_file
    kw = dict(alg="admf", dim=8, iters=2, eta=0.02, eta_reg=0.05, lam=0.02,
              gb=float(train.mean_rating()), seed=4, batch_size=1000)
    js0 = jax_init_admf(jax.random.PRNGKey(kw["seed"]), train.nu, train.nv,
                        8, lam=kw["lam"], gb=kw["gb"])
    monkeypatch.setattr(tloop, "init_admf", lambda *a, **k:
                        admf_state_from_numpy(ad_arrays(js0), "cpu"))
    base = jax.random.PRNGKey(kw["seed"] ^ 0xADF0)
    n_batches = -(-len(train) // kw["batch_size"])
    monkeypatch.setattr(
        tloop, "_admf_stream_samples", lambda cfg, it, dev: (
            lambda i, d=jax_draws(jax.random.fold_in(base, it), n_batches,
                                  len(test)): torch.as_tensor(d[i])))
    jlog, tlog = [], []
    tdata = RatingsCOO(test.u, test.v, test.r, test.nu, test.nv)
    want = jax_train_admf_stream(JaxConfig(**kw), path, test, test_ds=test,
                                 log=jlog.append)
    got = tloop.train_admf_stream(TrainConfig(**kw), path, tdata,
                                  test_ds=tdata, log=tlog.append,
                                  device="cpu")
    g, w = admf_state_to_numpy(got), ad_arrays(want)
    for k in TABLES + LAMBDAS:
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-5, err_msg=k)
    assert [x.split("\t")[0] for x in tlog] == ["iter#1", "iter#2"]
    np.testing.assert_allclose(
        [float(x.split("tRMSE=")[1]) for x in tlog],
        [float(x.split("tRMSE=")[1]) for x in jlog], rtol=0, atol=1e-5)


@pytest.mark.parametrize("alg", ["mf", "dpmf", "admf"])
def test_resumed_stream_run_equals_uninterrupted(stream_file, tmp_path, alg):
    """A streamed CPU run of 2 epochs with --resume, restarted with 3,
    resumes round 2, runs round 3 alone and ends with the tables of an
    uninterrupted 3-round run. admf's shadows restart as copies of the
    restored tables (as tpu_mf's): its resumed run equals epoch 3 streamed
    from ``with_shadows`` of the uninterrupted round-2 state."""
    from tpu_mf_torch.models.admf import with_shadows

    path, train, test = stream_file
    tdata = RatingsCOO(test.u, test.v, test.r, test.nu, test.nv)
    kw = dict(alg=alg, dim=8, eta=0.03 if alg != "dpmf" else 5e-6,
              hyperb=1000.0, gb=float(train.mean_rating()), batch_size=1000)

    def run(iters, result=None):
        cfg = TrainConfig(iters=iters, result=result, resume=bool(result),
                          **kw)
        lines = []
        if alg == "mf":
            out = tloop.train_mf_stream(cfg, path, tdata, log=lines.append,
                                        device="cpu")
        elif alg == "dpmf":
            out = tloop.train_dpmf_stream(cfg, path, tdata,
                                          log=lines.append, device="cpu")
        else:
            out = tloop.train_admf_stream(cfg, path, tdata, tdata,
                                          log=lines.append, device="cpu")
        return out, lines

    if alg == "admf":
        st, _ = run(2)
        cfg = TrainConfig(iters=3, **kw)
        st, _ = tstream.streaming_adreg_epoch(
            with_shadows(st.params, [getattr(st, k) for k in LAMBDAS]),
            path, valid_tensors(test),
            AdRegHyper(cfg.eta_at(3), cfg.eta_reg_at(3), cfg.loss),
            tloop._admf_stream_samples(cfg, 3, "cpu"),
            batch_size=cfg.batch_size)
        want = st.params
    else:
        want, _ = run(3)
    prefix = str(tmp_path / "m")
    run(2, prefix)
    got, lines = run(3, prefix)
    assert f"# resumed from round 2 ({prefix}.state)" in lines
    assert [x.split("\t")[0] for x in lines if not x.startswith("#")] == [
        "round #3" if alg == "dpmf" else "iter#3"]
    if alg != "mf":
        got, want = got.params, getattr(want, "params", want)
    held(params_to_numpy(got)[:4], params_to_numpy(want)[:4], 0.0, alg)


# ---- Prefetcher ---------------------------------------------------------------

def drain(pf, timeout=20.0):
    """The Prefetcher's items, on a thread joined with a timeout, so a hang
    fails the test instead of blocking it."""
    out, err = [], []

    def run():
        try:
            out.extend(pf)
        except BaseException as e:  # noqa: BLE001 - surfaced below
            err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), "the Prefetcher hung"
    return out, err


def test_prefetcher_keeps_order_and_stages_arrays():
    """Items come out in source order, their numpy arrays as CPU tensors,
    other values as they were."""
    src = [(np.arange(i, i + 4, dtype=np.int32), {"k": np.float32(i)}, i)
           for i in range(20)]
    out, err = drain(tstream.Prefetcher(iter(src), fly=3, device="cpu"))
    assert not err and len(out) == 20
    for i, (a, d, j) in enumerate(out):
        assert isinstance(a, torch.Tensor) and a.tolist() == list(
            range(i, i + 4))
        assert j == i and float(d["k"]) == i


def test_prefetcher_raises_the_source_error_at_consumption():
    """The source's exception reaches the consumer after the items made
    before it."""
    def src():
        yield np.zeros(2)
        yield np.ones(2)
        raise ValueError("bad frame")

    out, err = drain(tstream.Prefetcher(src(), fly=1, device="cpu"))
    assert len(out) == 2 and len(err) == 1
    assert isinstance(err[0], ValueError) and "bad frame" in str(err[0])


def test_prefetcher_close_releases_the_worker():
    """close() on an abandoned Prefetcher with a full queue lets the worker
    finish (it stops putting) and drops the staged items."""
    made = []

    def src():
        for i in range(1000):
            made.append(i)
            yield np.full(3, i)

    pf = tstream.Prefetcher(src(), fly=2, device="cpu")
    assert next(pf).tolist() == [0, 0, 0]
    pf.close()
    pf._thread.join(10.0)
    assert not pf._thread.is_alive()
    assert len(made) < 1000 and pf._q.empty()
    pf.close()  # idempotent
