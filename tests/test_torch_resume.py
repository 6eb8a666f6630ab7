"""Resume and bfloat16 tables in the PyTorch port (tpu_mf_torch/io/resume.py,
the loops' --resume, --dtype bfloat16) against tpu_mf: state file names,
pruning and the atomic temp name; state files crossing between the two
packages both ways; resumed CPU runs of all three algorithms against
uninterrupted ones; bf16 init draws, a batched bf16 epoch, and the dtype a
fused schedule returns."""

import glob
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_mf.data.coo import epoch_batches, synthetic_ratings
from tpu_mf.io import resume as jres
from tpu_mf.models.mf import MFParams as JaxParams
from tpu_mf.models.mf import init_mf as jax_init_mf
from tpu_mf.ops.sgd import sgd_epoch as jax_sgd_epoch
from tpu_mf_torch.config import TrainConfig
from tpu_mf_torch.io import resume as tres
from tpu_mf_torch.models.admf import LAMBDAS, init_admf, with_shadows
from tpu_mf_torch.models.dpmf import init_dpmf
from tpu_mf_torch.models.mf import MFParams, init_mf, params_from_numpy
from tpu_mf_torch.ops.sgd import sgd_epoch
from tpu_mf_torch.train import train_admf, train_dpmf, train_mf
from tpu_mf_torch.train.loop import (
    _dpmf_extras,
    _Observer,
    _train_admf_batched,
    _train_mf_fused,
)

torch.set_num_threads(1)


def data(seed=0):
    ds = synthetic_ratings(200, 150, 6000, rank=3, noise=0.2, seed=seed)
    return ds.split(0.1, seed=seed + 1)


def np_tables(nu, nv, dim, gb=3.0, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1e-1, (nu, dim)).astype(np.float32),
            rng.normal(0, 1e-1, (nv, dim)).astype(np.float32),
            rng.normal(0, 1e-1, nu).astype(np.float32),
            rng.normal(0, 1e-1, nv).astype(np.float32), np.float32(gb))


def test_round_files_prune_and_temp_name(tmp_path, monkeypatch):
    """<prefix>.r%06d.npz, the newest 3 kept, written by renaming
    <prefix>.tmp-npz.npz; tpu_mf's writer leaves the same names."""
    renames = []
    real_replace = os.replace

    def replace(src, dst):
        renames.append((os.path.basename(src), os.path.basename(dst)))
        real_replace(src, dst)

    monkeypatch.setattr(tres.os, "replace", replace)
    tabs = np_tables(5, 4, 2)
    port_prefix = str(tmp_path / "port" / "run.state")
    jax_prefix = str(tmp_path / "jax" / "run.state")
    os.makedirs(os.path.dirname(port_prefix))
    os.makedirs(os.path.dirname(jax_prefix))
    assert tres.latest(port_prefix) is None and tres.resume_round(
        port_prefix) == 0 and tres.load_round(port_prefix, "cpu") is None
    for rnd in (1, 2, 3, 4, 12):
        path = tres.save_round(port_prefix, rnd,
                               params_from_numpy(*tabs, device="cpu"))
        assert path == f"{port_prefix}.r{rnd:06d}.npz"
        jres.save_round(jax_prefix, rnd, JaxParams(*tabs))
    assert renames[-1] == ("run.state.tmp-npz.npz", "run.state.r000012.npz")
    names = sorted(os.path.basename(p) for p in glob.glob(port_prefix + "*"))
    assert names == ["run.state.r000003.npz", "run.state.r000004.npz",
                     "run.state.r000012.npz"]
    assert names == sorted(os.path.basename(p)
                           for p in glob.glob(jax_prefix + "*"))
    assert tres.resume_round(port_prefix) == 12
    assert tres.latest(port_prefix).endswith(".r000012.npz")


def dpmf_extras_np(rng, nu, nv, dim):
    """tpu_mf's dpmf_extras keys and dtypes (loop.py:1142-1152)."""
    return dict(
        lambda_r=np.float32(1.5), lambda_ub=np.float32(90.0),
        lambda_vb=np.float32(110.0),
        lambda_u=rng.uniform(50, 150, dim).astype(np.float32),
        lambda_v=rng.uniform(50, 150, dim).astype(np.float32),
        gcountu=rng.integers(0, 1000, nu + 1).astype(np.int32),
        gcountv=rng.integers(0, 1000, nv + 1).astype(np.int32),
        gcount=np.int32(4321))


EXTRAS = {
    "mf": lambda rng, nu, nv, dim: {},
    "dpmf": dpmf_extras_np,
    "admf": lambda rng, nu, nv, dim: {k: np.float32(x) for k, x in zip(
        LAMBDAS, rng.uniform(0, 0.1, 4))},
}


@pytest.mark.parametrize("alg", sorted(EXTRAS))
@pytest.mark.parametrize("writer", ["tpu_mf", "port"])
def test_state_files_cross_between_packages(tmp_path, writer, alg):
    """A round file written by either package loads in the other with
    equal arrays, keys and dtypes (dpmf's int32 counters included); bf16
    tables in the port are written as float32."""
    rng = np.random.default_rng(7)
    nu, nv, dim = 30, 20, 4
    tabs = np_tables(nu, nv, dim, gb=2.5)
    extras = EXTRAS[alg](rng, nu, nv, dim)
    prefix = str(tmp_path / "s.state")
    if writer == "tpu_mf":
        jres.save_round(prefix, 2, JaxParams(*(jnp.asarray(t) for t in tabs)),
                        **extras)
        params, got = tres.load_round(prefix, "cpu")
        assert all(isinstance(t, torch.Tensor) for t in params)
        host = [t.numpy() for t in params[:4]] + [float(params.gb)]
    else:
        tres.save_round(prefix, 2, params_from_numpy(*tabs, device="cpu"),
                        **extras)
        jparams, got = jres.load_round(prefix)
        host = [np.asarray(t) for t in jparams[:4]] + [float(jparams.gb)]
    for a, b in zip(host[:4], tabs[:4]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.float32
    assert host[4] == float(tabs[4])
    assert sorted(got) == sorted(["round", *extras])
    assert int(got["round"]) == 2
    for k, v in extras.items():
        np.testing.assert_array_equal(got[k], v)
        assert got[k].dtype == np.asarray(v).dtype, k
    # bf16 tables are widened on the way out, and tpu_mf reads them
    bf = MFParams(*(torch.as_tensor(t).to(torch.bfloat16) for t in tabs[:4]),
                  torch.tensor(2.5, dtype=torch.bfloat16))
    tres.save_round(prefix, 3, bf)
    jparams, _ = jres.load_round(prefix)
    for a, b in zip(jparams[:4], bf[:4]):
        assert np.asarray(a).dtype == np.float32
        np.testing.assert_array_equal(np.asarray(a), b.float().numpy())


def test_port_dpmf_extras_are_tpu_mf_keys_and_dtypes():
    """_dpmf_extras writes tpu_mf's keys with its dtypes: float32
    precisions, int32 counters (the port's state holds int64)."""
    tr, _ = data()
    st = init_dpmf(tr, 4, 3.0, torch.Generator().manual_seed(0), "cpu")
    st.gcountu[:] = torch.arange(tr.nu + 1)
    got = _dpmf_extras(st._replace(gcount=torch.tensor(77)))
    want = dpmf_extras_np(np.random.default_rng(0), tr.nu, tr.nv, 4)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
    assert int(got["gcount"]) == 77
    np.testing.assert_array_equal(got["gcountu"], np.arange(tr.nu + 1))


def test_resume_requires_result_like_tpu_mf(tmp_path, capsys):
    """--resume without --result: tpu_mf's message on stderr and its exit
    code, before any data is read."""
    from tpu_mf.cli import main as jax_main
    from tpu_mf_torch.cli import main

    args = ["--train", str(tmp_path / "absent.csv"), "--resume"]
    rc = main(args + ["--device", "cpu"])
    port_err = capsys.readouterr().err
    jrc = jax_main(args)
    jax_err = capsys.readouterr().err
    assert rc == jrc == 1
    assert port_err == jax_err == (
        "--resume requires --result (checkpoint prefix)\n")


def run_alg(alg, cfg, tr, te, log):
    if alg == "mf":
        return train_mf(cfg, tr, te, log=log, device="cpu")
    if alg == "dpmf":
        return train_dpmf(cfg, tr, te, log=log, device="cpu")
    return train_admf(cfg, tr, te, te, log=log, device="cpu")


CFGS = {"mf": dict(dim=8, eta=0.02, batch_size=512),
        "dpmf": dict(alg="dpmf", dim=8, eta=2e-5, hyperb=1000.0,
                     batch_size=512),
        "admf": dict(alg="admf", dim=8, eta=0.02, eta_reg=0.05,
                     batch_size=512)}


def metrics(line):
    """A round line's RMSE fields (the elapsed time left out)."""
    return [x for x in line.split("\t") if "RMSE=" in x]


def final_tables(out):
    params = out if isinstance(out, MFParams) else out.params
    return [t.float().numpy() for t in params[:4]]


@pytest.mark.parametrize("alg", sorted(CFGS))
def test_resumed_run_equals_uninterrupted(tmp_path, alg):
    """Rounds 1-2, then a resumed call to round 3, against 3 rounds in one
    call (CPU, the batched path): mf and dpmf end bit for bit equal, with
    equal tRMSE lines for round 3; the files keep rounds 1-3. admf's
    shadows restart as copies of the restored tables: its resumed run
    equals round 3 from ``with_shadows`` of the round-2 state."""
    tr, te = data()
    opts = dict(CFGS[alg], gb=tr.mean_rating(), seed=1, resume=True)
    whole, log_w = str(tmp_path / "whole"), []
    want = run_alg(alg, TrainConfig(iters=3, result=whole, **opts), tr, te,
                   log_w.append)
    part, log_p = str(tmp_path / "part"), []
    first = run_alg(alg, TrainConfig(iters=2, result=part, **opts), tr, te,
                    log_p.append)
    got = run_alg(alg, TrainConfig(iters=3, result=part, **opts), tr, te,
                  log_p.append)
    assert f"# resumed from round 2 ({part}.state)" in log_p
    assert sorted(os.path.basename(p) for p in glob.glob(part + ".state*")
                  ) == [f"part.state.r00000{i}.npz" for i in (1, 2, 3)]
    third = [x.split("\t")[0] for x in log_p[log_p.index(
        f"# resumed from round 2 ({part}.state)") + 1:]]
    assert third == (["round #3"] if alg == "dpmf" else ["iter#3"])
    if alg != "admf":
        for a, b in zip(final_tables(got), final_tables(want)):
            np.testing.assert_array_equal(a, b)
        assert metrics(log_p[-1]) == metrics(log_w[-1])
        return
    cfg = TrainConfig(iters=3, **{k: v for k, v in opts.items()
                                  if k != "resume"})
    restart = with_shadows(MFParams(*(t.clone() for t in first.params)),
                           [getattr(first, k) for k in LAMBDAS])
    for t, s in zip(restart.params[:4], restart[1:5]):
        assert torch.equal(t, s) and t.data_ptr() != s.data_ptr()
    ref = _train_admf_batched(cfg, tr, te, te, restart, lambda _: None,
                              _Observer(cfg, len(tr)), start=2)
    for a, b in zip(final_tables(got), final_tables(ref)):
        np.testing.assert_array_equal(a, b)
    for k in LAMBDAS:
        assert float(getattr(got, k)) == float(getattr(ref, k))


def test_bf16_init_rounds_like_tpu_mf():
    """init_mf / init_dpmf / init_admf with bfloat16 storage: the float32
    draw rounded to nearest bf16 (tpu_mf's astype), gb stored in bf16; the
    rounding of tpu_mf's own f32 draw in torch is tpu_mf's bf16 draw, bit
    for bit."""
    def gen():
        return torch.Generator().manual_seed(4)

    f32 = init_mf(40, 30, 6, 3.3, gen(), "cpu")
    bf = init_mf(40, 30, 6, 3.3, gen(), "cpu", dtype=torch.bfloat16)
    for a, b in zip(bf, f32):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b.to(torch.bfloat16))
    tr, _ = data()
    dp = init_dpmf(tr, 6, 3.3, gen(), "cpu", dtype=torch.bfloat16)
    ad = init_admf(tr.nu, tr.nv, 6, 0.01, 3.3, gen(), "cpu",
                   dtype=torch.bfloat16)
    assert dp.params.theta.dtype == ad.theta_old.dtype == torch.bfloat16
    assert dp.lambda_u.dtype == ad.lam_u.dtype == torch.float32
    assert dp.gcountu.dtype == torch.int64
    key = jax.random.PRNGKey(9)
    j32 = jax_init_mf(key, 40, 30, 6, gb=3.3)
    jbf = jax_init_mf(key, 40, 30, 6, gb=3.3, dtype=jnp.bfloat16)
    for a, b in zip(j32, jbf):
        mine = torch.as_tensor(np.array(a)).to(torch.bfloat16)
        theirs = torch.as_tensor(np.asarray(b.astype(jnp.float32)))
        assert torch.equal(mine.float(), theirs)


def test_bf16_batched_epoch_matches_tpu_mf():
    """One batched epoch on bf16 tables against tpu_mf's sgd_epoch on the
    same bf16 inputs and batches: rows gathered and the error computed in
    float32, decay factors and deltas rounded to bf16, one rounding per
    scatter add in slot order. Bit for bit (atol 0): both round the same
    float32 values, in the same order."""
    tr, _ = data()
    tabs = np_tables(tr.nu, tr.nv, 8, gb=3.5)
    u, v, r, w = epoch_batches(tr, 512, 1, 0)
    want = jax_sgd_epoch(
        JaxParams(*(jnp.asarray(t, jnp.bfloat16) for t in tabs)),
        tuple(jnp.asarray(x) for x in (u, v, r, w)), jnp.float32(0.02),
        jnp.float32(5e-3))
    got = sgd_epoch(
        MFParams(*(torch.as_tensor(t).to(torch.bfloat16) for t in tabs[:4]),
                 torch.tensor(3.5, dtype=torch.bfloat16)),
        (torch.as_tensor(u.astype(np.int64)),
         torch.as_tensor(v.astype(np.int64)), torch.as_tensor(r),
         torch.as_tensor(w)), 0.02, 5e-3)
    for a, b, t in zip(got[:4], want[:4], tabs):
        assert a.dtype == torch.bfloat16
        b = np.asarray(b.astype(jnp.float32))
        np.testing.assert_array_equal(a.float().numpy(), b)
        assert np.abs(b - t).max() > 1e-2  # it trained


@pytest.mark.parametrize("alg", sorted(CFGS))
def test_bf16_cpu_runs_keep_the_storage_dtype(alg):
    """--dtype bfloat16 on the CPU path (batched) for all three
    algorithms: the tables stay bf16 and tRMSE stays finite and close to
    the float32 run's."""
    tr, te = data()
    rm = {}
    for dtype in ("float32", "bfloat16"):
        cfg = TrainConfig(iters=2, gb=tr.mean_rating(), dtype=dtype,
                          **CFGS[alg])
        log = []
        out = run_alg(alg, cfg, tr, te, log.append)
        params = out if isinstance(out, MFParams) else out.params
        assert params.theta.dtype == getattr(torch, dtype)
        rm[dtype] = [float(x.split("tRMSE=")[1].split("\t")[0])
                     for x in log if "tRMSE=" in x]
    assert len(rm["bfloat16"]) == 2 and np.all(np.isfinite(rm["bfloat16"]))
    np.testing.assert_allclose(rm["bfloat16"], rm["float32"], atol=2e-2)


def test_fused_schedule_on_bf16_tables_returns_float32():
    """The fused schedule on CPU tensors from bf16 tables (dense at dim 8)
    returns float32 tables, as tpu_mf's runners' trim does
    (split_params), and trains as from the widened tables."""
    from tpu_mf.ops.pallas_sgd_dense import DenseEpochRunner

    tr, te = data()
    cfg = TrainConfig(dim=8, iters=2, eta=0.01, gb=tr.mean_rating())
    tabs = np_tables(tr.nu, tr.nv, 8, gb=cfg.gb)
    bf = MFParams(*(torch.as_tensor(t).to(torch.bfloat16) for t in tabs[:4]),
                  torch.tensor(float(cfg.gb), dtype=torch.bfloat16))
    got = _train_mf_fused(cfg, tr, te, bf, lambda _: None,
                          _Observer(cfg, len(tr)))
    widened = MFParams(*(t.float() for t in bf))
    again = _train_mf_fused(cfg, tr, te, widened, lambda _: None,
                            _Observer(cfg, len(tr)))
    jr = DenseEpochRunner(tr, seed=0, saturate=True, dim=8, mxu="float32",
                          interpret=True)
    jt = jr.trim(jr.pad(JaxParams(*(jnp.asarray(t, jnp.bfloat16)
                                    for t in tabs))))
    for a, b, j in zip(got, again, jt):
        assert a.dtype == torch.float32 == getattr(torch, str(j.dtype))
        assert torch.equal(a, b)
