"""The --alg dpmf slice of the PyTorch port on the CPU, against tpu_mf on the
same numpy-made states: the round body with both SGLD runners, the routing
of train_dpmf, the CLI and the reference-binary DPMF checkpoint."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_mf.data.coo import synthetic_ratings
from tpu_mf.io.checkpoint import load_dpmf_binary as jax_load_dpmf_binary
from tpu_mf.io.checkpoint import load_dpmf_hyper as jax_load_dpmf_hyper
from tpu_mf.io.checkpoint import save_dpmf_binary as jax_save_dpmf_binary
from tpu_mf.models.dpmf import dp_bound as jax_dp_bound
from tpu_mf.models.dpmf import init_dpmf as jax_init_dpmf
from tpu_mf.models.mf import MFParams as JaxParams
from tpu_mf.models.mf import calc_mse as jax_calc_mse
from tpu_mf.models.mf import rmse as jax_rmse
from tpu_mf.ops.gibbs import sample_hyper as jax_sample_hyper
from tpu_mf.ops.sgld import finish_noise as jax_finish_noise
from tpu_mf_torch.config import TrainConfig
from tpu_mf_torch.data.coo import RatingsCOO
from tpu_mf_torch.models.dpmf import dpmf_state_from_numpy, dpmf_state_to_numpy
from tpu_mf_torch.ops import sgld_cells as tg
from tpu_mf_torch.ops import sgld_slot as tss
from tpu_mf_torch.train import train_dpmf
from tpu_mf_torch.train.loop import _dpmf_round, _dpmf_runner, _dpmf_setup

torch.set_num_threads(1)
TABLES = ("theta", "phi", "bu", "bv")
PRECISIONS = ("lambda_r", "lambda_ub", "lambda_vb", "lambda_u", "lambda_v")


def port(ds):
    return RatingsCOO(ds.u, ds.v, ds.r, ds.nu, ds.nv)


def data(seed=0):
    """(tpu_mf train, tpu_mf test, port train, port test): zipfy ratings."""
    ds = synthetic_ratings(300, 200, 4000, rank=3, noise=0.2, seed=seed,
                           zipf=1.1)
    tr, te = ds.split(0.1, seed=seed + 1)
    return tr, te, port(tr), port(te)


def arrays_of(js) -> dict:
    """A tpu_mf state as the host arrays the port's carry-over takes."""
    p = js.params
    return {k: np.asarray(v) for k, v in dict(
        theta=p.theta, phi=p.phi, bu=p.bu, bv=p.bv, gb=p.gb,
        lambda_r=js.lambda_r, lambda_ub=js.lambda_ub, lambda_vb=js.lambda_vb,
        lambda_u=js.lambda_u, lambda_v=js.lambda_v, ur=js.ur, vr=js.vr,
        gcountu=js.gcountu, gcountv=js.gcountv, gcount=js.gcount).items()}


def jax_round(cfg, jr, jtr, jte, js, rnd, bound, key):
    """tpu_mf's train_dpmf loop body with a fused runner (loop.py:1145-1222):
    (state, train RMSE, test RMSE)."""
    f32 = jnp.float32
    eta_r = cfg.eta_at_cutoff(rnd)
    ntrain = len(jtr)
    scal = eta_r * ntrain * bound * float(js.lambda_r)
    jr.set_lambdas(js)
    tables = jr.epoch(jr.pad(js), int(js.gcount),
                      (eta_r, cfg.temp, bound, scal, float(js.params.gb)),
                      noise_seed=cfg.seed * 1_000_003 + rnd * jr.seed_stride,
                      epoch_idx=rnd - 1)
    js = jr.unpack(js, tables)
    js = jax_finish_noise(js, f32(eta_r), f32(cfg.temp),
                          jax.random.fold_in(key, rnd + 500_000))
    mse = jax_calc_mse(js.params, jtr.u, jtr.v, jtr.r, cfg.eval_batch)
    js = jax_sample_hyper(js, f32(mse * ntrain), f32(ntrain), f32(cfg.hypera),
                          f32(cfg.hyperb),
                          jax.random.fold_in(key, rnd + 1_000_000))
    return js, float(np.sqrt(mse)), float(jax_rmse(js.params, jte))


def runner_pair(kind, jtr, tr, dim, seed):
    """tpu_mf's interpret-mode runner and the port's CPU runner, f32, two
    rotated plans, at test sizes."""
    from tpu_mf.ops.pallas_sgld import PallasSgldRunner
    from tpu_mf.ops.pallas_sgld_slot import SlotSgldRunner as JaxSlot

    if kind == "gen1":
        kw = dict(tile_u=64, tile_v=64, batch=128, seed=seed, n_plans=2,
                  mxu="float32")
        return (PallasSgldRunner(jtr, interpret=True, **kw),
                tg.SgldCellRunner(tr, device="cpu", **kw))
    kw = dict(sub=16, seed=seed, dim=dim, tile=64, n_plans=2, striped=True,
              mxu="float32")
    return (JaxSlot(jtr, interpret=True, balance=True, saturate=True, **kw),
            tss.SlotSgldRunner(tr, device="cpu", **kw))


def line_rmse(line):
    """(RMSE, tRMSE) of a round line."""
    f = line.split("\t")
    assert f[0].startswith("round #"), line
    return float(f[1].split("=")[1]), float(f[2].split("=")[1])


@pytest.mark.parametrize("kind,dim", [("gen1", 16), ("slot", 8)])
def test_dpmf_rounds_match_tpu_mf_loop_body(kind, dim):
    """_dpmf_round over 3 rounds with a fused runner on CPU tensors (the
    kernel's plain version, f32) against tpu_mf's loop body with its
    interpret-mode runner, at temp 0; tpu_mf's Gibbs draws carried into
    the port's state between rounds. Tables, counters and the RMSE / tRMSE
    of the round lines within 1e-4 (f32 sums in other orders over 3
    rounds of the kernels' 3e-5)."""
    jtr, jte, tr, te = data()
    cfg = TrainConfig(alg="dpmf", dim=dim, iters=3, eta=2e-5, temp=0.0,
                      hyperb=1000.0, gb=float(jtr.mean_rating()), seed=3)
    js = jax_init_dpmf(jax.random.PRNGKey(0), jtr, dim, gb=cfg.gb)
    st = dpmf_state_from_numpy(arrays_of(js), "cpu")
    jr, runner = runner_pair(kind, jtr, tr, dim, cfg.seed)
    assert runner.seed_stride == jr.seed_stride
    log = []
    run = _dpmf_setup(cfg, tr, te, log.append, None, "cpu", runner)
    bound = jax_dp_bound(cfg.epsilon, cfg.tau, jtr.nv)
    key = jax.random.PRNGKey(cfg.seed ^ 0xD1FF)
    start = arrays_of(js)["theta"]
    for rnd in range(1, 4):
        js, rm, trm = jax_round(cfg, jr, jtr, jte, js, rnd, bound, key)
        st = _dpmf_round(run, rnd, st)
        got, want = dpmf_state_to_numpy(st), arrays_of(js)
        for k in TABLES:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                       err_msg=f"round {rnd} {k}")
        for k in ("gcountu", "gcountv", "gcount"):
            np.testing.assert_array_equal(got[k], want[k].astype(np.int64))
        np.testing.assert_allclose(line_rmse(log[-1]), (rm, trm), rtol=0,
                                   atol=1e-4)
        assert float(st.lambda_r) > 0
        st = st._replace(**{k: torch.as_tensor(want[k]) for k in PRECISIONS})
    assert [x.split("\t")[0] for x in log] == [f"round #{i}" for i in (1, 2, 3)]
    assert np.abs(arrays_of(js)["theta"] - start).max() > 1e-3  # it trained
    assert type(run.runner).launches == 0  # CPU tensors: no kernel launch


# name: (dim, port runner family or None for the batched path); tpu_mf
# takes the batched path from dim 252 (its VMEM row limit)
ROUTES = {"dim8": (8, "slot"), "dim26": (26, "slot"), "dim58": (58, "slot"),
          "dim59": (59, "gen1"), "dim128": (128, "gen1"),
          "dim252": (252, "gen1"), "dim2049": (2049, None)}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_dpmf_routing_matches_tpu_mf(case):
    """_dpmf_runner on a CUDA device (plans are built on the host, nothing
    reaches the card) picks the runner tpu_mf's train_dpmf builds on a
    device: the striped, balanced, saturating slot runner at dim <= 58,
    the gen-1 runner at tiles 512 and batch max(8192, batch_size) above,
    with the same geometry and plans. The gen-1 kernel also takes dims
    past tpu_mf's 251, up to MAX_DIM (2048); beyond, the batched path with
    a log line. CPU tensors and --no-pallas always take the batched
    path."""
    from tpu_mf.ops.pallas_sgld import PallasSgldRunner
    from tpu_mf.ops.pallas_sgld_slot import SlotSgldRunner as JaxSlot
    from tpu_mf_torch.models.dpmf import init_dpmf

    dim, family = ROUTES[case]
    ds = synthetic_ratings(1500, 700, 30000, rank=3, seed=2, zipf=1.1)
    tr = port(ds)
    cfg = TrainConfig(alg="dpmf", dim=dim, iters=2, seed=5)
    state = init_dpmf(tr, dim, 3.0, torch.Generator().manual_seed(0), "cpu")
    log = []
    runner = _dpmf_runner(cfg, tr, state, log.append, "cuda")
    if family is None:
        assert runner is None
        assert log == ["# fused SGLD ineligible (see sgld_cells_eligible); "
                       "falling back to the batched path"]
        return
    if family == "slot":
        want = JaxSlot(ds, seed=cfg.seed, dim=dim, n_plans=2, balance=True,
                       saturate=True, striped=True)
        assert isinstance(runner, tss.SlotSgldRunner) and runner.striped
        assert (runner.sub, runner.pack) == (want.sub, want.pack)
    else:
        want = PallasSgldRunner(ds, tile_u=512, tile_v=512,
                                batch=max(8192, cfg.batch_size),
                                seed=cfg.seed, n_plans=2)
        assert isinstance(runner, tg.SgldCellRunner)
        assert runner.batch == want.batch
    assert (runner.tile_u, runner.tile_v, runner.seed_stride) == (
        want.tile_u, want.tile_v, want.seed_stride)
    assert len(runner.plans) == len(want.plans) == 2
    for a, b in zip(runner.plans, want.plans):
        np.testing.assert_array_equal(a.u, b.u)
        np.testing.assert_array_equal(a.v, b.v)
    assert runner.device.type == "cuda" and not runner._dev
    assert _dpmf_runner(cfg, tr, state, log.append, "cpu") is None
    cfg.use_pallas = False
    assert _dpmf_runner(cfg, tr, state, log.append, "cuda") is None


def np_state(nu, nv, dim, seed=0):
    rng = np.random.default_rng(seed)
    return (JaxParams(*(rng.normal(0, 0.1, s).astype(np.float32)
                        for s in ((nu, dim), (nv, dim), nu, nv)), 3.0),
            (1.25, 90.5, 70.25, rng.uniform(50, 150, dim).astype(np.float32),
             rng.uniform(50, 150, dim).astype(np.float32)))


def test_dpmf_checkpoint_bytes_match_tpu_mf(tmp_path):
    """save_dpmf_binary writes tpu_mf's bytes for the same state; each
    package's load_dpmf_hyper reads the other's file, and load_dpmf_binary
    gives the tables back exactly."""
    from tpu_mf_torch.io.checkpoint import (
        load_dpmf_binary,
        load_dpmf_hyper,
        save_dpmf_binary,
    )
    from tpu_mf_torch.models.mf import params_from_numpy

    jp, hyper = np_state(30, 20, 6)
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    save_dpmf_binary(str(mine), params_from_numpy(*jp, device="cpu"), *hyper)
    jax_save_dpmf_binary(str(theirs), JaxParams(*(jnp.asarray(x) for x in jp)),
                         *hyper)
    assert mine.read_bytes() == theirs.read_bytes()
    for got in (load_dpmf_hyper(str(theirs)), jax_load_dpmf_hyper(str(mine))):
        assert got[:3] == hyper[:3]
        np.testing.assert_array_equal(got[3], hyper[3])
        np.testing.assert_array_equal(got[4], hyper[4])
    params, back = load_dpmf_binary(str(theirs), gb=3.0, device="cpu")
    assert back[:3] == hyper[:3]
    for a, b in zip(params[:4], jp[:4]):
        np.testing.assert_array_equal(a.numpy(), b)
    jparams, _ = jax_load_dpmf_binary(str(mine), gb=3.0)
    np.testing.assert_array_equal(np.asarray(jparams.theta), jp.theta)
    (tmp_path / "short").write_bytes(mine.read_bytes()[:-4])
    with pytest.raises(ValueError, match="truncated"):
        load_dpmf_binary(str(tmp_path / "short"), device="cpu")


def cli_args(tmp_path):
    from tpu_mf.data.textfmt import write_raw

    jtr, jte, _, _ = data()
    write_raw(str(tmp_path / "train.csv"), jtr)
    write_raw(str(tmp_path / "test.csv"), jte)
    return ["--alg", "dpmf", "--train", str(tmp_path / "train.csv"),
            "--test", str(tmp_path / "test.csv"), "--nu", "300", "--nv",
            "200", "--dim", "8", "--iter", "2", "--eta", "2e-5",
            "--hyperb", "1000", "--device", "cpu"]


def test_cli_dpmf_cpu_writes_reference_checkpoint(tmp_path, capsys,
                                                  monkeypatch):
    """--alg dpmf --device cpu runs the batched path and prints one
    finite round line per round; {result}_{iters} is the reference's DPMF
    binary (tpu_mf reads it and writes the same bytes back); --model warm
    starts the precisions only."""
    from tpu_mf_torch.cli import main
    from tpu_mf_torch.train import loop

    args = cli_args(tmp_path)
    assert main(args + ["--result", str(tmp_path / "m")]) == 0
    lines = [x for x in capsys.readouterr().out.splitlines()
             if x.startswith("round #")]
    assert [x.split("\t")[0] for x in lines] == ["round #1", "round #2"]
    assert all(np.isfinite(line_rmse(x)).all() for x in lines)
    path = tmp_path / "m_2"
    params, hyper = jax_load_dpmf_binary(str(path))
    assert params.theta.shape == (300, 8) and hyper[0] > 0
    jax_save_dpmf_binary(str(tmp_path / "again"), params, *hyper)
    assert path.read_bytes() == (tmp_path / "again").read_bytes()

    seen = {}

    def spy(cfg, train_ds, test_ds=None, state=None, **kw):
        seen["state"] = state
        return state

    monkeypatch.setattr(loop, "train_dpmf", spy)
    assert main(args + ["--model", str(path)]) == 0
    st = seen["state"]
    assert float(st.lambda_r) == hyper[0] and float(st.lambda_vb) == hyper[2]
    np.testing.assert_array_equal(st.lambda_u.numpy(), hyper[3])
    assert st.params.theta.shape == (300, 8) and int(st.gcount) == 0


def test_train_dpmf_cpu_batched_path():
    """train_dpmf on CPU tensors runs the batched path at temp 1: finite
    round lines, tRMSE falling, counters reset by the noise flush, the
    caller's state left as it was; --mesh > 1 (not ported) raises, and
    bfloat16 tables keep their storage dtype."""
    from tpu_mf_torch.models.dpmf import init_dpmf

    _, _, tr, te = data()
    cfg = TrainConfig(alg="dpmf", dim=8, iters=3, eta=2e-5, hyperb=1000.0,
                      gb=tr.mean_rating())
    state = init_dpmf(tr, 8, cfg.gb, torch.Generator().manual_seed(0), "cpu")
    before = state.params.theta.clone()
    log = []
    out = train_dpmf(cfg, tr, te, state, log=log.append, device="cpu")
    rm = [line_rmse(x)[1] for x in log]
    assert len(rm) == 3 and np.all(np.isfinite(rm)) and rm[-1] < rm[0], log
    assert torch.equal(state.params.theta, before)
    assert int(out.gcount) == 0 and not out.gcountu.any()
    with pytest.raises(NotImplementedError):
        train_dpmf(TrainConfig(alg="dpmf", dim=8, iters=1, mesh=2), tr,
                   device="cpu")
    bf = train_dpmf(TrainConfig(alg="dpmf", dim=8, iters=1, eta=2e-5,
                                hyperb=1000.0, gb=tr.mean_rating(),
                                dtype="bfloat16"), tr, device="cpu")
    assert bf.params.theta.dtype == torch.bfloat16
    assert bool(torch.isfinite(bf.params.theta.float()).all())


def test_cli_dpmf_defaults_to_cuda(tmp_path):
    """--alg dpmf runs on the card unless --device cpu is given: without a
    GPU it exits non-zero instead of training on the CPU."""
    from tpu_mf_torch.cli import build_parser, main

    assert build_parser().parse_args(["--alg", "dpmf"]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = cli_args(tmp_path)
    assert main(args[:-2] + ["--device", "cuda"]) != 0
    assert main(args[:-2]) != 0
