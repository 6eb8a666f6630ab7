"""The --alg admf slice of the PyTorch port on the CPU, against tpu_mf on the
same numpy-made states: the state carried across, the routing of
train_admf, its fused loop against tpu_mf's loop body, the batched path,
the CLI and its reference-binary checkpoint."""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_mf.data.coo import synthetic_ratings
from tpu_mf.data.textfmt import write_raw
from tpu_mf.io.checkpoint import load_mf_binary as jax_load_mf_binary
from tpu_mf.io.checkpoint import save_mf_binary as jax_save_mf_binary
from tpu_mf.models.admf import init_admf as jax_init_admf
from tpu_mf.models.mf import rmse as jax_rmse
from tpu_mf.ops import adreg as jax_adreg
from tpu_mf_torch.config import TrainConfig
from tpu_mf_torch.data.coo import RatingsCOO
from tpu_mf_torch.models.admf import (
    admf_state_from_numpy,
    admf_state_to_numpy,
    init_admf,
)
from tpu_mf_torch.ops import adreg as ta
from tpu_mf_torch.ops.adreg_cells import AdRegCellRunner
from tpu_mf_torch.ops.adreg_slot import SlotAdRegRunner
from tpu_mf_torch.train import train_admf
from tpu_mf_torch.train.loop import (
    _admf_key,
    _admf_runner,
    _Observer,
    _train_admf_fused,
)

torch.set_num_threads(1)
K = 64
TABLES = ("theta", "phi", "bu", "bv")
SHADOWS = ("theta_old", "phi_old", "bu_old", "bv_old")
LAMBDAS = ("lam_u", "lam_v", "lam_bu", "lam_bv")


def port(ds):
    return RatingsCOO(ds.u, ds.v, ds.r, ds.nu, ds.nv)


def data(seed=0):
    """(train, valid, test) tpu_mf rating sets: zipfy ratings split
    80/10/10."""
    ds = synthetic_ratings(300, 200, 5000, rank=3, noise=0.2, seed=seed,
                           zipf=1.1)
    tr, rest = ds.split(0.2, seed=seed + 1)
    va, te = rest.split(0.5, seed=seed + 2)
    return tr, va, te


def arrays_of(js) -> dict:
    out = {k: np.asarray(getattr(js.params, k)) for k in TABLES + ("gb",)}
    out.update({k: np.asarray(getattr(js, k)) for k in SHADOWS + LAMBDAS})
    return out


def trmse(lines):
    return [float(x.split("tRMSE=")[1]) for x in lines if "tRMSE=" in x]


def test_state_carries_across_and_computes_the_same_update():
    """admf_state_from_numpy on tpu_mf's init_admf state gives a port state
    (distinct shadow tensors, float32 lambdas) that round-trips through
    admf_state_to_numpy and takes the same batched update as tpu_mf's;
    the port's init_admf has tpu_mf's structure."""
    tr, va, _ = data()
    js = jax_init_admf(jax.random.PRNGKey(0), tr.nu, tr.nv, 8, lam=0.03,
                       gb=3.0)
    arrays = arrays_of(js)
    st = admf_state_from_numpy(arrays, "cpu")
    back = admf_state_to_numpy(st)
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k])
    assert st.theta_old.data_ptr() != st.params.theta.data_ptr()
    u, v, r, w = tr.to_batches(512, shuffle_seed=1)
    key = jax.random.PRNGKey(2)
    js = jax_adreg.adreg_batch_update(
        js, tuple(jnp.asarray(x[0]) for x in (u, v, r, w)),
        tuple(jnp.asarray(x) for x in (va.u, va.v, va.r)),
        jax_adreg.AdRegHyper(jnp.float32(0.05), jnp.float32(1.0), 0), key)
    st = ta.adreg_batch_update(
        st, (torch.as_tensor(u[0].astype(np.int64)),
             torch.as_tensor(v[0].astype(np.int64)), torch.as_tensor(r[0]),
             torch.as_tensor(w[0])),
        tuple(torch.as_tensor(x) for x in (va.u.astype(np.int64),
                                           va.v.astype(np.int64), va.r)),
        ta.AdRegHyper(0.05, 1.0, 0),
        torch.as_tensor(np.asarray(jax.random.randint(key, (K,), 0,
                                                      len(va)))))
    got, want = admf_state_to_numpy(st), arrays_of(js)
    for k in TABLES + SHADOWS + LAMBDAS:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    assert got["lam_u"] != np.float32(0.03)  # the update moved it
    mine = init_admf(tr.nu, tr.nv, 8, 0.03, 3.0,
                     torch.Generator().manual_seed(0), "cpu")
    for t, s in zip(mine.params[:4], mine[1:5]):
        assert torch.equal(t, s) and t.data_ptr() != s.data_ptr()
    assert [float(getattr(mine, k)) for k in LAMBDAS] == [
        float(np.float32(0.03))] * 4


# name: (dim, eta, port runner family or None for the batched path)
ROUTES = {"dim8": (8, 4e-4, "slot"), "dim8_big_eta": (8, 0.5, "gen1"),
          "dim8_envelope": (8, None, "gen1"), "dim40": (40, 4e-4, "slot"),
          "dim62": (62, 1e-3, "gen1"), "dim128": (128, 1e-3, "gen1"),
          "dim300": (300, 1e-3, "gen1"), "dim2049": (2049, 1e-3, None)}


def jax_route(cfg, ds, valid, js):
    """The runner tpu_mf's _train_admf_impl builds on a device, in its
    order (tpu_mf/train/loop.py:1378-1405), or None (the XLA path)."""
    from tpu_mf.ops.pallas_adreg import PallasAdRegRunner, adreg_pallas_eligible
    from tpu_mf.ops.pallas_adreg_slot import SlotAdRegRunner as JaxSlot
    from tpu_mf.ops.pallas_adreg_slot import adreg_slot_eligible
    from tpu_mf.ops.pallas_sgd_slot import slot_dup_lower_bound

    runner = None
    if adreg_slot_eligible(js, cfg.batch_size):
        lb, _ = slot_dup_lower_bound(ds, dim=cfg.dim, balance=True)
        if cfg.eta_at(1) * lb <= 0.2:
            runner = JaxSlot(ds, valid, seed=cfg.seed, loss=cfg.loss,
                             n_plans=2 if cfg.iters > 1 else 1, dim=cfg.dim,
                             balance=True, striped=True)
            if cfg.eta_at(1) * max(runner._dup_max[8],
                                   runner._vdup_max[8]) > 0.2:
                runner = None
    if runner is None and adreg_pallas_eligible(js, cfg.batch_size):
        runner = PallasAdRegRunner(
            ds, valid, tile_u=512, tile_v=512,
            batch=max(1024, cfg.batch_size), seed=cfg.seed, loss=cfg.loss,
            n_plans=2 if cfg.iters > 1 else 1)
    return runner


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_admf_routing_matches_tpu_mf(case):
    """_admf_runner on a CUDA device (plans are built on the host, nothing
    reaches the card) picks the runner tpu_mf's train_admf builds on a
    device, with the same geometry, segments and plans: the striped,
    balanced slot runner where eta0 clears the pigeonhole bound and the
    runner's own window duplicates, else the gen-1 runner (tiles 512,
    batch max(1024, batch_size)); past MAX_DIM the batched path. CPU
    tensors and --no-pallas take the batched path."""
    from tpu_mf_torch.ops.sgd_slot import slot_dup_lower_bound

    dim, eta, family = ROUTES[case]
    ds = synthetic_ratings(1500, 700, 30000, rank=3, seed=2, zipf=1.1)
    valid = synthetic_ratings(1500, 700, 500, rank=3, seed=3)
    tr, va = port(ds), port(valid)
    if eta is None:  # just inside the pigeonhole bound, outside the plans'
        eta = 0.2 / slot_dup_lower_bound(tr, dim=dim, balance=True)[0]
    cfg = TrainConfig(alg="admf", dim=dim, iters=2, eta=eta, seed=5)
    js = jax_init_admf(jax.random.PRNGKey(0), ds.nu, ds.nv, dim, lam=0.01)
    want = jax_route(cfg, ds, valid, js)
    state = init_admf(tr.nu, tr.nv, dim, 0.01, 3.0,
                      torch.Generator().manual_seed(0), "cpu")
    log = []
    runner = _admf_runner(cfg, tr, va, state, log.append, "cuda")
    if family is None:
        assert runner is None and want is None
        assert log == [f"# dim {dim} > 2048: no fused AdaptReg kernel; "
                       "using the batched path"]
        return
    if family == "slot":
        assert isinstance(runner, SlotAdRegRunner) and runner.striped
        assert (runner.sub, runner.pack) == (want.sub, want.pack)
        assert runner._dup_max == want._dup_max
        assert runner._vdup_max == want._vdup_max
    else:
        assert isinstance(runner, AdRegCellRunner)
        assert type(want).__name__ == "PallasAdRegRunner"
        assert runner.batch == want.batch
    envelope = ("# slot AdaptReg envelope exceeded at eta0; using the gen-1 "
                "fused kernel")
    assert (envelope in log) == (case == "dim8_envelope")
    assert (runner.tile_u, runner.tile_v, runner.segments) == (
        want.tile_u, want.tile_v, want.segments)
    assert len(runner.plans) == len(want.plans) == 2
    for a, b in zip(runner.plans, want.plans):
        np.testing.assert_array_equal(a.u, b.u)
        np.testing.assert_array_equal(a.v, b.v)
    assert runner.device.type == "cuda" and not runner._dev
    assert _admf_runner(cfg, tr, va, state, log.append, "cpu") is None
    cfg.use_pallas = False
    assert _admf_runner(cfg, tr, va, state, log.append, "cuda") is None


@pytest.mark.parametrize("kind", ["gen1", "slot"])
def test_admf_fused_loop_matches_tpu_mf_loop_body(kind):
    """_train_admf_fused over 3 epochs with a CPU runner (the kernel's
    plain version, f32, two rotated plans) against tpu_mf's loop body with
    its interpret-mode runner (loop.py:1407-1430), tpu_mf's validation
    draws injected: the iter# lines' tRMSE and the final state within
    1e-4, the lambdas within 1e-6."""
    from tpu_mf.ops.pallas_adreg import PallasAdRegRunner
    from tpu_mf.ops.pallas_adreg_slot import SlotAdRegRunner as JaxSlot

    tr, va, te = data()
    cfg = TrainConfig(alg="admf", dim=8, iters=3, eta=0.02, lam=0.02,
                      eta_reg=0.05, gb=float(tr.mean_rating()), seed=4)
    if kind == "gen1":
        kw = dict(tile_u=64, tile_v=64, batch=256, seed=cfg.seed, n_plans=2,
                  mxu="float32")
        jr = PallasAdRegRunner(tr, va, interpret=True, **kw)
        runner = AdRegCellRunner(port(tr), port(va), device="cpu", **kw)
    else:
        kw = dict(sub=16, seed=cfg.seed, dim=8, tile=64, n_plans=2,
                  striped=True, mxu="float32")
        jr = JaxSlot(tr, va, interpret=True, balance=True, **kw)
        runner = SlotAdRegRunner(port(tr), port(va), device="cpu", **kw)
        cfg.eta = 0.18 / max(jr._dup_max[8], jr._vdup_max[8])
    js = jax_init_admf(jax.random.PRNGKey(0), tr.nu, tr.nv, 8, lam=cfg.lam,
                       gb=cfg.gb)
    base = jax.random.PRNGKey(cfg.seed ^ 0xADF0)
    keys = {it: jax.random.fold_in(base, it) for it in (1, 2, 3)}

    def samples(it):
        segs = jr.bundles[(it - 1) % 2]["segments"]
        return np.stack([np.asarray(jax.random.randint(
            jax.random.fold_in(keys[it], s), (K,), 0, len(va)))
            for s in range(segs)])

    epoch = runner.epoch

    def injected(tables, eta, eta_reg, key, epoch_idx=0):
        assert key == _admf_key(cfg, epoch_idx + 1)
        return epoch(tables, eta, eta_reg, key, epoch_idx,
                     samples=samples(epoch_idx + 1))

    runner.epoch = injected
    log = []
    st = _train_admf_fused(cfg, runner, admf_state_from_numpy(
        arrays_of(js), "cpu"), port(te), log.append,
        _Observer(cfg, len(tr), log.append))
    tables, want_rm = jr.pad(js), []
    for it in range(1, 4):
        tables = jr.epoch(tables, cfg.eta_at(it), cfg.eta_reg_at(it),
                          keys[it], epoch_idx=it - 1)
        want_rm.append(float(jax_rmse(jr.trim(tables), te)))
    assert [x.split("\t")[0] for x in log] == ["iter#1", "iter#2", "iter#3"]
    np.testing.assert_allclose(trmse(log), want_rm, rtol=0, atol=1e-4)
    got, want = admf_state_to_numpy(st), arrays_of(jr.state(tables, js))
    for k in TABLES + SHADOWS:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    for k in LAMBDAS:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    assert any(abs(float(got[k]) - cfg.lam) > 1e-4 for k in LAMBDAS)
    assert want_rm[-1] < want_rm[0]


def test_train_admf_cpu_batched_path():
    """train_admf on CPU tensors runs the batched path: finite iter# lines,
    tRMSE falling, lambdas >= 0 and moved, the caller's state left as it
    was; --mesh > 1 (not ported) raises; bfloat16 tables keep their
    storage dtype, and --resume without a result prefix trains afresh."""
    tr, va, te = (port(x) for x in data())
    cfg = TrainConfig(alg="admf", dim=8, iters=3, eta=0.02, eta_reg=0.05,
                      batch_size=512, gb=tr.mean_rating())
    state = init_admf(tr.nu, tr.nv, 8, cfg.lam, cfg.gb,
                      torch.Generator().manual_seed(0), "cpu")
    before = state.params.theta.clone()
    log = []
    out = train_admf(cfg, tr, va, te, state, log=log.append, device="cpu")
    rm = trmse(log)
    assert len(rm) == 3 and np.all(np.isfinite(rm)) and rm[-1] < rm[0], log
    assert torch.equal(state.params.theta, before)
    lams = [float(getattr(out, k)) for k in LAMBDAS]
    assert min(lams) >= 0 and max(abs(x - cfg.lam) for x in lams) > 1e-5
    with pytest.raises(NotImplementedError):
        train_admf(TrainConfig(alg="admf", dim=8, iters=1, mesh=2), tr, va,
                   device="cpu")
    for opt in (dict(dtype="bfloat16"), dict(resume=True)):
        one = train_admf(TrainConfig(alg="admf", dim=8, iters=1, eta=0.02,
                                     batch_size=512, gb=tr.mean_rating(),
                                     **opt), tr, va, device="cpu")
        assert one.params.theta.dtype == getattr(
            torch, opt.get("dtype", "float32"))
        assert one.theta_old.dtype == one.params.theta.dtype


def cli_args(tmp_path):
    tr, va, te = data()
    for name, ds in (("train", tr), ("valid", va), ("test", te)):
        write_raw(str(tmp_path / f"{name}.csv"), ds)
    return ["--alg", "admf", "--train", str(tmp_path / "train.csv"),
            "--test", str(tmp_path / "test.csv"), "--nu", "300", "--nv",
            "200", "--dim", "8", "--iter", "2", "--eta", "0.02",
            "--eta_reg", "0.05", "--batch_size", "512", "--device", "cpu"]


def test_cli_admf_cpu_writes_reference_checkpoint(tmp_path, capsys):
    """--alg admf --valid ... --device cpu prints one finite iter# line per
    epoch and writes {result}_{iters} as the reference MF binary with
    lam_u (tpu_mf reads it and writes the same bytes back); --model is not
    read, as in tpu_mf; --metrics carries the four lambdas."""
    from tpu_mf_torch.cli import main

    metrics = tmp_path / "m.jsonl"
    assert main(cli_args(tmp_path) + [
        "--valid", str(tmp_path / "valid.csv"), "--result",
        str(tmp_path / "m"), "--model", str(tmp_path / "absent"),
        "--metrics", str(metrics)]) == 0
    lines = [x for x in capsys.readouterr().out.splitlines()
             if x.startswith("iter#")]
    assert [x.split("\t")[0] for x in lines] == ["iter#1", "iter#2"]
    assert np.all(np.isfinite(trmse(lines)))
    rows = [json.loads(x) for x in metrics.read_text().splitlines()]
    assert [r["alg"] for r in rows] == ["admf", "admf"]
    assert all(r[k] >= 0 for r in rows for k in LAMBDAS)
    path = tmp_path / "m_2"
    params, lam = jax_load_mf_binary(str(path))
    assert params.theta.shape == (300, 8)
    assert lam == np.float32(rows[-1]["lam_u"])
    jax_save_mf_binary(str(tmp_path / "again"), params, lam)
    assert path.read_bytes() == (tmp_path / "again").read_bytes()


def test_cli_admf_requires_valid(tmp_path, capsys):
    from tpu_mf_torch.cli import main

    assert main(cli_args(tmp_path)) == 1
    assert "admf requires --valid" in capsys.readouterr().err


def test_cli_admf_defaults_to_cuda(tmp_path):
    """--alg admf runs on the card unless --device cpu is given: without a
    GPU it exits non-zero instead of training on the CPU."""
    from tpu_mf_torch.cli import build_parser, main

    assert build_parser().parse_args(["--alg", "admf"]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = cli_args(tmp_path)[:-2] + ["--valid", str(tmp_path / "valid.csv")]
    assert main(args + ["--device", "cuda"]) != 0
    assert main(args) != 0
