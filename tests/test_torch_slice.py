"""The --alg mf slice of the PyTorch port end to end on the CPU, against
tpu_mf on the same numpy-made tables."""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_mf.config import TrainConfig
from tpu_mf.data.coo import synthetic_ratings
from tpu_mf.data.textfmt import write_raw
from tpu_mf.io.checkpoint import load_mf_binary as jax_load_mf_binary
from tpu_mf.io.checkpoint import save_mf_binary as jax_save_mf_binary
from tpu_mf.models.mf import MFParams as JaxParams
from tpu_mf.ops.pallas_sgd_dense import DenseEpochRunner as JaxDenseRunner
from tpu_mf.train.loop import train_mf as jax_train_mf
from tpu_mf_torch.models.mf import params_from_numpy, params_to_numpy
from tpu_mf_torch.train import train_mf
from tpu_mf_torch.train.loop import _Observer, _train_mf_fused

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def data(seed=0):
    ds = synthetic_ratings(200, 150, 6000, rank=3, noise=0.2, seed=seed)
    return ds.split(0.1, seed=seed + 1)


def np_tables(nu, nv, dim, gb, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1e-2, (nu, dim)).astype(np.float32),
            rng.normal(0, 1e-2, (nv, dim)).astype(np.float32),
            rng.normal(0, 1e-2, nu).astype(np.float32),
            rng.normal(0, 1e-2, nv).astype(np.float32), np.float32(gb))


def trmse(lines):
    return [float(x.split("tRMSE=")[1]) for x in lines if "tRMSE=" in x]


def test_train_mf_cpu_matches_jax():
    """The CPU path (batched sgd_epoch over host-shuffled batches) against
    tpu_mf.train_mf(device_shuffle=False), 3 epochs at dim 8: per-epoch
    tRMSE and final tables within 1e-5 (f32; duplicate-row scatter sums
    in another order)."""
    tr, te = data()
    cfg = TrainConfig(dim=8, iters=3, eta=0.02, lam=5e-3, batch_size=512,
                      gb=tr.mean_rating(), seed=0)
    tabs = np_tables(tr.nu, tr.nv, 8, cfg.gb)
    jlog, tlog = [], []
    want = jax_train_mf(cfg, tr, te, JaxParams(*(jnp.asarray(t) for t in tabs)),
                        log=jlog.append, device_shuffle=False)
    got = train_mf(cfg, tr, te, params_from_numpy(*tabs, device="cpu"),
                   log=tlog.append, device="cpu")
    assert len(trmse(tlog)) == 3
    np.testing.assert_allclose(trmse(tlog), trmse(jlog), rtol=0, atol=1e-5)
    for a, b in zip(params_to_numpy(got)[:4], want[:4]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)


def test_fused_schedule_on_cpu_matches_pallas_loop():
    """_train_mf_fused on CPU tensors (the dense epoch's plain version, f32)
    against a loop over tpu_mf's interpret-mode DenseEpochRunner with the
    same eta_at, lam and gb: tables within 1e-4 after 3 epochs."""
    tr, te = data()
    cfg = TrainConfig(dim=8, iters=3, eta=0.01, lam=5e-3,
                      gb=tr.mean_rating(), seed=0)
    tabs = np_tables(tr.nu, tr.nv, 8, cfg.gb)
    log = []
    got = _train_mf_fused(cfg, tr, te, params_from_numpy(*tabs, device="cpu"),
                          log.append, _Observer(cfg, len(tr), log.append))
    assert log[0].startswith("# dense-cell kernel from epoch 1")

    jr = JaxDenseRunner(tr, seed=0, saturate=True, dim=8, mxu="float32",
                        interpret=True)
    tables = jr.pad(JaxParams(*(jnp.asarray(t) for t in tabs)))
    for it in range(1, 4):
        tables = jr.epoch(tables, cfg.eta_at(it), cfg.lam, float(cfg.gb))
    want = jr.trim(tables)
    for a, b in zip(params_to_numpy(got)[:4], want[:4]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-4)
    assert len(trmse(log)) == 3 and np.all(np.isfinite(trmse(log)))


def test_fused_schedule_runs_batched_epochs_before_dense():
    """At an eta above the dense window bound the epochs before engagement
    run the batched path, and the log says so by name."""
    tr, _ = data()
    cfg = TrainConfig(dim=8, iters=3, eta=0.04, gam=2.0, gb=tr.mean_rating())
    log = []
    params = params_from_numpy(*np_tables(tr.nu, tr.nv, 8, cfg.gb),
                               device="cpu")
    _train_mf_fused(cfg, tr, None, params, log.append,
                    _Observer(cfg, len(tr), log.append))
    assert "# one-hot kernels (gen-1/packed/slot) not yet ported: epochs " \
           "1..1 use the batched path" in log
    assert "# epoch 2: switching to DenseEpochRunner" in log


def write_data(tmp_path):
    tr, te = data()
    write_raw(str(tmp_path / "train.csv"), tr)
    write_raw(str(tmp_path / "test.csv"), te)
    return ["--train", str(tmp_path / "train.csv"),
            "--test", str(tmp_path / "test.csv"), "--nu", "200", "--nv", "150",
            "--dim", "8", "--iter", "2", "--eta", "0.01"]


def test_cli_checkpoint_is_reference_binary(tmp_path, capsys):
    """The CLI writes {result}_{iters} in the reference's binary layout:
    tpu_mf reads it, and tpu_mf's writer gives the same bytes back."""
    from tpu_mf_torch.cli import main

    args = write_data(tmp_path) + ["--device", "cpu",
                                   "--result", str(tmp_path / "m")]
    assert main(args) == 0
    out = capsys.readouterr().out
    assert len(trmse(out.splitlines())) == 2
    path = tmp_path / "m_2"
    params, lam = jax_load_mf_binary(str(path))
    assert params.theta.shape == (200, 8) and lam == np.float32(5e-3)
    jax_save_mf_binary(str(tmp_path / "again"), params, lam)
    assert path.read_bytes() == (tmp_path / "again").read_bytes()


def test_cli_metrics_and_trace(tmp_path):
    """--metrics appends one JSON line per epoch; --trace writes a
    torch.profiler trace."""
    import json

    from tpu_mf_torch.cli import main

    metrics, trace = tmp_path / "m.jsonl", tmp_path / "trace"
    assert main(write_data(tmp_path) + [
        "--device", "cpu", "--metrics", str(metrics),
        "--trace", str(trace)]) == 0
    rows = [json.loads(x) for x in metrics.read_text().splitlines()]
    assert [r["round"] for r in rows] == [1, 2]
    assert all(r["updates_per_sec"] > 0 and r["tRMSE"] > 0 for r in rows)
    assert (trace / "trace.json").stat().st_size > 0


def test_port_runs_without_jax(tmp_path):
    """A fresh interpreter imports the port and runs the CPU slice through
    the CLI without importing JAX."""
    args = write_data(tmp_path) + ["--device", "cpu"]
    code = ("import sys; from tpu_mf_torch.cli import main; "
            f"rc = main({args!r}); "
            "assert rc == 0 and 'jax' not in sys.modules, sorted(sys.modules)")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "iter#2" in proc.stdout


def test_cli_cuda_without_gpu_fails(tmp_path):
    """--device cuda on a machine without a GPU exits non-zero instead of
    training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from tpu_mf_torch.cli import main

    assert main(write_data(tmp_path) + ["--device", "cuda"]) != 0
