"""CUDA-only tests of the PyTorch port: the hand-written kernels against
their plain PyTorch versions on the card. They skip where no GPU is present.

This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from tpu_mf.config import TrainConfig
from tpu_mf.data.coo import synthetic_ratings
from tpu_mf_torch.models.mf import params_from_numpy
from tpu_mf_torch.ops import sgd_dense as td
from tpu_mf_torch.train import train_mf


def np_tables(nu, nv, dim, seed, gb):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1e-1, (nu, dim)).astype(np.float32),
            rng.normal(0, 1e-1, (nv, dim)).astype(np.float32),
            rng.normal(0, 1e-1, nu).astype(np.float32),
            rng.normal(0, 1e-1, nv).astype(np.float32), np.float32(gb))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [40, 130])
@pytest.mark.parametrize("mxu,atol", [
    # f32 working type: only the order of the f32 sums differs
    ("float32", 1e-4),
    # bf16: both sides round E to bf16 from f32 values that may differ in
    # the last bit, one bf16 step of E times eta per flipped element
    ("bfloat16", 2e-3),
])
def test_dense_kernel_matches_reference(cuda, mxu, atol, dim):
    """A 3x5 cell grid with ragged tile edges (tu 72, tv 128), with rows of
    one (dim 40) and two (dim 130) 128-lane groups."""
    ds = synthetic_ratings(200, 600, 40000, rank=3, noise=0.3, seed=5)
    tabs = np_tables(ds.nu, ds.nv, dim, seed=6, gb=3.0)
    r = td.DenseEpochRunner(ds, tile_u=72, tile_v=128, k_cells=5, mxu=mxu,
                            device=cuda)
    base = r.pad(params_from_numpy(*tabs, device=cuda))
    ref = tuple(t.clone() for t in base)
    before = td.dense_epoch.launches
    td.dense_epoch_reference(*ref, r.cells, 0.02, 0.005, 3.0, 10.0, r.dim)
    r.epoch(base, 0.02, 0.005, 3.0)
    torch.cuda.synchronize()
    assert td.dense_epoch.launches == before + 1
    for a, b in zip(base, ref):
        assert float((a - b).abs().max()) <= atol
    start = r.pad(params_from_numpy(*tabs, device=cuda))
    assert float((base[0] - start[0]).abs().max()) > 1e-3  # it trained


@pytest.mark.cuda
def test_train_mf_on_gpu_runs_the_kernel(cuda):
    """train_mf on a CUDA device takes the dense kernel from epoch 1 and the
    test RMSE falls."""
    ds = synthetic_ratings(600, 400, 30000, rank=3, noise=0.2, seed=1)
    tr, te = ds.split(0.1, seed=2)
    cfg = TrainConfig(dim=16, iters=3, eta=0.005, gb=tr.mean_rating())
    log = []
    before = td.dense_epoch.launches
    train_mf(cfg, tr, te, log=log.append, device=cuda)
    assert log[0].startswith("# dense-cell kernel from epoch 1"), log
    assert td.dense_epoch.launches == before + 3
    rm = [float(x.split("tRMSE=")[1]) for x in log if "tRMSE=" in x]
    assert np.all(np.isfinite(rm)) and rm[-1] < rm[0], rm
