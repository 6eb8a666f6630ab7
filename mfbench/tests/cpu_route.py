"""Helpers of the harness's CPU tests: a tiny cell, and the program's
fused route run on the CPU (its plain versions in place of the kernels),
which ``train_mf`` itself takes only on a CUDA device."""

from __future__ import annotations

import json

from mfbench.spec import PKG


def fused_on_cpu(cfg, train_ds, test_ds=None, params=None, log=print,
                 device="cuda"):
    """``train_mf`` on the CPU through the fused schedule."""
    from tpu_mf_torch.models.mf import MFParams
    from tpu_mf_torch.train import loop

    params = MFParams(*(t.to("cpu").clone() for t in params))
    obs = loop._Observer(cfg, len(train_ds), log)
    try:
        return loop._train_mf_fused(cfg, train_ds, test_ds, params, log, obs)
    finally:
        obs.close()


def tiny_spec(cell: str, nu: int = 4000, nv: int = 1000, ratings: int = 60000,
              dim: int = 64) -> dict:
    """The spec of ``cell`` from its files, at a CPU-sized scale with the
    float32 working type of the CPU routes, and the cell's own limits."""
    from mfbench.spec import cell_spec

    spec = cell_spec(cell)
    spec["config"].update(nu=nu, nv=nv, ratings=ratings, dim=dim,
                          work="float32")
    spec["traffic"]["job_epochs"] = 5
    return spec


def limits(cell: str) -> dict:
    with open(PKG / "limits" / f"{cell}.json") as f:
        return json.load(f)
