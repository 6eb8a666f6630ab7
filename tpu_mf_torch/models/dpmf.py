"""DPMF model state: differentially private SGLD matrix factorization
(counterpart of ``tpu_mf/models/dpmf.py``; reference: src/model.h:32-72,
src/model.cc:197-352).

Beyond the MF tables the state holds:

* the Gibbs-sampled precisions: scalar lambda_r, lambda_ub, lambda_vb and
  per-dimension lambda_u / lambda_v (inits 1 / 1e2: model.h:41,
  model.cc:228);
* the inverse-frequency weights ur = ntrain / count(u), vr likewise
  (model.cc:263-297);
* the lazy-noise clock: a global update counter and per-row last-touch
  stamps, int64, with one extra slot (index nu / nv) that takes padded
  batch slots, as in ``tpu_mf``.

``tpu_mf``'s tables come from ``jax.random``; tests that compare the two
packages make the state with numpy and carry it into both with
``dpmf_state_from_numpy`` / ``dpmf_state_to_numpy``.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch

from tpu_mf_torch.models.mf import MFParams, init_mf, params_from_numpy

# the fields the carry-over functions move, beside the params
_SCALARS = ("lambda_r", "lambda_ub", "lambda_vb")
_VECTORS = ("lambda_u", "lambda_v", "ur", "vr")
_COUNTERS = ("gcountu", "gcountv", "gcount")


class DPMFState(NamedTuple):
    params: MFParams
    lambda_r: torch.Tensor    # () rating precision
    lambda_ub: torch.Tensor   # () user-bias precision
    lambda_vb: torch.Tensor   # () item-bias precision
    lambda_u: torch.Tensor    # (dim,) per-dimension user precisions
    lambda_v: torch.Tensor    # (dim,)
    ur: torch.Tensor          # (nu,) inverse-frequency weights
    vr: torch.Tensor          # (nv,)
    gcountu: torch.Tensor     # (nu+1,) int64 last-touch stamps (+pad slot)
    gcountv: torch.Tensor     # (nv+1,) int64
    gcount: torch.Tensor      # () int64 global update counter


def dp_bound(epsilon: float, tau: int, nv: int) -> float:
    """Privacy scale (reference: model.cc:240-242)."""
    if tau <= 0:
        tau = nv
    if epsilon <= 0.0:
        return 1.0
    return float(epsilon / (4.0 * 25.0 * tau))


def inverse_frequency(train_ds) -> tuple[np.ndarray, np.ndarray]:
    """(ur, vr) float32: ntrain / max(count, 1) per user and per item."""
    uc, vc = train_ds.counts()
    ntrain = float(len(train_ds))
    return ((ntrain / np.maximum(uc, 1)).astype(np.float32),
            (ntrain / np.maximum(vc, 1)).astype(np.float32))


def init_dpmf(train_ds, dim: int, gb: float, generator: torch.Generator,
              device: torch.device | str = "cuda",
              scale: float = 1e-2,
              dtype: torch.dtype = torch.float32) -> DPMFState:
    """``init_mf``'s tables (in the storage ``dtype``), the initial
    precisions, the inverse-frequency weights of ``train_ds`` and zeroed
    counters, on ``device``."""
    nu, nv = train_ds.nu, train_ds.nv
    params = init_mf(nu, nv, dim, gb, generator, device, scale, dtype)
    ur, vr = inverse_frequency(train_ds)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32).to(device)

    return DPMFState(
        params=params,
        lambda_r=f32(1.0), lambda_ub=f32(1e2), lambda_vb=f32(1e2),
        lambda_u=f32(np.full(dim, 1e2)), lambda_v=f32(np.full(dim, 1e2)),
        ur=f32(ur), vr=f32(vr),
        gcountu=torch.zeros(nu + 1, dtype=torch.int64, device=device),
        gcountv=torch.zeros(nv + 1, dtype=torch.int64, device=device),
        gcount=torch.zeros((), dtype=torch.int64, device=device),
    )


def dpmf_state_from_numpy(arrays: Mapping, device) -> DPMFState:
    """A state from host arrays keyed by the names ``dpmf_state_to_numpy``
    gives: theta, phi, bu, bv, gb, the five precisions, ur, vr and the
    counters (float32 copies, int64 counters, on ``device``)."""
    params = params_from_numpy(*(arrays[k] for k in
                                 ("theta", "phi", "bu", "bv", "gb")), device)

    def f32(k):
        return torch.as_tensor(np.asarray(arrays[k], np.float32)).to(
            device).clone()

    def i64(k):
        return torch.as_tensor(np.asarray(arrays[k], np.int64)).to(
            device).clone()

    return DPMFState(params, *(f32(k) for k in _SCALARS + _VECTORS),
                     *(i64(k) for k in _COUNTERS))


def dpmf_state_to_numpy(state: DPMFState) -> dict:
    """The state as host arrays (float32, counters int64), keyed by field."""
    out = dict(zip(("theta", "phi", "bu", "bv"),
                   (x.detach().cpu().to(torch.float32).numpy()
                    for x in state.params[:4])))
    out["gb"] = np.float32(float(state.params.gb))
    for k in _SCALARS + _VECTORS:
        out[k] = getattr(state, k).detach().cpu().to(torch.float32).numpy()
    for k in _COUNTERS:
        out[k] = getattr(state, k).detach().cpu().to(torch.int64).numpy()
    return out
