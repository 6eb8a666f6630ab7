"""Adaptive-regularization MF state (counterpart of ``tpu_mf/models/admf.py``;
reference: src/model.h:74-118, src/model.cc:355-415, src/admf.h).

Beside the MF tables the state holds four scalar regularizers lam_u, lam_v,
lam_bu, lam_bv, learned online by hypergradient steps against a validation
sample, and full shadow copies of the tables that hold pre-update ("old")
row values, as the reference's theta_old_/phi_old_/bias_old_ arrays (init1,
model.cc:355-383). The shadows are distinct tensors: the batched update
writes them in place.

``tpu_mf``'s tables come from ``jax.random``; tests that compare the two
packages make the state with numpy and carry it into both with
``admf_state_from_numpy`` / ``admf_state_to_numpy``.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch

from tpu_mf_torch.models.mf import MFParams, init_mf, params_from_numpy

_SHADOWS = ("theta_old", "phi_old", "bu_old", "bv_old")
LAMBDAS = ("lam_u", "lam_v", "lam_bu", "lam_bv")  # field names, in order


class AdaptRegState(NamedTuple):
    params: MFParams
    theta_old: torch.Tensor  # (nu, dim) shadow of pre-update rows
    phi_old: torch.Tensor    # (nv, dim)
    bu_old: torch.Tensor     # (nu,)
    bv_old: torch.Tensor     # (nv,)
    lam_u: torch.Tensor      # () learned regularizers, float32
    lam_v: torch.Tensor
    lam_bu: torch.Tensor
    lam_bv: torch.Tensor


def with_shadows(params: MFParams, lams) -> AdaptRegState:
    """A state whose shadows are copies of ``params`` (the "no previous
    update yet" state an epoch begins with) and whose lambdas are the four
    ``lams`` (floats or 0-d tensors) as float32 on the tables' device."""
    dev = params.theta.device
    return AdaptRegState(
        params, *(t.clone() for t in params[:4]),
        *(torch.as_tensor(x, dtype=torch.float32).to(dev).clone()
          for x in lams))


def init_admf(nu: int, nv: int, dim: int, lam: float, gb: float,
              generator: torch.Generator,
              device: torch.device | str = "cuda",
              scale: float = 1e-2,
              dtype: torch.dtype = torch.float32) -> AdaptRegState:
    """``init_mf``'s tables (in the storage ``dtype``), shadow copies of
    them, and all four lambdas at ``lam`` (reference: ctor model.h:81-83,
    init1 model.cc:355-383)."""
    params = init_mf(nu, nv, dim, gb, generator, device, scale, dtype)
    return with_shadows(params, (lam,) * 4)


def admf_state_from_numpy(arrays: Mapping, device) -> AdaptRegState:
    """A state from host arrays keyed by the names ``admf_state_to_numpy``
    gives: theta, phi, bu, bv, gb, the four shadows and the four lambdas
    (float32 copies on ``device``)."""
    params = params_from_numpy(*(arrays[k] for k in
                                 ("theta", "phi", "bu", "bv", "gb")), device)

    def f32(k):
        return torch.as_tensor(np.asarray(arrays[k], np.float32)).to(
            device).clone()

    return AdaptRegState(params, *(f32(k) for k in _SHADOWS + LAMBDAS))


def admf_state_to_numpy(state: AdaptRegState) -> dict:
    """The state as float32 host arrays, keyed by field."""
    out = dict(zip(("theta", "phi", "bu", "bv"),
                   (x.detach().cpu().to(torch.float32).numpy()
                    for x in state.params[:4])))
    out["gb"] = np.float32(float(state.params.gb))
    for k in _SHADOWS + LAMBDAS:
        out[k] = getattr(state, k).detach().cpu().to(torch.float32).numpy()
    return out
