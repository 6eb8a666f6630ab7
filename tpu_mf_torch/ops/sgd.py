"""Batched synchronous SGD update for biased MF (counterpart of
``tpu_mf/ops/sgd.py``).

Per rating, as in the reference's inner loop (src/mf.h:72-133):

    err      = eta * (r - theta_u . phi_v - bu_u - bv_v - gb)
    theta_u <- (1 - eta*lambda) * theta_u + err * phi_v(old)
    phi_v   <- (1 - eta*lambda) * phi_v   + err * theta_u(old)
    bu_u, bv_v likewise with err.

A batch of B ratings is processed against batch-start values: the decay is
one multiply by (1-eta*lambda)^k per row touched k times, and the gradient
terms are scatter-added. At B=1 this is the sequential update. The tables
are updated in place. On bfloat16 tables (``--dtype bfloat16``) rows are
gathered and the prediction and error computed in float32; decay factors
and deltas are rounded to the storage dtype before they scale and add, as
``tpu_mf`` does.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpu_mf_torch.models.mf import MFParams
from tpu_mf_torch.ops.common import (
    decay_factors,
    occurrence_stats,
    scatter_add,
)

Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def sgd_batch_update(params: MFParams, batch: Batch, eta: float,
                     lam: float) -> MFParams:
    """One synchronous SGD step over a batch of ratings, in place."""
    u, v, r, w = batch
    theta, phi, bu, bv, gb = params
    real = w > 0

    f32 = torch.float32
    t = theta[u].to(f32)
    p = phi[v].to(f32)
    pred = (t * p).sum(-1) + bu[u].to(f32) + bv[v].to(f32) + gb.to(f32)
    # f32 scalars, as tpu_mf computes eta * w and 1 - eta * lam
    eta_t, lam_t = torch.tensor([eta, lam], dtype=f32, device=theta.device)
    err = (eta_t * w) * (r - pred)       # padded slots carry w = 0

    fu, ku = occurrence_stats(u, real, theta.shape[0])
    fv, kv = occurrence_stats(v, real, phi.shape[0])
    lameta = (1.0 - eta_t * lam_t).expand_as(err)
    fac_u = decay_factors(lameta, fu, ku).to(theta.dtype)
    fac_v = decay_factors(lameta, fv, kv).to(phi.dtype)

    # first occurrences name each touched row once
    uf, vf = u[fu], v[fv]
    theta[uf] *= fac_u[fu, None]
    phi[vf] *= fac_v[fv, None]
    bu[uf] *= fac_u[fu]
    bv[vf] *= fac_v[fv]

    scatter_add(theta, u, err[:, None] * p)
    scatter_add(phi, v, err[:, None] * t)
    scatter_add(bu, u, err)
    scatter_add(bv, v, err)
    return params


def sgd_epoch(params: MFParams, batches: Batch, eta: float,
              lam: float) -> MFParams:
    """Run the batched update over one epoch of (nb, B) rating batches
    (the ``lax.scan`` of ``tpu_mf`` as a loop)."""
    u, v, r, w = batches
    for b in range(u.shape[0]):
        sgd_batch_update(params, (u[b], v[b], r[b], w[b]), eta, lam)
    return params
