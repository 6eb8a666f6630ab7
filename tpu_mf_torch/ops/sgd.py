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
are updated in place.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpu_mf_torch.models.mf import MFParams
from tpu_mf_torch.ops.common import decay_factors, occurrence_stats

Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def sgd_batch_update(params: MFParams, batch: Batch, eta: float,
                     lam: float) -> MFParams:
    """One synchronous SGD step over a batch of ratings, in place."""
    u, v, r, w = batch
    theta, phi, bu, bv, gb = params
    real = w > 0

    t = theta[u]
    p = phi[v]
    pred = (t * p).sum(-1) + bu[u] + bv[v] + gb
    # f32 scalars, as tpu_mf computes eta * w and 1 - eta * lam
    eta_t, lam_t = torch.tensor([eta, lam], dtype=torch.float32,
                                device=theta.device)
    err = (eta_t * w) * (r - pred)       # padded slots carry w = 0

    fu, ku = occurrence_stats(u, real, theta.shape[0])
    fv, kv = occurrence_stats(v, real, phi.shape[0])
    lameta = (1.0 - eta_t * lam_t).expand_as(err)
    fac_u = decay_factors(lameta, fu, ku)
    fac_v = decay_factors(lameta, fv, kv)

    # first occurrences name each touched row once
    uf, vf = u[fu], v[fv]
    theta[uf] *= fac_u[fu, None]
    phi[vf] *= fac_v[fv, None]
    bu[uf] *= fac_u[fu]
    bv[vf] *= fac_v[fv]

    theta.index_add_(0, u, err[:, None] * p)
    phi.index_add_(0, v, err[:, None] * t)
    bu.index_add_(0, u, err)
    bv.index_add_(0, v, err)
    return params


def sgd_epoch(params: MFParams, batches: Batch, eta: float,
              lam: float) -> MFParams:
    """Run the batched update over one epoch of (nb, B) rating batches
    (the ``lax.scan`` of ``tpu_mf`` as a loop)."""
    u, v, r, w = batches
    for b in range(u.shape[0]):
        sgd_batch_update(params, (u[b], v[b], r[b], w[b]), eta, lam)
    return params
