"""Batched adaptive-regularization SGD update (counterpart of
``tpu_mf/ops/adreg.py``; reference: src/admf.h:52-86).

Per batch of B ratings, against batch-start values:

1. the touched rows are copied into the shadow tables (admf.h:67-68,77-78);
2. an SGD step with the four learned regularizers (admf.h:69-80): a row
   touched k times decays by (1 - eta*lam)^k (lam_u / lam_bu on a user's
   factors / bias, lam_v / lam_bv on an item's), and the gradient terms
   err = eta * w * (r - act(pred)) are scatter-added;
3. one hypergradient step on the lambdas (admf.h:82-83, model.h:86-102)
   from K validation records, scaled by the batch's distinct real users:

       grad  = r_valid - act(pred_valid)       (new tables)
       lam_u <- max(0, lam_u - s * sum(grad * <theta_old_u, phi_v>))
       lam_v <- max(0, lam_v - s * sum(grad * <theta_u, phi_old_v>))
       lam_bu, lam_bv likewise with the shadow biases,
       s = eta_reg * eta * n_users / K.

act is the identity (least squares) or the logistic sigmoid (--loss 1).
This is the CPU path and the ``--no-pallas`` path. The K validation
indices of each batch are an argument, so that tests can feed ``tpu_mf``'s
draws; tables and shadows are updated in place. On bfloat16 tables rows
are gathered and every prediction computed in float32; shadows, decay
factors and deltas are rounded to the storage dtype before they are
written, scale or add, as ``tpu_mf`` does.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from tpu_mf_torch.models.admf import AdaptRegState
from tpu_mf_torch.ops.common import (
    decay_factors,
    occurrence_stats,
    scatter_add,
)

Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
Valid = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

N_REG_SAMPLES = 64  # validation records per hypergradient step (tpu_mf's K)


class AdRegHyper(NamedTuple):
    eta: float
    eta_reg: float
    loss: int  # 0 least squares, 1 logistic


def activate(score: torch.Tensor, loss: int) -> torch.Tensor:
    return torch.sigmoid(score) if loss == 1 else score


def adreg_batch_update(state: AdaptRegState, batch: Batch, valid: Valid,
                       hyper: AdRegHyper,
                       samples: torch.Tensor) -> AdaptRegState:
    """One AdaptReg step over a batch (u, v, r, w), in place on the tables
    and shadows; ``samples`` are the K validation indices of the
    hypergradient. Returns the state with the new lambdas."""
    u, v, r, w = batch
    theta, phi, bu, bv, gb = state.params
    dev = theta.device
    eta, eta_reg = torch.tensor([hyper.eta, hyper.eta_reg],
                                dtype=torch.float32, device=dev)
    real = w > 0
    f32 = torch.float32
    t, p, bu_g, bv_g = (x.to(f32) for x in (theta[u], phi[v], bu[u], bv[v]))
    gb = gb.to(f32)

    # 1. shadows of the touched rows (padded slots write nothing)
    ur, vr = u[real], v[real]
    state.theta_old[ur] = t[real].to(state.theta_old.dtype)
    state.phi_old[vr] = p[real].to(state.phi_old.dtype)
    state.bu_old[ur] = bu_g[real].to(state.bu_old.dtype)
    state.bv_old[vr] = bv_g[real].to(state.bv_old.dtype)

    # 2. SGD step with the learned regularizers
    err = (eta * w) * (r - activate((t * p).sum(-1) + bu_g + bv_g + gb,
                                    hyper.loss))
    fu, ku = occurrence_stats(u, real, theta.shape[0])
    fv, kv = occurrence_stats(v, real, phi.shape[0])

    def fac(lam, first, k, dtype):
        return decay_factors((1.0 - eta * lam).expand_as(err), first,
                             k).to(dtype)

    uf, vf = u[fu], v[fv]
    theta[uf] *= fac(state.lam_u, fu, ku, theta.dtype)[fu, None]
    phi[vf] *= fac(state.lam_v, fv, kv, phi.dtype)[fv, None]
    bu[uf] *= fac(state.lam_bu, fu, ku, bu.dtype)[fu]
    bv[vf] *= fac(state.lam_bv, fv, kv, bv.dtype)[fv]
    # padded slots carry err = 0
    scatter_add(theta, u, err[:, None] * p)
    scatter_add(phi, v, err[:, None] * t)
    scatter_add(bu, u, err)
    scatter_add(bv, v, err)

    # 3. hypergradient step on the lambdas
    uv, vv, rv = valid
    su, sv, sr = uv[samples], vv[samples], rv[samples]
    t_new, p_new = theta[su].to(f32), phi[sv].to(f32)
    grad = sr - activate((t_new * p_new).sum(-1) + bu[su].to(f32)
                         + bv[sv].to(f32) + gb, hyper.loss)
    inner_u = (state.theta_old[su].to(f32) * p_new).sum(-1)
    inner_v = (t_new * state.phi_old[sv].to(f32)).sum(-1)
    # one micro-step per distinct real user of the batch, as the reference
    seen = torch.zeros(theta.shape[0], dtype=torch.float32, device=dev)
    seen.scatter_reduce_(0, u, real.to(torch.float32), reduce="amax")
    scale = (eta_reg * eta) * seen.sum() / samples.shape[0]

    def step(lam, x):
        return torch.clamp(lam - scale * (grad * x).sum(), min=0.0)

    return state._replace(
        lam_u=step(state.lam_u, inner_u), lam_v=step(state.lam_v, inner_v),
        lam_bu=step(state.lam_bu, state.bu_old[su].to(f32)),
        lam_bv=step(state.lam_bv, state.bv_old[sv].to(f32)))


def adreg_epoch(state: AdaptRegState, batches: Batch, valid: Valid,
                hyper: AdRegHyper, samples: torch.Tensor) -> AdaptRegState:
    """The update over one epoch of (nb, B) batches, in order (the
    ``lax.scan`` of ``tpu_mf`` as a loop); ``samples`` is (nb, K)."""
    u, v, r, w = batches
    for b in range(u.shape[0]):
        state = adreg_batch_update(state, (u[b], v[b], r[b], w[b]), valid,
                                   hyper, samples[b])
    return state
