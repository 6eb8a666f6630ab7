"""Batched DP-SGLD update: lazy Langevin noise and the privacy-scaled
gradient step (counterpart of ``tpu_mf/ops/sgld.py``; reference:
src/dpmf.h:37-92).

Per batch of B ratings, against batch-start values:

1. every row touched in the batch takes one draw of
   sqrt(temp * eta * c) * N(0, 1) on its factors and bias, where c counts
   the global updates since the row was last touched (the batch's real
   ratings included), and is stamped with the batch-end clock;
2. the gradient step, scal = eta * ntrain * bound * lambda_r:

       err      = scal * w * (r - theta_u . phi_v - bu_u - bv_v - gb)
       theta_u <- theta_u * (1 - eta*bound*ur_u*lambda_u)^k + err * phi_v
       bu_u    <- bu_u * (1 - eta*bound*ur_u*lambda_ub)^k + err

   and likewise for the items, with per-dimension decay applied once per
   row touched k times.

This is the CPU path and the ``--no-pallas`` path. Noise comes from an
explicit ``torch.Generator``; tables and counters are updated in place. On
bfloat16 tables noise and deltas are drawn and computed in float32 and
rounded to the storage dtype before they add, decay factors before they
scale, and rows are gathered in float32, as ``tpu_mf`` does.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from tpu_mf_torch.models.dpmf import DPMFState
from tpu_mf_torch.ops.common import (
    decay_factors,
    occurrence_stats,
    scatter_add,
)

Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


class SgldHyper(NamedTuple):
    """Per-round scalars of the SGLD step."""

    eta: float
    temp: float
    bound: float
    ntrain: float


def _f32(dev, *xs):
    return torch.tensor(xs, dtype=torch.float32, device=dev)


def sgld_batch_update(state: DPMFState, batch: Batch, hyper: SgldHyper,
                      generator: torch.Generator) -> DPMFState:
    """One SGLD step over a batch (u, v, r, w), in place on the tables and
    counters; returns the state with the advanced global counter."""
    u, v, r, w = batch
    theta, phi, bu, bv, gb = state.params
    nu, dim = theta.shape
    nv = phi.shape[0]
    dev = theta.device
    # f32 scalars, combined in tpu_mf's order
    eta, temp, bound, ntrain = _f32(dev, *hyper)
    real = w > 0
    fu, ku = occurrence_stats(u, real, nu)
    fv, kv = occurrence_stats(v, real, nv)
    u_pad = torch.where(real, u, nu)
    v_pad = torch.where(real, v, nv)

    # lazy Langevin noise (dpmf.h:61-70): one draw per row touched
    gc_end = state.gcount + real.sum()
    te = temp * eta
    uf, vf = u[fu], v[fv]
    su = torch.sqrt(te * (gc_end - state.gcountu[uf]).to(torch.float32))
    sv = torch.sqrt(te * (gc_end - state.gcountv[vf]).to(torch.float32))

    def normal(*shape):
        return torch.randn(*shape, generator=generator, device=dev)

    theta[uf] += (su[:, None] * normal(len(uf), dim)).to(theta.dtype)
    phi[vf] += (sv[:, None] * normal(len(vf), dim)).to(phi.dtype)
    bu[uf] += (su * normal(len(uf))).to(bu.dtype)
    bv[vf] += (sv * normal(len(vf))).to(bv.dtype)
    state.gcountu[u_pad] = gc_end
    state.gcountv[v_pad] = gc_end

    # privacy-scaled gradient step (dpmf.h:72-88)
    f32 = torch.float32
    t, p = theta[u].to(f32), phi[v].to(f32)
    scal = eta * ntrain * bound * state.lambda_r
    pred = (t * p).sum(-1) + bu[u].to(f32) + bv[v].to(f32) + gb.to(f32)
    err = (scal * w) * (r - pred)
    ur_g, vr_g = state.ur[u], state.vr[v]
    fac_t = decay_factors(1.0 - (eta * bound * ur_g)[:, None]
                          * state.lambda_u[None, :], fu, ku)
    fac_p = decay_factors(1.0 - (eta * bound * vr_g)[:, None]
                          * state.lambda_v[None, :], fv, kv)
    fac_bu = decay_factors(1.0 - eta * state.lambda_ub * bound * ur_g, fu, ku)
    fac_bv = decay_factors(1.0 - eta * state.lambda_vb * bound * vr_g, fv, kv)
    theta[uf] *= fac_t[fu].to(theta.dtype)
    phi[vf] *= fac_p[fv].to(phi.dtype)
    bu[uf] *= fac_bu[fu].to(bu.dtype)
    bv[vf] *= fac_bv[fv].to(bv.dtype)
    # padded slots carry err = 0
    scatter_add(theta, u, err[:, None] * p)
    scatter_add(phi, v, err[:, None] * t)
    scatter_add(bu, u, err)
    scatter_add(bv, v, err)
    return state._replace(gcount=gc_end)


def sgld_epoch(state: DPMFState, batches: Batch, hyper: SgldHyper,
               generator: torch.Generator) -> DPMFState:
    """The SGLD update over one round of (nb, B) batches, in order."""
    u, v, r, w = batches
    for b in range(u.shape[0]):
        state = sgld_batch_update(state, (u[b], v[b], r[b], w[b]), hyper,
                                  generator)
    return state


def finish_noise(state: DPMFState, eta: float, temp: float,
                 generator: torch.Generator) -> DPMFState:
    """Flush the outstanding lazy noise of every row and reset the counters
    (reference: DPMF::finish_noise, model.cc:312-332), in place."""
    theta, phi, bu, bv, _ = state.params
    nu, dim = theta.shape
    nv = phi.shape[0]
    dev = theta.device
    eta_t, temp_t = _f32(dev, eta, temp)
    te = temp_t * eta_t

    def std(stamps):
        c = (state.gcount - stamps).to(torch.float32)
        return torch.sqrt(te * torch.clamp(c, min=0.0))

    su, sv = std(state.gcountu[:nu]), std(state.gcountv[:nv])

    def normal(*shape):
        return torch.randn(*shape, generator=generator, device=dev)

    theta += (su[:, None] * normal(nu, dim)).to(theta.dtype)
    phi += (sv[:, None] * normal(nv, dim)).to(phi.dtype)
    bu += (su * normal(nu)).to(bu.dtype)
    bv += (sv * normal(nv)).to(bv.dtype)
    state.gcountu.zero_()
    state.gcountv.zero_()
    state.gcount.zero_()
    return state
