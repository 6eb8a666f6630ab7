"""Gibbs resampling of the DP-SGLD precisions (counterpart of
``tpu_mf/ops/gibbs.py``; reference: DPMF::sample_hyper, src/model.cc:335-348,
and its Gamma sampler, util.h:126-154).

Each precision is drawn from its Gamma posterior
Gamma(shape = a + n/2, rate = b + ||x||^2 / 2): lambda_r from the training
sum of squared errors, the bias precisions from the bias vectors, and
lambda_u / lambda_v per dimension from the factor columns. The 2 dim + 3
variates are drawn on the host from an explicit ``numpy.random.Generator``
(``torch.distributions.Gamma`` takes no generator).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_mf_torch.models.dpmf import DPMFState


def gamma_posterior_params(prior_a, prior_b, psum_sqr, psum_cnt):
    """(alpha, beta) float32 of the posterior Gamma(a + cnt/2, b + sqr/2);
    arrays broadcast (util.h:146-154)."""
    f32 = np.float32
    alpha = f32(prior_a) + f32(0.5) * np.asarray(psum_cnt, f32)
    beta = f32(prior_b) + f32(0.5) * np.asarray(psum_sqr, f32)
    return alpha, beta


def gamma_posterior(rng: np.random.Generator, prior_a, prior_b, psum_sqr,
                    psum_cnt) -> np.ndarray:
    """lambda ~ Gamma(alpha, rate beta), one variate per element of the
    broadcast shape, float32."""
    alpha, beta = np.broadcast_arrays(
        *gamma_posterior_params(prior_a, prior_b, psum_sqr, psum_cnt))
    return (rng.standard_gamma(alpha.astype(np.float64))
            / beta).astype(np.float32)


def sample_hyper(state: DPMFState, sse_train: float, ntrain: float,
                 hyper_a: float, hyper_b: float,
                 rng: np.random.Generator) -> DPMFState:
    """All precisions resampled from their posteriors (model.cc:335-348).

    ``sse_train`` is the SUM of squared errors over the training set, as
    the reference passes calc_mse's raw sum (model.cc:302, 336)."""
    theta, phi, bu, bv, _ = state.params
    nu, nv = theta.shape[0], phi.shape[0]

    def host(x):
        return x.detach().to(torch.float32).cpu().numpy()

    # column squared norms (reference: normsqr_col, util.h:156-161)
    sums = [(bu.float() ** 2).sum(), (bv.float() ** 2).sum(),
            (theta.float() ** 2).sum(0), (phi.float() ** 2).sum(0)]
    sq_ub, sq_vb, normu, normv = (host(s) for s in sums)
    draws = [
        gamma_posterior(rng, hyper_a, hyper_b, sse_train, ntrain),
        gamma_posterior(rng, hyper_a, hyper_b, sq_ub, nu),
        gamma_posterior(rng, hyper_a, hyper_b, sq_vb, nv),
        gamma_posterior(rng, hyper_a, hyper_b, normu, nu),
        gamma_posterior(rng, hyper_a, hyper_b, normv, nv),
    ]
    dev = theta.device
    lr, lub, lvb, lu, lv = (torch.as_tensor(d).to(dev) for d in draws)
    return state._replace(lambda_r=lr, lambda_ub=lub, lambda_vb=lvb,
                          lambda_u=lu, lambda_v=lv)
