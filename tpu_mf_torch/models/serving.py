"""Inference / serving API (counterpart of ``tpu_mf/models/serving.py``).

The reference has NO serving path — prediction exists only inline in its
eval and hypergradient code (SURVEY §3.5; pred formula at model.cc:62,
model.h:87). Here scoring and top-k recommendation are first-class and
batched: score all items for a batch of users with one matrix product
(``torch.matmul``), mask already-seen items, and take the top k on the
tables' device (``torch.topk``). The score is a plain product outside any
fused kernel, so no kernel of ``csrc/`` is involved.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpu_mf_torch.models.mf import MFParams


def score_all_items(params: MFParams, users: torch.Tensor) -> torch.Tensor:
    """Scores for every item for each user in ``users``: (B, nv) float32.

    pred[b, j] = theta_{u_b} . phi_j + bu_{u_b} + bv_j + gb — one batched
    matrix product instead of the reference's per-pair cblas_sdot.
    """
    f32 = torch.float32
    users = users.to(params.theta.device, torch.int64)
    t = params.theta[users].to(f32)                        # (B, D)
    scores = t @ params.phi.to(f32).T                      # (B, nv)
    return (scores + params.bu[users].to(f32)[:, None]
            + params.bv.to(f32)[None, :] + params.gb.to(f32))


def recommend_topk(
    params: MFParams,
    users: torch.Tensor,
    k: int,
    seen_v: Optional[torch.Tensor] = None,
    seen_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k items per user, optionally masking already-rated items.

    seen_v/seen_mask: (B, S) padded per-user lists of seen item ids and a
    {0,1} validity mask; seen items score -inf before the top-k, while
    padding slots (mask 0) and repeated ids change nothing (an ``amin``
    scatter of -inf or +inf). Returns (items (B, k) int64, scores (B, k)).

    ``torch.topk`` does not promise ``lax.top_k``'s order among equal
    scores (the lower index first), so on ties the two packages may return
    different items.
    """
    scores = score_all_items(params, users)
    if seen_v is not None:
        seen_v = seen_v.to(scores.device, torch.int64)
        if seen_mask is None:
            seen_mask = torch.ones_like(seen_v, dtype=torch.float32)
        fill = torch.where(seen_mask.to(scores.device) > 0,
                           float("-inf"), float("inf"))
        scores = scores.scatter_reduce(1, seen_v, fill, reduce="amin")
    vals, idx = torch.topk(scores, k, dim=1)
    return idx, vals
