"""Per-batch occurrence statistics and geometric decay for batched SGD.

Counterpart of ``tpu_mf/ops/common.py``. The reference decays a row touched
k times in a row by (1-d)^k (mf.h:94-109); the batched update applies that
as one multiply per touched row and scatter-adds the gradient terms.

JAX drops out-of-bounds scatter indices, so ``tpu_mf`` redirects padded
slots to row ``n_rows``. PyTorch raises on such indices instead, so here
padded slots are masked out explicitly with the batch's weight vector.
"""

from __future__ import annotations

from typing import Tuple

import torch


def occurrence_stats(
    idx: torch.Tensor, real: torch.Tensor, n_rows: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-slot (is_first_occurrence, row_occurrence_count) within a batch.

    ``real`` marks the slots that hold a rating; padded slots are never a
    first occurrence and are not counted."""
    b = idx.shape[0]
    pos = torch.arange(b, device=idx.device)
    ridx = idx[real]
    first_pos = torch.full((n_rows,), b, dtype=torch.int64, device=idx.device)
    first_pos.scatter_reduce_(0, ridx, pos[real], reduce="amin")
    is_first = real & (first_pos[idx] == pos)
    counts = torch.zeros(n_rows, dtype=torch.float32, device=idx.device)
    counts.index_add_(0, ridx, torch.ones_like(ridx, dtype=torch.float32))
    return is_first, counts[idx]


def decay_factors(
    base: torch.Tensor, is_first: torch.Tensor, counts: torch.Tensor
) -> torch.Tensor:
    """(1-d)^k per first-occurrence slot, 1 elsewhere (``base`` is (B,))."""
    return torch.where(is_first, torch.pow(base, counts),
                       torch.ones_like(base))
