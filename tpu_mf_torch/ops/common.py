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

import numpy as np
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
    """(1-d)^k per first-occurrence slot, 1 elsewhere.

    ``base`` is (B,) or (B, D) (per-dimension decay); ``is_first`` and
    ``counts`` are (B,). ``torch.pow`` keeps the sign of a negative base
    for odd k, as the sequential reference oscillates."""
    if base.ndim == 2:
        is_first = is_first[:, None]
        counts = counts[:, None]
    return torch.where(is_first, torch.pow(base, counts),
                       torch.ones_like(base))


def scatter_add(table: torch.Tensor, idx: torch.Tensor,
                delta: torch.Tensor) -> None:
    """table[idx] += delta in place, duplicate ids included. A float32
    table sums with ``index_add_``; a narrower storage dtype (bf16) takes
    the deltas rounded to it and one rounding per add, in slot order, as
    ``tpu_mf``'s scatter does (``index_add_`` sums 2-D bf16 rows in float32
    and rounds once)."""
    if table.dtype == torch.float32:
        table.index_add_(0, idx, delta)
    else:
        table.index_put_((idx,), delta.to(table.dtype), accumulate=True)


def distinct_counts(ids, real) -> np.ndarray:
    """Distinct real ids per leading row, vectorized (host-side plan build;
    ``tpu_mf``'s, as it is).

    ids/real: (..., n_slots) arrays; returns float32 of shape ids.shape[:-1].
    """
    sentinel = np.iinfo(np.int64).max
    flat = ids.astype(np.int64, copy=True)
    flat[~np.asarray(real, bool)] = sentinel
    flat.sort(axis=-1)
    first = np.empty(flat.shape, bool)
    first[..., :1] = flat[..., :1] < sentinel
    first[..., 1:] = ((flat[..., 1:] != flat[..., :-1])
                      & (flat[..., 1:] < sentinel))
    return first.sum(axis=-1).astype(np.float32)
