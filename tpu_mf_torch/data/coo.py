"""COO rating datasets (the port's copy of ``tpu_mf/data/coo.py``).

The reference streams protobuf ``mf.Block`` frames (user-grouped rating lists,
reference: src/blocks.proto:3-18) through a TBB pipeline. Here a dataset is a
flat COO triple ``(u, v, r)`` of host arrays, from which the plan builders
and the batched path cut their epochs. The generators and shuffles are
``tpu_mf``'s, bit for bit (``tests/test_torch_copies.py``), so one seed gives
one dataset in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class RatingsCOO:
    """A set of ratings in coordinate format.

    Attributes:
      u: int32[n] user ids.
      v: int32[n] item ids.
      r: float32[n] ratings.
      nu: number of users (row count of the user factor table).
      nv: number of items.
    """

    u: np.ndarray
    v: np.ndarray
    r: np.ndarray
    nu: int
    nv: int

    def __post_init__(self):
        self.u = np.asarray(self.u, dtype=np.int32)
        self.v = np.asarray(self.v, dtype=np.int32)
        self.r = np.asarray(self.r, dtype=np.float32)
        # Out-of-range ids would silently clamp/drop inside gathers and
        # scatters (corrupting training and eval); fail loudly instead.
        if len(self.u):
            if int(self.u.min()) < 0 or int(self.u.max()) >= self.nu:
                raise ValueError(
                    f"user ids in [{self.u.min()}, {self.u.max()}] exceed nu={self.nu}"
                )
            if int(self.v.min()) < 0 or int(self.v.max()) >= self.nv:
                raise ValueError(
                    f"item ids in [{self.v.min()}, {self.v.max()}] exceed nv={self.nv}"
                )

    def __len__(self) -> int:
        return int(self.u.shape[0])

    @property
    def n(self) -> int:
        return len(self)

    def shuffled(self, seed: int) -> "RatingsCOO":
        rng = np.random.default_rng(seed)
        p = rng.permutation(len(self))
        return RatingsCOO(self.u[p], self.v[p], self.r[p], self.nu, self.nv)

    def split(self, frac: float, seed: int = 0) -> Tuple["RatingsCOO", "RatingsCOO"]:
        """Random split into (1-frac, frac) — e.g. train/test."""
        rng = np.random.default_rng(seed)
        p = rng.permutation(len(self))
        k = int(len(self) * (1.0 - frac))
        a, b = p[:k], p[k:]
        return (
            RatingsCOO(self.u[a], self.v[a], self.r[a], self.nu, self.nv),
            RatingsCOO(self.u[b], self.v[b], self.r[b], self.nu, self.nv),
        )

    def counts(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-user and per-item rating counts (reference: block_count, model.cc:247-261)."""
        uc = np.bincount(self.u, minlength=self.nu).astype(np.int32)
        vc = np.bincount(self.v, minlength=self.nv).astype(np.int32)
        return uc, vc

    def mean_rating(self) -> float:
        return float(self.r.mean()) if len(self) else 0.0

    def to_batches(
        self, batch_size: int, *, shuffle_seed: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Reshape into (nb, B) batch arrays, padding the tail.

        Padded slots carry weight 0 and point at row id 0, so their update
        contribution is exactly zero in the batched SGD op.

        Returns (u, v, r, w) each of shape (nb, batch_size); w is {0,1} float32.
        """
        n = len(self)
        if shuffle_seed is not None:
            ds = self.shuffled(shuffle_seed)
        else:
            ds = self
        nb = -(-n // batch_size)
        pad = nb * batch_size - n
        u = np.concatenate([ds.u, np.zeros(pad, np.int32)]).reshape(nb, batch_size)
        v = np.concatenate([ds.v, np.zeros(pad, np.int32)]).reshape(nb, batch_size)
        r = np.concatenate([ds.r, np.zeros(pad, np.float32)]).reshape(nb, batch_size)
        w = np.concatenate(
            [np.ones(n, np.float32), np.zeros(pad, np.float32)]
        ).reshape(nb, batch_size)
        return u, v, r, w


def synthetic_ratings(
    nu: int,
    nv: int,
    n: int,
    rank: int = 4,
    noise: float = 0.1,
    seed: int = 0,
    gb: float = 3.0,
    zipf: float = 0.0,
    signal: float = 1.0,
    zipf_q: float = 0.0,
    zipf_u: float = 0.0,
    zipf_uq: float = 0.0,
    bias_std: float = 0.1,
) -> RatingsCOO:
    """Low-rank ground-truth synthetic dataset for tests and benchmarks.

    zipf > 0 skews item popularity as p(j) ~ 1/(j+1+zipf_q)^zipf
    (Zipf-Mandelbrot; MovieLens-like long tails at exponent ~0.8-1.0, and
    the offset zipf_q flattens the head — real catalogs' top item holds a
    fraction of a percent of all ratings, not the 5%+ a pure power law
    gives). zipf_u/zipf_uq do the same for user activity; 0 keeps uniform.

    signal scales the latent dot term: Var[s * tu.tv] = s^2/rank, so the
    Bayes-optimal test RMSE is `noise` and a bias-only model sits at
    sqrt(noise^2 + signal^2/rank + Var[bu] + Var[bv]) — pick (noise, signal)
    to calibrate convergence studies against real-dataset operating points.
    """
    rng = np.random.default_rng(seed)
    tu = rng.normal(0, 1.0 / np.sqrt(rank), (nu, rank)).astype(np.float32)
    tv = rng.normal(0, 1.0 / np.sqrt(rank), (nv, rank)).astype(np.float32)
    bu = rng.normal(0, bias_std, nu).astype(np.float32)
    bv = rng.normal(0, bias_std, nv).astype(np.float32)

    def skewed(count, expo, q):
        p = 1.0 / np.power(np.arange(1, count + 1, dtype=np.float64) + q, expo)
        p /= p.sum()
        # shuffle so popularity is not correlated with id
        p = p[rng.permutation(count)]
        return rng.choice(count, size=n, p=p).astype(np.int32)

    if zipf_u > 0.0:
        u = skewed(nu, zipf_u, zipf_uq)
    else:
        u = rng.integers(0, nu, n).astype(np.int32)
    if zipf > 0.0:
        v = skewed(nv, zipf, zipf_q)
    else:
        v = rng.integers(0, nv, n).astype(np.int32)
    r = (
        gb
        + bu[u]
        + bv[v]
        + signal * np.einsum("nk,nk->n", tu[u], tv[v])
        + rng.normal(0, noise, n)
    ).astype(np.float32)
    return RatingsCOO(u, v, r, nu, nv)


def epoch_batches(
    ds: RatingsCOO, batch_size: int, epoch: int, seed: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Shuffled fixed-shape batches for one epoch (host-side)."""
    return ds.to_batches(batch_size, shuffle_seed=seed * 1_000_003 + epoch)
