"""The benchmark's rating generator: a calibrated Zipf-Mandelbrot stand-in
for a public rating log, made on the device from ``--seed``.

The model and its calibration are those the repository's ML-10M study
settled on (rank-8 latent factors, noise 0.76, bias spread 0.38,
Zipf-Mandelbrot item and user popularity; ``benchmarks/ML10M_STUDY.md``).
The draws are torch's, not numpy's, so a seed gives other ratings than
the program's own ``synthetic_ratings``; the distribution is the same.

A configuration file's ``generator`` block holds the calibration; its
``nu``, ``nv``, ``ratings`` and ``test_frac`` the scale and the split.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Ratings:
    """One split of the generated log: host arrays (what the program is
    handed) and the same values on the device (what the reference reads)."""

    u: np.ndarray   # int32
    v: np.ndarray   # int32
    r: np.ndarray   # float32
    nu: int
    nv: int

    def __len__(self) -> int:
        return int(self.u.shape[0])

    def on(self, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return (torch.as_tensor(self.u).to(device, torch.int64),
                torch.as_tensor(self.v).to(device, torch.int64),
                torch.as_tensor(self.r).to(device))


def _skewed(g: torch.Generator, count: int, n: int, expo: float, q: float,
            device) -> torch.Tensor:
    """n ids in [0, count) with p(rank j) ~ 1 / (j + 1 + q)^expo, the ranks
    dealt to ids by a random permutation (popularity is not the id)."""
    if expo <= 0.0:
        return torch.randint(0, count, (n,), generator=g, device=device)
    ranks = torch.arange(1, count + 1, dtype=torch.float64, device=device)
    p = (ranks + q).pow(-expo)
    p = p[torch.randperm(count, generator=g, device=device)]
    cdf = torch.cumsum(p, 0)
    cdf /= cdf[-1].clone()
    x = torch.rand(n, generator=g, dtype=torch.float64, device=device)
    return torch.searchsorted(cdf, x, right=True).clamp_(max=count - 1)


def generate(cfg: dict, seed: int, device) -> tuple[Ratings, Ratings]:
    """(train, test) of configuration ``cfg``, drawn from ``seed`` on
    ``device`` and split by a seeded permutation."""
    gen = cfg["generator"]
    nu, nv, n = int(cfg["nu"]), int(cfg["nv"]), int(cfg["ratings"])
    rank = int(gen["rank"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))

    def normal(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=device) * std

    tu = normal(nu, rank, std=1.0 / math.sqrt(rank))
    tv = normal(nv, rank, std=1.0 / math.sqrt(rank))
    bu = normal(nu, std=gen["bias_std"])
    bv = normal(nv, std=gen["bias_std"])
    u = _skewed(g, nu, n, gen["zipf_u"], gen["zipf_uq"], device)
    v = _skewed(g, nv, n, gen["zipf"], gen["zipf_q"], device)
    r = torch.empty(n, dtype=torch.float32, device=device)
    chunk = 1 << 22
    for s in range(0, n, chunk):
        cu, cv = u[s:s + chunk], v[s:s + chunk]
        r[s:s + chunk] = (gen["gb"] + bu[cu] + bv[cv]
                          + gen["signal"] * (tu[cu] * tv[cv]).sum(1)
                          + normal(cu.numel(), std=gen["noise"]))
    del tu, tv, bu, bv
    perm = torch.randperm(n, generator=g, device=device)
    k = int(n * (1.0 - float(cfg["test_frac"])))

    def part(idx):
        return Ratings(u=u[idx].to(torch.int32).cpu().numpy(),
                       v=v[idx].to(torch.int32).cpu().numpy(),
                       r=r[idx].cpu().numpy(), nu=nu, nv=nv)

    return part(perm[:k]), part(perm[k:])


def init_tables(nu: int, nv: int, dim: int, seed: int, device,
                scale: float = 1e-2) -> dict:
    """Gaussian(0, scale) factor and bias tables (the reference trainer's
    init, model.cc:22-33), float32, drawn on ``device`` from ``seed`` in
    one call per table."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) ^ 0x5EED)

    def normal(*shape):
        return torch.randn(*shape, generator=g, device=device) * scale

    return {"theta": normal(nu, dim), "phi": normal(nv, dim),
            "bu": normal(nu), "bv": normal(nv)}
