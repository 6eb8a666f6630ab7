"""Item-sharded gen-1 epochs for large catalogs (counterpart of
``tpu_mf/ops/phi_shard.py``).

``tpu_mf`` routes a catalog whose fused item table passes 64 MiB
(``pallas_eligible``; the reference's Yahoo workload, nu 1,000,990 and nv
624,961, at every dim) here instead of to the single-call gen-1 runner:

* both axes are relabeled with the serpentine per-tile balance map
  (``_tile_balance_map``), and the balanced item axis is cut into K
  contiguous shards of whole item tiles (``phi_shard_tiles`` at
  ``PHI_SHARD_BUDGET``); each tile carries the same load, so each shard
  carries the same work;
* each shard's ratings form a dataset of their own (all padded users, the
  shard's items) with its own gen-1 cell plans (``CellEpochRunner``,
  seeds ``seed + 101 k``, batch counts rounded to ``nb_round``);
* an epoch runs the K sub-epochs in order, theta chained through them:
  shard k+1 sees shard k's user updates, and within a shard the windows
  are those of the single-call path.

The budget is a TPU residency figure, but it fixes which ratings share a
sub-epoch and in what order, so it is kept as it is; so is the large-catalog
tile domain of ``pick_cell_geometry_large`` (tiles up to 4096 x 2040),
which sets the window. Every sub-epoch is one launch of
``csrc/cell_sgd.cu`` (``cell_epoch``), which gathers rows directly at any
tile size.

Tables are (theta_ext, [phi_0, ..., phi_{K-1}]); the shards are row ranges
of one fused item table, updated in place.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tpu_mf_torch.data.coo import RatingsCOO
from tpu_mf_torch.models.mf import MFParams
from tpu_mf_torch.ops.rows import cdiv, fuse_rows, row_lanes, split_params
from tpu_mf_torch.ops.sgd_cells import (
    CellEpochRunner,
    _tile_balance_map,
    cell_epoch,
)
from tpu_mf_torch.ops.tile_walk import TileWalkCounters
from tpu_mf_torch.train.metrics import span

# Bytes of one shard's fused item rows (tpu_mf's VMEM budget).
PHI_SHARD_BUDGET = 36 * 1024 * 1024


def pick_cell_geometry_large(ds: RatingsCOO, lanes: int = 128
                             ) -> Tuple[int, int, int]:
    """(tile_u, tile_v, batch) of a sparse, large-catalog cell plan,
    ``tpu_mf``'s chooser: the fill terms of ``pick_cell_geometry`` over
    the cost ~ (tile_u + tile_v) / 768 * (1 + 94 / sub) per rating, on the
    domain tile_u <= 4096, tile_v <= 2040, with the TPU's one-hot
    temporaries (4 * sub * (tu + tv) bf16) within 48 MiB. ``lanes`` is
    part of the signature and scores nothing."""
    del lanes
    n = len(ds)
    best = (1024, 1024, 8 * 512)
    best_score = -1.0
    for tu in (512, 1024, 2048, 4096):
        n_gu = cdiv(ds.nu, tu)
        for tv in (256, 512, 1024, 1536, 2040):
            n_gv = cdiv(ds.nv, tv)
            gloss = n_gv / (cdiv(n_gv, 8) * 8)
            c = n / (n_gu * n_gv)
            for sub in (512, 768, 1024):
                if 4 * sub * (tu + tv) * 2 > 48 * 1024 * 1024:
                    continue
                blocks = max(1, cdiv(int(c * 1.12), sub))
                fill = c / (blocks * sub) * gloss
                cost = (tu + tv) / 768.0 * (1.0 + 94.0 / sub)
                score = fill / cost
                if score > best_score:
                    best_score = score
                    best = (tu, tv, 8 * sub)
    return best


def phi_shard_tiles(nv_pad: int, tile_v: int, dim: int,
                    budget: int = PHI_SHARD_BUDGET) -> Tuple[int, int]:
    """(item tiles per shard, shard count): the fewest shards whose fused
    rows fit ``budget`` bytes, then the tiles spread evenly over them."""
    lanes = row_lanes(dim)
    tiles_total = nv_pad // tile_v
    rows_budget = max(tile_v, budget // (lanes * 4))
    tiles_fit = max(1, rows_budget // tile_v)
    n_shards = cdiv(tiles_total, tiles_fit)
    tiles_per = cdiv(tiles_total, n_shards)
    return tiles_per, cdiv(tiles_total, tiles_per)


class PhiShardedRunner:
    """K gen-1 sub-epochs an epoch over contiguous item shards, as
    ``tpu_mf``'s PhiShardedRunner (``pad`` / ``epoch`` / ``trim``).

    The geometry defaults to ``pick_cell_geometry_large``; ``n_plans``,
    ``saturate``, ``mxu``, the groups and ``nb_round`` go to every shard's
    ``CellEpochRunner`` (``balance=False``: the maps here balance both
    axes once, globally). The shards' runners share one set of tile-walk
    counters, and with them one buffer of dtheta slices."""

    # kernel launches made through sharded runners (each one also counts
    # on CellEpochRunner.launches and cell_epoch.launches)
    launches = 0

    def __init__(self, ds: RatingsCOO, dim: int, tile_u: int | None = None,
                 tile_v: int | None = None, batch: int | None = None,
                 seed: int = 0, mxu: str = "bfloat16", n_plans: int = 1,
                 saturate: bool = True, budget: int = PHI_SHARD_BUDGET,
                 theta_groups: int | None = None,
                 phi_groups: int | None = None, nb_round: int = 256,
                 device: torch.device | str = "cuda"):
        if tile_u is None or tile_v is None or batch is None:
            tile_u, tile_v, batch = pick_cell_geometry_large(ds,
                                                             row_lanes(dim))
        self.nu, self.nv = ds.nu, ds.nv
        self.nu_pad = cdiv(ds.nu, tile_u) * tile_u
        nv_pad = cdiv(ds.nv, tile_v) * tile_v
        self.tile_u, self.tile_v, self.batch = tile_u, tile_v, batch
        tiles_per, self.n_shards = phi_shard_tiles(nv_pad, tile_v, dim,
                                                   budget)
        self.shard_rows = tiles_per * tile_v
        self.nv_pad = self.n_shards * self.shard_rows
        self._map_u = _tile_balance_map(np.bincount(ds.u, minlength=ds.nu),
                                        tile_u)
        self._map_v = _tile_balance_map(np.bincount(ds.v, minlength=ds.nv),
                                        tile_v)
        ub, vb = self._map_u[ds.u], self._map_v[ds.v]
        S = self.shard_rows
        self.inners = []
        for k in range(self.n_shards):
            m = (vb >= k * S) & (vb < (k + 1) * S)
            ds_k = RatingsCOO(u=ub[m], v=vb[m] - k * S, r=ds.r[m],
                              nu=self.nu_pad, nv=S)
            self.inners.append(CellEpochRunner(
                ds_k, tile_u=tile_u, tile_v=tile_v, batch=batch,
                seed=seed + 101 * k, mxu=mxu, theta_groups=theta_groups,
                phi_groups=phi_groups, n_plans=n_plans, balance=False,
                saturate=saturate, nb_round=nb_round, device=device))
        first = self.inners[0].plan
        counters = TileWalkCounters(first.n_gv, first.n_gu, device)
        for inner in self.inners:
            inner.walk_counters = counters
        self.dim = None
        self.gb = 0.0

    @property
    def n_slots(self) -> int:
        """Plan slots per epoch (real and padded), over every shard."""
        return sum(int(r.plan.u.size) for r in self.inners)

    def pad(self, params: MFParams):
        """(theta_ext, [phi shard k]): fused rows placed through the maps;
        the shards are row ranges of one item table. Uploads every
        shard's plans."""
        self.dim = params.theta.shape[1]
        self.gb = float(params.gb)
        lanes = row_lanes(self.dim)
        for inner in self.inners:
            inner.materialize().bind(self.dim, self.gb)
        theta = fuse_rows(params.theta, params.bu, self.nu_pad, lanes, "u",
                          self._map_u)
        phi = fuse_rows(params.phi, params.bv, self.nv_pad, lanes, "v",
                        self._map_v)
        S = self.shard_rows
        return theta, [phi[k * S:(k + 1) * S] for k in range(self.n_shards)]

    def epoch(self, tables, eta: float, lam: float, gb: float,
              epoch_idx: int = 0, walk: str | None = None):
        """The K sub-epochs in shard order, in place, each in a
        ``tmf.sub_epoch`` span (``walk`` forces the walk of every one);
        returns the tables."""
        theta, phis = tables
        cuda = theta.device.type == "cuda"
        launched = cell_epoch.launches
        for k, (inner, phi_k) in enumerate(zip(self.inners, phis)):
            with span("tmf.sub_epoch", cuda, shard=k):
                inner.epoch((theta, phi_k), eta, lam, gb,
                            epoch_idx=epoch_idx, walk=walk)
        PhiShardedRunner.launches += cell_epoch.launches - launched
        return tables

    def trim(self, tables, dim: int | None = None) -> MFParams:
        theta, phis = tables
        return split_params(theta, torch.cat(phis, 0), self.nu, self.nv,
                            dim or self.dim, self.gb, self._map_u,
                            self._map_v)
