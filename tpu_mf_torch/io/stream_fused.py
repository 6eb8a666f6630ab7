"""Out-of-core MF epochs on the gen-1 window-plan kernel (counterpart of
``tpu_mf/io/stream_fused.py``).

* One scatter pass re-shards the on-disk stream into per-user-tile-range
  chunk files (12-byte packed records, any input format — data/streamfmt;
  ``ShardStore``, ``tpu_mf``'s shard count and seeded shuffles bit for bit).
* Each epoch walks the shards in user-tile order. A background thread
  (``io/stream.Prefetcher``) loads the next shard, reshuffles it, builds its
  gen-1 cell plan (``prepare_cells``, ``tpu_mf``'s seeds) or loads it from
  the workdir's plan cache, and uploads it to the device on a side stream
  while ``csrc/cell_sgd.cu`` runs the current shard: one ``cell_epoch``
  launch per non-empty shard, at 8/8 groups, without saturation, t*p
  rounded to the working type (``tpu_mf``'s ``_run_epoch`` call). Host
  memory stays bounded by about two shards of plan arrays.
* The fused factor tables stay on the device across shards: theta is
  chained through the shards, phi updated in place.

``tpu_mf`` pads each shard plan's batch count to a multiple of 64 so that
XLA compiles few shapes, and builds a byte-plane id stream on the device;
both are TPU compile and layout devices. The port pads nothing (a pad batch
would cost 8 grid-synced window steps of sentinels) and uploads the plan's
id, rating and weight arrays as they are. Its plan cache files are its own
(``tplan.<shard>.<variant>.npz``), so neither package reads the other's.
"""

from __future__ import annotations

import os
import tempfile
from typing import Iterator, Optional

import numpy as np
import torch

from tpu_mf_torch.data.coo import RatingsCOO
from tpu_mf_torch.data.streamfmt import iter_ratings, scan_stats
from tpu_mf_torch.models.mf import MFParams
from tpu_mf_torch.ops.rows import cdiv, pad_params, split_params
from tpu_mf_torch.ops.sgd_cells import (
    CellPlan,
    cell_epoch,
    prepare_cells,
    upload_plan,
)
from tpu_mf_torch.ops.tile_walk import TileWalkCounters, upload_window_walks
from tpu_mf_torch.train.metrics import note, span

REC = np.dtype([("u", "<i4"), ("v", "<i4"), ("r", "<f4")])

# the plan arrays a cache file holds (w is 1 exactly where u is no sentinel)
_CACHED = ("u", "v", "r", "gu", "gv")


class ShardStore:
    """On-disk re-shard of a rating stream by user-tile range."""

    def __init__(
        self,
        path: str,
        tile_u: int = 512,
        mem_limit: int = 20_000_000,
        workdir: Optional[str] = None,
    ):
        self.nu, self.nv, self.n = scan_stats(path)
        n_gu = cdiv(self.nu, tile_u)
        n_shards = min(n_gu, max(1, cdiv(self.n, mem_limit)))
        self.tiles_per_shard = cdiv(n_gu, n_shards)
        self.n_shards = cdiv(n_gu, self.tiles_per_shard)
        self.tile_u = tile_u
        self._own = workdir is None
        self.workdir = workdir or tempfile.mkdtemp(prefix="tpumf_shards_")
        os.makedirs(self.workdir, exist_ok=True)
        self.paths = [
            os.path.join(self.workdir, f"shard.{s:04d}.rec")
            for s in range(self.n_shards)
        ]
        shard_users = tile_u * self.tiles_per_shard
        files = [open(p, "wb") for p in self.paths]
        try:
            for u, v, r in iter_ratings(path, chunk=min(1 << 18, mem_limit)):
                rec = np.empty(len(u), REC)
                rec["u"], rec["v"], rec["r"] = u, v, r
                dest = u // shard_users
                for s in np.unique(dest):
                    rec[dest == s].tofile(files[s])
        finally:
            for f in files:
                f.close()

    def load(self, shard: int, seed: int) -> RatingsCOO:
        """Load one shard, reshuffled with the given seed (global ids)."""
        rec = np.fromfile(self.paths[shard], REC)
        rng = np.random.default_rng(seed)
        rng.shuffle(rec)
        return RatingsCOO(
            rec["u"].astype(np.int32), rec["v"].astype(np.int32),
            rec["r"].astype(np.float32), self.nu, self.nv,
        )

    def close(self) -> None:
        if self._own:
            for name in os.listdir(self.workdir):
                try:
                    os.remove(os.path.join(self.workdir, name))
                except OSError:
                    pass
            try:
                os.rmdir(self.workdir)
            except OSError:
                pass


class FusedStreamTrainer:
    """Out-of-core MF epochs on ``csrc/cell_sgd.cu`` over a ShardStore
    (``pad`` / ``epoch`` / ``trim``), on ``device``: CUDA tensors launch
    the kernel, CPU tensors take its plain version (``cell_epoch``).

    ``plan_cache`` = number of shuffled plan variants cached in the workdir
    per shard (epochs rotate through them, variant = epoch % plan_cache);
    0 rebuilds every epoch with a fresh shuffle. ``mxu`` names the working
    type ("bfloat16", or "float32" for parity runs).

    With the span recorder on (``train/metrics.py``), each shard's plan
    build or cache load is a ``tmf.plan_build`` span on the worker thread
    (attributes shard, epoch, cached), its upload a ``tmf.plan_upload``
    span on the side stream (shard, epoch; CUDA events), and its launch a
    ``tmf.sub_epoch`` span (shard, epoch, n_real; CUDA events)."""

    launches = 0  # kernel launches made by the trainers

    def __init__(
        self,
        path: str,
        tile_u: int = 512,
        tile_v: int = 512,
        batch: int = 4096,
        mem_limit: int = 20_000_000,
        seed: int = 0,
        mxu: str = "bfloat16",
        workdir: Optional[str] = None,
        plan_cache: int = 2,
        device: torch.device | str = "cuda",
    ):
        self.store = ShardStore(
            path, tile_u=tile_u, mem_limit=mem_limit, workdir=workdir
        )
        self.nu, self.nv = self.store.nu, self.store.nv
        self.n = self.store.n
        self.tile_u, self.tile_v = tile_u, tile_v
        self.batch = cdiv(batch, 8) * 8
        self.seed = seed
        self.work_dtype = {"bfloat16": torch.bfloat16,
                           "float32": torch.float32}[mxu]
        self.n_gu = cdiv(self.nu, tile_u)
        self.n_gv = cdiv(self.nv, tile_v)
        self.plan_cache = plan_cache
        self.device = torch.device(device)
        # the shards' tile walks hand tiles on through one set of counters
        self.walk_counters = TileWalkCounters(self.n_gv, self.n_gu,
                                              self.device)
        self.dim = None
        self.gb = 0.0

    def _build_plan(self, s: int, seed_load: int,
                    seed_plan: int) -> Optional[CellPlan]:
        ds = self.store.load(s, seed=seed_load)
        if len(ds) == 0:
            return None
        return prepare_cells(ds, self.tile_u, self.tile_v, self.batch,
                             seed=seed_plan)

    def _fingerprint(self) -> np.ndarray:
        """Identity of the plan geometry: a cached plan built under any other
        (seed, batch, tiles, dataset shape) must not be silently reused —
        user-supplied workdirs persist across runs (ShardStore._own=False)."""
        return np.asarray(
            [self.seed, self.batch, self.tile_u, self.tile_v,
             self.nu, self.nv, self.n],
            np.int64,
        )

    def _from_cache(self, z, n_real: int) -> CellPlan:
        u = z["u"]
        return CellPlan(u=u, v=z["v"], r=z["r"],
                        w=(u != self.tile_u).astype(np.float32), gu=z["gu"],
                        gv=z["gv"], tile_u=self.tile_u, tile_v=self.tile_v,
                        n_gu=self.n_gu, n_gv=self.n_gv, n_real=n_real)

    def _plans(self, epoch_idx: int) -> Iterator[tuple]:
        """(shard, host plan, from the cache) of each non-empty shard of
        the epoch, in shard order, each built or loaded in a
        ``tmf.plan_build`` span."""
        for s in range(self.store.n_shards):
            with span("tmf.plan_build", shard=s, epoch=epoch_idx):
                plan, cached = self._plan(s, epoch_idx)
                note("cached", cached)
            if plan is not None:
                yield s, plan, cached

    def _plan(self, s: int, epoch_idx: int) -> tuple:
        """(shard ``s``'s host plan for the epoch or None where it has no
        ratings, whether it came from the cache)."""
        fp = self._fingerprint()
        cached = False
        if self.plan_cache > 0:
            variant = epoch_idx % self.plan_cache
            cpath = os.path.join(
                self.store.workdir, f"tplan.{s:04d}.{variant}.npz"
            )
            plan = None
            if os.path.exists(cpath):
                with np.load(cpath) as z:
                    if "fp" in z and np.array_equal(z["fp"], fp):
                        n_real = int(z["n_real"])
                        plan = (self._from_cache(z, n_real) if n_real
                                else None)
                        cached = True
            if not cached:
                plan = self._build_plan(
                    s,
                    seed_load=self.seed + 7919 * variant + 104729 * s,
                    seed_plan=self.seed ^ (variant * 65537 + s),
                )
                arrs = {k: (getattr(plan, k) if plan is not None
                            else np.empty(0)) for k in _CACHED}
                tmp = f"{cpath}.{os.getpid()}.tmp.npz"
                np.savez(tmp, fp=fp, n_real=np.int64(
                    plan.n_real if plan is not None else 0), **arrs)
                os.replace(tmp, cpath)
        else:
            plan = self._build_plan(
                s,
                seed_load=self.seed + 7919 * epoch_idx + 104729 * s,
                seed_plan=self.seed ^ (epoch_idx * 65537 + s),
            )
        return plan, cached

    def _stage(self, item, epoch_idx: int):
        """The device form of one shard plan of epoch ``epoch_idx`` with
        its tile walk at one column a window (the 8/8 groups), built and
        uploaded in a ``tmf.plan_upload`` span (on the Prefetcher's side
        stream), and the shard's (shard, real ratings)."""
        from tpu_mf_torch.io.stream import to_device

        s, plan, _ = item
        with span("tmf.plan_upload", self.device.type == "cuda", shard=s,
                  epoch=epoch_idx):
            dplan = upload_plan(plan, self.device,
                                put=lambda a: to_device(a, self.device))
            dplan = dplan._replace(walk=upload_window_walks(
                plan, self.walk_counters, windows=(1,)))
        return dplan, (s, int(plan.n_real))

    def pad(self, params: MFParams):
        """Fused (theta_ext, phi_ext) float32 tables of ``params`` on the
        trainer's device."""
        self.dim = params.theta.shape[1]
        self.gb = float(params.gb)
        params = MFParams(*(t.to(self.device) for t in params))
        return pad_params(params, self.n_gu * self.tile_u,
                          self.n_gv * self.tile_v)

    def _launch(self, tables, plan, eta: float, lam: float,
                gb: float) -> None:
        """One shard's kernel launch, in place on the fused tables."""
        cell_epoch(tables[0], tables[1], plan, eta, lam, gb,
                   max(1.0, 0.2 / max(eta, 1e-9)), self.dim, theta_groups=8,
                   phi_groups=8, work=self.work_dtype, saturate=False,
                   mxu_pred=True)

    def epoch(self, tables, eta: float, lam: float, gb: float,
              epoch_idx: int = 0, fly: int = 2):
        """One out-of-core pass, in place on the fused tables: shards stream
        through the kernel while the next shard's plan builds on a
        background thread, each launch in a ``tmf.sub_epoch`` span. Returns
        the tables."""
        from tpu_mf_torch.io.stream import Prefetcher

        cuda = self.device.type == "cuda"
        pf = Prefetcher(self._plans(epoch_idx), fly=fly, device=self.device,
                        stage=lambda item: self._stage(item, epoch_idx))
        try:
            for plan, (s, n_real) in pf:
                with span("tmf.sub_epoch", cuda, shard=s, epoch=epoch_idx,
                          n_real=n_real):
                    launched = cell_epoch.launches
                    self._launch(tables, plan, eta, lam, gb)
                    type(self).launches += cell_epoch.launches - launched
        finally:
            pf.close()
        return tables

    def trim(self, tables) -> MFParams:
        return split_params(
            tables[0], tables[1], self.nu, self.nv, self.dim, self.gb
        )

    def close(self) -> None:
        self.store.close()
