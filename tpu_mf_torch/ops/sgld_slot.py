"""DP-SGLD rounds on slot plans, for small rank (counterpart of
``tpu_mf/ops/pallas_sgld_slot.py``; reference semantics: src/dpmf.h:37-92).

On the TPU the slot-major layout packs P rows per 128-lane row; the stacked
tables, packed ids, lane rolls and broadcast matmuls are layout. What the
kernel computes is a window of one whole batch:

- all 8 columns of batch i read the batch-start rows and scatter
  err = scal * (r - t . p - bu - bv - gb) times the other side's row; a
  padded slot contributes nothing;
- then every touched tile applies once (the items at their tile's last
  touching column, the users at batch end): a row touched k times takes
  its delta scaled by min(1, cap / max(k, 1)) (saturation),
  cap = max(1, 0.2 / scal), and decays by base^k per lane as in
  ``ops/sgld_cells.py``;
- on the applies of every ``noise_every``-th batch (i % noise_every ==
  noise_every - 1) touched rows also take
  sqrt(max(temp * eta * (start_i - stamp), 0)) * ring[...] on their factor
  and bias lanes and are stamped start_i, the batch-START clock.

The normals come from a per-round standard-normal ring of
(4 * tile, 128) drawn from ``noise_seed`` (``slot_ring``), read at
``tpu_mf``'s offsets: the slice of a tile starts at ring row 8 q,
q = (v ^ (v >> 7)) & (nq - 1), v = i * 40503 + site * 25253 + noise_seed in
int32 arithmetic, site = item tile * tile or user tile * tile + 1, and the
tile-local row l takes lane (l % P) * 128/P + lane of row
q * 8 + (l % P) * tile/P + l // P (``ring_noise``). Kernel and plain
version take the ring as a tensor, so a test can hand both another ring.

The pack is ``sgld_slot_pack`` (dim + 6 lanes a slot), not the SGD pack:
tiles, balance maps and sub picks follow it. The plans (``ops/sgd_slot.py``,
bit for bit ``tpu_mf``'s) become window plans through ``to_window_plan``
and run on ``csrc/sgld_cells.cu``'s slot mode.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_mf_torch.data.coo import RatingsCOO
from tpu_mf_torch.models.dpmf import DPMFState
from tpu_mf_torch.ops.rows import LANES, cdiv
from tpu_mf_torch.ops.sgd_cells import (
    DevicePlan,
    _apply_flags,
    upload_plan,
)
from tpu_mf_torch.ops.sgd_slot import (
    _slot_bucket_counts,
    balance_dataset,
    pick_sub,
    pick_sub_stripe,
    prepare_cells_slot,
    prepare_cells_stripe,
    to_window_plan,
)
from tpu_mf_torch.ops.sgld_cells import (
    _MASK,
    MAX_EXACT_COUNT,
    Hyper,
    SgldRunner,
    _decay,
    _inject,
    _noise_lanes,
    _scalars,
    launch_sgld,
    ring_slices,
)
from tpu_mf_torch.ops.tile_walk import (
    WALKS,
    DeviceWalk,
    pick_walk,
    plan_tile_walk,
    routed,
    tile_apply_flags,
    upload_walk,
)


def sgld_slot_pack(dim: int) -> int:
    """Rows per 128-lane row on the TPU; slot = [fac|bias|one|cnt|gclo|
    invf|gchi]."""
    if dim + 6 <= 16:
        return 8
    if dim + 6 <= 32:
        return 4
    if dim + 6 <= 64:
        return 2
    return 1


def sgld_slot_eligible(state: DPMFState, ntrain: int) -> bool:
    """Whether the slot mode of ``csrc/sgld_cells.cu`` takes the state's
    rounds: dim <= 58 (a pack of 2 or more) and a round below 2^31 ratings.
    The kernel keeps both tables in HBM, so ``tpu_mf``'s 64 MiB VMEM limit
    on the slot-major item table routes nothing here."""
    return (sgld_slot_pack(state.params.theta.shape[1]) >= 2
            and ntrain < MAX_EXACT_COUNT)


def slot_ring(noise_seed: int, tile_u: int, tile_v: int,
              device) -> torch.Tensor:
    """The round's (4 * max(tile_u, tile_v), 128) standard-normal ring."""
    gen = torch.Generator(device=device).manual_seed(noise_seed)
    return torch.randn(4 * max(tile_u, tile_v), LANES, generator=gen,
                       device=device)


def saturation_cap(scal: float) -> float:
    """The window step cap max(1, 0.2 / scal), as the float32 the kernel
    takes."""
    return float(np.float32(max(1.0, 0.2 / max(float(scal), 1e-12))))


def ring_offset(i: int, site: int, noise_seed: int, nq: int) -> int:
    """The slice index q of batch i at ``site``, in int32 arithmetic with
    an arithmetic right shift, as ``tpu_mf``'s slot kernel takes it."""
    v = (i * 40503 + site * 25253 + noise_seed) & _MASK
    v -= (v >> 31) << 32
    return (v ^ (v >> 7)) & (nq - 1)


def ring_noise(ring: torch.Tensor, q: int, tile: int, pack: int, dim: int,
               side: int) -> torch.Tensor:
    """(tile, dim + 1) normals of a tile's rows from ring slice q: logical
    lanes are the factors, then the bias (slot lane dim of a user row,
    dim + 1 of an item row)."""
    dev = ring.device
    l = torch.arange(tile, device=dev)
    rows = q * 8 + (l % pack) * (tile // pack) + l // pack
    cols = ((l % pack) * (LANES // pack))[:, None] + _noise_lanes(
        dim, side, dev)[None, :]
    return ring[rows[:, None], cols]


class SlotSgldPlan(NamedTuple):
    """A slot plan on a device as window-plan columns, with its
    batch-START clock (int64), apply flags (1 at a tile's last touching
    column, 2 there on noise batches) and its tile walk (a window is a
    batch; the walk's flags are those of the real columns)."""

    cells: DevicePlan
    cum: torch.Tensor     # (NB,) int64
    cum_host: np.ndarray
    ap: torch.Tensor      # (NB, 8) int32
    ap_host: np.ndarray
    walk: DeviceWalk


def sgld_slot_epoch_reference(theta, phi, stamp_u, stamp_v, invf_u, invf_v,
                              lam, plan: SlotSgldPlan, clock0: int,
                              hyper: Hyper, dim: int, noise_seed: int,
                              ring: torch.Tensor, pack: int,
                              noise_every: int, cap: float,
                              work: torch.dtype = torch.float32) -> None:
    """Plain PyTorch SGLD round on a slot plan, in place on the fused
    tables and the stamps: per batch one window of all 8 columns, then the
    applies."""
    f32 = torch.float32
    dev = theta.device
    cp = plan.cells
    tu, tv = cp.tile_u, cp.tile_v
    lanes = theta.shape[1]
    scal, gb, eb, te = _scalars(hyper, dev)
    cap_t = torch.tensor(cap, dtype=f32, device=dev)
    lane = torch.arange(lanes, device=dev)
    keep = ((lane <= dim).to(f32), ((lane < dim) | (lane == dim + 1)).to(f32))
    cnt = (lane == dim + 2).to(f32)
    nzl = (_noise_lanes(dim, 0, dev), _noise_lanes(dim, 1, dev))
    n_ring = ring.shape[0]
    acc = torch.zeros_like(phi)

    def rnd(x):
        return x if work == f32 else x.to(work).to(f32)

    def apply(tab, d, stamps, inv, side, i, clock, noisy, site, tile):
        k = d[:, dim + 2]
        d = d * torch.clamp(cap_t / torch.clamp(k, min=1.0), max=1.0)[:, None]
        out = tab * _decay(inv, lam[side], k, eb) + d * keep[side]
        if noisy:
            q = ring_offset(i, site, noise_seed, ring_slices(n_ring, tile))
            _inject(out, stamps, k > 0, clock, te, nzl[side],
                    ring_noise(ring, q, tile, pack, dim, side))
        tab.copy_(out)

    for i in range(cp.u.shape[0]):
        clock = clock0 + int(plan.cum_host[i])
        gu = int(cp.gu_host[i])
        us = slice(gu * tu, (gu + 1) * tu)
        th = theta[us]
        w = cp.w[i].reshape(-1, 1)
        real = w[:, 0] > 0
        ul = torch.where(real, cp.u[i].reshape(-1), 0).long()
        vl = (torch.where(real, cp.v[i].reshape(-1), 0).long()
              + (cp.gv[i, :, None].long() * tv).expand(8, cp.u.shape[2])
              .reshape(-1))
        t, p = rnd(th[ul]), rnd(phi[vl])
        pred = (t * p).sum(-1, keepdim=True) + gb
        err = (scal * w) * (cp.r[i].reshape(-1, 1) - pred)
        d_th = torch.zeros(tu, lanes, dtype=f32, device=dev)
        d_th.index_add_(0, ul, rnd(err * p + w * cnt))
        acc.index_add_(0, vl, rnd(err * t + w * cnt))
        for k in range(8):
            flag = int(plan.ap_host[i, k])
            if flag:
                gv = int(cp.gv_host[i, k])
                vs = slice(gv * tv, (gv + 1) * tv)
                apply(phi[vs], acc[vs], stamp_v[vs], invf_v[vs], 1, i, clock,
                      flag == 2, gv * tv, tv)
                acc[vs] = 0.0
        apply(th, d_th, stamp_u[us], invf_u[us], 0, i, clock,
              i % noise_every == noise_every - 1, gu * tu + 1, tu)


def sgld_slot_epoch(theta, phi, stamp_u, stamp_v, invf_u, invf_v, lam,
                    plan: SlotSgldPlan, clock0: int, hyper: Hyper, dim: int,
                    noise_seed: int, ring: torch.Tensor, pack: int,
                    noise_every: int, cap: float,
                    work: torch.dtype = torch.bfloat16,
                    walk: str | None = None) -> None:
    """One SGLD round on a slot plan, in place on the fused tables and
    stamps. CPU tensors take the plain version; CUDA tensors launch
    ``csrc/sgld_cells.cu``'s slot mode (one launch per round) or raise, on
    the walk ``walk`` forces ("tile" or "grid"; default: the plan's
    route)."""
    args = (theta, phi, stamp_u, stamp_v, invf_u, invf_v, lam, plan, clock0,
            hyper, dim, noise_seed, ring, pack, noise_every, cap, work)
    if theta.device.type == "cpu":
        sgld_slot_epoch_reference(*args)
        return
    if theta.device.type != "cuda":
        raise ValueError(f"sgld_slot_epoch: no kernel for {theta.device}")
    route = pick_walk(plan.walk, walk)
    launch_sgld((theta, phi, stamp_u, stamp_v), (invf_u, invf_v), lam,
                plan.cells, plan.cum, clock0, hyper, dim, noise_seed, work,
                ring=ring, ap=plan.ap, slot=(pack, noise_every, cap),
                walk=plan.walk if route == "tile" else None)
    sgld_slot_epoch.launches += 1
    sgld_slot_epoch.walks[route] += 1


sgld_slot_epoch.launches = 0  # kernel launches (CUDA calls), not CPU runs
sgld_slot_epoch.walks = dict.fromkeys(WALKS, 0)  # the launches by walk


class SlotSgldRunner(SgldRunner):
    """Slot-plan SGLD rounds, as ``tpu_mf``'s SlotSgldRunner (pad /
    set_lambdas / epoch / unpack, and):

    - ``sub`` None: ``pick_sub_stripe`` when ``striped``, else 1.25 x
      ``pick_sub`` rounded down to 8 (SGLD's heavier apply favours taller
      columns);
    - ``noise_every`` is the noise cadence in batches.

    Ids are relabeled with the serpentine map
    (``balance_dataset(cross_tile=True)``) and every window saturates, as
    ``tpu_mf``'s ``train_dpmf`` builds its runner (balance and saturate
    on); the TPU runner's unbalanced, unsaturated and in-kernel PRNG
    variants are ablations and are not ported. With saturation the window
    needs no duplicate envelope (``tpu_mf``'s ``envelope_ok`` is always
    true then)."""

    launches = 0

    def __init__(self, train_ds: RatingsCOO, sub: int | None = None,
                 seed: int = 0, mxu: str = "bfloat16", n_plans: int = 1,
                 dim: int | None = None, tile: int | None = None,
                 noise_every: int = 8, striped: bool = False,
                 device: torch.device | str = "cuda"):
        if dim is None:
            raise ValueError("pass dim=")
        pack = sgld_slot_pack(dim)
        if pack not in (2, 4, 8):
            raise ValueError(f"slot SGLD needs dim <= 58, got {dim}")
        self.pack, self.striped = pack, striped
        self.noise_every = max(1, int(noise_every))
        tile = tile or 128 * pack
        nu, nv = train_ds.nu, train_ds.nv
        train_ds, map_u, map_v = balance_dataset(train_ds, tile, tile, pack,
                                                 cross_tile=True)
        if sub is None:
            bc = _slot_bucket_counts(train_ds, tile, tile, pack)
            if striped:
                sub = pick_sub_stripe(bc, pack, cdiv(train_ds.nv, tile))
            else:
                sub = max(8, int(pick_sub(bc, pack) * 1.25) // 8 * 8)
        if striped and sub % pack:
            raise ValueError(f"striped plans need P | sub, got {sub} / {pack}")
        self.sub = sub
        builder = prepare_cells_stripe if striped else prepare_cells_slot
        plans = [builder(train_ds, tile, tile, sub, seed + 7919 * p, pack)
                 for p in range(max(1, n_plans))]
        super().__init__(plans, nu, nv, len(train_ds), mxu, device,
                         map_u, map_v)

    def _upload(self, idx: int) -> SlotSgldPlan:
        plan = self.plans[idx]
        nb = plan.u.shape[0]
        flags = _apply_flags(plan.gv, 1)
        noisy = np.arange(nb) % self.noise_every == self.noise_every - 1
        ap = (flags + flags * noisy[:, None]).astype(np.int32)
        real = (plan.u != plan.tile_u // self.pack).reshape(nb, -1).sum(1)
        cum = np.concatenate([[0], np.cumsum(real)[:-1]]).astype(np.int64)
        wp = to_window_plan(plan, self.striped)
        walk = plan_tile_walk(wp, 0, nb, 8)
        tap = tile_apply_flags(walk.col_tile, 1) * (1 + noisy[:, None])
        return SlotSgldPlan(
            upload_plan(wp, self.device),
            torch.as_tensor(cum).to(self.device), cum,
            torch.as_tensor(ap).to(self.device), ap,
            routed(upload_walk(walk, self._counters, tap={1: tap})))

    def epoch(self, tables, state_gcount: int, hyper: Hyper,
              noise_seed: int, epoch_idx: int = 0,
              ring: torch.Tensor | None = None, walk: str | None = None):
        """One round in place on the tables; ``hyper`` = (eta, temp, bound,
        scal, gb). The ring is drawn from ``noise_seed`` unless given;
        ``walk`` forces "tile" or "grid" (default: the plan's route)."""
        plan = self.materialize()._dev[epoch_idx % len(self._dev)]
        if ring is None:
            ring = slot_ring(noise_seed, self.tile_u, self.tile_v,
                             self.device)
        cap = saturation_cap(hyper[3])
        launched = sgld_slot_epoch.launches
        sgld_slot_epoch(*tables, *self.invf, self.lam, plan,
                        int(state_gcount), hyper, self.dim, noise_seed, ring,
                        self.pack, self.noise_every, cap,
                        self.work_dtype, walk)
        type(self).launches += sgld_slot_epoch.launches - launched
        return tables
