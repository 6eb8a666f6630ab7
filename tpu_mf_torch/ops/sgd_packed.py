"""Lane-packed plans on the window-plan kernel (counterpart of
``tpu_mf/ops/pallas_sgd_packed.py``), for dim <= 62.

On the TPU, P fused rows share one 128-lane register row (P = 8, 4, 2 for
dim <= 14, 30, 62), so a rating's user and item data sit in slots u mod P
and v mod P. The plan buckets ratings by (user tile, delta = (v - u) mod P,
item tile) and gives column k of a batch only delta class k mod P, so the
kernel's slot-aligning lane roll is a constant per column. Packing, rolls
and one-hot gathers are layout; what the kernel computes per rating is
gen-1's:

    pred = t . p + bu + bv + gb  (rows in the working type, products and
                                  sums f32: the TPU does not round t*p)
    err  = eta * (r - pred),  dtheta[u] += err * p,  dphi[v] += err * t

with gen-1's theta and phi groups, deferred item applies, decay and
saturation. What the plan decides, and so what is ported bit for bit, is
which ratings share a column and in what order the columns run. Its ids are
already tile-local (u mod tile_u, v mod tile_v) and it carries its weights:
it is a window plan as it stands (``upload_plan`` takes it as it is), and
``PackedEpochRunner`` runs ``csrc/cell_sgd.cu`` on it with ``mxu_pred``
off, on the fused homogeneous rows of ``ops/rows.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_mf_torch.data.coo import RatingsCOO
from tpu_mf_torch.models.mf import MFParams
from tpu_mf_torch.ops.plan_cache import cached_build
from tpu_mf_torch.ops.rows import LANES, cdiv
from tpu_mf_torch.ops.sgd_cells import WindowRunner


def packing_factor(dim: int) -> int:
    """Rows per 128-lane register row: slot = [dim factors | bias | count]."""
    if dim + 2 <= 16:
        return 8
    if dim + 2 <= 32:
        return 4
    if dim + 2 <= 64:
        return 2
    return 1


class PackedPlan(NamedTuple):
    """Epoch layout of the lane-packed family; the fields of ``tpu_mf``'s
    PackedPlan, so the two packages share cached plans."""

    u: np.ndarray    # (NB, B/8, 8) int32 tile-local user ids; tile_u = pad
    v: np.ndarray    # (NB, B/8, 8) int32 tile-local item ids; tile_v = pad
    r: np.ndarray    # (NB, B/8, 8) float32
    w: np.ndarray    # (NB, B/8, 8) float32 {0,1}
    gu: np.ndarray   # (NB,) int32 user-tile index per batch
    gv: np.ndarray   # (NB, 8) int32 item-tile index per sub-batch column
    gd: np.ndarray   # (NB, 8) int32 slot delta per column; always col % P
    tile_u: int
    tile_v: int
    n_gu: int
    n_gv: int
    n_real: int
    pack: int        # P


def prepare_cells_packed(ds: RatingsCOO, tile_u: int, tile_v: int,
                         batch_size: int, seed: int, pack: int) -> PackedPlan:
    """Disk-cached plan build (``ops/plan_cache.py``)."""
    return cached_build(
        "packed", PackedPlan, ds, seed, (tile_u, tile_v, batch_size, pack),
        lambda: _prepare_cells_packed_impl(ds, tile_u, tile_v, batch_size,
                                           seed, pack),
    )


def _prepare_cells_packed_impl(ds: RatingsCOO, tile_u: int, tile_v: int,
                               batch_size: int, seed: int,
                               pack: int) -> PackedPlan:
    """Bin shuffled ratings into (user-tile, delta, item-tile) buckets, pad
    each bucket to whole sub-batches of B/8, pack 8 sub-batches per batch
    within each user-tile group (column k takes delta class k % P only),
    and order batches by user tile."""
    P = pack
    if batch_size % 8 or tile_u % P or tile_v % P:
        raise ValueError(f"packed plans need 8 | batch and P | tiles, got "
                         f"batch {batch_size}, tiles {tile_u}x{tile_v}, "
                         f"P {P}")
    sub = batch_size // 8
    n_gu = cdiv(ds.nu, tile_u)
    n_gv = cdiv(ds.nv, tile_v)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(ds))
    u, v, r = ds.u[perm], ds.v[perm], ds.r[perm]

    gu = u // tile_u
    gv = v // tile_v
    gd = (v - u) % P  # == (v%P - u%P) % P since tiles are P-aligned
    # bucket key ordered (gu, delta, gv) so one cursor walks a delta class
    cell = ((gu * P + gd) * n_gv + gv).astype(np.int64)
    order = np.argsort(cell, kind="stable")
    u, v, r, cell = u[order], v[order], r[order], cell[order]
    counts = np.bincount(cell, minlength=n_gu * n_gv * P)
    sb_per_cell = np.ceil(counts / sub).astype(np.int64)
    # a group's batch count is driven by its largest delta class
    cpc = 8 // P  # columns per delta class
    sb_per_class = sb_per_cell.reshape(n_gu, P, n_gv).sum(2)
    nb_per_group = np.maximum(
        1, np.ceil(sb_per_class / cpc).max(1)).astype(np.int64)
    nb_total = int(nb_per_group.sum())

    U = np.full((nb_total, sub, 8), tile_u, np.int32)  # sentinel = padded
    V = np.full((nb_total, sub, 8), tile_v, np.int32)
    R = np.zeros((nb_total, sub, 8), np.float32)
    W = np.zeros((nb_total, sub, 8), np.float32)
    GU = np.zeros(nb_total, np.int32)
    GV = np.zeros((nb_total, 8), np.int32)
    GD = np.broadcast_to(np.arange(8, dtype=np.int32) % P,
                         (nb_total, 8)).copy()

    # each rating's (batch, row, column) slot follows from cumsum arithmetic
    # over the (group, delta class, item tile) bucket sizes; one flat
    # scatter fills the plan
    src = np.concatenate([[0], np.cumsum(counts)])
    sb_cs = np.concatenate([[0], np.cumsum(sb_per_cell)])
    base = np.concatenate([[0], np.cumsum(nb_per_group)])
    GU[:] = np.repeat(np.arange(n_gu, dtype=np.int32),
                      nb_per_group.astype(np.int64))

    l = np.arange(len(u), dtype=np.int64) - src[cell]   # index within bucket
    cls = cell // n_gv                                   # (group, delta)
    g = cls // P
    d = (cls % P).astype(np.int64)
    sbc = (sb_cs[cell] - sb_cs[cls * n_gv]) + l // sub   # sb within class
    b = base[g] + sbc // cpc
    col = d + (sbc % cpc) * P
    pos = l % sub
    flat = (b * sub + pos) * 8 + col
    U.reshape(-1)[flat] = (u % tile_u).astype(np.int32)
    V.reshape(-1)[flat] = (v % tile_v).astype(np.int32)
    R.reshape(-1)[flat] = r
    W.reshape(-1)[flat] = 1.0
    GV.reshape(-1)[b * 8 + col] = (cell % n_gv).astype(np.int32)
    return PackedPlan(
        u=U, v=V, r=R, w=W, gu=GU, gv=GV, gd=GD,
        tile_u=tile_u, tile_v=tile_v, n_gu=n_gu, n_gv=n_gv,
        n_real=len(ds), pack=P,
    )


class PackedEpochRunner(WindowRunner):
    """Packed plans on a device and gen-1 epochs over them, as ``tpu_mf``'s
    PackedEpochRunner (options: ``WindowRunner``'s): tiles default to
    128 * P, ``n_plans`` > 1 rotates plans of seeds seed + 7919 p, and the
    adaptive groups read the plans' window duplicates."""

    kind = "packed"
    launches = 0

    def __init__(self, ds: RatingsCOO, tile_u: int | None = None,
                 tile_v: int | None = None, batch: int = 4096, seed: int = 0,
                 mxu: str = "bfloat16", theta_groups: int | None = None,
                 phi_groups: int | None = None, n_plans: int = 1,
                 dim: int | None = None, pack: int | None = None,
                 saturate: bool = False,
                 device: torch.device | str = "cuda"):
        if pack is None:
            if dim is None:
                raise ValueError("pass dim= or pack=")
            pack = packing_factor(dim)
        if pack not in (2, 4, 8):
            raise ValueError(f"packed plans need pack in 2/4/8 (dim <= 62), "
                             f"got {pack}")
        self.pack = pack
        tile_u = tile_u or 128 * pack
        tile_v = tile_v or 128 * pack
        self.batch = batch = cdiv(batch, 8) * 8
        plans = [prepare_cells_packed(ds, tile_u, tile_v, batch,
                                      seed + 7919 * p, pack)
                 for p in range(max(1, n_plans))]
        super().__init__(plans, ds.nu, ds.nv, mxu, theta_groups, phi_groups,
                         saturate, device)
        self.mxu_pred = False  # the TPU kernel sums unrounded t*p


def packed_eligible(params: MFParams, batch_size: int) -> bool:
    """``tpu_mf``'s routing rule for the packed family: dim <= 62 and the
    packed item table plus its scratch within 64 MiB. A TPU residency rule
    that only routes epochs; it bounds nothing in ``csrc/cell_sgd.cu``."""
    del batch_size
    dim = params.theta.shape[1]
    pack = packing_factor(dim)
    if pack < 2:
        return False
    nv = params.phi.shape[0]
    tile_v = 128 * pack
    vmem_phi = cdiv(nv, tile_v) * tile_v // pack * LANES * 4
    return 2 * vmem_phi <= 64 * 1024 * 1024
