"""Slot-major plans on the window-plan kernel (counterpart of
``tpu_mf/ops/pallas_sgd_slot.py``), for dim <= 61.

On the TPU each sublane row of a column carries P ratings, one per lane
slot, against slot-major stacked tables; multi-hot gathers, lane rolls and
broadcast matmuls put every rating's rows into its own slot. All of that is
layout. What the kernel computes per rating is gen-1's with ``mxu_pred``
off (rows in the working type, unrounded t*p, f32 sums), over columns of
sub * P ratings: a rating's window is its whole column, so the staleness
envelope binds at a smaller eta than the packed family's. What the plans
decide, and so what is ported bit for bit, is which ratings share a column
and in what order the columns run:

- plain plans (``prepare_cells_slot``): column k of a batch holds one delta
  class (v - u) mod P = k mod P; lane k*P + j of a row holds a rating whose
  user sits in slot j, and its item id in the same lane;
- striped plans (``prepare_cells_stripe``): the P sublane segments of a
  column hold the P delta classes, and the item id rides the lane of its
  own slot.

``to_window_plan`` turns either into window-plan columns of height sub * P
with tile-local ids and weights, and ``SlotEpochRunner`` runs
``csrc/cell_sgd.cu`` on them, on the fused homogeneous rows of
``ops/rows.py``. The sub pickers, the balance maps, the pigeonhole pre-gate
and the window statistics are ``tpu_mf``'s, so the schedule engages the
same phases at the same epochs.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Tuple

import numpy as np
import torch

from tpu_mf_torch.data.coo import RatingsCOO
from tpu_mf_torch.models.mf import MFParams
from tpu_mf_torch.ops.plan_cache import cached_build
from tpu_mf_torch.ops.rows import LANES, cdiv
from tpu_mf_torch.ops.sgd_cells import CellPlan, WindowRunner, _dup_stats


class SlotPlan(NamedTuple):
    """Slot-major epoch layout; the fields of ``tpu_mf``'s SlotPlan, so the
    two packages share cached plans. A batch = 8 columns x sub rows x P
    slots; lane k*P+j of row s is column k's slot-j rating."""

    u: np.ndarray    # (NB, sub, 8P) int32 segment-local packed-row ids
    v: np.ndarray    # (NB, sub, 8P) int32; sentinel = rows_v
    r: np.ndarray    # (NB, sub, 8P) float32
    gu: np.ndarray   # (NB,) int32 user-tile per batch
    gv: np.ndarray   # (NB, 8) int32 item-tile per column
    tile_u: int
    tile_v: int
    sub: int
    n_gu: int
    n_gv: int
    n_real: int
    pack: int


def cdiv_np(a, b):
    return -(-a // b)


def prepare_cells_slot(ds: RatingsCOO, tile_u: int, tile_v: int, sub: int,
                       seed: int, pack: int) -> SlotPlan:
    """Disk-cached plan build (``ops/plan_cache.py``)."""
    return cached_build(
        "slot", SlotPlan, ds, seed, (tile_u, tile_v, sub, pack),
        lambda: _prepare_cells_slot_impl(ds, tile_u, tile_v, sub, seed, pack),
    )


def _check_tiles(tile_u: int, tile_v: int, P: int) -> None:
    if tile_u % P or tile_v % P or 8 % P:
        raise ValueError(f"slot plans need P | tiles and P | 8, got tiles "
                         f"{tile_u}x{tile_v}, P {P}")


def _prepare_cells_slot_impl(ds: RatingsCOO, tile_u: int, tile_v: int,
                             sub: int, seed: int, pack: int) -> SlotPlan:
    """Bucket shuffled ratings by (user-tile, delta, item-tile, slot) and
    fill slot-major columns; vectorized cumsum + scatter fill."""
    P = pack
    _check_tiles(tile_u, tile_v, P)
    rows_u = tile_u // P
    rows_v = tile_v // P
    n_gu = cdiv(ds.nu, tile_u)
    n_gv = cdiv(ds.nv, tile_v)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(ds))
    u, v, r = ds.u[perm], ds.v[perm], ds.r[perm]

    g = u // tile_u
    gv = v // tile_v
    j = u % P
    d = (v - u) % P
    cell = ((g * P + d) * n_gv + gv).astype(np.int64)   # column class + tile
    bucket = cell * P + j
    order = np.argsort(bucket, kind="stable")
    u, v, r, bucket = u[order], v[order], r[order], bucket[order]
    counts = np.bincount(bucket, minlength=n_gu * P * n_gv * P)
    # a cell's columns hold all P slots; its column count is driven by its
    # fullest slot
    cols_per_cell = cdiv_np(counts.reshape(-1, P).max(1), sub)
    cpc = 8 // P
    cols_per_class = cols_per_cell.reshape(n_gu, P, n_gv).sum(2)
    nb_per_group = np.maximum(
        1, cdiv_np(cols_per_class, cpc).max(1)).astype(np.int64)
    nb_total = int(nb_per_group.sum())

    U = np.full((nb_total, sub, 8 * P), rows_u, np.int32)   # sentinel
    V = np.full((nb_total, sub, 8 * P), rows_v, np.int32)
    R = np.zeros((nb_total, sub, 8 * P), np.float32)
    GU = np.zeros(nb_total, np.int32)
    GV = np.zeros((nb_total, 8), np.int32)

    src = np.concatenate([[0], np.cumsum(counts)])
    col_cs = np.concatenate([[0], np.cumsum(cols_per_cell)])
    base = np.concatenate([[0], np.cumsum(nb_per_group)])
    GU[:] = np.repeat(np.arange(n_gu, dtype=np.int32), nb_per_group)

    l = np.arange(len(u), dtype=np.int64) - src[bucket]   # index in bucket
    cellv = bucket // P
    cls = cellv // n_gv                                   # (group, delta)
    gg = cls // P
    dd = (cls % P).astype(np.int64)
    jj = (bucket % P).astype(np.int64)
    col_in_class = (col_cs[cellv] - col_cs[cls * n_gv]) + l // sub
    b = base[gg] + col_in_class // cpc
    kcol = dd + (col_in_class % cpc) * P
    lane = kcol * P + jj
    row = l % sub
    flat = (b * sub + row) * (8 * P) + lane
    U.reshape(-1)[flat] = ((u % tile_u) // P).astype(np.int32)
    V.reshape(-1)[flat] = ((v % tile_v) // P).astype(np.int32)
    R.reshape(-1)[flat] = r
    GV.reshape(-1)[b * 8 + kcol] = (cellv % n_gv).astype(np.int32)
    return SlotPlan(
        u=U, v=V, r=R, gu=GU, gv=GV,
        tile_u=tile_u, tile_v=tile_v, sub=sub, n_gu=n_gu, n_gv=n_gv,
        n_real=len(ds), pack=P,
    )


def prepare_cells_stripe(ds: RatingsCOO, tile_u: int, tile_v: int, sub: int,
                         seed: int, pack: int) -> SlotPlan:
    """Disk-cached striped plan build (``ops/plan_cache.py``)."""
    return cached_build(
        "stripe", SlotPlan, ds, seed, (tile_u, tile_v, sub, pack),
        lambda: _prepare_cells_stripe_impl(ds, tile_u, tile_v, sub, seed,
                                           pack),
    )


def _prepare_cells_stripe_impl(ds: RatingsCOO, tile_u: int, tile_v: int,
                               sub: int, seed: int, pack: int) -> SlotPlan:
    """Delta-striped slot plan: sublane segment s of a column (rows
    s*sub/P .. (s+1)*sub/P - 1) holds ratings with (v - u) % P == s, so
    the P*P (delta, slot) buckets of a (user-tile, item-tile) pair share
    columns: columns per pair = max over those buckets of
    ceil(count / (sub/P)).

    Per column k: lane k*P + j carries the user id and rating of a segment-s
    rating whose user slot is j; lane k*P + (j + s) % P, its item's own
    slot, carries its item id."""
    P = pack
    _check_tiles(tile_u, tile_v, P)
    if sub % P:
        raise ValueError(f"striped plans need P | sub, got {sub} / {P}")
    seg = sub // P
    rows_u = tile_u // P
    rows_v = tile_v // P
    n_gu = cdiv(ds.nu, tile_u)
    n_gv = cdiv(ds.nv, tile_v)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(ds))
    u, v, r = ds.u[perm], ds.v[perm], ds.r[perm]

    g = u // tile_u
    gvt = v // tile_v
    j = u % P
    s = (v - u) % P
    pair = g.astype(np.int64) * n_gv + gvt
    bucket = (pair * P + s) * P + j
    order = np.argsort(bucket, kind="stable")
    u, v, r, bucket = u[order], v[order], r[order], bucket[order]
    counts = np.bincount(bucket, minlength=n_gu * n_gv * P * P)
    ncols_pair = cdiv_np(counts.reshape(-1, P * P).max(1), seg)
    cols_per_gu = ncols_pair.reshape(n_gu, n_gv).sum(1)
    nb_per_gu = np.maximum(1, cdiv_np(cols_per_gu, 8)).astype(np.int64)
    nb_total = int(nb_per_gu.sum())

    U = np.full((nb_total, sub, 8 * P), rows_u, np.int32)   # sentinel
    V = np.full((nb_total, sub, 8 * P), rows_v, np.int32)
    R = np.zeros((nb_total, sub, 8 * P), np.float32)
    GU = np.repeat(np.arange(n_gu, dtype=np.int32), nb_per_gu).astype(
        np.int32)
    GV = np.zeros((nb_total, 8), np.int32)

    src = np.concatenate([[0], np.cumsum(counts)])
    col_cs = np.concatenate([[0], np.cumsum(ncols_pair)])
    base = np.concatenate([[0], np.cumsum(nb_per_gu)])

    l = np.arange(len(u), dtype=np.int64) - src[bucket]   # index in bucket
    pairid = bucket // (P * P)
    ss = (bucket // P) % P
    jj = bucket % P
    gg = pairid // n_gv
    col_in_gu = (col_cs[pairid] - col_cs[gg * n_gv]) + l // seg
    b = base[gg] + col_in_gu // 8
    kcol = col_in_gu % 8
    row = ss * seg + l % seg
    lane_u = kcol * P + jj
    lane_v = kcol * P + (jj + ss) % P
    flat_u = (b * sub + row) * (8 * P) + lane_u
    flat_v = (b * sub + row) * (8 * P) + lane_v
    U.reshape(-1)[flat_u] = ((u % tile_u) // P).astype(np.int32)
    V.reshape(-1)[flat_v] = ((v % tile_v) // P).astype(np.int32)
    R.reshape(-1)[flat_u] = r
    GV.reshape(-1)[b * 8 + kcol] = (pairid % n_gv).astype(np.int32)
    return SlotPlan(
        u=U, v=V, r=R, gu=GU, gv=GV,
        tile_u=tile_u, tile_v=tile_v, sub=sub, n_gu=n_gu, n_gv=n_gv,
        n_real=len(ds), pack=P,
    )


def slot_col_ids(ids: np.ndarray, pack: int) -> np.ndarray:
    """(NB, sub, 8P) segment-local ids -> (NB, sub*P, 8) labels
    packed_row * P + lane slot, for the window-duplicate statistics
    (sentinel rows map >= tile). These are a rating's true tile-local ids
    for users and for striped items; for plain plans' items they name the
    user's slot, not the item's (``tpu_mf``'s statistics, kept as they are
    so both packages pick the same groups; ROADMAP Queue 3)."""
    P = pack
    nb, sub, _ = ids.shape
    i4 = ids.reshape(nb, sub, 8, P)
    j = np.arange(P, dtype=ids.dtype)
    full = i4 * P + j  # local id = packed_row * P + slot
    return np.swapaxes(full, 2, 3).reshape(nb, sub * P, 8)


def to_window_plan(plan: SlotPlan, striped: bool = False) -> CellPlan:
    """Window-plan columns of a slot plan, height sub * P: column k of a
    batch holds every rating of lanes k*P .. k*P + P - 1 (row s, slot j at
    column row s*P + j), with tile-local ids and w = 1 where the user lane
    is not the sentinel (the slot plan carries no weights).

    The user's id is U*P + j. The item's is V*P + (its own slot): in a plain
    plan V sits in the user's lane and the item's slot is (j + k % P) % P;
    in a striped plan V sits in the lane of the item's own slot
    (j + s // (sub/P)) % P."""
    P = plan.pack
    nb, sub, _ = plan.u.shape
    U = plan.u.reshape(nb, sub, 8, P)
    V = plan.v.reshape(nb, sub, 8, P)
    j = np.arange(P)
    if striped:
        vslot = (j[None, :] + (np.arange(sub) // (sub // P))[:, None]) % P
        vslot = np.broadcast_to(vslot[:, None, :], (sub, 8, P))
        V = np.take_along_axis(V, np.broadcast_to(vslot, V.shape), axis=3)
    else:
        vslot = np.broadcast_to(
            ((j[None, :] + np.arange(8)[:, None]) % P)[None], (sub, 8, P))
    real = U != plan.tile_u // P

    def cols(a):  # (nb, sub, 8, P) -> (nb, sub*P, 8)
        return np.ascontiguousarray(np.swapaxes(a, 2, 3)).reshape(
            nb, sub * P, 8)

    return CellPlan(
        u=cols(np.where(real, U * P + j, plan.tile_u).astype(np.int32)),
        v=cols(np.where(real, V * P + vslot, plan.tile_v).astype(np.int32)),
        r=cols(plan.r.reshape(nb, sub, 8, P)),
        w=cols(real.astype(np.float32)),
        gu=plan.gu, gv=plan.gv, tile_u=plan.tile_u, tile_v=plan.tile_v,
        n_gu=plan.n_gu, n_gv=plan.n_gv, n_real=plan.n_real)


def _slot_bucket_counts(ds: RatingsCOO, tile_u: int, tile_v: int,
                        pack: int) -> np.ndarray:
    """Per-(user-tile, delta, item-tile, slot) bucket sizes. Shuffle-
    invariant, so the sub pickers can run before any plan is built."""
    P = pack
    n_gu = cdiv(ds.nu, tile_u)
    n_gv = cdiv(ds.nv, tile_v)
    g = ds.u // tile_u
    gv = ds.v // tile_v
    d = (ds.v - ds.u) % P
    bucket = ((g.astype(np.int64) * P + d) * n_gv + gv) * P + ds.u % P
    return np.bincount(bucket, minlength=n_gu * P * n_gv * P)


def slot_dup_lower_bound(ds: RatingsCOO, dim: int | None = None,
                         pack: int | None = None, tile_u: int | None = None,
                         tile_v: int | None = None, sub: int | None = None,
                         balance: bool = False) -> Tuple[int, int]:
    """(lower bound on the max within-column duplicates at g=8, chosen sub).

    Shuffle-invariant pigeonhole bound, computable before any plan exists:
    a row with c ratings in its (cell, slot) bucket is spread over the
    cell's ncols columns, so some column holds >= ceil(c / ncols) of them.
    The schedule uses it to skip building slot plans when even the last
    epoch's eta cannot satisfy eta * dups <= 0.2; the exact per-plan
    statistics (``envelope_ok``) still gate a built runner."""
    if pack is None:
        if dim is None:
            raise ValueError("pass dim= or pack=")
        pack = slot_packing_factor(dim)
    P = pack
    tile_u = tile_u or 128 * P
    tile_v = tile_v or 128 * P
    if balance:
        # the runners' map (cross_tile=True), so the bound sees their buckets
        ds, _, _ = balance_dataset(ds, tile_u, tile_v, P, cross_tile=True)
    counts = _slot_bucket_counts(ds, tile_u, tile_v, P)
    if sub is None:
        sub = pick_sub(counts, P)
    rows_u = tile_u // P
    rows_v = tile_v // P
    n_gv = cdiv(ds.nv, tile_v)
    ncols = np.maximum(cdiv_np(counts.reshape(-1, P).max(1), sub), 1)

    g = ds.u.astype(np.int64) // tile_u
    gvt = ds.v.astype(np.int64) // tile_v
    d = (ds.v.astype(np.int64) - ds.u) % P
    bucket = ((g * P + d) * n_gv + gvt) * P + ds.u % P

    def side_bound(ids, tile, rows):
        key = bucket * rows + (ids.astype(np.int64) % tile) // P
        c = np.bincount(key)
        nz = np.nonzero(c)[0]
        if nz.size == 0:
            return 0
        return int(cdiv_np(c[nz], ncols[nz // (rows * P)]).max())

    lb = max(side_bound(ds.u, tile_u, rows_u),
             side_bound(ds.v, tile_v, rows_v))
    return lb, sub


# column heights the sub pickers choose from (tpu_mf's measured on-trend
# heights; the ladder's phases are told apart by them)
_SUB_CANDIDATES = (32, 64, 128, 192, 256, 384, 512)
_SUB_CANDIDATES_STRIPE = (128, 192, 256, 320, 384, 448, 512)


def pick_sub(counts: np.ndarray, pack: int) -> int:
    """``tpu_mf``'s column height for plain plans: plan fill from the exact
    bucket sizes (a cell's columns quantize at its fullest slot) over its
    per-slot cost model 1 + 94/sub."""
    per_cell_max = counts.reshape(-1, pack).max(1)
    n = int(counts.sum())
    best, best_score = 128, -1.0
    for sub in _SUB_CANDIDATES:
        cols = cdiv_np(per_cell_max, sub)
        slots = int(cols.sum()) * sub * pack
        if slots == 0:
            continue
        fill = n / slots
        score = fill / (1.0 + 94.0 / sub)
        if score > best_score:
            best, best_score = sub, score
    return best


def pick_sub_stripe(counts: np.ndarray, pack: int, n_gv: int) -> int:
    """``pick_sub`` for striped plans: a (user-tile, item-tile) pair's
    columns quantize at its fullest (delta, slot) bucket against segment
    height sub/P, over the cost model 1 + 170/sub; candidates keep
    8 | sub/P."""
    n = int(counts.sum())
    # counts keyed ((gu*P + d)*n_gv + gv)*P + j -> (n_gu, P, n_gv, P)
    per_pair_max = (
        counts.reshape(-1, pack, n_gv, pack).max(axis=(1, 3)).reshape(-1))
    best, best_score = 128, -1.0
    for sub in _SUB_CANDIDATES_STRIPE:
        seg = sub // pack
        if sub % pack or seg % 8:
            continue
        cols = cdiv_np(per_pair_max, seg)
        slots = int(cols.sum()) * sub * pack
        if slots == 0:
            continue
        fill = n / slots
        score = fill / (1.0 + 170.0 / sub)
        if score > best_score:
            best, best_score = sub, score
    return best


def _balance_map(counts: np.ndarray, tile: int, pack: int) -> np.ndarray:
    """``new_of_old`` relabeling: per-tile capacity-constrained LPT over
    slots. Within each ``tile``-sized id block, rows go heaviest-first to
    the least-loaded slot that still has physical rows free (capacity
    tile/P), which evens out the per-(cell, slot) bucket sizes; tile
    membership (id // tile) is kept."""
    P = pack
    n = counts.size
    n_pad = cdiv(n, tile) * tile
    c = np.zeros(n_pad, np.int64)
    c[:n] = counts
    rows = tile // P
    out = np.empty(n_pad, np.int64)
    for t in range(n_pad // tile):
        seg = c[t * tile:(t + 1) * tile]
        order = np.argsort(-seg, kind="stable")
        load = np.zeros(P, np.float64)
        nxt = np.zeros(P, np.int64)
        for o in order:
            j = int(np.argmin(np.where(nxt < rows, load, np.inf)))
            out[t * tile + o] = t * tile + j + P * nxt[j]
            load[j] += seg[o]
            nxt[j] += 1
    return out[:n].astype(np.int32)


def _balance_map_serpentine(counts: np.ndarray, tile: int,
                            pack: int) -> np.ndarray:
    """``new_of_old`` relabeling: a global serpentine heaviest-first deal
    across all (tile, slot) buckets. Sorted id at position i -> pass
    p = i // B, bucket b = i % B (reversed on odd passes, B = n_tiles * P
    buckets), new id = t*tile + p*P + j for b = (t, j); every bucket gets
    exactly tile/P ids."""
    P = pack
    n = counts.size
    n_pad = cdiv(n, tile) * tile
    c = np.zeros(n_pad, np.int64)
    c[:n] = counts
    B = (n_pad // tile) * P
    order = np.argsort(-c, kind="stable")
    i = np.arange(n_pad, dtype=np.int64)
    p = i // B
    b = i % B
    b = np.where(p % 2 == 1, B - 1 - b, b)
    t, j = b // P, b % P
    out = np.empty(n_pad, np.int64)
    out[order] = t * tile + p * P + j
    return out[:n].astype(np.int32)


def balance_dataset(ds: RatingsCOO, tile_u: int, tile_v: int, pack: int,
                    cross_tile: bool = False
                    ) -> Tuple[RatingsCOO, np.ndarray, np.ndarray]:
    """(relabeled ds padded to whole tiles, map_u, map_v), the maps
    new-id-of-old-id: ``_balance_map`` within tiles, or
    ``_balance_map_serpentine`` across them (``cross_tile``). Training on
    the relabeled ids is exact; the runner's pad/trim invert the maps."""
    bmap = _balance_map_serpentine if cross_tile else _balance_map
    mu = bmap(np.bincount(ds.u, minlength=ds.nu), tile_u, pack)
    mv = bmap(np.bincount(ds.v, minlength=ds.nv), tile_v, pack)
    ds2 = RatingsCOO(
        u=mu[ds.u], v=mv[ds.v], r=ds.r,
        nu=cdiv(ds.nu, tile_u) * tile_u, nv=cdiv(ds.nv, tile_v) * tile_v,
    )
    return ds2, mu, mv


def slot_packing_factor(dim: int) -> int:
    """Rows per 128-lane row on the TPU; slot = [fac | bias | one | cnt]."""
    if dim + 3 <= 16:
        return 8
    if dim + 3 <= 32:
        return 4
    if dim + 3 <= 64:
        return 2
    return 1


class SlotEpochRunner(WindowRunner):
    """Slot plans on a device and gen-1 epochs over them, as ``tpu_mf``'s
    SlotEpochRunner (options: ``WindowRunner``'s, and):

    - ``sub`` None: ``pick_sub`` (``pick_sub_stripe`` when ``striped``)
      from the bucket sizes; a column holds sub * P ratings;
    - ``balance`` relabels ids with the serpentine map
      (``balance_dataset(cross_tile=True)``);
    - ``envelope_ok`` tells the schedule whether any grouping keeps the
      window within eta * duplicates <= 0.2; probing it never uploads."""

    kind = "slot"
    launches = 0

    def __init__(self, ds: RatingsCOO, tile_u: int | None = None,
                 tile_v: int | None = None, sub: int | None = None,
                 seed: int = 0, mxu: str = "bfloat16",
                 theta_groups: int | None = None,
                 phi_groups: int | None = None, n_plans: int = 1,
                 dim: int | None = None, pack: int | None = None,
                 balance: bool = False, saturate: bool = False,
                 striped: bool = False, device: torch.device | str = "cuda"):
        self.striped = striped
        if pack is None:
            if dim is None:
                raise ValueError("pass dim= or pack=")
            pack = slot_packing_factor(dim)
        if pack not in (2, 4, 8):
            raise ValueError(f"slot plans need pack in 2/4/8 (dim <= 61), "
                             f"got {pack}")
        self.pack = pack
        tile_u = tile_u or 128 * pack
        tile_v = tile_v or 128 * pack
        nu, nv = ds.nu, ds.nv  # pre-relabel row counts for trim
        map_u = map_v = None
        if balance:
            ds, map_u, map_v = balance_dataset(ds, tile_u, tile_v, pack,
                                               cross_tile=True)
        if sub is None:
            bc = _slot_bucket_counts(ds, tile_u, tile_v, pack)
            sub = (pick_sub_stripe(bc, pack, cdiv(ds.nv, tile_v)) if striped
                   else pick_sub(bc, pack))
        self.sub = sub
        builder = prepare_cells_stripe if striped else prepare_cells_slot
        plans = [builder(ds, tile_u, tile_v, sub, seed + 7919 * p, pack)
                 for p in range(max(1, n_plans))]
        super().__init__(plans, nu, nv, mxu, theta_groups, phi_groups,
                         saturate, device, map_u=map_u, map_v=map_v)
        self.mxu_pred = False  # the TPU kernel sums unrounded t*p

    def _dups(self, plan: SlotPlan, side: str) -> dict:
        """``tpu_mf``'s window statistics of a slot plan: over the lanes'
        slot labels (``slot_col_ids``), on both sides."""
        ids, tile = (plan.u, plan.tile_u) if side == "u" else (plan.v,
                                                               plan.tile_v)
        return _dup_stats(slot_col_ids(ids, self.pack), tile)

    def _window_plan(self, plan: SlotPlan) -> CellPlan:
        return to_window_plan(plan, self.striped)

    def envelope_ok(self, eta: float) -> bool:
        """True when some grouping keeps eta * max window duplicates <= 0.2
        on both sides (pinned groups skip the check)."""
        du = self._dup_max[8] if self._dup_max else 0
        dv = self._vdup_max[8] if self._vdup_max else 0
        return eta * max(du, dv) <= 0.2

    def _warn(self, side: str, eta: float, dups: int) -> None:
        if side in self._warned:  # once per runner and side, not per eta
            return
        self._warned.add(side)
        warnings.warn(
            f"slot kernel {side}-side staleness envelope exceeded even at "
            f"the most sequential grouping: eta={eta:g} x max window "
            f"duplicates {dups} = {eta * dups:.2f} > 0.2. A row hit that "
            "often inside one sub*P-slot column accumulates that many "
            "stale gradients and can diverge (bias terms first). Reduce "
            "eta, use a smaller sub, or the packed kernel (window = sub).",
            stacklevel=4,
        )


def slot_eligible(params: MFParams, batch_size: int = 8192) -> bool:
    """``tpu_mf``'s routing rule for the slot family: dim <= 61 and the
    slot-major item table plus its scratch within 64 MiB. A TPU residency
    rule that only routes epochs; it bounds nothing in
    ``csrc/cell_sgd.cu``."""
    del batch_size
    dim = params.theta.shape[1]
    pack = slot_packing_factor(dim)
    if pack < 2:
        return False
    nv = params.phi.shape[0]
    tile_v = 128 * pack
    vmem_phi = cdiv(nv, tile_v) * tile_v * LANES * 4
    return 2 * vmem_phi <= 64 * 1024 * 1024
