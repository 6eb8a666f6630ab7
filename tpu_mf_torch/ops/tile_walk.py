"""The tile walk of the window-plan kernels ``csrc/cell_sgd.cu``,
``csrc/adreg_cells.cu`` and ``csrc/sgld_cells.cu`` and of the free-column
kernel ``csrc/free_cells.cu``: the host planner, the hand-off counters and,
for the two kernels that keep a grid walk beside it (``csrc/cell_sgd.cu``
and ``csrc/sgld_cells.cu``), the route between the two walks. The
AdaptReg and free-column kernels have the tile walk only: their
``DeviceWalk`` reads route "tile".

A window plan's batches are sorted by user tile, and one window (a step of
``window`` columns of one batch) reads and writes only its user tile and
the item tiles of its columns. A free-column plan gives every column its
own user tile, but deals its columns in cell order, user tile first, so
each user tile is one run of columns there. So a window depends on two
kinds of earlier windows: the last one on its user tile and, per item tile
it touches, the last one on that item tile. A grid walk runs the
windows one after another, each ending in two grid syncs. The tile walk
runs **units**, the maximal runs of consecutive real columns on one user
tile (columns without a real slot, w = 0 in every slot, are dropped: they
change nothing), each on one thread-block cluster, and orders them by
ready counters:

- units are taken by an atomic ticket in plan order, so a unit waits only
  on units already running or done;
- before its first column on a tile (its user tile at its start, an item
  tile at its first touch), a unit waits until the tile's counter shows that
  every earlier unit of the launch on that tile has released it;
- after its last apply of a tile, it releases the tile.

Counters are never cleared. A launch has a generation number ``gen``; the
unit that holds the w-th wait on a tile (w earlier units of the launch
touch it) waits for the value ``gen << 32 | w`` and releases with
``gen << 32 | (w + 1)``, a store (no other unit writes the tile's counter
meanwhile). A unit with w = 0 does not wait: the launches before it on the
stream have ended. A value from another launch never equals the awaited one
unless 2^32 launches lie between them. The ticket is a 32-bit counter that a
launch advances by its units plus its clusters (each cluster draws one
ticket past the last unit); both numbers wrap unsigned.

``plan_tile_walk`` builds a plan's walk once per plan and launch range (at
``materialize``; ``plan_tile_walks`` at several window widths on one set of
units, as ``upload_window_walks`` does for ``csrc/cell_sgd.cu``, whose
window width follows the groupings eta picks), ``cluster_size`` sizes its
clusters by the slots of a window (``free_cluster_size`` those of a free
plan, ``cell_cluster_size`` those of ``csrc/cell_sgd.cu``, by a model of
the walk's time), ``tile_walk_route`` picks the walk of a kernel with two
by a model of both walks' time, and ``TileWalkCounters`` numbers the
launches on one device.

Windows of a free plan may span two units (a user tile's run ends inside a
window). That is exact: a unit applies a tile where its flag
(``tile_apply_flags``, on either side) lies, at the last real column of the
window that touches the tile, and releases an item tile after its last
touch even where that flag lies on a later unit's column; the later unit
then reads the tile unapplied, as it stood at the window's start, and adds
to the same deltas, which it applies.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

# the walks of csrc/cell_sgd.cu and csrc/sgld_cells.cu (and the keys of
# every kernel's launch counts by walk)
WALKS = ("tile", "grid")
# blocks per thread-block cluster: one unit's window steps spread over this
# many SMs. 8 (the portable most; 16 clusters fit an H100 at once) where a
# window holds at most WIDE_SLOTS slots, 16 (8 clusters) past that: at
# ML-10M shape clusters of 8 ran the gen-1 walks (windows of 512 and 1,024
# slots) faster than clusters of 4 or 16, and clusters of 16 the slot
# plans' (3,584 and 28,672) faster than clusters of 8 (PERF.md)
CLUSTER, WIDE_CLUSTER = 8, 16
WIDE_SLOTS = 4 * 32 * CLUSTER  # four rounds of a warp's slots at CLUSTER
# the grid walk's blocks: one per SM of an H100 SXM
H100_SMS = 132
# a window step's fixed cost (waits or grid syncs, barriers, slot and row
# loads), in rounds of a warp's slots, on each walk (the ML-10M runs of
# both walks, PERF.md)
TILE_STEP_ROUNDS, GRID_STEP_ROUNDS = 7, 3
# the free-column walk's cluster sizes, and the fixed cost of a window step
# on each (waits, barriers, releases), in rounds of a warp's slots or
# applied rows (fitted to the ML-10M free plan's epochs at each size, ~1 us
# a round, PERF.md)
FREE_CLUSTERS = (1, 2, 4, 8)
FREE_STEP_ROUNDS = {1: 1, 2: 6, 4: 6, 8: 7}
# csrc/cell_sgd.cu's cluster sizes (cell_cluster_size); 2 is left out: at
# the Yahoo tiles 66 clusters' dtheta slices would take 71 MB
CELL_CLUSTERS = (4, 8, 16)


class TileWalk(NamedTuple):
    """The tile walk of one launch range of a window plan (host arrays).

    Columns are numbered i * 8 + k over the whole plan; the ``col_*``
    arrays cover every column of the plan, so segments of one plan share
    them."""

    unit_c0: np.ndarray    # (n_units,) int32 first real column of the unit
    unit_c1: np.ndarray    # (n_units,) int32 one past its last real column
    unit_gu: np.ndarray    # (n_units,) int32 its user tile
    unit_wait: np.ndarray  # (n_units,) int32 earlier units on its user tile
    col_tile: np.ndarray   # (nb * 8,) int32 item tile of a real column, -1
    col_wait: np.ndarray   # (nb * 8,) int32 wait value at a unit's first
    #                        touch of the column's item tile, else -1
    col_rel: np.ndarray    # (nb * 8,) int32 wait value + 1 at a unit's last
    #                        touch of the column's item tile, else 0
    window: int            # columns per window step
    slots: int             # rating slots of a window (window x column)
    n_windows: int         # windows of the range that hold a real column
    crit: int              # windows on the critical path
    b0: int
    b1: int

    @property
    def n_units(self) -> int:
        return int(self.unit_c0.shape[0])


def real_columns(w: np.ndarray) -> np.ndarray:
    """(nb * 8,) bool: columns of a window plan (host w of (nb, sub, 8))
    with at least one real slot."""
    return (w > 0).any(axis=1).reshape(-1)


def column_user_tiles(gu: np.ndarray) -> np.ndarray:
    """(nb * 8,) int64: the user tile of every column, from a window plan's
    gu of (nb,) (one per batch) or a free plan's of (nb, 8)."""
    gu = np.asarray(gu, np.int64)
    return gu.reshape(-1) if gu.ndim == 2 else np.repeat(gu, 8)


def plan_tile_walk(plan, b0: int, b1: int, window: int = 1) -> TileWalk:
    """The tile walk of the plan batches [b0, b1) of a window plan (a
    ``CellPlan``: host u/v/w of (nb, sub, 8), gu (nb,), gv (nb, 8); or a
    ``FreePlan``, gu (nb, 8)) at ``window`` columns per window step (groups
    of that width): units, per unit and item tile the first and last
    touching column with the wait value and its release, and the critical
    path in windows."""
    return plan_tile_walks(plan, b0, b1, (window,))[window]


def _rank_within(keys: np.ndarray) -> np.ndarray:
    """(n,) int32: for each entry, how many earlier entries hold its key."""
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    idx = np.arange(len(keys))
    start = np.maximum.accumulate(
        np.where(np.r_[True, sk[1:] != sk[:-1]], idx, 0)) if len(keys) \
        else idx
    out = np.empty(len(keys), np.int32)
    out[order] = idx - start
    return out


def plan_tile_walks(plan, b0: int, b1: int,
                    windows=(1, 2, 4, 8)) -> dict:
    """{window: TileWalk} of the plan batches [b0, b1) at each width of
    ``windows`` (``plan_tile_walk``'s arguments): the units and the column
    arrays are built once and shared by every width; only the window count
    and the critical path depend on the width."""
    for window in windows:
        if window not in (1, 2, 4, 8):
            raise ValueError(
                f"window must divide the 8 columns, got {window}")
    nb = plan.gu.shape[0]
    if not 0 <= b0 <= b1 <= nb:
        raise ValueError(f"batches [{b0}, {b1}) outside the plan's {nb}")
    real = real_columns(plan.w)
    gv = plan.gv.reshape(-1).astype(np.int64)
    col_tile = np.where(real, gv, -1).astype(np.int32)
    col_wait = np.full(nb * 8, -1, np.int32)
    col_rel = np.zeros(nb * 8, np.int32)
    cols = np.flatnonzero(real[b0 * 8:b1 * 8]) + b0 * 8
    gu_col = column_user_tiles(plan.gu)[cols]
    # units: maximal runs of consecutive real columns on one user tile
    new = np.r_[True, gu_col[1:] != gu_col[:-1]][:len(cols)]
    starts = np.flatnonzero(new)
    unit_of = np.cumsum(new) - 1  # the unit of each real column
    ends = np.r_[starts[1:], len(cols)].astype(np.int64)
    unit_gu = gu_col[starts]
    unit_c0 = cols[starts]
    unit_c1 = cols[ends - 1] + 1 if len(cols) else cols
    unit_wait = _rank_within(unit_gu)  # earlier units on its user tile
    # (unit, item tile) pairs, ordered by unit: the first and last column
    # of each; its wait value counts the earlier units on the tile
    tiles = gv[cols]
    key = unit_of * (int(tiles.max(initial=0)) + 1) + tiles
    _, first = np.unique(key, return_index=True)
    _, rlast = np.unique(key[::-1], return_index=True)
    last = len(key) - 1 - rlast
    pair_tile = tiles[first]
    wait = _rank_within(pair_tile)
    col_wait[cols[first]] = wait
    col_rel[cols[last]] = wait + 1
    arrays = (unit_c0.astype(np.int32), unit_c1.astype(np.int32),
              unit_gu.astype(np.int32), unit_wait, col_tile, col_wait,
              col_rel)
    out = {}
    for window in windows:
        n_windows, crit = _critical_path(cols, unit_of, unit_gu, first, last,
                                         pair_tile, window)
        out[window] = TileWalk(*arrays, window, window * plan.w.shape[1],
                               n_windows, crit, b0, b1)
    return out


def _critical_path(cols, unit_of, unit_gu, first, last, pair_tile,
                   window: int):
    """(windows, windows on the critical path) of a walk at ``window``
    columns a window step: the depth of a window is 1 + the most of the
    depths it waits on (the unit's previous window, or at the unit's start
    the last release of its user tile; the last release of each item tile
    it touches first)."""
    if not len(cols):
        return 0, 0
    win = cols // window
    wnew = np.r_[True, (unit_of[1:] != unit_of[:-1]) | (win[1:] != win[:-1])]
    win_id = np.cumsum(wnew) - 1  # the window of each real column
    n_windows = int(win_id[-1]) + 1
    w_unit = unit_of[wnew].tolist()
    gu = unit_gu.tolist()
    # the item tiles first touched in each window, and those released
    fw, lw = win_id[first], win_id[last]
    fo, lo = np.argsort(fw, kind="stable"), np.argsort(lw, kind="stable")
    fw, ft = fw[fo].tolist() + [n_windows], pair_tile[fo].tolist()
    lw, lt = lw[lo].tolist() + [n_windows], pair_tile[lo].tolist()
    rel_v = [0] * (int(pair_tile.max()) + 1)
    rel_u: dict = {}
    fi = li = crit = depth = 0
    unit = -1
    for w in range(n_windows):
        if w_unit[w] != unit:
            if unit >= 0:
                rel_u[gu[unit]] = depth
            unit = w_unit[w]
            depth = rel_u.get(gu[unit], 0)
        dep = depth
        while fw[fi] == w:
            dep = max(dep, rel_v[ft[fi]])
            fi += 1
        depth = dep + 1
        while lw[li] == w:
            rel_v[lt[li]] = depth
            li += 1
        crit = max(crit, depth)
    return n_windows, crit


def walk_user_tiles(walk: TileWalk) -> np.ndarray:
    """(nb * 8,) int32: the user tile of each real column of the walk's
    units, -1 elsewhere (``col_tile``'s counterpart on the user side)."""
    out = np.full(walk.col_tile.shape, -1, np.int32)
    for c0, c1, g in zip(walk.unit_c0, walk.unit_c1, walk.unit_gu):
        out[c0:c1] = np.where(walk.col_tile[c0:c1] >= 0, g, -1)
    return out


def tile_apply_flags(col_tile: np.ndarray, groups: int) -> np.ndarray:
    """(nb, 8) int32: 1 where a real column is the last REAL column of its
    group (of ``8 // groups`` columns) on its tile, the tile walk's
    deferred-apply point; ``_apply_flags`` of ``ops/sgd_cells.py`` with the
    columns that hold no real slot left out. ``col_tile`` holds the item
    tile of each real column (``TileWalk.col_tile``) for the item side, or
    its user tile (``walk_user_tiles``) for a free plan's user side."""
    w = 8 // groups
    ct = col_tile.reshape(-1, 8)
    flags = (ct >= 0).astype(np.int32)
    for g0 in range(0, 8, w):
        for j in range(g0, g0 + w - 1):
            later = (ct[:, j + 1:g0 + w] == ct[:, j:j + 1]).any(1)
            flags[:, j] &= (~later).astype(np.int32)
    return flags


def item_noise_ranges(walk: TileWalk, tv_off: np.ndarray, tv_ids: np.ndarray,
                      tile_v: int, n_gv: int):
    """(nz_lo, nz_hi), (nb * 8,) int32 each: for the first real column of
    batch i on item tile v, the range of batch i's item touch list
    (``tv_ids[tv_off[i]:tv_off[i + 1]]``, table rows sorted within the
    batch) that lies on tile v; empty (0, 0) at every other column. The
    gen-1 SGLD walk injects a batch's item noise tile by tile, there."""
    nb = tv_off.shape[0] - 1
    batch = np.repeat(np.arange(nb, dtype=np.int64), np.diff(tv_off))
    keys = batch * n_gv + tv_ids.astype(np.int64) // tile_v
    ct = walk.col_tile.reshape(nb, 8).astype(np.int64)
    first = ct >= 0
    for k in range(1, 8):
        first[:, k] &= ~(ct[:, :k] == ct[:, k:k + 1]).any(1)
    want = np.arange(nb, dtype=np.int64)[:, None] * n_gv + ct
    lo = np.searchsorted(keys, want, "left")
    hi = np.searchsorted(keys, want, "right")
    return (np.where(first, lo, 0).astype(np.int32).reshape(-1),
            np.where(first, hi, 0).astype(np.int32).reshape(-1))


def segment_walks(plan, seg_len: int, n_seg: int,
                  window: int = 1) -> list:
    """``plan_tile_walk`` of each of ``n_seg`` launch ranges of ``seg_len``
    batches (an AdaptReg plan's segments; one range for an SGLD round)."""
    return [plan_tile_walk(plan, s * seg_len, (s + 1) * seg_len, window)
            for s in range(n_seg)]


def cluster_size(walks) -> int:
    """The blocks of a cluster for a plan's tile walk (``walks``: a
    ``TileWalk`` or a list of them): ``CLUSTER``, or ``WIDE_CLUSTER`` where
    a window holds more than ``WIDE_SLOTS`` slots."""
    if isinstance(walks, TileWalk):
        walks = [walks]
    return WIDE_CLUSTER if max(w.slots for w in walks) > WIDE_SLOTS \
        else CLUSTER


def walk_steps(walk: TileWalk, cluster: int, sms: int = H100_SMS) -> int:
    """The window steps the tile walk takes one after another: the critical
    path's, or, where fewer clusters of ``cluster`` blocks (one block an
    SM) fit on ``sms`` SMs than that keeps busy, its windows spread over
    the clusters, whichever is more."""
    return max(walk.crit, -(-walk.n_windows // max(1, sms // cluster)))


def tile_walk_route(walks, cluster: int | None = None,
                    sms: int = H100_SMS, rows: int = 0,
                    grid_windows: int | None = None,
                    grid_rows: int = 0) -> str:
    """The walk a plan takes on the card in a kernel with both walks, by a
    model of each walk's time in rounds of a warp's slots: the tile walk
    runs ``walk_steps`` windows one after another, each a fixed
    ``TILE_STEP_ROUNDS`` plus its slots (and ``rows`` applied rows) over the
    32 warps of each of a cluster's ``cluster`` blocks; the grid walk runs every window (``grid_windows``
    where it also steps through the windows that hold no real slot), each
    ``GRID_STEP_ROUNDS`` plus its slots (and ``grid_rows`` applied rows)
    over one block of 32 warps on each of ``sms`` SMs. "tile" where the
    first is the shorter, else "grid"; summed over the launch ranges of
    ``walks`` (a ``TileWalk`` or a list of them). At ML-10M shape the
    gen-1 plans' chains shrink 8-16x and the tile walk wins; a slot SGLD
    window of 28,672 slots keeps a cluster of 16 busy for 56 rounds, and
    the grid walk wins. ``cluster`` defaults to ``cluster_size``."""
    if isinstance(walks, TileWalk):
        walks = [walks]
    cluster = cluster or cluster_size(walks)
    tile = sum(tile_rounds(w, cluster, sms, TILE_STEP_ROUNDS, rows)
               for w in walks)
    warps = 32 * sms
    grid = sum((w.n_windows if grid_windows is None else grid_windows)
               * (GRID_STEP_ROUNDS + -(-w.slots // warps)
                  + -(-grid_rows // warps)) for w in walks)
    return "tile" if tile < grid else "grid"


def tile_rounds(walk: TileWalk, cluster: int, sms: int = H100_SMS,
                fixed: int = TILE_STEP_ROUNDS, rows: int = 0) -> int:
    """The tile walk's modelled time in rounds of a warp's slots:
    ``walk_steps`` window steps of ``fixed`` rounds plus the window's slots
    and ``rows`` applied rows over the cluster's warps."""
    warps = 32 * cluster
    return walk_steps(walk, cluster, sms) * (
        fixed + -(-walk.slots // warps) + -(-rows // warps))


def free_cluster_size(walk: TileWalk, rows: int,
                      sms: int = H100_SMS) -> int:
    """The blocks of a cluster for a free plan's tile walk: the size of
    ``FREE_CLUSTERS`` whose modelled time (``tile_rounds`` at
    ``FREE_STEP_ROUNDS``, ``rows`` applied rows a step) is the least. A free
    plan's chain is short beside its windows (at ML-10M 659 of 46,086 on
    546 units), so the clusters that fit on the card, not the chain, bound
    large clusters: 2 blocks win there (PERF.md)."""
    return min(FREE_CLUSTERS, key=lambda c: tile_rounds(
        walk, c, sms, FREE_STEP_ROUNDS[c], rows))


class DeviceWalk(NamedTuple):
    """A plan's tile walks (one per launch range) on a device, with what
    the kernels read beside them: the apply flags of the real columns
    (``tile_apply_flags``) per phi groups, or the slot SGLD flags; the
    gen-1 SGLD item noise ranges. The ranges' units are concatenated
    (launch s takes units [unit_off[s], unit_off[s + 1])); their column
    arrays cover disjoint columns and are merged."""

    unit_c0: torch.Tensor
    unit_c1: torch.Tensor
    unit_gu: torch.Tensor
    unit_wait: torch.Tensor
    col_tile: torch.Tensor
    col_wait: torch.Tensor
    col_rel: torch.Tensor
    tap: dict                      # {groups: (nb, 8) int32}
    nz: Optional[tuple]            # (nz_lo, nz_hi) or None
    walks: list                    # the host TileWalks
    unit_off: list                 # host offsets of each range's units
    cluster: int                   # blocks per cluster (cluster_size)
    route: str                     # "tile", or routed (``routed``)
    counters: "TileWalkCounters"   # shared by the runner's plans
    tap_u: Optional[dict] = None   # a free plan's user-side apply flags

    def range_of(self, b0: int, b1: int) -> int:
        """The index of the launch range [b0, b1)."""
        for s, w in enumerate(self.walks):
            if (w.b0, w.b1) == (b0, b1):
                return s
        raise ValueError(f"no tile walk for batches [{b0}, {b1})")


def device_sms(device: torch.device) -> int:
    """The SMs of ``device``: a CUDA card's, an H100's on the CPU."""
    return (torch.cuda.get_device_properties(device).multi_processor_count
            if device.type == "cuda" else H100_SMS)


def upload_walk(walks, counters: "TileWalkCounters", tap: dict | None = None,
                nz=None, free_rows: int | None = None) -> DeviceWalk:
    """The ``TileWalk``s of one plan (a list, or one) on the device of
    ``counters``, on route "tile" (``routed`` routes a kernel with two
    walks); ``tap`` defaults to the real columns' apply flags at every phi
    grouping. ``free_rows`` marks a free plan's walk (one range), whose
    window steps apply that many rows: its user-side flags (``tap_u``) are
    uploaded too, and ``free_cluster_size`` sizes its clusters for the
    device's SMs (an H100's on the CPU)."""
    device = counters.counters.device
    if isinstance(walks, TileWalk):
        walks = [walks]
    first = walks[0]
    if tap is None:
        tap = {g: tile_apply_flags(first.col_tile, g) for g in (1, 2, 4, 8)}

    def dev(a):  # the kernels read int32
        return torch.as_tensor(np.ascontiguousarray(a, np.int32)).to(device)

    def cat(name):
        return dev(np.concatenate([getattr(w, name) for w in walks]))

    col_wait = np.maximum.reduce([w.col_wait for w in walks])
    col_rel = np.maximum.reduce([w.col_rel for w in walks])
    off = np.concatenate([[0], np.cumsum([w.n_units for w in walks])])
    tap_u = None
    if free_rows is None:
        cluster = cluster_size(walks)
    else:
        if len(walks) != 1:
            raise ValueError("a free plan's walk has one launch range")
        users = walk_user_tiles(first)
        tap_u = {g: dev(tile_apply_flags(users, g)) for g in (1, 2, 4, 8)}
        cluster = free_cluster_size(first, free_rows, device_sms(device))
    return DeviceWalk(
        cat("unit_c0"), cat("unit_c1"), cat("unit_gu"), cat("unit_wait"),
        dev(first.col_tile), dev(col_wait), dev(col_rel),
        {g: dev(a) for g, a in tap.items()},
        None if nz is None else tuple(dev(a) for a in nz), list(walks),
        [int(x) for x in off], cluster, "tile", counters, tap_u)


def routed(walk: DeviceWalk) -> DeviceWalk:
    """``walk`` on the route ``tile_walk_route`` gives its ranges at its
    cluster size for its counters' device (an H100's SMs on the CPU): the
    walk of a kernel that keeps both (``csrc/sgld_cells.cu``)."""
    sms = device_sms(walk.counters.counters.device)
    return walk._replace(route=tile_walk_route(walk.walks, walk.cluster,
                                               sms))


def cell_cluster_size(walk: TileWalk, rows: int,
                      sms: int = H100_SMS) -> int:
    """The blocks of a cluster for ``csrc/cell_sgd.cu``'s tile walk: the
    size of ``CELL_CLUSTERS`` whose modelled time (``tile_rounds`` at
    ``TILE_STEP_ROUNDS``, ``rows`` applied rows a step) is the least. On
    the H100 the model picked the fastest size of 4, 8 and 16 on each plan
    timed: clusters of 4 on gen-1's 8/8 windows at ML-10M (more clusters
    for a plan whose windows, not its chain, bound it), 8 on a Yahoo
    shard's 8/8 windows, 16 on its wider ones (PERF.md)."""
    return min(CELL_CLUSTERS, key=lambda c: tile_rounds(
        walk, c, sms, TILE_STEP_ROUNDS, rows))


def cell_walk_rows(tile_u: int, tile_v: int, sub: int,
                   window: int) -> tuple:
    """(tile walk, grid walk) rows one window step of ``window`` columns
    of ``sub`` slots applies in ``csrc/cell_sgd.cu`` at equal groupings:
    the tile walk applies the user rows and each column's item rows its
    slots touched, at most a tile of each (``cell_walk_kernel`` claims
    them slot by slot where a group holds fewer slots than the tile has
    rows); the grid walk every row of the user tile and of each item
    tile."""
    return (min(tile_u, window * sub) + window * min(tile_v, sub),
            tile_u + window * tile_v)


def upload_window_walks(plan, counters: "TileWalkCounters",
                        windows=(1, 2, 4, 8)) -> dict:
    """{window: DeviceWalk} of a window plan (``CellPlan``, host arrays)
    for ``csrc/cell_sgd.cu``'s tile walk at each window width of
    ``windows`` (columns; a width left out runs the grid walk): the units,
    the column arrays and the apply flags are built and uploaded once
    (``plan_tile_walks``); each width has its own critical path, cluster
    size (``cell_cluster_size``) and route (``tile_walk_route`` over the
    grid walk's every window, with the rows terms of ``cell_walk_rows``).
    A plan whose real columns are not sorted by user tile (a user tile in
    more than one unit) keeps the grid walk at every width."""
    nb, sub = plan.gu.shape[0], plan.w.shape[1]
    walks = plan_tile_walks(plan, 0, nb, windows)
    first = walks[windows[0]]
    base = upload_walk(first, counters)
    sms = device_sms(counters.counters.device)
    sorted_u = bool((np.diff(first.unit_gu.astype(np.int64)) > 0).all())
    out = {}
    for window, walk in walks.items():
        rows, grid_rows = cell_walk_rows(plan.tile_u, plan.tile_v, sub,
                                         window)
        cluster = cell_cluster_size(walk, rows, sms)
        route = tile_walk_route(walk, cluster, sms, rows=rows,
                                grid_windows=nb * 8 // window,
                                grid_rows=grid_rows) if sorted_u else "grid"
        out[window] = base._replace(walks=[walk], cluster=cluster,
                                    route=route)
    return out


class TileWalkCounters:
    """The tile walk's hand-off state on one device: a 64-bit ready counter
    per tile (``n_gv`` item tiles, then ``n_gu`` user tiles) and the unit
    ticket (the low 32 bits of one more 64-bit word). Nothing is cleared
    between launches: each launch takes the next generation (``gen``, a
    32-bit number) and starts its tickets at ``ticket_base``; ``advance``
    moves both past it, modulo 2^32 as the kernel's unsigned counters
    wrap."""

    def __init__(self, n_gv: int, n_gu: int, device):
        self.n_gv, self.n_gu = n_gv, n_gu
        self.counters = torch.zeros(n_gv + n_gu + 1, dtype=torch.int64,
                                    device=device)
        self.gen = 1
        self.ticket_base = 0
        self._slices: Optional[torch.Tensor] = None

    def slices(self, rows: int, stride: int) -> torch.Tensor:
        """A zero (rows, stride) float32 view of the dtheta slices kept
        with the counters, for a walk kernel that leaves its slices zero
        (``csrc/cell_sgd.cu``): one buffer for every plan and launch on
        these counters, grown (zero) when a launch needs more."""
        need = rows * stride
        if self._slices is None or self._slices.numel() < need:
            self._slices = None
            self._slices = torch.zeros(need, dtype=torch.float32,
                                       device=self.counters.device)
        return self._slices[:need].view(rows, stride)

    def advance(self, n_units: int, n_clusters: int) -> None:
        self.gen = (self.gen + 1) % 2 ** 32
        self.ticket_base = (self.ticket_base + n_units + n_clusters) % 2 ** 32


class WalkLaunch(ctypes.Structure):
    """``tile_walk::WalkLaunch`` of ``csrc/tile_walk.cuh``, field for
    field."""

    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "counters", "ticket", "dtheta", "unit_c0", "unit_c1", "unit_gu",
        "unit_wait", "col_tile", "col_wait", "col_rel", "tap", "nz_lo",
        "nz_hi")]
        + [(name, ctypes.c_longlong) for name in (
            "n_units", "n_gv", "cluster", "n_clusters")]
        + [(name, ctypes.c_ulonglong) for name in ("ticket_base", "gen")])


_resident: dict = {}


def resident_clusters(key, cluster: int, query) -> int:
    """The most clusters of ``cluster`` blocks of a walk kernel the card
    keeps resident, from ``query(cluster, byref(out))`` (a library's
    ``*_walk_clusters`` bound to the kernel), cached by ``key``."""
    key = (*key, cluster, torch.cuda.current_device())
    if key not in _resident:
        out = ctypes.c_int(0)
        rc = query(cluster, ctypes.byref(out))
        if rc != 0 or out.value < 1:
            raise RuntimeError(f"tile walk: no cluster of {cluster} blocks "
                               f"fits (CUDA error {rc})")
        _resident[key] = out.value
    return _resident[key]


def pick_walk(walk: DeviceWalk, forced: str | None) -> str:
    """``forced`` ("tile" or "grid"), or the plan's route."""
    route = forced or walk.route
    if route not in WALKS:
        raise ValueError(f"no walk {forced!r}")
    return route


def walk_launch(walk: DeviceWalk, b0: int, b1: int, tap_groups, key, query,
                tile_u: int, lanes: int, device: torch.device,
                stride: int | None = None):
    """(the ``WalkLaunch`` of the range [b0, b1) of ``walk``, the tensors
    it points into): at most the clusters the card keeps resident
    (``resident_clusters(key, walk.cluster, query)``) and no more than the
    range's units, each with a zeroed tile_u x lanes dtheta slice on
    ``device``, where the walk's counters must lie; with ``stride``, slices
    of tile_u x stride from the counters' own buffer
    (``TileWalkCounters.slices``), which the kernel leaves zero.
    ``tap_groups`` picks the apply flags (None: none)."""
    if walk.counters.counters.device != device:
        raise ValueError(f"tile walk: the counters are on "
                         f"{walk.counters.counters.device}, the tables on "
                         f"{device}")
    resident = resident_clusters(key, walk.cluster, query)
    s = walk.range_of(b0, b1)
    lo, n_units = walk.unit_off[s], walk.walks[s].n_units
    n_clusters = max(1, min(resident, n_units))
    cnt = walk.counters
    if stride is None:
        dtheta = torch.zeros(n_clusters * tile_u, lanes, dtype=torch.float32,
                             device=cnt.counters.device)
    else:
        dtheta = cnt.slices(n_clusters * tile_u, stride)
    base = cnt.counters.data_ptr()

    def at(t, off=0):
        return t.data_ptr() + 4 * off

    nz = walk.nz or (None, None)
    launch = WalkLaunch(
        base, base + 8 * (cnt.n_gv + cnt.n_gu), dtheta.data_ptr(),
        at(walk.unit_c0, lo), at(walk.unit_c1, lo), at(walk.unit_gu, lo),
        at(walk.unit_wait, lo), at(walk.col_tile), at(walk.col_wait),
        at(walk.col_rel),
        None if tap_groups is None else at(walk.tap[tap_groups]),
        None if nz[0] is None else at(nz[0]),
        None if nz[1] is None else at(nz[1]),
        n_units, cnt.n_gv, walk.cluster, n_clusters, cnt.ticket_base,
        cnt.gen)
    return launch, dtheta
