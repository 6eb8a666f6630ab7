"""Gen-1 cell-plan SGD epochs (counterpart of ``tpu_mf/ops/pallas_sgd.py``).

Ratings are binned into (user tile x item tile) cells; each cell is padded
to whole sub-batches of B/8 slots and a batch packs 8 sub-batch columns
that share one user tile, each column with its own item tile
(``prepare_cells``). Batches are sorted by user tile. One epoch walks the
batches in plan order and, inside a batch, the 8 columns:

    pred = t . p + gb      (fused homogeneous rows, ``ops/rows.py``)
    err  = eta * w * (r - pred)
    dtheta[u] += err * p,  dphi[v] += err * t,  count lane += w

User deltas apply once per theta group of ``8 / theta_groups`` columns;
item deltas once per phi group of ``8 / phi_groups`` columns, each item
tile at the last column of the group that touches it (``_apply_flags``).
A column gathers theta and phi as they stood at the start of its groups.
At an apply a row touched k times decays by (1 - eta*lam)^k and takes its
summed delta, scaled by min(1, cap/k) when saturating.

The plan builders, the balance maps, the group pickers and
``pallas_eligible`` are ``tpu_mf``'s, bit for bit, so both packages run the
same windows. ``cell_epoch`` runs the hand-written CUDA kernel
(``csrc/cell_sgd.cu``, one launch per epoch) on CUDA tensors, on the walk
``ops/tile_walk.py: upload_window_walks`` routes the plan to at the
groupings' window width (the tile walk: units of columns on one user tile,
one thread-block cluster each, ordered by ready counters per tile; or the
grid walk), and the plain PyTorch version ``cell_epoch_reference`` on CPU
tensors. Epochs update the fused tables in place.

Any plan of (NB, column height, 8) tile-local ids with ``gu``, ``gv`` and
weights is a window plan: the lane-packed and slot-major families
(``ops/sgd_packed.py``, ``ops/sgd_slot.py``) convert theirs to it and run
on the same kernel through ``WindowRunner``.
"""

from __future__ import annotations

import ctypes
import warnings
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from tpu_mf_torch.data.coo import RatingsCOO
from tpu_mf_torch.models.mf import MFParams
from tpu_mf_torch.ops import _build
from tpu_mf_torch.ops.plan_cache import cached_build
from tpu_mf_torch.ops.rows import (
    LANES,
    MAX_DIM,
    cdiv,
    pad_params,
    row_lanes,
    split_params,
)
from tpu_mf_torch.ops.tile_walk import (
    WALKS,
    TileWalkCounters,
    pick_walk,
    upload_window_walks,
    walk_launch,
)
from tpu_mf_torch.train.metrics import count, span

GROUPS = (1, 2, 4, 8)
# the counter of each (theta, phi) grouping, made once
GROUP_KEYS = {t: {p: f"groups_{t}x{p}" for p in GROUPS} for t in GROUPS}


class CellPlan(NamedTuple):
    """Epoch data layout (host side); the fields of ``tpu_mf``'s CellPlan,
    so the two packages share cached plans."""

    u: np.ndarray    # (NB, B/8, 8) int32 tile-local user ids; tile_u = pad
    v: np.ndarray    # (NB, B/8, 8) int32 tile-local item ids; tile_v = pad
    r: np.ndarray    # (NB, B/8, 8) float32
    w: np.ndarray    # (NB, B/8, 8) float32 {0, 1}
    gu: np.ndarray   # (NB,) int32 user tile per batch
    gv: np.ndarray   # (NB, 8) int32 item tile per sub-batch column
    tile_u: int
    tile_v: int
    n_gu: int
    n_gv: int
    n_real: int


def prepare_cells(ds: RatingsCOO, tile_u: int = 512, tile_v: int = 512,
                  batch_size: int = 2048, seed: int = 0) -> CellPlan:
    """Disk-cached plan build (``ops/plan_cache.py``)."""
    return cached_build(
        "cell", CellPlan, ds, seed, (tile_u, tile_v, batch_size),
        lambda: _prepare_cells_impl(ds, tile_u, tile_v, batch_size, seed),
    )


def _prepare_cells_impl(ds: RatingsCOO, tile_u: int, tile_v: int,
                        batch_size: int, seed: int) -> CellPlan:
    """Bin shuffled ratings into cells, pad each cell to whole sub-batches
    (B/8), pack 8 sub-batches per batch within each user-tile group, and
    order batches by user tile. Each rating's (batch, row, column) slot comes
    from cumsum arithmetic and one flat scatter fills the plan."""
    if batch_size % 8:
        raise ValueError(
            f"batch_size must be a multiple of 8, got {batch_size}")
    sub = batch_size // 8
    n_gu = cdiv(ds.nu, tile_u)
    n_gv = cdiv(ds.nv, tile_v)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(ds))
    u, v, r = ds.u[perm], ds.v[perm], ds.r[perm]

    cell = ((u // tile_u) * n_gv + v // tile_v).astype(np.int64)
    order = np.argsort(cell, kind="stable")
    u, v, r, cell = u[order], v[order], r[order], cell[order]
    counts = np.bincount(cell, minlength=n_gu * n_gv)
    sb_per_cell = np.ceil(counts / sub).astype(np.int64)
    sb_per_group = sb_per_cell.reshape(n_gu, n_gv).sum(1)
    nb_per_group = np.maximum(1, np.ceil(sb_per_group / 8)).astype(np.int64)
    nb_total = int(nb_per_group.sum())

    U = np.full((nb_total, sub, 8), tile_u, np.int32)  # sentinel = padded
    V = np.full((nb_total, sub, 8), tile_v, np.int32)
    R = np.zeros((nb_total, sub, 8), np.float32)
    W = np.zeros((nb_total, sub, 8), np.float32)
    GV = np.zeros((nb_total, 8), np.int32)

    src = np.concatenate([[0], np.cumsum(counts)])
    sb_cs = np.concatenate([[0], np.cumsum(sb_per_cell)])
    base = np.concatenate([[0], np.cumsum(nb_per_group)])
    GU = np.repeat(np.arange(n_gu, dtype=np.int32), nb_per_group)

    l = np.arange(len(u), dtype=np.int64) - src[cell]      # index in cell
    g = cell // n_gv                                       # user tile
    sb_w = (sb_cs[cell] - sb_cs[g * n_gv]) + l // sub      # sub-batch in group
    b = base[g] + sb_w // 8
    col = sb_w % 8
    flat = (b * sub + l % sub) * 8 + col
    U.reshape(-1)[flat] = (u % tile_u).astype(np.int32)
    V.reshape(-1)[flat] = (v % tile_v).astype(np.int32)
    R.reshape(-1)[flat] = r
    W.reshape(-1)[flat] = 1.0
    GV.reshape(-1)[b * 8 + col] = (cell % n_gv).astype(np.int32)
    return CellPlan(u=U, v=V, r=R, w=W, gu=GU, gv=GV, tile_u=tile_u,
                    tile_v=tile_v, n_gu=n_gu, n_gv=n_gv, n_real=len(ds))


def pad_plan_nb(plan: CellPlan, nb: int) -> CellPlan:
    """Pad a plan to ``nb`` batches with all-sentinel batches (w = 0) on the
    last real user tile; they update nothing."""
    cur = plan.u.shape[0]
    if cur >= nb:
        return plan
    e = nb - cur

    def pad3(a, fill):
        return np.concatenate([a, np.full((e,) + a.shape[1:], fill, a.dtype)])

    return plan._replace(
        u=pad3(plan.u, plan.tile_u), v=pad3(plan.v, plan.tile_v),
        r=pad3(plan.r, 0), w=pad3(plan.w, 0),
        gu=np.concatenate(
            [plan.gu, np.full(e, plan.gu[-1] if cur else 0, plan.gu.dtype)]),
        gv=np.concatenate([plan.gv, np.zeros((e, 8), plan.gv.dtype)]),
    )


def _tile_balance_map(counts: np.ndarray, tile: int) -> np.ndarray:
    """new-of-old relabeling that equalizes per-tile rating loads: rows
    sorted heaviest first are dealt across the tiles in snake order."""
    n = counts.size
    n_tiles = cdiv(n, tile)
    order = np.argsort(-counts, kind="stable")
    rnd, c = divmod(np.arange(n, dtype=np.int64), n_tiles)
    tile_of = np.where(rnd % 2 == 0, c, n_tiles - 1 - c)
    out = np.empty(n, np.int64)
    out[order] = tile_of * tile + rnd
    return out.astype(np.int32)


def balance_cells(ds: RatingsCOO, tile_u: int, tile_v: int
                  ) -> Tuple[RatingsCOO, np.ndarray, np.ndarray]:
    """(relabeled ds padded to whole tiles, map_u, map_v). Training on the
    relabeled ids is exact; the runner's pad/trim invert the maps."""
    mu = _tile_balance_map(np.bincount(ds.u, minlength=ds.nu), tile_u)
    mv = _tile_balance_map(np.bincount(ds.v, minlength=ds.nv), tile_v)
    ds2 = RatingsCOO(u=mu[ds.u], v=mv[ds.v], r=ds.r,
                     nu=cdiv(ds.nu, tile_u) * tile_u,
                     nv=cdiv(ds.nv, tile_v) * tile_v)
    return ds2, mu, mv


def pick_cell_geometry(ds: RatingsCOO, tile_u: int = 256
                       ) -> Tuple[int, int, int]:
    """(tile_u, tile_v, batch) of the balanced plan, scored by ``tpu_mf``'s
    fill model: per-cell padding to sub ~ 1.12 x the mean cell, rounding of
    the item tiles to groups of 8 columns, and a per-column fixed cost."""
    n_gu = cdiv(ds.nu, tile_u)
    n = len(ds)
    best = (tile_u, 256, 8192)
    best_score = -1.0
    for tv in range(128, 385, 8):
        n_gv = cdiv(ds.nv, tv)
        gloss = n_gv / (cdiv(n_gv, 8) * 8)
        c = n / (n_gu * n_gv)
        for sub in (512, 640, 768, 896, 1024):
            blocks = max(1, cdiv(int(c * 1.12), sub))
            score = c / (blocks * sub) * gloss / (1.0 + 94.0 / sub)
            if score > best_score:
                best_score = score
                best = (tile_u, tv, 8 * sub)
    return best


def _apply_flags(gv: np.ndarray, groups: int) -> np.ndarray:
    """(NB, 8) int32: 1 where column k is the last column of its phi group
    that touches its item tile (the deferred-apply point)."""
    w = 8 // groups
    flags = np.ones_like(gv, np.int32)
    for g0 in range(groups):
        cols = gv[:, g0 * w:(g0 + 1) * w]
        for j in range(w - 1):
            later = (cols[:, j + 1:] == cols[:, j:j + 1]).any(1)
            flags[:, g0 * w + j] = (~later).astype(np.int32)
    return flags


def _dup_stats(ids: np.ndarray, sentinel: int) -> dict:
    """{g: max count of one id inside one window of 8 // g columns} over an
    (NB, B/8, 8) id array whose padded slots carry ``sentinel``."""
    nb = ids.shape[0]
    out = {g: 0 for g in GROUPS}
    chunk = max(1, (1 << 23) // (8 * sentinel))  # ~64 MB of int64 counts
    for s0 in range(0, nb, chunk):
        u = ids[s0:s0 + chunk]
        cb = u.shape[0]
        c_idx = np.broadcast_to(np.arange(8, dtype=np.int64), u.shape)
        b_idx = np.broadcast_to(np.arange(cb, dtype=np.int64)[:, None, None],
                                u.shape)
        real = u < sentinel
        key = ((b_idx * 8 + c_idx) * sentinel + u)[real]
        counts = np.bincount(key, minlength=cb * 8 * sentinel).reshape(
            cb, 8, sentinel)
        for g in GROUPS:
            m = counts.reshape(cb, g, 8 // g, sentinel).sum(2).max(initial=0)
            out[g] = max(out[g], int(m))
    return out


def warn_window_envelope(kind: str, side: str, eta: float, dups: int,
                         warned: set) -> None:
    """Warn once per runner and side when even the most sequential grouping
    breaks the staleness envelope eta * max window duplicates <= 0.2."""
    if side in warned:
        return
    warned.add(side)
    warnings.warn(
        f"{kind} kernel {side}-side staleness envelope exceeded even at "
        f"the most sequential grouping: eta={eta:g} x max window "
        f"duplicates {dups} = {eta * dups:.2f} > 0.2. A row hit that "
        "often inside one deferred-apply window accumulates that many "
        "gradients computed at the same stale point and can diverge "
        "(bias terms first; watch for nan tRMSE). Reduce eta, raise gam "
        "so eta decays faster, or shrink the batch.",
        stacklevel=5,
    )


def pallas_eligible(params: MFParams, batch_size: int) -> bool:
    """``tpu_mf``'s gen-1 routing rule: rows within MAX_DIM and the fused
    item table within 64 MiB; otherwise it shards the item table
    (``ops/phi_shard.py``). A TPU residency rule that only routes epochs;
    it bounds nothing in ``csrc/cell_sgd.cu``."""
    del batch_size
    dim = params.theta.shape[1]
    if dim > MAX_DIM:
        return False
    nv = params.phi.shape[0]
    return cdiv(nv, 512) * 512 * row_lanes(dim) * 4 <= 64 * 1024 * 1024


# ---- the epoch --------------------------------------------------------------

class DevicePlan(NamedTuple):
    """One CellPlan on a device, columns contiguous: slot s of column k of
    batch i is element [i, k, s]. The host copies of gu/gv/ap drive the
    plain version's loop without device reads."""

    u: torch.Tensor    # (NB, 8, B/8) int32 tile-local ids, sentinel tile_u
    v: torch.Tensor    # (NB, 8, B/8) int32
    r: torch.Tensor    # (NB, 8, B/8) float32
    w: torch.Tensor    # (NB, 8, B/8) float32 {0, 1}
    gu: torch.Tensor   # (NB,) int32
    gv: torch.Tensor   # (NB, 8) int32
    ap: dict           # {phi_groups: (NB, 8) int32 apply flags}
    gu_host: np.ndarray
    gv_host: np.ndarray
    ap_host: dict
    tile_u: int
    tile_v: int
    # {window width: DeviceWalk}: the plan's tile walk (``cell_epoch``), or
    # None where it has none (the grid walk runs it)
    walk: Optional[dict] = None


def upload_plan(plan: CellPlan, device: torch.device | str,
                put=None) -> DevicePlan:
    """The plan on ``device``; ``put(array)`` makes each array's tensor
    there (by default a copy on the current stream)."""
    if put is None:
        def put(a):
            return torch.as_tensor(a).to(device)

    def cols(a):
        return put(a).transpose(1, 2).contiguous()

    ap_host = {g: _apply_flags(plan.gv, g) for g in (1, 2, 4)}
    ap_host[8] = np.ones_like(plan.gv, np.int32)
    return DevicePlan(
        u=cols(plan.u), v=cols(plan.v), r=cols(plan.r), w=cols(plan.w),
        gu=put(plan.gu), gv=put(plan.gv),
        ap={g: put(a) for g, a in ap_host.items()},
        gu_host=plan.gu, gv_host=plan.gv, ap_host=ap_host,
        tile_u=plan.tile_u, tile_v=plan.tile_v,
    )


def cell_epoch_reference(theta: torch.Tensor, phi: torch.Tensor,
                         plan: DevicePlan, eta: float, lam: float, gb: float,
                         cap: float, dim: int, theta_groups: int,
                         phi_groups: int, work: torch.dtype = torch.float32,
                         saturate: bool = True, mxu_pred: bool = True) -> None:
    """Plain PyTorch gen-1 epoch, in place on the fused tables.

    Gathers and ``index_add_`` per window step: the columns between two
    group ends run at once. Rows and products are rounded to the working
    type where the TPU kernel rounds them; every sum is float32."""
    eta_t, lam_t, gb_t, cap_t = torch.tensor([eta, lam, gb, cap],
                                             dtype=torch.float32,
                                             device=theta.device)
    window_reference(theta, phi, plan, (0, plan.u.shape[0]), eta_t, gb_t,
                     dim, theta_groups, phi_groups, work, mxu_pred,
                     window_apply(eta_t, lam_t, cap_t, theta.shape[1], dim,
                                  saturate))


def window_apply(eta_t: torch.Tensor, lam_t: torch.Tensor,
                 cap_t: torch.Tensor, lanes: int, dim: int, saturate: bool):
    """``apply(rows, deltas, side)`` of gen-1's window step: a row touched
    k times (the deltas' count lane) decays by (1 - eta*lam)^k on its kept
    lanes (``window_keep``) and takes its summed delta, scaled by
    min(1, cap/k) when saturating; untouched rows stay as they are."""
    ln_decay = torch.log(1.0 - eta_t * lam_t)
    keep = window_keep(lanes, dim, eta_t.device)

    def apply(cur, d, side):
        k = d[:, dim + 2:dim + 3]
        if saturate:
            d = d * torch.clamp(cap_t / torch.clamp(k, min=1.0), max=1.0)
        return (cur * (1.0 + keep[side] * (torch.exp(k * ln_decay) - 1.0))
                + d * keep[side])

    return apply


def window_keep(lanes: int, dim: int, dev) -> Tuple[torch.Tensor, ...]:
    """(keep_u, keep_v) float32 lane masks: the lanes an apply writes (a
    user row's factors and bias, an item row's factors and bias)."""
    lane = torch.arange(lanes, device=dev)
    return ((lane <= dim).to(torch.float32),
            ((lane < dim) | (lane == dim + 1)).to(torch.float32))


def window_reference(theta: torch.Tensor, phi: torch.Tensor,
                     plan: DevicePlan, batches: Tuple[int, int],
                     eta_t: torch.Tensor, gb_t: torch.Tensor, dim: int,
                     theta_groups: int, phi_groups: int, work: torch.dtype,
                     mxu_pred: bool, apply, activate=None) -> None:
    """The plain window-plan walk over the plan batches [b0, b1), in place:
    per window step the gathers, the prediction (``activate`` applied to
    t . p + gb, when given), the scatter of the deltas and counts
    (``window_scatter``), and at each group end ``apply(rows, deltas,
    side)`` (side 0 the user tile, 1 an item tile), which returns the new
    rows."""
    tu, tv = plan.tile_u, plan.tile_v
    tg_w, pg_w = 8 // theta_groups, 8 // phi_groups
    step = min(tg_w, pg_w)
    ap = plan.ap_host[phi_groups]
    d_theta = torch.zeros(tu, theta.shape[1], dtype=torch.float32,
                          device=theta.device)
    acc = torch.zeros_like(phi)
    for i in range(*batches):
        gu = int(plan.gu_host[i])
        th = theta[gu * tu:(gu + 1) * tu]
        for c0 in range(0, 8, step):
            c1 = c0 + step
            window_scatter(th, phi, plan, i, c0, c1, eta_t, gb_t, dim, work,
                           mxu_pred, d_theta, acc, activate)
            if c1 % pg_w == 0:
                for c in range(c1 - pg_w, c1):
                    if ap[i, c]:
                        rows = slice(int(plan.gv_host[i, c]) * tv,
                                     (int(plan.gv_host[i, c]) + 1) * tv)
                        phi[rows] = apply(phi[rows], acc[rows], 1)
                        acc[rows] = 0.0
            if c1 % tg_w == 0:
                th[:] = apply(th, d_theta, 0)
                d_theta.zero_()


def window_scatter(th: torch.Tensor, phi: torch.Tensor, plan: DevicePlan,
                   i: int, c0: int, c1: int, eta_t: torch.Tensor,
                   gb_t: torch.Tensor, dim: int, work: torch.dtype,
                   mxu_pred: bool, d_theta: torch.Tensor, acc: torch.Tensor,
                   activate=None) -> None:
    """The window step of the columns [c0, c1) of batch i, read from the
    user tile ``th`` and ``phi``: each real slot's deltas and counts added
    to ``d_theta`` (the user tile's) and ``acc`` (phi's shape), rounded to
    the working type where the TPU kernel rounds them."""
    f32 = torch.float32
    lanes = th.shape[1]
    cnt = (torch.arange(lanes, device=th.device) == dim + 2).to(f32)

    def rnd(x):
        return x if work == f32 else x.to(work).to(f32)

    w = plan.w[i, c0:c1]
    real = w > 0
    ul = torch.where(real, plan.u[i, c0:c1], 0).long()
    vl = (torch.where(real, plan.v[i, c0:c1], 0).long()
          + plan.gv[i, c0:c1, None].long() * plan.tile_v)
    t = rnd(th[ul])                      # (step, B/8, lanes)
    p = rnd(phi[vl])
    tp = rnd(t * p) if mxu_pred else t * p
    pred = tp.sum(-1, keepdim=True) + gb_t
    if activate is not None:
        pred = activate(pred)
    wk = w.unsqueeze(-1)
    err = (eta_t * wk) * (plan.r[i, c0:c1].unsqueeze(-1) - pred)
    d_theta.index_add_(0, ul.reshape(-1),
                       rnd(err * p + wk * cnt).reshape(-1, lanes))
    acc.index_add_(0, vl.reshape(-1),
                   rnd(err * t + wk * cnt).reshape(-1, lanes))


def _cell_lib() -> ctypes.CDLL:
    return bind_cell_lib(_build.load("cell_sgd"))


def bind_cell_lib(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``, a build of ``csrc/cell_sgd.cu``, with its entry points'
    argument types set."""
    fn = lib.tmf_cell_epoch
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 11
                   + [ctypes.c_float] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.tmf_cell_walk
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
                   + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    fn = lib.tmf_cell_walk_clusters
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return lib


# the window-plan kernels' working types (csrc/cell_sgd.cu, adreg_cells.cu)
WORK = {torch.float32: 0, torch.bfloat16: 1}


def check_window_launch(name: str, theta: torch.Tensor, phi: torch.Tensor,
                        plan: DevicePlan, phi_groups: int, dim: int,
                        extra=()) -> None:
    """Raise ValueError unless the tables, the plan (and the ``extra``
    (name, tensor, dtype, shape) operands) are what the window-plan kernels
    (``csrc/cell_sgd.cu``, ``csrc/adreg_cells.cu``) take: contiguous, of the
    right type and shape, on theta's device."""
    nb, cols, sub = plan.u.shape
    for tname, t, dtype, shape in (
            ("theta", theta, torch.float32, None),
            ("phi", phi, torch.float32, None), *extra,
            ("u", plan.u, torch.int32, (nb, 8, sub)),
            ("v", plan.v, torch.int32, (nb, 8, sub)),
            ("r", plan.r, torch.float32, (nb, 8, sub)),
            ("w", plan.w, torch.float32, (nb, 8, sub)),
            ("gu", plan.gu, torch.int32, (nb,)),
            ("gv", plan.gv, torch.int32, (nb, 8)),
            ("ap", plan.ap[phi_groups], torch.int32, (nb, 8))):
        if (t.device != theta.device or not t.is_contiguous()
                or t.dtype != dtype or (shape and t.shape != shape)):
            raise ValueError(f"{name}: {tname} must be a contiguous "
                             f"{dtype} tensor of shape {shape} on "
                             f"{theta.device}")
    if (cols != 8 or theta.shape[0] % plan.tile_u or phi.shape[0] % plan.tile_v
            or phi.shape[1] != theta.shape[1] or dim + 3 > theta.shape[1]):
        raise ValueError(f"{name}: table or plan shapes do not match")


def cell_walk(plan: DevicePlan, theta_groups: int, phi_groups: int):
    """The plan's tile walk at the window width of the groups (a
    ``DeviceWalk``), or None where the plan has none at that width."""
    if plan.walk is None:
        return None
    return plan.walk.get(min(8 // theta_groups, 8 // phi_groups))


def cell_epoch(theta: torch.Tensor, phi: torch.Tensor, plan: DevicePlan,
               eta: float, lam: float, gb: float, cap: float, dim: int,
               theta_groups: int, phi_groups: int,
               work: torch.dtype = torch.bfloat16, saturate: bool = True,
               mxu_pred: bool = True, walk: str | None = None) -> None:
    """One gen-1 epoch, in place on the fused (theta_ext, phi_ext).

    CPU tensors take the plain version; CUDA tensors launch the
    ``csrc/cell_sgd.cu`` kernel (one launch per epoch) or raise: on the
    tile walk of the plan's walk at the groups' window width where its
    route or ``walk`` ("tile" or "grid") says so, else on the grid walk
    (a plan without a walk takes the grid walk). The launch counts on
    ``cell_epoch.walks`` and as ``walk_tile`` / ``walk_grid`` on the
    innermost span."""
    if theta_groups not in GROUPS or phi_groups not in GROUPS:
        raise ValueError(f"groups must divide the 8 columns, got "
                         f"{theta_groups}/{phi_groups}")
    if work not in WORK:
        raise ValueError(f"cell_epoch: unsupported working type {work}")
    if theta.device.type == "cpu":
        cell_epoch_reference(theta, phi, plan, eta, lam, gb, cap, dim,
                             theta_groups, phi_groups, work, saturate,
                             mxu_pred)
        return
    if theta.device.type != "cuda":
        raise ValueError(f"cell_epoch: no kernel for device {theta.device}")
    check_window_launch("cell_epoch", theta, phi, plan, phi_groups, dim)
    dwalk = cell_walk(plan, theta_groups, phi_groups)
    if dwalk is None:
        if walk not in (None, "grid"):
            raise ValueError(f"cell_epoch: the plan has no tile walk, "
                             f"{walk!r} asked")
        route = "grid"
    else:
        route = pick_walk(dwalk, walk)
    nb, _, sub = plan.u.shape
    lanes = theta.shape[1]
    acc = torch.zeros_like(phi)
    lib = _cell_lib()
    with torch.cuda.device(theta.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "grid":
            d_theta = torch.zeros(plan.tile_u, lanes, dtype=torch.float32,
                                  device=theta.device)
            rc = lib.tmf_cell_epoch(
                theta.data_ptr(), phi.data_ptr(), plan.u.data_ptr(),
                plan.v.data_ptr(), plan.r.data_ptr(), plan.w.data_ptr(),
                plan.gu.data_ptr(), plan.gv.data_ptr(),
                plan.ap[phi_groups].data_ptr(), d_theta.data_ptr(),
                acc.data_ptr(), nb, sub, plan.tile_u, plan.tile_v, lanes,
                dim, theta_groups, phi_groups, WORK[work], int(mxu_pred),
                int(saturate), eta, lam, gb, cap, stream)
        else:
            key = (WORK[work], int(mxu_pred and work != torch.float32))
            launch, _ = walk_launch(
                dwalk, 0, nb, phi_groups, ("cell", *key),
                lambda c, out: lib.tmf_cell_walk_clusters(*key, c, out),
                plan.tile_u, lanes, theta.device, stride=dim + 3)
            rc = lib.tmf_cell_walk(
                theta.data_ptr(), phi.data_ptr(), plan.u.data_ptr(),
                plan.v.data_ptr(), plan.r.data_ptr(), plan.w.data_ptr(),
                plan.gv.data_ptr(), acc.data_ptr(), nb, sub, plan.tile_u,
                plan.tile_v, lanes, dim, theta_groups, phi_groups,
                WORK[work], int(mxu_pred), int(saturate), eta, lam, gb, cap,
                ctypes.addressof(launch), stream)
    if rc != 0:
        raise RuntimeError(f"cell_sgd kernel launch failed: CUDA error {rc}")
    if route == "tile":
        dwalk.counters.advance(launch.n_units, launch.n_clusters)
    cell_epoch.launches += 1
    cell_epoch.walks[route] += 1
    count("launches")
    count(WALK_KEYS[route])


cell_epoch.launches = 0  # kernel launches (CUDA calls), not CPU runs
cell_epoch.walks = dict.fromkeys(WALKS, 0)  # the launches by walk
# the counter of each walk on the innermost span
WALK_KEYS = {w: f"walk_{w}" for w in WALKS}


class WindowRunner:
    """Window plans on a device and gen-1 epochs over them (``pad`` /
    ``epoch`` / ``trim``): what the gen-1, lane-packed and slot-major
    runners share. Each family builds its own plans (``plans``, kept as
    ``tpu_mf`` builds them) and says how one becomes window-plan columns
    (``_window_plan``); all of them run ``cell_epoch``.

    - ``theta_groups`` / ``phi_groups`` None: picked per epoch from eta and
      the plans' within-window duplicate counts (``_dups``, which a family
      overrides where its plan's ids are not the labels to count).
    - ``saturate`` caps a row's window step at min(1, cap/k),
      cap = max(1, 0.2/eta).
    - ``mxu`` names the working type: "bfloat16" (production: bf16 rows and
      products, f32 sums) or "float32" (everything f32, for parity runs).
    - ``map_u`` / ``map_v``: new-of-old id relabelings the plans were built
      on; ``pad`` / ``trim`` invert them, so training on them is exact.
    - Plans reach the device at ``materialize`` (``pad`` calls it), never
      while a schedule only probes a runner's statistics, each with its
      tile walk at every window width (``upload_window_walks``) on one set
      of hand-off counters (``walk_counters``; a runner that shares its
      device with others may be handed theirs before ``materialize``).
      ``epoch`` runs a plan on the walk its route picks for the groupings'
      window width (``route``), or on the one ``walk`` forces."""

    kind = "blocked"  # the family's name in the envelope warning
    # kernel launches made by the family's runners; each family keeps its
    # own count (``cell_epoch.launches`` counts them all)
    launches = 0

    def __init__(self, plans, nu: int, nv: int, mxu: str,
                 theta_groups: int | None, phi_groups: int | None,
                 saturate: bool, device: torch.device | str,
                 map_u: np.ndarray | None = None,
                 map_v: np.ndarray | None = None):
        for g in (theta_groups, phi_groups):
            if g is not None and g not in GROUPS:
                raise ValueError(f"groups must divide the 8 columns, got {g}")
        self.plans = plans
        self.plan = plans[0]
        self.tile_u, self.tile_v = self.plan.tile_u, self.plan.tile_v
        self.nu, self.nv = nu, nv
        self._map_u, self._map_v = map_u, map_v
        self.work_dtype = {"bfloat16": torch.bfloat16,
                           "float32": torch.float32}[mxu]
        self.theta_groups, self.phi_groups = theta_groups, phi_groups
        self.saturate = saturate
        self.mxu_pred = True
        self._warned: set = set()
        # element-wise max over every plan the rotation can pick
        self._dup_max = self._vdup_max = None
        if theta_groups is None:
            stats = [self._dups(p, "u") for p in plans]
            self._dup_max = {g: max(s[g] for s in stats) for g in GROUPS}
        if phi_groups is None:
            stats = [self._dups(p, "v") for p in plans]
            self._vdup_max = {g: max(s[g] for s in stats) for g in GROUPS}
        self.device = torch.device(device)
        self._dev: list = []
        self.walk_counters: Optional[TileWalkCounters] = None
        self.dim = None
        self.gb = 0.0

    def _dups(self, plan, side: str) -> dict:
        """``_dup_stats`` of one plan's user ("u") or item ("v") ids."""
        if side == "u":
            return _dup_stats(plan.u, plan.tile_u)
        return _dup_stats(plan.v, plan.tile_v)

    def _window_plan(self, plan) -> CellPlan:
        return plan

    def materialize(self) -> "WindowRunner":
        """Upload the plans, as window-plan columns, to the runner's device
        (once)."""
        if not self._dev:
            with span("tmf.plan_upload"):
                plans = [self._window_plan(p) for p in self.plans]
                if self.walk_counters is None:
                    self.walk_counters = TileWalkCounters(
                        plans[0].n_gv, plans[0].n_gu, self.device)
                self._dev = [upload_plan(p, self.device)._replace(
                    walk=upload_window_walks(p, self.walk_counters))
                    for p in plans]
        return self

    def route(self, epoch_idx: int = 0, theta_groups: int = 8,
              phi_groups: int = 8) -> str:
        """The walk the kernel takes on plan ``epoch_idx`` at these
        groupings (``upload_window_walks``)."""
        plan = self.materialize()._dev[epoch_idx % len(self._dev)]
        dwalk = cell_walk(plan, theta_groups, phi_groups)
        return "grid" if dwalk is None else dwalk.route

    def _warn(self, side: str, eta: float, dups: int) -> None:
        if not self.saturate:
            warn_window_envelope(self.kind, side, eta, dups, self._warned)

    def _pick(self, fixed, dups, side, eta):
        if fixed is not None:
            return fixed
        for g in GROUPS:
            if eta * dups[g] <= 0.2:
                return g
        self._warn(side, eta, dups[8])
        return 8

    def pick_theta_groups(self, eta: float) -> int:
        """Most parallel user-side grouping whose staleness stays within
        eta * max window duplicates <= 0.2."""
        return self._pick(self.theta_groups, self._dup_max, "theta", eta)

    def pick_phi_groups(self, eta: float) -> int:
        """Item-side counterpart of ``pick_theta_groups``."""
        return self._pick(self.phi_groups, self._vdup_max, "phi", eta)

    def epoch(self, tables, eta: float, lam: float, gb: float,
              epoch_idx: int = 0, walk: str | None = None):
        """One epoch, in place on the fused tables; returns them. The
        grouping it took counts as ``groups_<theta>x<phi>`` on the
        innermost span; ``walk`` forces "tile" or "grid" (default: the
        plan's route)."""
        cap = max(1.0, 0.2 / max(eta, 1e-9))
        plan = self.materialize()._dev[epoch_idx % len(self._dev)]
        launched = cell_epoch.launches
        tg, pg = self.pick_theta_groups(eta), self.pick_phi_groups(eta)
        cell_epoch(tables[0], tables[1], plan, eta, lam, gb, cap, self.dim,
                   tg, pg, self.work_dtype, self.saturate, self.mxu_pred,
                   walk)
        type(self).launches += cell_epoch.launches - launched
        count(GROUP_KEYS[tg][pg])
        return tables

    def bind(self, dim: int, gb: float) -> None:
        """Fix the tables' rank and global bias for the epochs to come;
        past 2 lane groups t*p is summed unrounded (``mxu_pred`` off)."""
        self.dim = dim
        if row_lanes(dim) > 2 * LANES:
            self.mxu_pred = False
        self.gb = float(gb)

    def pad(self, params: MFParams):
        self.materialize()
        self.bind(params.theta.shape[1], params.gb)
        p = self.plan
        return pad_params(params, p.n_gu * p.tile_u, p.n_gv * p.tile_v,
                          self._map_u, self._map_v)

    def trim(self, tables, dim: int | None = None) -> MFParams:
        return split_params(tables[0], tables[1], self.nu, self.nv,
                            dim or self.dim, self.gb, self._map_u,
                            self._map_v)


class CellEpochRunner(WindowRunner):
    """Gen-1 cell plans on a device, as ``tpu_mf``'s PallasEpochRunner
    (the options of ``WindowRunner``, and):

    - ``n_plans`` > 1 rotates independently shuffled plans (seeds
      seed + 7919 p) by epoch; ``nb_round`` pads them to a common batch
      count.
    - ``balance`` relabels ids to even out per-tile loads
      (``balance_cells``).
    - t*p is rounded to the working type before the row sum up to 2 lane
      groups (``mxu_pred``; ``pad`` turns it off past that, as in
      ``tpu_mf``)."""

    launches = 0

    def __init__(self, ds: RatingsCOO, tile_u: int = 512, tile_v: int = 512,
                 batch: int = 2048, seed: int = 0, mxu: str = "bfloat16",
                 theta_groups: int | None = None,
                 phi_groups: int | None = None, n_plans: int = 1,
                 balance: bool = False,
                 saturate: bool = False, nb_round: int = 1,
                 device: torch.device | str = "cuda"):
        nu, nv = ds.nu, ds.nv
        map_u = map_v = None
        if balance:
            ds, map_u, map_v = balance_cells(ds, tile_u, tile_v)
        batch = cdiv(batch, 8) * 8
        plans = [prepare_cells(ds, tile_u, tile_v, batch, seed + 7919 * p)
                 for p in range(max(1, n_plans))]
        if nb_round > 1:
            nbmax = cdiv(max(p.u.shape[0] for p in plans),
                         nb_round) * nb_round
            plans = [pad_plan_nb(p, nbmax) for p in plans]
        self.batch = batch
        super().__init__(plans, nu, nv, mxu, theta_groups, phi_groups,
                         saturate, device, map_u=map_u, map_v=map_v)
