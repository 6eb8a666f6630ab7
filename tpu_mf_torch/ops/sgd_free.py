"""Free-column plans and their epoch (counterpart of
``tpu_mf/ops/pallas_sgd_free.py``).

A free-column plan bins shuffled ratings into (user tile x item tile)
cells of 128 x 128, pads each cell to whole sub-batches of B/8 and deals
the sub-batches in cell order into the 8 columns of the batches: every
column carries its own user tile ``gu`` and item tile ``gv``. The unused
columns of the last batch hold only sentinels, with ``gu = gv = 0``. One
epoch walks the columns in plan order, per rating gen-1's update

    pred = t . p + gb      (fused homogeneous rows, ``ops/rows.py``)
    err  = eta * w * (r - pred)
    dtheta[u] += err * p,  dphi[v] += err * t,  count lane += w

and both sides are deferred the same way: user deltas sum over a window of
8 / groups_u columns, item deltas over 8 / groups_v, each into a scratch of
its table's shape, and at the window's end each tile applies at the last
column of the window that touches it (``_apply_flags`` on ``gu`` and on
``gv``). A column reads both tables as they stood at the start of its
windows. At 8 groups a window is one column: the applies are immediate.
An apply is gen-1's: decay (1 - eta*lam)^k, saturation min(1, cap/k) (on
by default here), rows with k = 0 left alone.

Flags come from ``_apply_flags`` as they are. ``tpu_mf`` masks them with
the columns that hold a real slot, so where a trailing sentinel column is
the last in its window to name a tile that a real column of the window
touched, its kernel flushes that tile's deltas nowhere; the port flushes
them at the window's end, as the sequential walk does.

The plan builder, the geometry picker, the balance maps, the window
statistics and ``free_eligible`` give ``tpu_mf``'s answers, bit for bit.
The TPU's byte-plane id streams, its SMEM plan check and its ablations are
layout or measurement and are not ported. ``free_epoch`` runs the
hand-written CUDA kernel (``csrc/free_cells.cu``, one launch per epoch) on
CUDA tensors, on its tile walk (``ops/tile_walk.py``: units of columns on
one user tile, one thread-block cluster each, ordered by ready counters
per tile), and the plain PyTorch version ``free_epoch_reference`` on CPU
tensors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from tpu_mf_torch.data.coo import RatingsCOO
from tpu_mf_torch.ops import _build
from tpu_mf_torch.ops.plan_cache import cached_build
from tpu_mf_torch.ops.rows import cdiv, row_lanes
from tpu_mf_torch.ops.sgd_cells import (
    GROUPS,
    WORK,
    CellPlan,
    WindowRunner,
    _apply_flags,
    balance_cells,
    window_apply,
)
from tpu_mf_torch.ops.tile_walk import (
    DeviceWalk,
    TileWalkCounters,
    plan_tile_walk,
    upload_walk,
    walk_launch,
)


class FreePlan(NamedTuple):
    """Epoch layout of the free-column family; the fields of ``tpu_mf``'s
    FreePlan, so the two packages share cached plans."""

    u: np.ndarray    # (NB, B/8, 8) int32 tile-local user ids; tile_u = pad
    v: np.ndarray    # (NB, B/8, 8) int32 tile-local item ids; tile_v = pad
    r: np.ndarray    # (NB, B/8, 8) float32
    w: np.ndarray    # (NB, B/8, 8) float32 {0, 1}
    gu: np.ndarray   # (NB, 8) int32 user tile per column
    gv: np.ndarray   # (NB, 8) int32 item tile per column
    tile_u: int
    tile_v: int
    n_gu: int
    n_gv: int
    n_real: int


def prepare_cells_free(ds: RatingsCOO, tile_u: int = 128, tile_v: int = 128,
                       batch_size: int = 2048, seed: int = 0) -> FreePlan:
    """Disk-cached plan build (``ops/plan_cache.py``)."""
    return cached_build(
        "freecell", FreePlan, ds, seed, (tile_u, tile_v, batch_size),
        lambda: _prepare_cells_free_impl(ds, tile_u, tile_v, batch_size,
                                         seed),
    )


def _prepare_cells_free_impl(ds: RatingsCOO, tile_u: int, tile_v: int,
                             batch_size: int, seed: int) -> FreePlan:
    """Bin shuffled ratings into cells, pad each cell to whole sub-batches
    (B/8) and deal the sub-batches, in cell order, into (batch, column)
    slots. Each rating's slot comes from cumsum arithmetic and one flat
    scatter fills the plan."""
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
    sb_total = int(sb_per_cell.sum())
    nb = max(1, cdiv(sb_total, 8))

    U = np.full((nb, sub, 8), tile_u, np.int32)  # sentinel = padded
    V = np.full((nb, sub, 8), tile_v, np.int32)
    R = np.zeros((nb, sub, 8), np.float32)
    W = np.zeros((nb, sub, 8), np.float32)
    GU = np.zeros((nb, 8), np.int32)
    GV = np.zeros((nb, 8), np.int32)

    src = np.concatenate([[0], np.cumsum(counts)])
    sb_cs = np.concatenate([[0], np.cumsum(sb_per_cell)])
    sb_cell = np.repeat(np.arange(n_gu * n_gv, dtype=np.int64), sb_per_cell)
    GU.reshape(-1)[:sb_total] = (sb_cell // n_gv).astype(np.int32)
    GV.reshape(-1)[:sb_total] = (sb_cell % n_gv).astype(np.int32)

    l = np.arange(len(u), dtype=np.int64) - src[cell]      # index in cell
    sb = sb_cs[cell] + l // sub                            # global sub-batch
    flat = ((sb // 8) * sub + l % sub) * 8 + sb % 8
    U.reshape(-1)[flat] = (u % tile_u).astype(np.int32)
    V.reshape(-1)[flat] = (v % tile_v).astype(np.int32)
    R.reshape(-1)[flat] = r
    W.reshape(-1)[flat] = 1.0
    return FreePlan(u=U, v=V, r=R, w=W, gu=GU, gv=GV, tile_u=tile_u,
                    tile_v=tile_v, n_gu=n_gu, n_gv=n_gv, n_real=len(ds))


def pick_free_geometry(ds: RatingsCOO, tile_u: int = 128, tile_v: int = 128
                       ) -> Tuple[int, int, int]:
    """(tile_u, tile_v, batch) of the free-column plan, by ``tpu_mf``'s fill
    model: per-cell padding to sub ~ 1.12 x the mean cell, against a
    per-column fixed cost."""
    n_gu = cdiv(ds.nu, tile_u)
    n_gv = cdiv(ds.nv, tile_v)
    c = len(ds) / (n_gu * n_gv)
    best, best_score = 256, -1.0
    for sub in (128, 256, 384, 512, 640, 768, 896, 1024):
        blocks = max(1, cdiv(int(c * 1.12), sub))
        score = c / (blocks * sub) / (1.0 + 94.0 / sub)
        if score > best_score:
            best_score, best = score, sub
    return tile_u, tile_v, 8 * best


def free_eligible(nu: int, nv: int, dim: int,
                  budget: int = 90 * 1024 * 1024) -> bool:
    """``tpu_mf``'s rule for the free-column kernel: dim <= 253 and both
    tables and both scratches within a 90 MiB VMEM budget. A TPU residency
    rule, kept so that both packages answer alike; it bounds nothing in
    ``csrc/free_cells.cu``."""
    if dim > 253:
        return False
    rows = cdiv(nu, 128) * 128 + cdiv(nv, 128) * 128
    return 2 * rows * row_lanes(dim) * 4 <= budget


def _global_dup_stats(ids: np.ndarray, g: np.ndarray, tile: int,
                      n_tiles: int) -> dict:
    """{groups: max count of one global row id g * tile + id inside one
    window of 8 // groups columns} over a free plan's (NB, B/8, 8) ids
    (with per-column tiles, tile-local ids of two columns may name
    different rows); padded slots (id >= tile) are not counted.

    ``tpu_mf`` counts with ``_dup_stats``, a dense count per column and
    row; here one sort of the real slots' (batch, row, column) keys gives
    the same numbers as run lengths, without the table-sized counts."""
    real = ids < tile
    nb = ids.shape[0]
    b = np.broadcast_to(np.arange(nb, dtype=np.int64)[:, None, None],
                        ids.shape)[real]
    c = np.broadcast_to(np.arange(8, dtype=np.int64), ids.shape)[real]
    row = (g[:, None, :].astype(np.int64) * tile + ids)[real]
    key = np.sort((b * (n_tiles * tile) + row) * 8 + c)
    out = {}
    for groups in GROUPS:
        # (batch, row, window) labels, non-decreasing along the sorted keys
        lab = key // 8 * groups + key % 8 // (8 // groups)
        ends = np.flatnonzero(np.diff(lab))
        runs = np.diff(np.concatenate([[-1], ends, [lab.size - 1]]))
        out[groups] = int(runs.max(initial=0))
    return out


def free_window_plan(plan: FreePlan) -> CellPlan:
    """The same epoch as a gen-1 window plan: one user "tile" that spans the
    padded user table, with global user ids, and the plan's item tiles.
    Exact, since an apply leaves untouched rows (k = 0) as they are; but
    every theta-group end then applies the whole user table. A cross-check
    of the semantics and a yardstick for ``csrc/free_cells.cu``."""
    rows = plan.n_gu * plan.tile_u
    real = plan.w > 0
    u = np.where(real, plan.gu[:, None, :] * plan.tile_u + plan.u, rows)
    return CellPlan(u=u.astype(np.int32), v=plan.v, r=plan.r, w=plan.w,
                    gu=np.zeros(plan.u.shape[0], np.int32), gv=plan.gv,
                    tile_u=rows, tile_v=plan.tile_v, n_gu=1, n_gv=plan.n_gv,
                    n_real=plan.n_real)


# ---- the epoch --------------------------------------------------------------

class FreeDevicePlan(NamedTuple):
    """One FreePlan on a device, columns contiguous: slot s of column k of
    batch i is element [i, k, s]. ``ap_u_host`` / ``ap_v_host`` hold each
    side's apply flags per grouping, and with the host tiles drive the
    plain version's loop without device reads. ``walk`` is the plan's tile
    walk, with the kernel's own flags."""

    u: torch.Tensor    # (NB, 8, B/8) int32 tile-local ids, sentinel tile_u
    v: torch.Tensor    # (NB, 8, B/8) int32
    r: torch.Tensor    # (NB, 8, B/8) float32
    w: torch.Tensor    # (NB, 8, B/8) float32 {0, 1}
    gu: torch.Tensor   # (NB, 8) int32
    gv: torch.Tensor   # (NB, 8) int32
    gu_host: np.ndarray
    gv_host: np.ndarray
    ap_u_host: dict    # {groups_u: (NB, 8) int32 user-side apply flags}
    ap_v_host: dict    # {groups_v: (NB, 8) int32 item-side apply flags}
    tile_u: int
    tile_v: int
    n_gu: int
    n_gv: int
    walk: DeviceWalk


def free_flags(g: np.ndarray) -> dict:
    """{groups: (NB, 8) int32}: 1 where a column is the last of its window
    to touch its tile, every column at 8 groups; sentinel columns
    included."""
    flags = {k: _apply_flags(g, k) for k in (1, 2, 4)}
    flags[8] = np.ones_like(g, np.int32)
    return flags


def upload_free_plan(plan: FreePlan, device: torch.device | str,
                     counters: TileWalkCounters | None = None
                     ) -> FreeDevicePlan:
    """The plan on ``device``, with its tile walk (at one column a window,
    the 8/8 groups) on ``counters`` (new ones by default; a runner's plans
    share one set)."""
    def cols(a):
        return torch.as_tensor(a).to(device).transpose(1, 2).contiguous()

    if counters is None:
        counters = TileWalkCounters(plan.n_gv, plan.n_gu, device)
    walk = upload_walk(plan_tile_walk(plan, 0, plan.gu.shape[0]), counters,
                       free_rows=plan.tile_u + plan.tile_v)
    return FreeDevicePlan(
        u=cols(plan.u), v=cols(plan.v), r=cols(plan.r), w=cols(plan.w),
        gu=torch.as_tensor(plan.gu).to(device),
        gv=torch.as_tensor(plan.gv).to(device), gu_host=plan.gu,
        gv_host=plan.gv, ap_u_host=free_flags(plan.gu),
        ap_v_host=free_flags(plan.gv), tile_u=plan.tile_u,
        tile_v=plan.tile_v, n_gu=plan.n_gu, n_gv=plan.n_gv, walk=walk,
    )


class FreeStep(NamedTuple):
    """What the plain version's window steps share: the working type, the
    hyperparameters on the tables' device, the apply and the count lane."""

    work: torch.dtype
    mxu_pred: bool
    eta: torch.Tensor
    gb: torch.Tensor
    apply: object      # window_apply(...)
    cnt: torch.Tensor  # 1 at the count lane

    @classmethod
    def of(cls, theta, eta, lam, gb, cap, dim, work, saturate, mxu_pred):
        f32, dev, lanes = torch.float32, theta.device, theta.shape[1]
        eta_t, lam_t, gb_t, cap_t = torch.tensor([eta, lam, gb, cap],
                                                 dtype=f32, device=dev)
        return cls(work, mxu_pred, eta_t, gb_t,
                   window_apply(eta_t, lam_t, cap_t, lanes, dim, saturate),
                   (torch.arange(lanes, device=dev) == dim + 2).to(f32))

    def scatter(self, theta, phi, acc_u, acc_v, plan: FreeDevicePlan,
                i: int, c0: int, c1: int) -> None:
        """Columns [c0, c1) of batch i at once: gather both rows of every
        slot from the tables, predict, and add the deltas and counts into
        the scratches. Rows, t*p (``mxu_pred``) and the scatter operands
        are rounded to the working type where the TPU kernel rounds them;
        every sum is float32."""
        lanes = theta.shape[1]
        w = plan.w[i, c0:c1]
        real = w > 0  # padded slots: their column's row 0, weight 0
        ul = (torch.where(real, plan.u[i, c0:c1], 0).long()
              + plan.gu[i, c0:c1].long().unsqueeze(-1) * plan.tile_u)
        vl = (torch.where(real, plan.v[i, c0:c1], 0).long()
              + plan.gv[i, c0:c1].long().unsqueeze(-1) * plan.tile_v)
        t = self.rnd(theta[ul])                   # (c1 - c0, B/8, lanes)
        p = self.rnd(phi[vl])
        tp = self.rnd(t * p) if self.mxu_pred else t * p
        pred = tp.sum(-1, keepdim=True) + self.gb
        wk = w.unsqueeze(-1)
        err = (self.eta * wk) * (plan.r[i, c0:c1].unsqueeze(-1) - pred)
        acc_u.index_add_(0, ul.reshape(-1),
                         self.rnd(err * p + wk * self.cnt).reshape(-1, lanes))
        acc_v.index_add_(0, vl.reshape(-1),
                         self.rnd(err * t + wk * self.cnt).reshape(-1, lanes))

    def apply_tile(self, tab, acc, g: int, tile: int, side: int) -> None:
        """Tile g of a table (side 0 theta, 1 phi) takes its deltas from
        ``acc``, which are cleared."""
        rows = slice(g * tile, (g + 1) * tile)
        tab[rows] = self.apply(tab[rows], acc[rows], side)
        acc[rows] = 0.0

    def rnd(self, x):
        return x if self.work == torch.float32 else x.to(self.work).float()


def free_epoch_reference(theta: torch.Tensor, phi: torch.Tensor,
                         plan: FreeDevicePlan, eta: float, lam: float,
                         gb: float, cap: float, dim: int, groups_u: int,
                         groups_v: int, work: torch.dtype = torch.float32,
                         saturate: bool = True, mxu_pred: bool = True) -> None:
    """Plain PyTorch free-column epoch, in place on the fused tables.

    Gathers and ``index_add_`` per window step (the columns between two
    window ends of either side run at once, ``FreeStep.scatter``); at a
    window's end each flagged tile applies from its side's scratch."""
    fs = FreeStep.of(theta, eta, lam, gb, cap, dim, work, saturate,
                     mxu_pred)
    acc_u, acc_v = torch.zeros_like(theta), torch.zeros_like(phi)
    sides = ((0, 8 // groups_u, theta, acc_u, plan.gu_host, plan.tile_u,
              plan.ap_u_host[groups_u]),
             (1, 8 // groups_v, phi, acc_v, plan.gv_host, plan.tile_v,
              plan.ap_v_host[groups_v]))
    step = min(8 // groups_u, 8 // groups_v)
    for i in range(plan.u.shape[0]):
        for c0 in range(0, 8, step):
            c1 = c0 + step
            fs.scatter(theta, phi, acc_u, acc_v, plan, i, c0, c1)
            for side, win, tab, acc, g, tile, ap in sides:
                if c1 % win:
                    continue
                for c in range(c1 - win, c1):
                    if ap[i, c]:
                        fs.apply_tile(tab, acc, int(g[i, c]), tile, side)


def _free_lib() -> ctypes.CDLL:
    return bind_free_lib(_build.load("free_cells"))


def bind_free_lib(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``, a build of ``csrc/free_cells.cu``, with its entry points'
    argument types set."""
    fn = lib.tmf_free_walk
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
                   + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    fn = lib.tmf_free_walk_clusters
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return lib


def check_free_launch(theta: torch.Tensor, phi: torch.Tensor,
                      plan: FreeDevicePlan, groups_u: int, groups_v: int,
                      dim: int, work: torch.dtype) -> None:
    """Raise ValueError unless the groups, the working type, the tables,
    the plan (the tiles the plain version reads too) and its walk's apply
    flags are what ``csrc/free_cells.cu`` takes: contiguous, of the right
    type and shape, on theta's device, the tables of the plan's tiles."""
    if groups_u not in GROUPS or groups_v not in GROUPS:
        raise ValueError(f"free_epoch: groups must divide the 8 columns, got "
                         f"{groups_u}/{groups_v}")
    if work not in WORK:
        raise ValueError(f"free_epoch: unsupported working type {work}")
    nb, cols, sub = plan.u.shape
    for name, t, dtype, shape in (
            ("theta", theta, torch.float32, None),
            ("phi", phi, torch.float32, None),
            ("u", plan.u, torch.int32, (nb, 8, sub)),
            ("v", plan.v, torch.int32, (nb, 8, sub)),
            ("r", plan.r, torch.float32, (nb, 8, sub)),
            ("w", plan.w, torch.float32, (nb, 8, sub)),
            ("gu", plan.gu, torch.int32, (nb, 8)),
            ("gv", plan.gv, torch.int32, (nb, 8)),
            ("tap_u", plan.walk.tap_u[groups_u], torch.int32, (nb, 8)),
            ("tap", plan.walk.tap[groups_v], torch.int32, (nb, 8))):
        if (t.device != theta.device or not t.is_contiguous()
                or t.dtype != dtype or (shape and t.shape != shape)):
            raise ValueError(f"free_epoch: {name} must be a contiguous "
                             f"{dtype} tensor of shape {shape} on "
                             f"{theta.device}")
    if (cols != 8 or theta.dim() != 2 or phi.dim() != 2
            or theta.shape[0] != plan.n_gu * plan.tile_u
            or phi.shape[0] != plan.n_gv * plan.tile_v
            or phi.shape[1] != theta.shape[1] or dim + 3 > theta.shape[1]):
        raise ValueError("free_epoch: table or plan shapes do not match")


def free_epoch(theta: torch.Tensor, phi: torch.Tensor, plan: FreeDevicePlan,
               eta: float, lam: float, gb: float, cap: float, dim: int,
               groups_u: int, groups_v: int,
               work: torch.dtype = torch.bfloat16, saturate: bool = True,
               mxu_pred: bool = True) -> None:
    """One free-column epoch, in place on the fused (theta_ext, phi_ext).

    CPU tensors take the plain version; CUDA tensors launch the
    ``csrc/free_cells.cu`` kernel on the plan's tile walk (one launch per
    epoch) or raise."""
    check_free_launch(theta, phi, plan, groups_u, groups_v, dim, work)
    if theta.device.type == "cpu":
        free_epoch_reference(theta, phi, plan, eta, lam, gb, cap, dim,
                             groups_u, groups_v, work, saturate, mxu_pred)
        return
    if theta.device.type != "cuda":
        raise ValueError(f"free_epoch: no kernel for device {theta.device}")
    nb, _, sub = plan.u.shape
    lanes = theta.shape[1]
    acc_v = torch.zeros_like(phi)
    lib = _free_lib()
    dw = plan.walk
    with torch.cuda.device(theta.device):
        stream = torch.cuda.current_stream().cuda_stream
        launch, d_theta = walk_launch(  # d_theta: held through the launch
            dw, 0, nb, groups_v, ("free", WORK[work], int(mxu_pred)),
            lambda c, out: lib.tmf_free_walk_clusters(
                WORK[work], int(mxu_pred), c, out),
            plan.tile_u, lanes, theta.device)
        rc = lib.tmf_free_walk(
            theta.data_ptr(), phi.data_ptr(), plan.u.data_ptr(),
            plan.v.data_ptr(), plan.r.data_ptr(), plan.w.data_ptr(),
            dw.tap_u[groups_u].data_ptr(), dw.tap[groups_v].data_ptr(),
            acc_v.data_ptr(), sub, plan.tile_u, plan.tile_v, lanes, dim,
            groups_u, groups_v, WORK[work], int(mxu_pred), int(saturate),
            eta, lam, gb, cap, ctypes.addressof(launch), stream)
    if rc != 0:
        raise RuntimeError(f"free_cells kernel launch failed: CUDA error {rc}")
    dw.counters.advance(launch.n_units, launch.n_clusters)
    free_epoch.launches += 1


free_epoch.launches = 0  # kernel launches (CUDA calls), not CPU runs


class FreeEpochRunner(WindowRunner):
    """Free-column plans on a device and epochs over them (``pad`` /
    ``epoch`` / ``trim``), as ``tpu_mf``'s FreeEpochRunner:

    - tiles 128 x 128; ``batch`` None picks ``pick_free_geometry``'s;
    - ``balance`` (default on) relabels ids to even out per-tile loads;
    - ``saturate`` (default on) caps a row's window step at min(1, cap/k);
    - ``groups_u`` / ``groups_v`` None: each side picked per epoch from eta
      and the plans' window duplicates of global ids (``_global_dup_stats``);
    - ``mxu_pred`` (default on) rounds t*p before the row sum;
    - ``n_plans`` > 1 rotates plans of seeds seed + 7919 p;
    - each plan's tile walk is built at ``materialize`` on one set of
      counters (``TileWalkCounters``), and every epoch on the card runs
      on it.

    The TPU's ``interpret`` and ``ablate`` options are not taken."""

    kind = "free"
    launches = 0

    def __init__(self, ds: RatingsCOO, tile_u: int = 128, tile_v: int = 128,
                 batch: int | None = None, seed: int = 0,
                 mxu: str = "bfloat16", n_plans: int = 1,
                 balance: bool = True, saturate: bool = True,
                 groups_u: int | None = None, groups_v: int | None = None,
                 mxu_pred: bool = True, device: torch.device | str = "cuda"):
        if batch is None:
            batch = pick_free_geometry(ds, tile_u, tile_v)[2]
        self.batch = batch = cdiv(batch, 8) * 8
        nu, nv = ds.nu, ds.nv
        map_u = map_v = None
        if balance:
            ds, map_u, map_v = balance_cells(ds, tile_u, tile_v)
        plans = [prepare_cells_free(ds, tile_u, tile_v, batch,
                                    seed + 7919 * p)
                 for p in range(max(1, n_plans))]
        super().__init__(plans, nu, nv, mxu, groups_u, groups_v, saturate,
                         device, map_u=map_u, map_v=map_v)
        self._mxu_pred = self.mxu_pred = mxu_pred
        self._counters: TileWalkCounters | None = None

    def _dups(self, plan, side: str) -> dict:
        if side == "u":
            return _global_dup_stats(plan.u, plan.gu, plan.tile_u, plan.n_gu)
        return _global_dup_stats(plan.v, plan.gv, plan.tile_v, plan.n_gv)

    def materialize(self) -> "FreeEpochRunner":
        """Upload the plans and their tile walks, which share one set of
        counters on the runner's device (once)."""
        if not self._dev:
            p = self.plans[0]
            self._counters = TileWalkCounters(p.n_gv, p.n_gu, self.device)
            self._dev = [upload_free_plan(q, self.device, self._counters)
                         for q in self.plans]
        return self

    def route(self, epoch_idx: int = 0) -> str:
        """The walk the kernel takes on plan ``epoch_idx``: the tile walk,
        its only one."""
        return "tile"

    def epoch(self, tables, eta: float, lam: float, gb: float,
              epoch_idx: int = 0):
        """One epoch, in place on the fused tables; returns them."""
        cap = max(1.0, 0.2 / max(eta, 1e-9))
        plan = self.materialize()._dev[epoch_idx % len(self._dev)]
        launched = free_epoch.launches
        free_epoch(tables[0], tables[1], plan, eta, lam, gb, cap, self.dim,
                   self.pick_theta_groups(eta), self.pick_phi_groups(eta),
                   self.work_dtype, self.saturate, self.mxu_pred)
        type(self).launches += free_epoch.launches - launched
        return tables

    def pad(self, params):
        tables = super().pad(params)
        self.mxu_pred = self._mxu_pred  # kept at every row width, as on the TPU
        return tables
