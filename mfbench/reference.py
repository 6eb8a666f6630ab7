"""The plain reference of the benchmark's MF cells: biased matrix
factorization trained by SGD, in plain PyTorch, from the ratings and the
initial tables the harness made. It imports nothing of the program.

Per rating (the reference trainer's inner loop, src/mf.h:72-133):

    err     = eta * (r - theta_u . phi_v - bu_u - bv_v - gb)
    theta_u <- (1 - eta*lam) theta_u + err phi_v,  bu_u <- ... + err
    phi_v   <- (1 - eta*lam) phi_v   + err theta_u, bv_v <- ... + err

taken in windows: every rating of a window sees the rows as the window
found them; a row hit k times in a window decays by (1 - eta*lam)^k and
takes the sum of its k steps, scaled by min(1, cap/k) with cap =
max(1, 0.2/eta) (saturation). Which ratings share a window, and in which
order windows run, is the update order. The reference works it out again
from the ratings and the run's seed, by the rules the program's routes
state (the dense-cell route, the gen-1 cell plans, the item-sharded
epochs), and takes nothing the program built.

Rows are held fused, as the routes hold them: a user row [theta | bu | 1]
and an item row [phi | 1 | bv], so that the dot product of the two is
theta . phi + bu + bv. ``work`` is the working type the configuration
states for operands (bfloat16: rows and, on the window routes, products
rounded to it before float32 sums); ``storage`` the type the tables are
kept in after each apply (float32, or a lower type for the control).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def row_lanes(dim: int) -> int:
    """Lanes of a fused row on the routes: (dim + 3) in groups of 128."""
    return cdiv(dim + 3, 128) * 128


# ---- routes: which update order the program's schedule picks -------------

def dense_tiles(nu: int, nv: int) -> tuple[int, int]:
    """Dense-cell tile sizes: 256x256 at ML-10M scale and above."""
    tu = min(256, max(64, cdiv(cdiv(nu, 8), 8) * 8))
    tv = min(256, max(128, cdiv(cdiv(nv, 8), 128) * 128))
    return tu, tv


def route(nu: int, nv: int, dim: int, u: np.ndarray, v: np.ndarray,
          eta_at, use_dense: bool, epochs: int) -> list:
    """The routes the program's schedule runs for ``epochs`` epochs, as
    [(first epoch, route)]: "sharded" where the fused item table passes
    64 MiB; "dense" where the dense cells fit 8 GiB, from the first epoch
    whose eta clears the dense window bound (eta * max k <= 5.5 and
    eta * mean k <= 0.25, k a row's ratings in one cell); "cells" (gen-1
    plans, at dim >= 63) before it, or throughout."""
    lanes = row_lanes(dim)
    if cdiv(nv, 512) * 512 * lanes * 4 > 64 * 1024 * 1024:
        return [(1, "sharded")]
    phases = [(1, "cells")]
    if use_dense:
        tu, tv = dense_tiles(nu, nv)
        pu, pv = cdiv(nu, tu) * tu, cdiv(nv, tv) * tv
        if 4 * pu * pv * 2 <= 8 * 1024 ** 3 and pv * lanes * 4 <= 64 << 20:
            n_gu, n_gv = cdiv(nu, tu), cdiv(nv, tv)
            ku = np.bincount(u.astype(np.int64) * n_gv + v // tv)
            kv = np.bincount(v.astype(np.int64) * n_gu + u // tu)
            max_k = max(int(ku.max()), int(kv.max()))
            mean_k = max(len(u) / max(1, int((ku > 0).sum())),
                         len(u) / max(1, int((kv > 0).sum())))
            bound = 5.5 if dim >= 16 else 1.8
            for e in range(1, epochs + 1):
                if eta_at(e) * max_k <= bound and eta_at(e) * mean_k <= 0.25:
                    if e == 1:
                        return [(1, "dense")]
                    phases.append((e, "dense"))
                    break
    if dim < 63:
        raise NotImplementedError("the reference follows gen-1 plans only "
                                  "at dim >= 63 (no packed or slot plans)")
    return phases


def describe(phases: list) -> str:
    """"dense@1", "cells@1,dense@2", ..."""
    return ",".join(f"{name}@{e}" for e, name in phases)


def balance_map(counts: np.ndarray, tile: int) -> np.ndarray:
    """New-of-old row labels that deal rows, heaviest first, across the
    tiles in snake order (the routes' load balancing)."""
    n = counts.size
    n_tiles = cdiv(n, tile)
    order = np.argsort(-counts, kind="stable")
    rnd, c = divmod(np.arange(n, dtype=np.int64), n_tiles)
    tile_of = np.where(rnd % 2 == 0, c, n_tiles - 1 - c)
    out = np.empty(n, np.int64)
    out[order] = tile_of * tile + rnd
    return out


def cell_geometry(nu: int, nv: int, n: int) -> tuple[int, int, int]:
    """(tile_u, tile_v, sub) of the gen-1 plans: user tiles of 256, the
    item tile and the window (sub-batch) that fill cells best."""
    tile_u = 256
    n_gu = cdiv(nu, tile_u)
    best, best_score = (tile_u, 256, 1024), -1.0
    for tv in range(128, 385, 8):
        n_gv = cdiv(nv, tv)
        gloss = n_gv / (cdiv(n_gv, 8) * 8)
        c = n / (n_gu * n_gv)
        for sub in (512, 640, 768, 896, 1024):
            blocks = max(1, cdiv(int(c * 1.12), sub))
            score = c / (blocks * sub) * gloss / (1.0 + 94.0 / sub)
            if score > best_score:
                best_score, best = score, (tile_u, tv, sub)
    return best


def large_geometry(nu: int, nv: int, n: int) -> tuple[int, int, int]:
    """(tile_u, tile_v, sub) of the item-sharded plans."""
    best, best_score = (1024, 1024, 512), -1.0
    for tu in (512, 1024, 2048, 4096):
        n_gu = cdiv(nu, tu)
        for tv in (256, 512, 1024, 1536, 2040):
            n_gv = cdiv(nv, tv)
            gloss = n_gv / (cdiv(n_gv, 8) * 8)
            c = n / (n_gu * n_gv)
            for sub in (512, 768, 1024):
                if 4 * sub * (tu + tv) * 2 > 48 * 1024 * 1024:
                    continue
                blocks = max(1, cdiv(int(c * 1.12), sub))
                score = (c / (blocks * sub) * gloss
                         / ((tu + tv) / 768.0 * (1.0 + 94.0 / sub)))
                if score > best_score:
                    best_score, best = score, (tu, tv, sub)
    return best


def shard_tiles(nv: int, tile_v: int, dim: int) -> tuple[int, int]:
    """(item tiles per shard, shards): the fewest shards whose fused item
    rows fit 36 MiB, the tiles spread evenly."""
    tiles_total = cdiv(nv, tile_v)
    rows_budget = max(tile_v, (36 << 20) // (row_lanes(dim) * 4))
    tiles_fit = max(1, rows_budget // tile_v)
    per = cdiv(tiles_total, cdiv(tiles_total, tiles_fit))
    return per, cdiv(tiles_total, per)


# ---- update orders ---------------------------------------------------------
#
# A route's epoch is a sequence of batches. A batch belongs to one user
# tile and holds up to 8 columns; a column holds ratings of one cell (one
# user tile, one item tile). Within a batch, a user row's steps collect
# over windows of 8 / theta_groups columns and an item row's over windows
# of 8 / phi_groups columns, all computed at the rows as the window found
# them, and are applied at the window's end. Batches run in order.
#
# The reference runs the same windows in levels: a unit (the columns that
# share both windows' state) gets the first level at which the user tile
# and the item tiles it reads hold every earlier apply in program order,
# and a window's apply takes place at the last level of its units. Units
# of one level touch no row another unit of that level applies, so they
# run at once, and the result is that of program order.

GROUPS = (1, 2, 4, 8)


@dataclass
class Plan:
    """One epoch's batches in program order, on the device."""

    u: torch.Tensor            # int64 fused user row per entry
    v: torch.Tensor            # int64 fused item row per entry
    s: torch.Tensor            # float32 rating (dense: a pair's sum)
    w: torch.Tensor            # float32 count (1 a rating; dense: a pair's)
    batch: torch.Tensor        # int64 batch of each entry
    col: torch.Tensor          # int64 column of each entry (0-7)
    batch_g: np.ndarray        # user tile of each batch
    tiles: np.ndarray          # (batches, 8) item tile of each column, -1
    tile_u: int
    tile_v: int
    dups_u: dict | None        # {groups: most hits of one id in a window}
    dups_v: dict | None
    _levels: dict = None

    def levels(self, tg_w: int, pg_w: int) -> "Levels":
        if self._levels is None:
            self._levels = {}
        if (tg_w, pg_w) not in self._levels:
            self._levels[tg_w, pg_w] = _level(self, tg_w, pg_w)
        return self._levels[tg_w, pg_w]


@dataclass
class Levels:
    """A plan run in levels at one grouping: entries of level L at
    ``at[L]:at[L + 1]`` (of ``u``, ``v``, ``s``, ``w``), and the user and
    item rows whose windows apply at its end (``th``, ``ph`` at ``th_at``,
    ``ph_at``)."""

    u: torch.Tensor
    v: torch.Tensor
    s: torch.Tensor
    w: torch.Tensor
    at: np.ndarray
    th: torch.Tensor
    th_at: np.ndarray
    ph: torch.Tensor
    ph_at: np.ndarray


def _level(p: Plan, tg_w: int, pg_w: int) -> Levels:
    step = min(tg_w, pg_w)
    nb = len(p.batch_g)
    n_units = 8 // step
    unit_level = np.zeros((nb, n_units), np.int64)
    th_ready: dict = {}
    ph_ready: dict = {}
    th_apply: dict = {}
    ph_apply: dict = {}
    for b in range(nb):
        g = int(p.batch_g[b])
        t_max, p_max, p_tiles = -1, -1, set()
        for k in range(n_units):
            c0, c1 = k * step, (k + 1) * step
            ts = [int(t) for t in p.tiles[b, c0:c1] if t >= 0]
            if ts:
                lv = th_ready.get(g, 0)
                for t in ts:
                    lv = max(lv, ph_ready.get(t, 0))
                unit_level[b, k] = lv
                t_max, p_max = max(t_max, lv), max(p_max, lv)
                p_tiles.update(ts)
            if c1 % pg_w == 0:
                if p_tiles:
                    ph_apply.setdefault(p_max, []).extend(p_tiles)
                    for t in p_tiles:
                        ph_ready[t] = p_max + 1
                p_tiles, p_max = set(), -1
            if c1 % tg_w == 0:
                if t_max >= 0:
                    th_apply.setdefault(t_max, []).append(g)
                    th_ready[g] = t_max + 1
                t_max = -1
    n_lv = 1 + max(list(th_apply) + list(ph_apply))
    dev = p.u.device
    lv = torch.as_tensor(unit_level, device=dev)[p.batch, p.col // step]
    o = torch.sort(lv, stable=True).indices
    per = torch.bincount(lv, minlength=n_lv).cpu().numpy()
    at = np.concatenate([[0], np.cumsum(per)]).astype(np.int64)

    def rows(apply, tile):
        lists = [apply.get(i, []) for i in range(n_lv)]
        counts = np.array([len(x) for x in lists], np.int64) * tile
        flat = np.array([t for x in lists for t in x], np.int64)
        idx = (torch.as_tensor(flat, device=dev)[:, None] * tile
               + torch.arange(tile, device=dev)).reshape(-1)
        return idx, np.concatenate([[0], np.cumsum(counts)])

    th, th_at = rows(th_apply, p.tile_u)
    ph, ph_at = rows(ph_apply, p.tile_v)
    return Levels(p.u[o], p.v[o], p.s[o], p.w[o], at, th, th_at, ph, ph_at)


def _plan(u, v, s, w, batch, col, batch_g, tile_u, tile_v,
          dups: bool) -> Plan:
    """The plan of entries in program order (``batch``, ``col``)."""
    nb = len(batch_g)
    tiles = np.full((nb, 8), -1, np.int64)
    tiles[batch.cpu().numpy(), col.cpu().numpy()] = (v // tile_v).cpu().numpy()
    du = dv = None
    if dups:
        du = _dups(batch, col, u % tile_u, tile_u)
        dv = _dups(batch, col, v % tile_v, tile_v)
    return Plan(u, v, s, w, batch, col, batch_g, tiles, tile_u, tile_v, du,
                dv)


def _dups(batch, col, local, tile) -> dict:
    """{groups: the most times one tile-local id occurs in one window of
    8 / groups columns of a batch}."""
    out = {}
    for g in GROUPS:
        win = (batch * 8 + col) // (8 // g)
        out[g] = int(torch.unique(win * tile + local,
                                  return_counts=True)[1].max())
    return out


def pick_groups(dups: dict, eta: float) -> int:
    """The most parallel grouping whose windows keep eta * (most hits of
    one id) within 0.2; else the most sequential."""
    for g in GROUPS:
        if eta * dups[g] <= 0.2:
            return g
    return 8


def dense_plan(u, v, r, nu, nv) -> Plan:
    """The dense-cell route: each cell of tu x tv one batch of one column
    (one window), cells in row-major order; each (user, item) pair once,
    its ratings summed and counted."""
    tu, tv = dense_tiles(nu, nv)
    n_gv = cdiv(nv, tv)
    keys, inv = torch.unique(u * nv + v, return_inverse=True)
    s = torch.zeros(keys.numel(), dtype=torch.float32, device=u.device)
    s.index_add_(0, inv, r)
    w = torch.bincount(inv, minlength=keys.numel()).to(torch.float32)
    pu, pv = keys // nv, keys % nv
    cell = (pu // tu) * n_gv + pv // tv
    cells, batch = torch.unique(cell, return_inverse=True)
    return _plan(pu, pv, s, w, batch, torch.zeros_like(batch),
                 (cells // n_gv).cpu().numpy(), tu, tv, dups=False)


def cell_plan(ub, vb, r, tu, tv, sub, seed) -> Plan:
    """Gen-1 batches of one rating set on balanced labels: the ratings in
    the order of a seeded permutation, grouped by cell (stable) in
    row-major order, each cell cut into columns of ``sub``; a user tile's
    columns fill batches of 8 in turn."""
    n = ub.numel()
    dev = ub.device
    perm = torch.as_tensor(np.random.default_rng(seed).permutation(n),
                           device=dev)
    ub, vb, r = ub[perm], vb[perm], r[perm]
    n_gv = int(vb.max()) // tv + 1
    cell = (ub // tu) * n_gv + vb // tv
    o = torch.sort(cell, stable=True).indices
    ub, vb, r, cell = ub[o], vb[o], r[o], cell[o]
    n_gu = int(ub.max()) // tu + 1
    counts = torch.bincount(cell, minlength=n_gu * n_gv)
    first = torch.cumsum(counts, 0) - counts
    l = torch.arange(n, device=dev) - first[cell]
    cols = (counts + sub - 1) // sub                    # columns per cell
    cols_before = torch.cumsum(cols, 0) - cols
    g = cell // n_gv
    in_group = cols_before[cell] - cols_before[g * n_gv] + l // sub
    per_group = cols.view(n_gu, n_gv).sum(1)
    nb_group = torch.clamp((per_group + 7) // 8, min=1)
    base = torch.cumsum(nb_group, 0) - nb_group
    batch = base[g] + in_group // 8
    batch_g = torch.repeat_interleave(torch.arange(n_gu, device=dev),
                                      nb_group).cpu().numpy()
    return _plan(ub, vb, r, torch.ones_like(r), batch, in_group % 8,
                 batch_g, tu, tv, dups=True)


def _balanced(u, v, nu, nv, tu, tv):
    mu = balance_map(np.bincount(u.cpu().numpy(), minlength=nu), tu)
    mv = balance_map(np.bincount(v.cpu().numpy(), minlength=nv), tv)
    return (torch.as_tensor(mu, device=u.device)[u],
            torch.as_tensor(mv, device=u.device)[v], mu, mv)


def cells_plans(u, v, r, nu, nv, seed: int):
    """The gen-1 route: [[plan 0], [plan 1]] (one shard each), rows, maps."""
    tu, tv, sub = cell_geometry(nu, nv, u.numel())
    ub, vb, mu, mv = _balanced(u, v, nu, nv, tu, tv)
    plans = [[cell_plan(ub, vb, r, tu, tv, sub, seed + 7919 * p)]
             for p in (0, 1)]
    return plans, cdiv(nu, tu) * tu, cdiv(nv, tv) * tv, mu, mv


def sharded_plans(u, v, r, nu, nv, dim: int, seed: int):
    """The item-sharded route: labels balanced on both axes, the item
    labels cut into shards of whole tiles; each shard's ratings (in the
    given order) make gen-1 batches of their own seed, and an epoch runs
    the shards one after another."""
    tu, tv, sub = large_geometry(nu, nv, u.numel())
    per, n_shards = shard_tiles(cdiv(nv, tv) * tv, tv, dim)
    rows_s = per * tv
    ub, vb, mu, mv = _balanced(u, v, nu, nv, tu, tv)
    plans = [[], []]
    for k in range(n_shards):
        m = (vb >= k * rows_s) & (vb < (k + 1) * rows_s)
        if not bool(m.any()):
            continue
        for p in (0, 1):
            pl = cell_plan(ub[m], vb[m] - k * rows_s, r[m], tu, tv, sub,
                           seed + 101 * k + 7919 * p)
            pl.v += k * rows_s
            pl.tiles = pl.tiles + np.where(pl.tiles >= 0, k * per, 0)
            plans[p].append(pl)
    return plans, cdiv(nu, tu) * tu, n_shards * rows_s, mu, mv


# ---- epochs ----------------------------------------------------------------

class Trainer:
    """Fused tables and the epochs of one route over them.

    ``plans[p]`` is a list of shard plans that one epoch runs in turn;
    epoch e runs ``plans[e % len(plans)]``. Each shard picks its groups
    per epoch from the duplicate counts of its shard in every plan.
    ``map_u`` / ``map_v`` place id i at fused row ``map[i]``.
    ``drop_half``, a planted fault (``control.py``, the tests), leaves
    out the second half of each level's entries; setting ``groups`` to
    (theta, phi) fixes the groupings."""

    def __init__(self, tables: dict, plans: list, rows_u: int, rows_v: int,
                 mode: str, gb: float, work: str = "bfloat16",
                 storage: str = "float32", map_u=None, map_v=None,
                 drop_half: bool = False):
        theta, phi = tables["theta"], tables["phi"]
        dev = theta.device
        nu, d = theta.shape
        nv = phi.shape[0]
        self.dim = d = int(d)
        self.map_u = torch.as_tensor(
            np.arange(nu) if map_u is None else map_u, device=dev)
        self.map_v = torch.as_tensor(
            np.arange(nv) if map_v is None else map_v, device=dev)
        self.th = torch.zeros(rows_u, d + 2, device=dev)
        self.ph = torch.zeros(rows_v, d + 2, device=dev)
        self.th[self.map_u, :d] = theta.float()
        self.th[self.map_u, d] = tables["bu"].float()
        self.th[self.map_u, d + 1] = 1.0
        self.ph[self.map_v, :d] = phi.float()
        self.ph[self.map_v, d] = 1.0
        self.ph[self.map_v, d + 1] = tables["bv"].float()
        self.plans, self.mode, self.gb = plans, mode, float(gb)
        self.work, self.storage = DTYPES[work], DTYPES[storage]
        self.drop_half = drop_half
        self.groups = None
        self.used: dict = {}           # epoch: {(theta, phi groups)}
        self._store(slice(None), slice(None))
        lane = torch.arange(d + 2, device=dev)
        self.keep_u = (lane <= d).float()
        self.keep_v = ((lane < d) | (lane == d + 1)).float()
        self.du = torch.zeros(rows_u, d + 3, device=dev)  # deltas | count
        self.dv = torch.zeros(rows_v, d + 3, device=dev)
        # a shard's duplicate counts: the most over the plans it rotates
        self.dups = []
        for k in range(len(plans[0])):
            shard = [pl[k] for pl in plans]
            if shard[0].dups_u is None:
                self.dups.append(None)
            else:
                self.dups.append(tuple(
                    {g: max(getattr(p, side)[g] for p in shard)
                     for g in GROUPS} for side in ("dups_u", "dups_v")))

    def _rnd(self, x):
        return x if self.work == torch.float32 else x.to(self.work).float()

    def _store(self, ru, rv):
        if self.storage != torch.float32:
            self.th[ru] = self.th[ru].to(self.storage).float()
            self.ph[rv] = self.ph[rv].to(self.storage).float()

    def tables(self) -> dict:
        """float32 tables by original id."""
        d = self.dim
        th, ph = self.th[self.map_u], self.ph[self.map_v]
        return {"theta": th[:, :d].clone(), "phi": ph[:, :d].clone(),
                "bu": th[:, d].clone(), "bv": ph[:, d + 1].clone()}

    def epoch(self, e: int, eta: float, lam: float) -> None:
        """Epoch ``e`` (from 1) at step size ``eta``."""
        f32 = torch.float32
        dev = self.th.device
        eta_t, lam_t, gb_t = torch.tensor([eta, lam, self.gb], dtype=f32,
                                          device=dev)
        cap_t = torch.tensor(max(1.0, 0.2 / max(eta, 1e-9)), dtype=f32,
                             device=dev)
        consts = (eta_t, gb_t, cap_t, torch.log(1.0 - eta_t * lam_t))
        for k, plan in enumerate(self.plans[e % len(self.plans)]):
            if self.dups[k] is None:      # dense: a batch is one window
                tg = pg = 8
            elif self.groups is not None:
                tg, pg = self.groups
            else:
                tg = pick_groups(self.dups[k][0], eta)
                pg = pick_groups(self.dups[k][1], eta)
            self.used.setdefault(e, set()).add((tg, pg))
            self._shard(plan, 8 // tg, 8 // pg, consts)

    def _shard(self, plan: Plan, tg_w: int, pg_w: int, consts) -> None:
        eta_t, gb_t, cap_t, ln_decay = consts
        dense = self.mode == "dense"
        d = self.dim
        o = plan.levels(tg_w, pg_w)
        for lv in range(len(o.at) - 1):
            a, b = int(o.at[lv]), int(o.at[lv + 1])
            if self.drop_half:
                b = a + (b - a + 1) // 2
            if b > a:
                u, v, s, w = o.u[a:b], o.v[a:b], o.s[a:b], o.w[a:b]
                t = self._rnd(self.th[u])
                p = self._rnd(self.ph[v])
                if dense:
                    # the route holds each pair's rating sum in the working
                    # type
                    pred = (t * p).sum(1) + gb_t
                    err = self._rnd(self._rnd(s) - w * pred)[:, None]
                    gu, gv = err * p, err * t
                else:
                    pred = self._rnd(t * p).sum(1) + gb_t
                    err = ((eta_t * w) * (s - pred))[:, None]
                    gu, gv = self._rnd(err * p), self._rnd(err * t)
                self.du.index_add_(0, u, torch.cat([gu, w[:, None]], 1))
                self.dv.index_add_(0, v, torch.cat([gv, w[:, None]], 1))
            if o.ph_at[lv + 1] > o.ph_at[lv]:
                rows = o.ph[o.ph_at[lv]:o.ph_at[lv + 1]]
                self.ph[rows] = self._apply(self.ph[rows], self.dv[rows],
                                            self.keep_v, dense, eta_t, cap_t,
                                            ln_decay, d)
                self.dv[rows] = 0.0
                self._store(slice(0), rows)
            if o.th_at[lv + 1] > o.th_at[lv]:
                rows = o.th[o.th_at[lv]:o.th_at[lv + 1]]
                self.th[rows] = self._apply(self.th[rows], self.du[rows],
                                            self.keep_u, dense, eta_t, cap_t,
                                            ln_decay, d)
                self.du[rows] = 0.0
                self._store(rows, slice(0))

    @staticmethod
    def _apply(cur, acc, keep, dense, eta_t, cap_t, ln_decay, d):
        """Rows after a window: decay (1 - eta*lam)^k on the kept lanes and
        the summed steps, scaled by min(1, cap/k); k = 0 leaves a row."""
        dlt, k = acc[:, :d + 2], acc[:, d + 2:]
        if dense:
            dlt = dlt * eta_t
        dlt = dlt * torch.clamp(cap_t / torch.clamp(k, min=1.0), max=1.0)
        return (cur * (1.0 + keep * (torch.exp(k * ln_decay) - 1.0))
                + dlt * keep)


def rmse(tables: dict, gb: float, u, v, r, chunk: int = 1 << 22) -> float:
    """Test RMSE of float32 tables by original id, summed in float64."""
    total = 0.0
    for s in range(0, u.numel(), chunk):
        cu, cv = u[s:s + chunk], v[s:s + chunk]
        pred = ((tables["theta"][cu].double() * tables["phi"][cv].double())
                .sum(1) + tables["bu"][cu].double() + tables["bv"][cv].double()
                + gb)
        total += float(((r[s:s + chunk].double() - pred) ** 2).sum())
    return math.sqrt(total / max(1, u.numel()))


def build(route_name: str, tables: dict, train, gb: float, dim: int,
          seed: int, work: str, storage: str, drop_half: bool = False
          ) -> Trainer:
    """The trainer of ``route_name`` over ``train`` = (u, v, r) on the
    device, from ``tables``; the program's run seed ``seed`` orders the
    gen-1 plans (two plans, rotated by epoch)."""
    u, v, r = train
    nu, nv = tables["theta"].shape[0], tables["phi"].shape[0]
    if route_name == "dense":
        tu, tv = dense_tiles(nu, nv)
        return Trainer(tables, [[dense_plan(u, v, r, nu, nv)]],
                       cdiv(nu, tu) * tu, cdiv(nv, tv) * tv, "dense", gb,
                       work, storage, drop_half=drop_half)
    if route_name == "cells":
        plans, ru, rv, mu, mv = cells_plans(u, v, r, nu, nv, seed)
    else:
        plans, ru, rv, mu, mv = sharded_plans(u, v, r, nu, nv, dim, seed)
    return Trainer(tables, plans, ru, rv, "window", gb, work, storage,
                   map_u=mu, map_v=mv, drop_half=drop_half)
