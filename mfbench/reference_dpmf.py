"""The plain reference of the benchmark's DP-SGLD cells: biased matrix
factorization trained by DP-SGLD (stochastic gradient Langevin dynamics
with Gibbs-sampled precisions, Li et al.'s DPMF; the reference trainer's
``--alg dpmf``, src/model.cc:197-352 and src/dpmf.h:37-92), in plain
PyTorch and NumPy, from the ratings, the initial tables and the run's
seed alone. It imports nothing of the program.

A round, at eta = max(mineta, eta0 / round^gam):

1. the SGLD pass over the round's plan (below), with
   scal = eta * ntrain * bound * lambda_r, bound = 1 at epsilon 0, else
   epsilon / (100 tau) (tau: nv where 0);
2. the noise flush: every row takes sqrt(temp * eta * (N - stamp)) N(0, 1)
   on its factors and bias, N the round's ratings, and the clock and
   stamps restart at 0;
3. the training set's sum of squared errors;
4. the Gibbs draws: lambda ~ Gamma(a + n/2, rate b + sum of squares / 2)
   for lambda_r (the training errors, n = ntrain), lambda_ub, lambda_vb
   (the bias vectors, n = nu, nv) and each dimension of lambda_u,
   lambda_v (the factor columns), in that order, from
   ``numpy.random.default_rng([(seed ^ 0xD1FF) * 1,000,003 + round +
   1,000,000])`` with float32 shape and rate;
5. the test RMSE.

The pass. Ratings are cut into gen-1 plans: tiles of 512 users x 512
items, the ratings in the order of a seeded permutation grouped by cell,
each cell in columns of 1,024, a user tile's columns in batches of 8
(``reference.cell_plan``); two plans, of seeds seed and seed + 7919,
taken in turn by round. The clock of batch i is the number of ratings up
to its end. Per batch: every user row the batch touches takes its lazy
noise, sqrt(max(temp * eta * (clock - stamp), 0)) N(0, 1) on its factors
and bias, and is stamped with the clock; then per column, in order: the
same for the item rows the column touches; the gradient of each rating of
the column against the rows as they stand,

    err = scal * (r - theta_u . phi_v - bu_u - bv_v - gb),

summed per row (err phi_v and err on the user side, err theta_u and err
on the item side); and the apply, a row touched k times in the column
becoming row * base^k + its sum, per lane base = 1 - eta * bound *
(ntrain / count of the row's ratings) * lambda (lambda_u per dimension
and lambda_ub on users, lambda_v and lambda_vb on items), the sign of a
negative base kept for odd k. In the ``bfloat16`` working type rows are
rounded to it before the products and each rating's err phi_v and
err theta_u before the sums; sums and tables are float32. No step is a
matrix product, so TF32 plays no part.

The reference runs the pass in levels: a column goes at the first level
after the last column on its user tile and the last on its item tile, so
that columns of one level share no row, and the result is that of
program order. A row's lazy counts follow from the plan alone, so a
block of levels draws its noise at once.

The normals. The reference trainer draws from a sequential generator,
which no parallel program can follow; the benchmark's program draws from
a counter-based hash keyed by (noise seed + batch, side, row, lane): two
rounds of murmur3's 32-bit finalizer and Box-Muller on 24-bit uniforms,
copied here (``normals``), with noise seed = seed * 1,000,003 + round *
(batches of the larger plan + 1). The flush draws ``torch.randn`` on the
device from a generator seeded (seed ^ 0xD1FF) * 1,000,003 + round +
500,000: theta, phi, bu, bv in that order.

Departures from the reference trainer (model.cc:197-352, dpmf.h:37-92),
as the program departs: the normals above; the gen-1 plan's order and
per-column windows (a row touched k times in a column takes its k steps
from the same point, and its decay once as base^k), where the reference
steps rating by rating; the noise of a row is taken at its batch's end
clock, not rating by rating; the hash's noise on a row touched again in
the batch is zero; the working type's rounding. Stand-ins for the
check's control: ``storage="bfloat16"`` keeps the tables in bfloat16
(every noise add and apply rounded); ``control="eager"`` gives every
touched row one step's noise whatever its lazy count; ``drop_half`` leaves
out half of every column's ratings.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from mfbench import reference

TILE = 512          # user and item tiles of the SGLD plans
BATCH = 8192        # ratings a batch: 8 columns of 1,024
N_PLANS = 2

# ---- counter-based normals ---------------------------------------------------

_MASK = 0xFFFFFFFF
_SIDE_KEYS = (0x9E3779B9, 0x3C6EF372)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for int64 x in [0, 2^32)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _word(key: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return _fmix32((_fmix32(c ^ key) + key) & _MASK)


def normals(keys: torch.Tensor, side: int, rows: torch.Tensor,
            width: int) -> torch.Tensor:
    """(len(rows), width) standard normals: row j's of batch key
    ``keys[j]`` (noise seed + batch, int64), table row ``rows[j]``, lanes
    0..width-1 (factors, then the bias)."""
    dev = rows.device
    ks = _fmix32((_fmix32(keys & _MASK) + _SIDE_KEYS[side]) & _MASK)
    kr = _word(ks[:, None], (rows & _MASK)[:, None])
    c = 2 * torch.arange(width, device=dev)[None, :]
    b1, b2 = _word(kr, c), _word(kr, c + 1)
    f32 = torch.float32
    u1 = (b1 >> 8).to(f32) * (1.0 / (1 << 24)) + (1.0 / (1 << 25))
    u2 = (b2 >> 8).to(f32) * (1.0 / (1 << 24))
    two_pi = torch.tensor(2.0 * math.pi, dtype=f32, device=dev)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(two_pi * u2)


# ---- plans in levels ---------------------------------------------------------

@dataclass
class Rows:
    """Table rows that the ops of each level touch, sorted by level: level
    L's at ``at[L]:at[L + 1]``. Noise rows: ``key`` the batch (of the
    normals' key), ``x`` the ratings counted since the row's last noise
    (its lazy count, above 0: a row touched again in its batch takes none);
    apply rows: ``x`` the row's ratings in the column."""

    rows: torch.Tensor
    key: torch.Tensor
    x: torch.Tensor
    at: np.ndarray


@dataclass
class LevelPlan:
    """One plan's round in levels: the ratings of level L at
    ``at[L]:at[L + 1]`` of ``u``, ``v``, ``r``; the user rows whose batch
    noise goes at each level and the item rows of its columns' noise
    (``noise_u``, ``noise_v``), the rows each level applies (``apply_u``,
    ``apply_v``), and each row's clock at its last noise (``last_u``,
    ``last_v``, 0 where the round touches it not); ``n_batches`` the
    program's batch count (an empty user tile takes one)."""

    u: torch.Tensor
    v: torch.Tensor
    r: torch.Tensor
    at: np.ndarray
    noise_u: Rows
    noise_v: Rows
    apply_u: Rows
    apply_v: Rows
    last_u: torch.Tensor
    last_v: torch.Tensor
    n_real: int
    n_batches: int


def _by_level(level: torch.Tensor, n_lv: int, *cols) -> tuple:
    o = torch.sort(level, stable=True).indices
    per = torch.bincount(level, minlength=n_lv).cpu().numpy()
    at = np.concatenate([[0], np.cumsum(per)]).astype(np.int64)
    return (*(c[o] for c in cols), at)


def _pairs(op_of: torch.Tensor, ids: torch.Tensor, n: int, lv_op) -> tuple:
    """(op, row, ratings, level) of each distinct (op, row) of entries."""
    keys, k = torch.unique(op_of * n + ids, return_counts=True)
    op = keys // n
    return op, keys % n, k, lv_op[op]


def _apply_rows(op_of, ids, n, lv_op, n_lv) -> Rows:
    op, rows, k, lv = _pairs(op_of, ids, n, lv_op)
    rows, op, k, at = _by_level(lv, n_lv, rows, op, k.float())
    return Rows(rows, op // 8, k, at)


def _noise_rows(op_of, ids, n, lv_op, clock_b, n_lv) -> tuple:
    """(noise rows, each row's last clock): a row's lazy count is its
    batch's clock less that of its previous noise in the round (a row's
    ops are in level order)."""
    op, rows, _, lv = _pairs(op_of, ids, n, lv_op)
    clock = clock_b[op // 8]
    o = torch.sort(rows * (int(lv.max()) + 1) + lv).indices
    rows, op, lv, clock = rows[o], op[o], lv[o], clock[o]
    prev = torch.zeros_like(clock)
    prev[1:] = torch.where(rows[1:] == rows[:-1], clock[:-1], 0)
    el = clock - prev
    last = torch.zeros(n, dtype=clock.dtype, device=clock.device)
    last.scatter_reduce_(0, rows, clock, "amax")
    keep = el > 0
    rows, op, el, at = _by_level(lv[keep], n_lv, rows[keep], op[keep],
                                 el[keep].float())
    return Rows(rows, op // 8, el, at), last


def level_plan(u, v, r, nu: int, nv: int, seed: int,
               drop_half: bool = False) -> LevelPlan:
    """The gen-1 SGLD plan of seed ``seed`` over ratings (u, v, r) on the
    device, in levels. ``drop_half``, a planted fault (``algs/dpmf.py:
    readings``), leaves out the second half of every column's ratings; the
    clocks stay the plan's."""
    p = reference.cell_plan(u, v, r, TILE, TILE, BATCH // 8, seed)
    dev = u.device
    nb = len(p.batch_g)
    n_real = int(p.u.numel())
    n_gu = reference.cdiv(nu, TILE)
    n_batches = nb + n_gu - (int(p.u.max()) // TILE + 1)
    clock_b = torch.cumsum(torch.bincount(p.batch, minlength=nb), 0)
    # ops: columns with ratings, in program order
    col_id = p.batch * 8 + p.col
    if drop_half:                 # a column's ratings are contiguous
        count = torch.bincount(col_id)
        rank = (torch.arange(n_real, device=dev)
                - (torch.cumsum(count, 0) - count)[col_id])
        keep = rank < (count[col_id] + 1) // 2
        p.u, p.v, p.s, p.batch = p.u[keep], p.v[keep], p.s[keep], p.batch[keep]
        col_id = col_id[keep]
    ops = torch.unique(col_id).cpu().numpy()
    g_of = p.batch_g[ops // 8]
    t_of = p.tiles[ops // 8, ops % 8]
    after_u: dict = {}
    after_v: dict = {}
    lv = np.empty(len(ops), np.int64)
    for j in range(len(ops)):
        g, t = int(g_of[j]), int(t_of[j])
        lv[j] = max(after_u.get(g, -1), after_v.get(t, -1)) + 1
        after_u[g] = after_v[t] = lv[j]
    n_lv = int(lv.max()) + 1
    ops_t, lv_t = torch.as_tensor(ops, device=dev), torch.as_tensor(lv,
                                                                   device=dev)
    lv_op = torch.full((nb * 8,), -1, dtype=torch.int64, device=dev)
    lv_op[ops_t] = lv_t
    # a batch's user noise goes at its first level
    first = torch.full((nb,), n_lv, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, ops_t // 8, lv_t, "amin")
    noise_u, last_u = _noise_rows(p.batch * 8, p.u, nu,
                                  first.repeat_interleave(8), clock_b, n_lv)
    noise_v, last_v = _noise_rows(col_id, p.v, nv, lv_op, clock_b, n_lv)
    eu, ev, er, at = _by_level(lv_op[col_id], n_lv, p.u, p.v, p.s)
    return LevelPlan(eu, ev, er, at, noise_u, noise_v,
                     _apply_rows(col_id, p.u, nu, lv_op, n_lv),
                     _apply_rows(col_id, p.v, nv, lv_op, n_lv),
                     last_u, last_v, n_real, n_batches)


# ---- rounds ------------------------------------------------------------------

def eta_at(flags: dict, rnd: int) -> float:
    """The round's step size (model.cc:350-352)."""
    return float(max(flags["mineta"], flags["eta"] / rnd ** flags["gam"]))


def dp_bound(flags: dict, nv: int) -> float:
    """The privacy scale (model.cc:240-242)."""
    if flags["epsilon"] <= 0.0:
        return 1.0
    tau = flags["tau"] if flags["tau"] > 0 else nv
    return float(flags["epsilon"] / (4.0 * 25.0 * tau))


def _sse(th, ph, gb, u, v, r, chunk: int = 1 << 20) -> float:
    """Sum of squared errors of fused tables, float64."""
    d = th.shape[1] - 2
    total = 0.0
    for s in range(0, u.numel(), chunk):
        t = th[u[s:s + chunk]].double()
        p = ph[v[s:s + chunk]].double()
        pred = (t[:, :d] * p[:, :d]).sum(1) + t[:, d] + p[:, d + 1] + gb
        total += float(((r[s:s + chunk].double() - pred) ** 2).sum())
    return total


class Trainer:
    """Fused tables [theta | bu | 1] and [phi | 1 | bv] (float32), the
    precisions, and DP-SGLD rounds over them. ``flags`` holds the
    trainer's eta, gam, mineta, temp, hypera, hyperb, epsilon and tau;
    ``seed`` is the run's seed."""

    def __init__(self, tables: dict, train, gb: float, seed: int,
                 flags: dict, work: str = "bfloat16",
                 storage: str = "float32", control: str | None = None,
                 drop_half: bool = False):
        theta, phi = tables["theta"], tables["phi"]
        dev = theta.device
        self.nu, d = theta.shape
        self.nv = phi.shape[0]
        self.dim = d
        self.th = torch.cat([theta.float(), tables["bu"].float()[:, None],
                             torch.ones(self.nu, 1, device=dev)], 1)
        self.ph = torch.cat([phi.float(), torch.ones(self.nv, 1, device=dev),
                             tables["bv"].float()[:, None]], 1)
        self.du = torch.zeros_like(self.th)
        self.dv = torch.zeros_like(self.ph)
        u, v, r = train
        self.train = train
        self.ntrain = int(u.numel())
        f64 = torch.float64
        self.inv_u = (self.ntrain / torch.bincount(u, minlength=self.nu)
                      .clamp(min=1).to(f64)).float()
        self.inv_v = (self.ntrain / torch.bincount(v, minlength=self.nv)
                      .clamp(min=1).to(f64)).float()
        self.gb, self.seed, self.flags = float(gb), int(seed), flags
        self.work = reference.DTYPES[work]
        self.storage = reference.DTYPES[storage]
        self.eager = control == "eager"
        self.lam = {"r": 1.0, "ub": 1e2, "vb": 1e2,
                    "u": np.full(d, 1e2, np.float32),
                    "v": np.full(d, 1e2, np.float32)}
        self.bound = dp_bound(flags, self.nv)
        self.plans = [level_plan(u, v, r, self.nu, self.nv,
                                 self.seed + 7919 * p, drop_half)
                      for p in range(N_PLANS)]
        self.stride = max(p.n_batches for p in self.plans) + 1
        lane = torch.arange(d + 2, device=dev)
        self.keep_u = (lane <= d).float()
        self.keep_v = ((lane < d) | (lane == d + 1)).float()
        # the noise lanes (factors, bias) of each table
        self.lanes_u = lane[:d + 1]
        self.lanes_v = torch.cat([lane[:d], lane[d + 1:]])
        every = slice(None)
        self._store(self.th, every)
        self._store(self.ph, every)

    def tables(self) -> dict:
        d = self.dim
        return {"theta": self.th[:, :d].clone(), "phi": self.ph[:, :d].clone(),
                "bu": self.th[:, d].clone(), "bv": self.ph[:, d + 1].clone()}

    def hyper(self) -> dict:
        return {k: np.array(x, np.float32) for k, x in self.lam.items()}

    def _rnd(self, x):
        return x if self.work == torch.float32 else x.to(self.work).float()

    def _store(self, tab, rows):
        if self.storage != torch.float32:
            tab[rows] = tab[rows].to(self.storage).float()

    def round(self, rnd: int) -> None:
        """Round ``rnd`` (from 1): the pass, the flush, the Gibbs draws."""
        plan, te = self.sgld(rnd)
        self._flush(rnd, plan, te)
        self._gibbs(rnd)

    def sgld(self, rnd: int) -> tuple:
        """Round ``rnd``'s SGLD pass: (its plan, temp * eta)."""
        f32 = torch.float32
        dev = self.th.device
        eta = eta_at(self.flags, rnd)
        scal_host = eta * self.ntrain * self.bound * float(self.lam["r"])
        eta_t, temp_t, bound_t, scal, gb = torch.tensor(
            [eta, self.flags["temp"], self.bound, scal_host, self.gb],
            dtype=f32, device=dev)
        te, eb = temp_t * eta_t, eta_t * bound_t
        lam = self.lam
        lam_u = np.concatenate([lam["u"], [lam["ub"], 0.0]]).astype(np.float32)
        lam_v = np.concatenate([lam["v"], [0.0, lam["vb"]]]).astype(np.float32)
        decay = []
        for inv, lam_lanes in ((self.inv_u, lam_u), (self.inv_v, lam_v)):
            base = 1.0 - (eb * inv)[:, None] * torch.as_tensor(
                lam_lanes).to(dev)[None, :]
            decay.append((torch.log(torch.clamp(base.abs(), min=1e-30)),
                          base < 0))
        signs = any(bool(neg.any()) for _, neg in decay)
        plan = self.plans[(rnd - 1) % N_PLANS]
        self._pass(plan, self.seed * 1_000_003 + rnd * self.stride, te, scal,
                   gb, decay, signs)
        return plan, te

    def _noise(self, rows: Rows, a: int, b: int, side: int, seed: int,
               lanes, te) -> torch.Tensor:
        """Rows a:b's noise, std x normals, in the table's lanes."""
        d = self.dim
        out = torch.zeros(b - a, d + 2, device=self.th.device)
        if b > a:
            el = torch.ones_like(rows.x[a:b]) if self.eager else rows.x[a:b]
            std = torch.sqrt(torch.clamp(te * el, min=0.0))
            out[:, lanes] = std[:, None] * normals(
                seed + rows.key[a:b], side, rows.rows[a:b], d + 1)
        return out

    @staticmethod
    def _decay(rows: Rows, a: int, b: int, decay, signs: bool):
        """base^k of rows a:b, per lane."""
        lb, neg = decay
        idx, k = rows.rows[a:b], rows.x[a:b]
        dec = torch.exp(k[:, None] * lb[idx])
        if signs:
            odd = torch.remainder(k, 2.0) == 1.0
            dec = torch.where(neg[idx] & odd[:, None], -dec, dec)
        return dec

    def _pass(self, plan: LevelPlan, seed: int, te, scal, gb, decay,
              signs: bool) -> None:
        """The SGLD pass, in blocks of levels: each block's noise and decay
        factors at once, then its levels in turn."""
        parts = (plan.noise_u, plan.noise_v, plan.apply_u, plan.apply_v)
        n_lv = len(plan.at) - 1
        lv = 0
        while lv < n_lv:
            end = lv + 1             # a block of levels of <= 2^17 rows
            while (end < n_lv and sum(int(x.at[end + 1] - x.at[lv])
                                      for x in parts) <= 1 << 17):
                end += 1
            o = [int(x.at[lv]) for x in parts]
            e = [int(x.at[end]) for x in parts]
            blk = (self._noise(plan.noise_u, o[0], e[0], 0, seed, self.lanes_u,
                               te),
                   self._noise(plan.noise_v, o[1], e[1], 1, seed, self.lanes_v,
                               te),
                   self._decay(plan.apply_u, o[2], e[2], decay[0], signs),
                   self._decay(plan.apply_v, o[3], e[3], decay[1], signs))
            for L in range(lv, end):
                sl = [slice(int(x.at[L]) - i, int(x.at[L + 1]) - i)
                      for x, i in zip(parts, o)]
                self._level(plan, L, scal, gb, blk, sl, o)
            lv = end

    def _level(self, plan: LevelPlan, L: int, scal, gb, blk, sl, o) -> None:
        """Level L: the noise of its batches' users and of its columns'
        items, the gradients of its ratings, the applies."""
        for tab, rows, nz, s, i in ((self.th, plan.noise_u, blk[0], sl[0],
                                     o[0]),
                                    (self.ph, plan.noise_v, blk[1], sl[1],
                                     o[1])):
            if s.stop > s.start:
                idx = rows.rows[s.start + i:s.stop + i]
                tab.index_add_(0, idx, nz[s])
                self._store(tab, idx)
        a, b = int(plan.at[L]), int(plan.at[L + 1])
        u, v, r = plan.u[a:b], plan.v[a:b], plan.r[a:b]
        t = self._rnd(self.th[u])
        p = self._rnd(self.ph[v])
        pred = (t * p).sum(1) + gb
        err = (scal * (r - pred))[:, None]
        self.du.index_add_(0, u, self._rnd(err * p))
        self.dv.index_add_(0, v, self._rnd(err * t))
        for tab, acc, rows, dec, s, i, keep in (
                (self.ph, self.dv, plan.apply_v, blk[3], sl[3], o[3],
                 self.keep_v),
                (self.th, self.du, plan.apply_u, blk[2], sl[2], o[2],
                 self.keep_u)):
            idx = rows.rows[s.start + i:s.stop + i]
            tab[idx] = tab[idx] * dec[s] + acc[idx] * keep
            acc[idx] = 0.0
            self._store(tab, idx)

    def _flush(self, rnd: int, plan: LevelPlan, te) -> None:
        """The round's outstanding noise on every row: its count is the
        round's ratings less the clock of its last noise."""
        d = self.dim
        dev = self.th.device
        g = torch.Generator(device=dev).manual_seed(
            (self.seed ^ 0xD1FF) * 1_000_003 + rnd + 500_000)

        def std(last):
            c = (plan.n_real - last).to(torch.float32)
            return torch.sqrt(te * torch.clamp(c, min=0.0))

        su, sv = std(plan.last_u), std(plan.last_v)

        def normal(*shape):
            return torch.randn(*shape, generator=g, device=dev)

        self.th[:, :d] += su[:, None] * normal(self.nu, d)
        self.ph[:, :d] += sv[:, None] * normal(self.nv, d)
        self.th[:, d] += su * normal(self.nu)
        self.ph[:, d + 1] += sv * normal(self.nv)
        every = slice(None)
        self._store(self.th, every)
        self._store(self.ph, every)

    def _gibbs(self, rnd: int) -> None:
        """The precisions, drawn from their posteriors."""
        d = self.dim
        f32 = np.float32
        fl = self.flags
        rng = np.random.default_rng(
            [((self.seed ^ 0xD1FF) * 1_000_003 + rnd + 1_000_000)
             & 0xFFFFFFFFFFFF])

        def draw(sqr, cnt):
            alpha = f32(fl["hypera"]) + f32(0.5) * np.asarray(cnt, f32)
            beta = f32(fl["hyperb"]) + f32(0.5) * np.asarray(sqr, f32)
            alpha, beta = np.broadcast_arrays(alpha, beta)
            return (rng.standard_gamma(alpha.astype(np.float64))
                    / beta).astype(f32)

        sse = _sse(self.th, self.ph, self.gb, *self.train)
        sq = [float((self.th[:, d].double() ** 2).sum()),
              float((self.ph[:, d + 1].double() ** 2).sum()),
              (self.th[:, :d].double() ** 2).sum(0).cpu().numpy(),
              (self.ph[:, :d].double() ** 2).sum(0).cpu().numpy()]
        self.lam = {"r": draw(sse, self.ntrain), "ub": draw(sq[0], self.nu),
                    "vb": draw(sq[1], self.nv), "u": draw(sq[2], self.nu),
                    "v": draw(sq[3], self.nv)}


def run_job(tables0: dict, train, test, gb: float, seed: int, flags: dict,
            rounds: int, work: str, storage: str = "float32",
            control: str | None = None, drop_half: bool = False) -> dict:
    """One job of rounds 1..``rounds``: {"tables": {1: .., rounds: ..},
    "rmse": {round: test RMSE}, "hyper": {round: precisions after it}}."""
    tr = Trainer(tables0, train, gb, seed, flags, work, storage, control,
                 drop_half)
    tables, rmses, hyper = {}, {}, {}
    for rnd in range(1, rounds + 1):
        tr.round(rnd)
        t = tr.tables()
        rmses[rnd] = reference.rmse(t, gb, *test)
        hyper[rnd] = tr.hyper()
        if rnd in (1, rounds):
            tables[rnd] = t
    return {"tables": tables, "rmse": rmses, "hyper": hyper}
