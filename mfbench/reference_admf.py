"""The plain reference of the benchmark's AdaptReg cells: biased matrix
factorization with adaptive regularization (S. Rendle, "Learning
Recommender Systems with Adaptive Regularization", WSDM 2012; the
reference trainer's ``--alg admf``: src/admf.h, ``AdaptRegMF`` at
src/model.h:74-118, ``run(AdaptRegMF&)`` at src/main.cc:77-93), in plain
PyTorch and NumPy, float32, from the ratings, the validation set, the
initial tables, the four initial lambdas and the run's seed alone. It
imports nothing of the program, and turns TF32 off where it runs.

Epoch e (from 1), at eta = eta0 / e^gam and eta_reg = eta_reg0 / e^gam
(model.cc:36-38, 386-388), runs the epoch's gen-1 plan cut into S
segments of consecutive batches; per segment:

1. K = 64 validation records drawn (``draw_samples``) and their rows
   gathered as the segment finds them ("old");
2. the segment's SGD steps with the four learned regularizers: per rating

       err = eta * (r - theta_u . phi_v - bu_u - bv_v - gb),

   summed per row over a plan column (one window), and at the column's
   end a row touched k times becomes row * base^k + its sum, per lane
   base = 1 - eta * lam (lam_u on the user's factors, lam_bu on its bias;
   lam_v and lam_bv on the item's), the sign of a negative base kept for
   odd k;
3. the hypergradient step (model.h:86-102): the K rows gathered again
   ("new"), g = r_k - (theta_new . phi_new + bu_new + bv_new + gb), and

       lam_u  <- max(0, lam_u  - s * sum g * (theta_old . phi_new))
       lam_v  <- max(0, lam_v  - s * sum g * (theta_new . phi_old))
       lam_bu <- max(0, lam_bu - s * sum g * bu_old)
       lam_bv <- max(0, lam_bv - s * sum g * bv_old)

   with s = eta_reg * eta (a float32 product) * visits / K, visits the
   distinct users of each of the segment's batches, summed;

then the test RMSE (float64, ``reference.rmse``).

The plans. Tiles of 512 users x 512 items; the ratings in the order of
a seeded permutation, grouped by cell, each cell in columns of 512, a
user tile's columns in batches of 8 (batches of 4,096 ratings,
``reference.cell_plan``); an empty user tile takes one batch of padding;
two plans, of seeds seed and seed + 7919, taken in turn by epoch. S =
min(8, batches), the batches padded to S * ceil(batches / S). The
reference runs a segment in levels: a column goes at the first level
after the segment's last earlier column on its user tile and on its item
tile, so columns of one level share no row and the result is that of
program order.

The validation draws are the program's, copied: the K indices of segment
s of epoch e come from ``torch.randint`` on a ``torch.Generator`` of the
run's device seeded ((key * 1,000,003 + s) mod 2^63), key = (seed ^
0xADF0) * 1,000,003 + e (``admf_key``, ``segment_seed``, ``draw_samples``;
copied from ``ops/adreg_cells.py`` and ``train/loop.py: _admf_key``).

In the ``bfloat16`` working type rows are rounded to it before the
products, and each rating's err phi_v and err theta_u before the sums;
products, sums, tables and the hypergradient step are float32.

Departures from the reference trainer, as the program departs:

- admf.h:52-86 steps rating by rating in file order; here the plan's
  order and per-column windows (a row touched k times in a column takes
  its k steps from the same point, and its decay once, as base^k);
- admf.h:67-68, 77-78 snapshot the rows before each rating's update; here
  "old" is a row as its segment found it;
- admf.h:82-83 take one hypergradient step per user, on one validation
  record; here one step per segment on K = 64 records, scaled by the
  segment's user-visits;
- model.cc:390-415 shuffle the validation set once and walk it; here
  seeded draws with replacement, by segment;
- the working type's rounding.

Stand-ins for the check's control (``algs/admf.py: readings``):
``storage="bfloat16"`` keeps the tables in bfloat16 (each apply rounded);
``control="frozen"`` skips every hypergradient step; ``segments=1`` takes
one step an epoch; ``drop_half`` leaves out the second half of every
column's ratings (the user-visits stay the plan's).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mfbench import reference

TILE = 512          # user and item tiles of the gen-1 AdaptReg plans
BATCH = 4096        # ratings a batch: 8 columns of 512
SEGMENTS = 8
N_PLANS = 2
K = 64              # validation records a hypergradient step

# ---- the program's validation draws (copied) --------------------------------


def admf_key(seed: int, epoch: int) -> int:
    """The validation-sample key of epoch ``epoch`` (``_admf_key``)."""
    return (seed ^ 0xADF0) * 1_000_003 + epoch


def segment_seed(key: int, seg: int) -> int:
    """The validation-sample seed of segment ``seg`` (``segment_seed``)."""
    return (key * 1_000_003 + seg) & 0x7FFF_FFFF_FFFF_FFFF


def draw_samples(key: int, seg: int, n_valid: int, device) -> torch.Tensor:
    """The K validation indices of segment ``seg`` (``draw_samples``)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(segment_seed(key, seg))
    return torch.randint(n_valid, (K,), generator=gen, device=device)


# ---- plans in segments and levels ---------------------------------------------

@dataclass
class Segment:
    """One segment's ratings in levels: level L's at ``at[L]:at[L + 1]`` of
    ``u``, ``v``, ``r``; the user rows each level applies at ``at_u[L]:
    at_u[L + 1]`` of ``ru`` with their ratings in the level ``ku`` (each
    rating's row at ``iu`` of ``ru``), the item rows likewise; ``visits``
    the segment's user-visits."""

    u: torch.Tensor
    v: torch.Tensor
    r: torch.Tensor
    at: np.ndarray
    ru: torch.Tensor
    ku: torch.Tensor
    iu: torch.Tensor
    at_u: np.ndarray
    rv: torch.Tensor
    kv: torch.Tensor
    iv: torch.Tensor
    at_v: np.ndarray
    visits: torch.Tensor


@dataclass
class Plan:
    """One plan's segments; ``n_batches`` its batches before the padding
    to whole segments."""

    segments: list
    n_batches: int


def _offsets(level: torch.Tensor, n_lv: int) -> np.ndarray:
    per = torch.bincount(level, minlength=n_lv).cpu().numpy()
    return np.concatenate([[0], np.cumsum(per)]).astype(np.int64)


def _rows(level: torch.Tensor, ids: torch.Tensor, n: int, n_lv: int):
    """(rows, ratings, each entry's slot, offsets) of the distinct (level,
    row) pairs of entries, level-major."""
    keys, inv, k = torch.unique(level * n + ids, return_inverse=True,
                                return_counts=True)
    return keys % n, k.float(), inv, _offsets(keys // n, n_lv)


def _segment(level: torch.Tensor, u, v, r, nu: int, nv: int,
             visits: torch.Tensor) -> Segment:
    n_lv = int(level.max()) + 1
    o = torch.sort(level, stable=True).indices
    level, u, v, r = level[o], u[o], v[o], r[o]
    ru, ku, iu, at_u = _rows(level, u, nu, n_lv)
    rv, kv, iv, at_v = _rows(level, v, nv, n_lv)
    return Segment(u, v, r, _offsets(level, n_lv), ru, ku, iu, at_u, rv, kv,
                   iv, at_v, visits)


def plan_segments(u, v, r, nu: int, nv: int, seed: int, tile: int = TILE,
                  batch: int = BATCH, segments: int = SEGMENTS,
                  drop_half: bool = False) -> Plan:
    """The gen-1 AdaptReg plan of seed ``seed`` over ratings (u, v, r) on
    the device, in segments and levels. ``drop_half``, a planted fault,
    leaves out the second half of every column's ratings."""
    p = reference.cell_plan(u, v, r, tile, tile, batch // 8, seed)
    dev = u.device
    nb = (len(p.batch_g) + reference.cdiv(nu, tile)
          - (int(p.u.max()) // tile + 1))
    n_seg = min(segments, nb)
    seg_len = reference.cdiv(nb, n_seg)
    pairs = torch.unique(p.batch * nu + p.u)
    visits = torch.bincount(pairs // nu // seg_len,
                            minlength=n_seg).to(torch.float32)
    col_id = p.batch * 8 + p.col
    if drop_half:                 # a column's ratings are contiguous
        count = torch.bincount(col_id)
        rank = (torch.arange(col_id.numel(), device=dev)
                - (torch.cumsum(count, 0) - count)[col_id])
        keep = rank < (count[col_id] + 1) // 2
        p.u, p.v, p.s, col_id = p.u[keep], p.v[keep], p.s[keep], col_id[keep]
    ops = torch.unique(col_id).cpu().numpy()
    g_of = p.batch_g[ops // 8]
    t_of = p.tiles[ops // 8, ops % 8]
    s_of = ops // 8 // seg_len
    lv = np.empty(len(ops), np.int64)
    after_u: dict = {}
    after_v: dict = {}
    for j in range(len(ops)):
        if j and s_of[j] != s_of[j - 1]:      # a segment starts afresh
            after_u, after_v = {}, {}
        g, t = int(g_of[j]), int(t_of[j])
        lv[j] = max(after_u.get(g, -1), after_v.get(t, -1)) + 1
        after_u[g] = after_v[t] = lv[j]
    lv_op = torch.full((nb * 8,), -1, dtype=torch.int64, device=dev)
    lv_op[torch.as_tensor(ops, device=dev)] = torch.as_tensor(lv, device=dev)
    seg = col_id // 8 // seg_len
    out = []
    for s in range(n_seg):
        m = seg == s
        if not bool(m.any()):
            out.append(None)
            continue
        out.append(_segment(lv_op[col_id[m]], p.u[m], p.v[m], p.s[m], nu, nv,
                            visits[s]))
    return Plan(out, nb)


# ---- epochs --------------------------------------------------------------------

class Trainer:
    """Fused tables [theta | bu | 1] and [phi | 1 | bv] (float32), the four
    lambdas (float32: lam_u, lam_v, lam_bu, lam_bv), and AdaptReg epochs
    over them.
    ``flags`` holds the trainer's eta, gam, eta_reg and loss; ``seed`` is
    the run's seed; ``valid`` the validation set (u, v, r) on the device."""

    def __init__(self, tables: dict, lams, train, valid, gb: float,
                 seed: int, flags: dict, work: str = "bfloat16",
                 storage: str = "float32", control: str | None = None,
                 drop_half: bool = False, tile: int = TILE,
                 batch: int = BATCH, segments: int = SEGMENTS):
        if int(flags.get("loss", 0)) != 0:
            raise NotImplementedError("the reference holds --loss 0 only")
        theta, phi = tables["theta"], tables["phi"]
        dev = theta.device
        self.nu, d = theta.shape
        self.nv = phi.shape[0]
        self.dim = d
        ones_u = torch.ones(self.nu, 1, device=dev)
        self.th = torch.cat([theta.float(), tables["bu"].float()[:, None],
                             ones_u], 1)
        self.ph = torch.cat([phi.float(), torch.ones(self.nv, 1, device=dev),
                             tables["bv"].float()[:, None]], 1)
        self.lams = torch.as_tensor(lams, dtype=torch.float32).to(dev).clone()
        self.valid = valid
        self.gb, self.seed, self.flags = float(gb), int(seed), flags
        self.gb_t = torch.tensor(self.gb, dtype=torch.float32, device=dev)
        self.work = reference.DTYPES[work]
        self.storage = reference.DTYPES[storage]
        self.frozen = control == "frozen"
        u, v, r = train
        self.plans = [plan_segments(u, v, r, self.nu, self.nv,
                                    self.seed + 7919 * p, tile, batch,
                                    segments, drop_half)
                      for p in range(N_PLANS)]
        lane = torch.arange(d + 2, device=dev)
        self.keep_u = (lane <= d).float()
        self.keep_v = ((lane < d) | (lane == d + 1)).float()
        every = slice(None)
        self._store(self.th, every)
        self._store(self.ph, every)

    def tables(self) -> dict:
        d = self.dim
        return {"theta": self.th[:, :d].clone(), "phi": self.ph[:, :d].clone(),
                "bu": self.th[:, d].clone(), "bv": self.ph[:, d + 1].clone()}

    def _rnd(self, x):
        return x if self.work == torch.float32 else x.to(self.work).float()

    def _store(self, tab, rows):
        if self.storage != torch.float32:
            tab[rows] = tab[rows].to(self.storage).float()

    def epoch(self, e: int) -> None:
        """Epoch ``e`` (from 1): each segment, and the step after it."""
        fl = self.flags
        eta = float(fl["eta"] / e ** fl["gam"])
        eta_reg = float(fl["eta_reg"] / e ** fl["gam"])
        key = admf_key(self.seed, e)
        uv, vv, rv = self.valid
        plan = self.plans[(e - 1) % N_PLANS]
        for s, seg in enumerate(plan.segments):
            if seg is None:       # padding alone: its step has no visits
                continue
            ks = draw_samples(key, s, uv.numel(), uv.device)
            su, sv, sr = uv[ks], vv[ks], rv[ks]
            old_t, old_p = self.th[su], self.ph[sv]
            self._walk(seg, eta)
            if not self.frozen:
                self.lams = hyper_step(self.lams, self.th[su], self.ph[sv],
                                       old_t, old_p, sr, eta, eta_reg,
                                       seg.visits, self.gb, self.dim)

    def _walk(self, seg: Segment, eta: float) -> None:
        """A segment's levels: each level's gradients, then the applies of
        the rows it touched."""
        d = self.dim
        f32 = torch.float32
        dev = self.th.device
        eta_t = torch.tensor(eta, dtype=f32, device=dev)
        lu, lv, lbu, lbv = self.lams
        zero = torch.zeros((), dtype=f32, device=dev)
        lam_u = torch.cat([lu.expand(d), lbu[None], zero[None]])
        lam_v = torch.cat([lv.expand(d), zero[None], lbv[None]])
        sides = []
        for tab, lam, keep, rows, k, idx, at in (
                (self.th, lam_u, self.keep_u, seg.ru, seg.ku, seg.iu,
                 seg.at_u),
                (self.ph, lam_v, self.keep_v, seg.rv, seg.kv, seg.iv,
                 seg.at_v)):
            base = 1.0 - eta_t * lam
            sides.append((tab, keep, rows, k, idx, at,
                          torch.log(torch.clamp(base.abs(), min=1e-30)),
                          base < 0))
        for L in range(len(seg.at) - 1):
            a, b = int(seg.at[L]), int(seg.at[L + 1])
            t = self._rnd(self.th[seg.u[a:b]])
            p = self._rnd(self.ph[seg.v[a:b]])
            pred = (t * p).sum(1) + self.gb_t
            err = (eta_t * (seg.r[a:b] - pred))[:, None]
            for (tab, keep, rows, k, idx, at, ln, neg), g in zip(
                    sides, (self._rnd(err * p), self._rnd(err * t))):
                a2, b2 = int(at[L]), int(at[L + 1])
                acc = torch.zeros(b2 - a2, d + 2, dtype=f32, device=dev)
                acc.index_add_(0, idx[a:b] - a2, g)
                kk = k[a2:b2, None]
                fac = torch.exp(kk * ln)
                odd = torch.remainder(kk, 2.0) == 1.0
                fac = torch.where(neg & odd, -fac, fac)
                rw = rows[a2:b2]
                tab[rw] = tab[rw] * fac + acc * keep
                self._store(tab, rw)



def hyper_step(lams: torch.Tensor, new_t, new_p, old_t, old_p, sr,
               eta: float, eta_reg: float, visits: torch.Tensor, gb: float,
               dim: int) -> torch.Tensor:
    """The hypergradient step (module docstring) from K fused rows
    [theta | bu | 1] and [phi | 1 | bv] gathered after (new) and before
    (old) a segment and the records' ratings ``sr``: the new lambdas."""
    d = dim
    tf, tb = new_t[:, :d], new_t[:, d]
    pf, pb = new_p[:, :d], new_p[:, d + 1]
    g = sr - ((tf * pf).sum(1) + tb + pb + gb)
    inner_u = (old_t[:, :d] * pf).sum(1)
    inner_v = (tf * old_p[:, :d]).sum(1)
    ee = float(np.float32(eta_reg) * np.float32(eta))
    scale = visits * ee / sr.shape[0]
    steps = torch.stack([(g * inner_u).sum(), (g * inner_v).sum(),
                         (g * old_t[:, d]).sum(), (g * old_p[:, d + 1]).sum()])
    return torch.clamp(lams - scale * steps, min=0.0)


def run_job(tables0: dict, lams0, train, valid, test, gb: float, seed: int,
            flags: dict, epochs: int, work: str, storage: str = "float32",
            control: str | None = None, drop_half: bool = False,
            tile: int = TILE, batch: int = BATCH,
            segments: int = SEGMENTS) -> dict:
    """One job of epochs 1..``epochs`` from ``tables0`` and the lambdas
    ``lams0``: {"tables": {1: .., epochs: ..}, "rmse": {epoch: test RMSE},
    "lams": {epoch: float64 lambdas after it}, "plans": [{"batches",
    "segments"} of each plan]}."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tr = Trainer(tables0, lams0, train, valid, gb, seed, flags, work,
                 storage, control, drop_half, tile, batch, segments)
    tables, rmses, lams = {}, {}, {}
    for e in range(1, epochs + 1):
        tr.epoch(e)
        t = tr.tables()
        rmses[e] = reference.rmse(t, gb, *test)
        lams[e] = tr.lams.double().cpu().numpy()
        if e in (1, epochs):
            tables[e] = t
    return {"tables": tables, "rmse": rmses, "lams": lams,
            "plans": [{"batches": p.n_batches, "segments": len(p.segments)}
                      for p in tr.plans]}
