"""Fused DP-SGLD epochs on gen-1 cell plans (counterpart of
``tpu_mf/ops/pallas_sgld.py``; reference semantics: src/dpmf.h:37-92).

A round walks the plan of ``prepare_cells`` (``ops/sgd_cells.py``): batch i
holds 8 sub-batch columns on one user tile, each column on its own item
tile. The global update clock of batch i is the END-of-batch count of real
ratings, ``cum_i`` (plus the state's counter at round start). Per batch:

1. user noise: every user row touched in any of the 8 columns takes
   sqrt(max(temp * eta * (cum_i - stamp), 0)) * N(0, 1) on its factor and
   bias lanes and is stamped cum_i;
2. per column k, in order: item noise for the item rows touched in the
   column, the same way; then the gradient against the current user tile
   (it carries the earlier columns' updates) and the noisy item tile,

       err = scal * w * (r - t . p - bu - bv - gb),
       scal = eta * ntrain * bound * lambda_r;

   then both sides apply at once: a row touched k times becomes
   row * base^k + delta on its factor and bias lanes, per lane
   base = 1 - eta * bound * invfreq_row * lambda_lane (lambda_u / lambda_ub,
   lambda_v / lambda_vb), the sign of a negative base kept for odd k. There
   is no saturation.

Rows are the fused homogeneous rows of ``ops/rows.py``; in the bf16
working type rows are rounded before the gather and the scatter operands
err*p and err*t are rounded, t*p is summed unrounded (``cell_sgd.cu``'s
rule with ``mxu_pred`` off). The last-touch stamps are int64 vectors beside
the tables and the inverse frequencies a float32 vector, not lanes of the
rows as on the TPU.

Normals. The TPU kernel draws from its hardware PRNG, which cannot be
matched. Here they come from a counter-based hash keyed by (noise_seed + i,
side, table row, lane), 32-bit multiply-low and xor-shift steps only
(``hash_normals``), so the kernel and the plain version draw the same
numbers. A row takes noise only at its first touch in a batch (later
touches see an elapsed count of 0), so the kernel injects the noise of
every row the batch touches before its first column, which is the same
result. The plain version also takes a normals source, called per (batch,
side, column) with the tile's rows, so that tests can feed it what another
generator gave.

``sgld_cell_epoch`` launches ``csrc/sgld_cells.cu`` on CUDA tensors, on
the walk ``ops/tile_walk.py: tile_walk_route`` picks for the plan (the
tile walk: units of columns on one user tile, one thread-block cluster
each, ordered by ready counters per tile; or the grid walk), and runs
``sgld_cell_epoch_reference`` on CPU tensors; ``SgldCellRunner`` is the
counterpart of ``PallasSgldRunner``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tpu_mf_torch.data.coo import RatingsCOO
from tpu_mf_torch.models.dpmf import DPMFState
from tpu_mf_torch.ops import _build
from tpu_mf_torch.ops.rows import LANES, MAX_DIM, cdiv, fuse_rows, row_lanes
from tpu_mf_torch.ops.sgd_cells import (
    CellPlan,
    DevicePlan,
    prepare_cells,
    upload_plan,
)
from tpu_mf_torch.ops.tile_walk import (
    WALKS,
    DeviceWalk,
    TileWalkCounters,
    item_noise_ranges,
    pick_walk,
    plan_tile_walk,
    routed,
    upload_walk,
    walk_launch,
)

# per-round counts below 2^31: the plans' touch-list offsets are int32
MAX_EXACT_COUNT = (1 << 31) - 1

# hyper = (eta, temp, bound, scal, gb) of one round, as tpu_mf passes it
Hyper = Tuple[float, float, float, float, float]
# normals(batch, side, column, first table row, rows) -> (rows, dim + 1);
# side 0 is the user tile (column 8), side 1 a column's item tile
Normals = Callable[[int, int, int, int, int], torch.Tensor]


def sgld_cells_eligible(state: DPMFState, ntrain: int) -> bool:
    """Whether ``csrc/sgld_cells.cu`` takes the state's rounds: rows within
    ``MAX_DIM`` (``ops/rows.py``) and a round below 2^31 ratings. The
    kernel keeps both tables in HBM, so ``tpu_mf``'s VMEM limits (dim <=
    251, the fused item table within 64 MiB) route nothing here."""
    return (state.params.theta.shape[1] <= MAX_DIM
            and ntrain < MAX_EXACT_COUNT)


# ---- counter-based normals ---------------------------------------------------

_MASK = 0xFFFFFFFF
_SIDE_KEYS = (0x9E3779B9, 0x3C6EF372)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for int64 x in [0, 2^32): c split into 16-bit halves
    keeps every product below 2^63."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _word(key: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """32 random bits of counter c under key (two finalizer rounds)."""
    return _fmix32((_fmix32(c ^ key) + key) & _MASK)


def hash_normals(noise_seed: int, i: int, side: int, rows: torch.Tensor,
                 width: int) -> torch.Tensor:
    """(len(rows), width) standard normals of batch i for table rows
    ``rows`` (int64) and logical lanes 0..width-1 (factors, then the
    bias): 24-bit uniforms and Box-Muller as ``tpu_mf``'s bits_to_normals,
    from the bits ``csrc/sgld_cells.cu`` computes."""
    dev = rows.device
    kb = _fmix32(torch.tensor((noise_seed + i) & _MASK, device=dev))
    ks = _fmix32((kb + _SIDE_KEYS[side]) & _MASK)
    kr = _word(ks, (rows & _MASK)[:, None])
    c = 2 * torch.arange(width, device=dev)[None, :]
    b1, b2 = _word(kr, c), _word(kr, c + 1)
    f32 = torch.float32
    u1 = (b1 >> 8).to(f32) * (1.0 / (1 << 24)) + (1.0 / (1 << 25))
    u2 = (b2 >> 8).to(f32) * (1.0 / (1 << 24))
    two_pi = torch.tensor(2.0 * math.pi, dtype=f32, device=dev)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(two_pi * u2)


def _decay(inv: torch.Tensor, lamv: torch.Tensor, k: torch.Tensor,
           eb: torch.Tensor) -> torch.Tensor:
    """(rows, lanes) base^k per lane, base = 1 - eb * inv * lambda, as
    |base|^k with the sign of a negative base for odd k; 1 where k = 0."""
    base = 1.0 - (eb * inv)[:, None] * lamv[None, :]
    mag = torch.exp(k[:, None] * torch.log(torch.clamp(base.abs(),
                                                       min=1e-30)))
    odd = torch.remainder(k, 2.0) == 1.0
    dec = torch.where((base < 0) & odd[:, None], -mag, mag)
    return torch.where(k[:, None] == 0, torch.ones_like(dec), dec)


def _noise_lanes(dim: int, side: int, dev) -> torch.Tensor:
    """Table lanes of the logical noise lanes 0..dim: the factors, then the
    bias (lane dim of a user row, dim + 1 of an item row)."""
    lanes = torch.arange(dim + 1, device=dev)
    if side == 1:
        lanes[dim] = dim + 1
    return lanes


def _inject(tab, stamps, touched, clock: int, te, lanes, nz) -> None:
    """Lazy noise on the touched rows of a tile (in place): std =
    sqrt(max(te * (clock - stamp), 0)); touched rows are stamped."""
    el = (clock - stamps).to(torch.float32)
    std = torch.sqrt(torch.clamp(te * el, min=0.0)) * touched
    tab[:, lanes] += std[:, None] * nz
    stamps[touched] = clock


def _scalars(hyper: Hyper, dev):
    """f32 tensors of scal, gb, eta * bound and temp * eta (tpu_mf's f32
    products)."""
    eta, temp, bound, scal, gb = torch.tensor(hyper, dtype=torch.float32,
                                              device=dev)
    return scal, gb, eta * bound, temp * eta


class SgldCellPlan(NamedTuple):
    """A gen-1 plan on a device for SGLD rounds: the window-plan columns,
    the END-of-batch clock (cumulative real ratings, int64), per batch the
    distinct touched rows (tile-local user rows, table item rows) the
    kernel injects noise into, and the round's tile walk (with the item
    touch list split by tile, ``item_noise_ranges``)."""

    cells: DevicePlan
    cum: torch.Tensor      # (NB,) int64
    cum_host: np.ndarray
    tu_off: torch.Tensor   # (NB + 1,) int32
    tu_ids: torch.Tensor   # int32 tile-local user rows
    tv_off: torch.Tensor   # (NB + 1,) int32
    tv_ids: torch.Tensor   # int32 item table rows
    walk: DeviceWalk


def _touch_lists(plan: CellPlan) -> Tuple[np.ndarray, ...]:
    """(tu_off, tu_ids, tv_off, tv_ids): the distinct rows each batch
    touches, user rows tile-local, item rows as table rows."""
    nb = plan.u.shape[0]
    real = plan.w > 0
    b = np.broadcast_to(np.arange(nb, dtype=np.int64)[:, None, None],
                        real.shape)[real]
    rows_v = plan.n_gv * plan.tile_v
    grow_v = plan.gv[:, None, :].astype(np.int64) * plan.tile_v + plan.v
    out = []
    for key, n in ((b * plan.tile_u + plan.u[real], plan.tile_u),
                   (b * rows_v + grow_v[real], rows_v)):
        key = np.unique(key)
        off = np.concatenate([[0], np.cumsum(np.bincount(key // n,
                                                         minlength=nb))])
        out += [off.astype(np.int32), (key % n).astype(np.int32)]
    return tuple(out)


def sgld_cell_epoch_reference(theta, phi, stamp_u, stamp_v, invf_u, invf_v,
                              lam, plan: SgldCellPlan, clock0: int,
                              hyper: Hyper, dim: int, noise_seed: int,
                              work: torch.dtype = torch.float32,
                              normals: Optional[Normals] = None) -> None:
    """Plain PyTorch SGLD round on a gen-1 plan, in place on the fused
    tables and the stamps: per batch the user noise, then per column the
    item noise, the gradient and the apply, as ``tpu_mf``'s kernel orders
    them. ``normals`` defaults to ``hash_normals``."""
    f32 = torch.float32
    dev = theta.device
    cp = plan.cells
    tu, tv = cp.tile_u, cp.tile_v
    lanes = theta.shape[1]
    scal, gb, eb, te = _scalars(hyper, dev)
    lane = torch.arange(lanes, device=dev)
    keep_u = (lane <= dim).to(f32)
    keep_v = ((lane < dim) | (lane == dim + 1)).to(f32)
    nz_u, nz_v = _noise_lanes(dim, 0, dev), _noise_lanes(dim, 1, dev)
    tile_rows = torch.arange(max(tu, tv), device=dev)

    def batch_normals(i, gu):
        """(user tile's normals, (8, tv, dim + 1) of the columns' item
        tiles): from ``normals``, or the hash in one call per side (its
        key has no column)."""
        if normals is not None:
            return (normals(i, 0, 8, gu * tu, tu),
                    [normals(i, 1, k, int(cp.gv_host[i, k]) * tv, tv)
                     for k in range(8)])
        v_rows = cp.gv[i].long()[:, None] * tv + tile_rows[None, :tv]
        return (hash_normals(noise_seed, i, 0, gu * tu + tile_rows[:tu],
                             dim + 1),
                hash_normals(noise_seed, i, 1, v_rows.reshape(-1),
                             dim + 1).view(8, tv, dim + 1))

    def rnd(x):
        return x if work == f32 else x.to(work).to(f32)

    def counts(ids, w, n):
        return torch.zeros(n, dtype=f32, device=dev).index_add_(0, ids, w)

    for i in range(cp.u.shape[0]):
        gu = int(cp.gu_host[i])
        us = slice(gu * tu, (gu + 1) * tu)
        th, st_u, inv_u = theta[us], stamp_u[us], invf_u[us]
        clock = clock0 + int(plan.cum_host[i])
        w = cp.w[i]
        real = w > 0
        ul = torch.where(real, cp.u[i], 0).long()
        k_all = counts(ul.reshape(-1), w.reshape(-1), tu)
        nzb_u, nzb_v = batch_normals(i, gu)
        _inject(th, st_u, k_all > 0, clock, te, nz_u, nzb_u)
        for k in range(8):
            gv = int(cp.gv_host[i, k])
            vs = slice(gv * tv, (gv + 1) * tv)
            ph, st_v, inv_v = phi[vs], stamp_v[vs], invf_v[vs]
            vl = torch.where(real[k], cp.v[i, k], 0).long()
            kv = counts(vl, w[k], tv)
            _inject(ph, st_v, kv > 0, clock, te, nz_v, nzb_v[k])
            t, p = rnd(th[ul[k]]), rnd(ph[vl])
            pred = (t * p).sum(-1, keepdim=True) + gb
            wk = w[k].unsqueeze(-1)
            err = (scal * wk) * (cp.r[i, k].unsqueeze(-1) - pred)
            d_th = torch.zeros(tu, lanes, dtype=f32, device=dev)
            d_th.index_add_(0, ul[k], rnd(err * p))
            d_ph = torch.zeros(tv, lanes, dtype=f32, device=dev)
            d_ph.index_add_(0, vl, rnd(err * t))
            ku = counts(ul[k], w[k], tu)
            th.copy_(th * _decay(inv_u, lam[0], ku, eb) + d_th * keep_u)
            ph.copy_(ph * _decay(inv_v, lam[1], kv, eb) + d_ph * keep_v)


def _sgld_lib() -> ctypes.CDLL:
    return bind_sgld_lib(_build.load("sgld_cells"))


def bind_sgld_lib(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``, a build of ``csrc/sgld_cells.cu``, with its entry points'
    argument types set."""
    fn = lib.tmf_sgld_epoch
    fn.argtypes = ([ctypes.c_void_p] * 22 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 14 + [ctypes.c_float] * 5
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    fn = lib.tmf_sgld_walk_clusters
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return lib


_WORK = {torch.float32: 0, torch.bfloat16: 1}


def launch_sgld(tables, invf, lam, cells: DevicePlan, cum, clock0: int,
                hyper: Hyper, dim: int, noise_seed: int, work: torch.dtype,
                touch=None, ring=None, ap=None, slot=None,
                walk: DeviceWalk | None = None) -> None:
    """One launch of ``csrc/sgld_cells.cu`` on CUDA tensors: the gen-1 mode
    with ``touch`` lists, or the slot mode with ``ring``, ``ap`` flags and
    ``slot = (pack, noise_every, cap)`` (slot windows always saturate); on
    the tile walk of ``walk``, or the grid walk when it is None. Checks
    devices, types and shapes, and raises if the launch fails."""
    theta, phi, stamp_u, stamp_v = tables
    dev = theta.device
    if work not in _WORK:
        raise ValueError(f"sgld kernel: unsupported working type {work}")
    nb, cols, col = cells.u.shape
    lanes = theta.shape[1]
    tu, tv = cells.tile_u, cells.tile_v
    checks = [("theta", theta, torch.float32, None),
              ("phi", phi, torch.float32, None),
              ("stamp_u", stamp_u, torch.int64, (theta.shape[0],)),
              ("stamp_v", stamp_v, torch.int64, (phi.shape[0],)),
              ("invf_u", invf[0], torch.float32, (theta.shape[0],)),
              ("invf_v", invf[1], torch.float32, (phi.shape[0],)),
              ("lam", lam, torch.float32, (2, lanes)),
              ("u", cells.u, torch.int32, (nb, 8, col)),
              ("v", cells.v, torch.int32, (nb, 8, col)),
              ("r", cells.r, torch.float32, (nb, 8, col)),
              ("w", cells.w, torch.float32, (nb, 8, col)),
              ("gu", cells.gu, torch.int32, (nb,)),
              ("gv", cells.gv, torch.int32, (nb, 8)),
              ("cum", cum, torch.int64, (nb,))]
    if touch is not None:
        checks += [("tu_off", touch[0], torch.int32, (nb + 1,)),
                   ("tu_ids", touch[1], torch.int32, None),
                   ("tv_off", touch[2], torch.int32, (nb + 1,)),
                   ("tv_ids", touch[3], torch.int32, None)]
    else:
        checks += [("ring", ring, torch.float32, None),
                   ("ap", ap, torch.int32, (nb, 8))]
    for name, t, dtype, shape in checks:
        if (t.device != dev or not t.is_contiguous() or t.dtype != dtype
                or (shape and tuple(t.shape) != shape)):
            raise ValueError(f"sgld kernel: {name} must be a contiguous "
                             f"{dtype} tensor of shape {shape} on {dev}")
    if (cols != 8 or theta.shape[0] % tu or phi.shape[0] % tv
            or phi.shape[1] != lanes or dim + 3 > lanes):
        raise ValueError("sgld kernel: table or plan shapes do not match")
    pack = noise_every = nq_u = nq_v = n_ring = 0
    cap = 1.0
    if slot is not None:
        pack, noise_every, cap = slot
        n_ring = ring.shape[0]
        if ring.shape[1] != LANES or n_ring < 8 + max(tu, tv):
            raise ValueError("sgld kernel: the noise ring is too small")
        nq_u, nq_v = ring_slices(n_ring, tu), ring_slices(n_ring, tv)
    scal, gb, eb, te = (float(x) for x in _scalars(hyper, "cpu"))
    acc = torch.zeros_like(phi)
    lib = _sgld_lib()
    seed32 = ((noise_seed & _MASK) ^ 0x80000000) - 0x80000000
    with torch.cuda.device(dev):
        launch = None
        if walk is None:
            d_theta = torch.zeros(tu, lanes, dtype=torch.float32, device=dev)
        else:
            mode = int(slot is not None)
            launch, d_theta = walk_launch(
                walk, 0, nb, 1 if mode else None, ("sgld", _WORK[work], mode),
                lambda c, out: lib.tmf_sgld_walk_clusters(_WORK[work], mode,
                                                          c, out),
                tu, lanes, dev)
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tmf_sgld_epoch(
            theta.data_ptr(), phi.data_ptr(), stamp_u.data_ptr(),
            stamp_v.data_ptr(), invf[0].data_ptr(), invf[1].data_ptr(),
            lam.data_ptr(), cells.u.data_ptr(), cells.v.data_ptr(),
            cells.r.data_ptr(), cells.w.data_ptr(), cells.gu.data_ptr(),
            cells.gv.data_ptr(), ap.data_ptr() if ap is not None else None,
            cum.data_ptr(),
            *(t.data_ptr() for t in touch) if touch else (None,) * 4,
            ring.data_ptr() if ring is not None else None,
            d_theta.data_ptr(), acc.data_ptr(), clock0,
            nb, col, tu, tv, lanes, dim, _WORK[work], int(slot is not None),
            pack, n_ring, nq_u, nq_v, noise_every, seed32,
            scal, gb, eb, te, cap,
            None if launch is None else ctypes.addressof(launch), stream)
    if rc != 0:
        raise RuntimeError(f"sgld_cells kernel launch failed: CUDA error {rc}")
    if launch is not None:
        walk.counters.advance(launch.n_units, launch.n_clusters)


def ring_slices(n_ring: int, tile: int) -> int:
    """Number of 8-row offsets a tile's ring slice starts from (a power of
    two), as ``tpu_mf``'s slot kernel computes it."""
    return 1 << (((n_ring - tile) // 8).bit_length() - 1)


def sgld_cell_epoch(theta, phi, stamp_u, stamp_v, invf_u, invf_v, lam,
                    plan: SgldCellPlan, clock0: int, hyper: Hyper, dim: int,
                    noise_seed: int, work: torch.dtype = torch.bfloat16,
                    walk: str | None = None) -> None:
    """One SGLD round on a gen-1 plan, in place on the fused tables and
    stamps. CPU tensors take the plain version; CUDA tensors launch
    ``csrc/sgld_cells.cu`` (one launch per round) or raise, on the walk
    ``walk`` forces ("tile" or "grid"; default: the plan's route)."""
    if theta.device.type == "cpu":
        sgld_cell_epoch_reference(theta, phi, stamp_u, stamp_v, invf_u,
                                  invf_v, lam, plan, clock0, hyper, dim,
                                  noise_seed, work)
        return
    if theta.device.type != "cuda":
        raise ValueError(f"sgld_cell_epoch: no kernel for {theta.device}")
    route = pick_walk(plan.walk, walk)
    launch_sgld((theta, phi, stamp_u, stamp_v), (invf_u, invf_v), lam,
                plan.cells, plan.cum, clock0, hyper, dim, noise_seed, work,
                touch=(plan.tu_off, plan.tu_ids, plan.tv_off, plan.tv_ids),
                walk=plan.walk if route == "tile" else None)
    sgld_cell_epoch.launches += 1
    sgld_cell_epoch.walks[route] += 1


sgld_cell_epoch.launches = 0  # kernel launches (CUDA calls), not CPU runs
sgld_cell_epoch.walks = dict.fromkeys(WALKS, 0)  # the launches by walk


class SgldRunner:
    """What the SGLD runners share (``pad`` / ``set_lambdas`` / ``epoch`` /
    ``unpack``, as ``tpu_mf``'s): fused homogeneous tables with int64
    stamps beside them, the inverse frequencies and the per-lane lambdas.
    ``map_u`` / ``map_v`` are new-of-old id relabelings the plans were built
    on; ``pad`` / ``unpack`` invert them. Plans reach the device at
    ``materialize`` (``pad`` calls it)."""

    launches = 0  # kernel launches made by the family's runners

    def __init__(self, plans, nu: int, nv: int, n_real: int, mxu: str,
                 device, map_u=None, map_v=None):
        self.plans = plans
        self.plan = plans[0]
        self.nb = max(p.u.shape[0] for p in plans)
        # distinct noise seeds of successive rounds are spaced by this
        self.seed_stride = self.nb + 1
        self.tile_u, self.tile_v = self.plan.tile_u, self.plan.tile_v
        self.nu, self.nv, self.n_real = nu, nv, n_real
        self._map_u, self._map_v = map_u, map_v
        self.work_dtype = {"bfloat16": torch.bfloat16,
                           "float32": torch.float32}[mxu]
        self.device = torch.device(device)
        self._dev: list = []
        self.dim = None

    def _upload(self, idx: int):
        """Plan ``idx`` on the runner's device."""
        raise NotImplementedError

    def materialize(self) -> "SgldRunner":
        """Upload the plans and their tile walks, which share one set of
        hand-off counters (once)."""
        if not self._dev:
            self._counters = TileWalkCounters(self.plan.n_gv, self.plan.n_gu,
                                              self.device)
            self._dev = [self._upload(i) for i in range(len(self.plans))]
        return self

    def route(self, epoch_idx: int = 0) -> str:
        """The walk the kernel takes on plan ``epoch_idx``
        (``tile_walk_route``)."""
        return self.materialize()._dev[epoch_idx % len(self._dev)].walk.route

    def _rows(self, idmap, n):
        if idmap is None:
            return slice(0, n)
        return torch.as_tensor(idmap, dtype=torch.int64).to(self.device)

    def set_lambdas(self, state: DPMFState) -> None:
        """(2, lanes) per-lane lambdas: lambda_u on the user factor lanes
        and lambda_ub on the user bias lane; lambda_v and lambda_vb on the
        item row's; zero elsewhere, so no other lane decays."""
        dim = state.params.theta.shape[1]
        lam = torch.zeros(2, row_lanes(dim), dtype=torch.float32,
                          device=self.device)
        lam[0, :dim] = state.lambda_u.to(self.device)
        lam[0, dim] = state.lambda_ub.to(self.device)
        lam[1, :dim] = state.lambda_v.to(self.device)
        lam[1, dim + 1] = state.lambda_vb.to(self.device)
        self.lam = lam

    def pad(self, state: DPMFState):
        """(theta_ext, phi_ext, stamp_u, stamp_v) of the state on the
        runner's device; also sets the inverse frequencies and lambdas."""
        self.materialize()
        p = self.plan
        params = state.params
        self.dim = dim = params.theta.shape[1]
        self.gb = float(params.gb)
        self.set_lambdas(state)
        lanes = row_lanes(dim)
        out, invf = [], []
        for side, fac, bias, stamps, weights, rows, idmap, n in (
                ("u", params.theta, params.bu, state.gcountu, state.ur,
                 p.n_gu * p.tile_u, self._map_u, self.nu),
                ("v", params.phi, params.bv, state.gcountv, state.vr,
                 p.n_gv * p.tile_v, self._map_v, self.nv)):
            at = self._rows(idmap, n)
            out.append(fuse_rows(fac.to(self.device), bias.to(self.device),
                                 rows, lanes, side, idmap))
            st = torch.zeros(rows, dtype=torch.int64, device=self.device)
            st[at] = stamps[:n].to(self.device)
            out.append(st)
            iv = torch.zeros(rows, dtype=torch.float32, device=self.device)
            iv[at] = weights.to(self.device)
            invf.append(iv)
        self.invf = tuple(invf)
        return out[0], out[2], out[1], out[3]

    def unpack(self, state: DPMFState, tables) -> DPMFState:
        """The state after a round: tables and stamps back in model order,
        the global counter advanced by the round's real ratings."""
        theta, phi, stamp_u, stamp_v = tables
        dim, nu, nv = self.dim, self.nu, self.nv
        th = theta[self._rows(self._map_u, nu)]
        ph = phi[self._rows(self._map_v, nv)]
        params = state.params._replace(
            theta=th[:, :dim].contiguous(), phi=ph[:, :dim].contiguous(),
            bu=th[:, dim].contiguous(), bv=ph[:, dim + 1].contiguous())
        dev = state.gcountu.device
        gcountu = torch.cat([stamp_u[self._rows(self._map_u, nu)].to(dev),
                             state.gcountu[nu:]])
        gcountv = torch.cat([stamp_v[self._rows(self._map_v, nv)].to(dev),
                             state.gcountv[nv:]])
        return state._replace(params=params, gcountu=gcountu,
                              gcountv=gcountv,
                              gcount=state.gcount + self.n_real)


class SgldCellRunner(SgldRunner):
    """Fused SGLD rounds over gen-1 cell plans, as ``tpu_mf``'s
    PallasSgldRunner: ``n_plans`` > 1 rotates independently shuffled plans
    (seeds seed + 7919 p) by round; ``mxu`` names the working type
    ("bfloat16", or "float32" for parity runs)."""

    launches = 0

    def __init__(self, train_ds: RatingsCOO, tile_u: int = 256,
                 tile_v: int = 256, batch: int = 1024, seed: int = 0,
                 mxu: str = "bfloat16", n_plans: int = 1,
                 device: torch.device | str = "cuda"):
        batch = cdiv(batch, 8) * 8
        plans = [prepare_cells(train_ds, tile_u, tile_v, batch,
                               seed + 7919 * p)
                 for p in range(max(1, n_plans))]
        super().__init__(plans, train_ds.nu, train_ds.nv, int(plans[0].n_real),
                         mxu, device)
        self.batch = batch
        # the global clock after each batch: cumulative REAL ratings
        self.cum_bases = [np.cumsum(p.w.reshape(p.w.shape[0], -1).sum(1))
                          .astype(np.int64) for p in plans]

    def _upload(self, idx: int) -> SgldCellPlan:
        plan, cum = self.plans[idx], self.cum_bases[idx]
        lists = _touch_lists(plan)
        walk = plan_tile_walk(plan, 0, plan.u.shape[0])
        nz = item_noise_ranges(walk, lists[2], lists[3], plan.tile_v,
                               plan.n_gv)
        touch = [torch.as_tensor(a).to(self.device) for a in lists]
        return SgldCellPlan(upload_plan(plan, self.device),
                            torch.as_tensor(cum).to(self.device), cum, *touch,
                            routed(upload_walk(walk, self._counters, nz=nz)))

    def epoch(self, tables, state_gcount: int, hyper: Hyper,
              noise_seed: int, epoch_idx: int = 0, walk: str | None = None):
        """One round in place on the tables; ``hyper`` = (eta, temp, bound,
        scal, gb). ``epoch_idx`` rotates the plans; ``walk`` forces "tile"
        or "grid" (default: the plan's route)."""
        plan = self.materialize()._dev[epoch_idx % len(self._dev)]
        launched = sgld_cell_epoch.launches
        sgld_cell_epoch(*tables, *self.invf, self.lam, plan,
                        int(state_gcount), hyper, self.dim, noise_seed,
                        self.work_dtype, walk)
        type(self).launches += sgld_cell_epoch.launches - launched
        return tables
