"""Fused AdaptReg epochs on gen-1 cell plans (counterpart of
``tpu_mf/ops/pallas_adreg.py``; reference semantics: src/admf.h:52-86).

An epoch is the gen-1 window-plan walk of ``ops/sgd_cells.py`` (a window is
one column, both sides apply at every column) split into S segments of
consecutive plan batches; the batch list is padded with no-op batches
(w = 0) to a whole number of segments, S = min(segments, batches). Inside a
segment, per rating,

    err = eta * w * (r - act(t . p + gb))     act: identity, or sigmoid
                                              with loss 1

and at an apply a row touched k times becomes row_l * base_l^k + d_l per
kept lane, base_l = 1 - eta * lam_l: lam_u on the user factor lanes, lam_bu
on its bias lane, lam_v / lam_bv on the item's (``build_adreg_lamvec``);
base^k keeps the sign of a negative base for odd k. No saturation; t*p is
summed unrounded.

Between segments the four lambdas take a hypergradient step
(``adreg_segment_step``, ``hypergrad_ext_rows``): K = 64 validation
records, their rows gathered before and after the segment, the step scaled
by eta_reg * eta * (the segment's user-visits) / K and clamped at 0. A
segment's user-visits are the distinct real users of each of its batches,
summed. Everything between segments runs on the lambdas' device: the kernel
reads them through a device pointer, and no segment waits for the host.

``adreg_segment`` launches the hand-written kernel ``csrc/adreg_cells.cu``
on CUDA tensors, on the tile walk of each segment's units
(``ops/tile_walk.py``: thread-block clusters ordered by ready counters per
tile, the kernel's only walk), and runs the plain version
``adreg_segment_reference`` on CPU tensors. The fused runners keep no
per-rating shadow tables (only the batched path does): ``state`` returns
shadows that are copies of the params.

Spans (``train/metrics.py``, off unless turned on): per segment a
``tmf.adreg_segment`` (its validation rows gathered before the walk, and
the walk; attributes ``segment`` and ``walk``, "tile"; counts ``launches``
and ``walk_tile``) and a ``tmf.hyper_step`` (the rows gathered after it
and the step; count ``valid_rows``, K a step), both with device events on
CUDA tensors; ``materialize`` in ``tmf.plan_upload``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from tpu_mf_torch.data.coo import RatingsCOO
from tpu_mf_torch.models.admf import AdaptRegState, with_shadows
from tpu_mf_torch.models.mf import MFParams
from tpu_mf_torch.ops import _build
from tpu_mf_torch.ops.adreg import N_REG_SAMPLES, activate
from tpu_mf_torch.ops.common import distinct_counts
from tpu_mf_torch.ops.rows import MAX_DIM, cdiv
from tpu_mf_torch.ops.sgd_cells import (
    GROUPS,
    WALK_KEYS,
    WORK,
    DevicePlan,
    WindowRunner,
    check_window_launch,
    pad_plan_nb,
    prepare_cells,
    upload_plan,
    window_keep,
    window_reference,
)
from tpu_mf_torch.ops.tile_walk import (
    WALKS,
    DeviceWalk,
    TileWalkCounters,
    segment_walks,
    upload_walk,
    walk_launch,
)
from tpu_mf_torch.train.metrics import count, span

# the validation set on a device: (u, v, r), ids in table rows
Valid = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def adreg_cells_eligible(state: AdaptRegState) -> bool:
    """Whether ``csrc/adreg_cells.cu`` takes the state's epochs: rows within
    ``MAX_DIM`` (``ops/rows.py``). The kernel keeps both tables in HBM, so
    ``tpu_mf``'s VMEM limit (the fused item table within 64 MiB) routes
    nothing here."""
    return state.params.theta.shape[1] <= MAX_DIM


def build_adreg_lamvec(dim: int, lams: torch.Tensor,
                       lanes: int) -> torch.Tensor:
    """(2, lanes) per-lane decay rates from lams = [lam_u, lam_v, lam_bu,
    lam_bv]: [lam_u x dim | lam_bu | 0..] for the user rows, [lam_v x dim |
    0 | lam_bv | 0..] for the item rows; 0 (base 1) on every other lane."""
    z = torch.zeros((), dtype=torch.float32, device=lams.device)
    lane = torch.arange(lanes, device=lams.device)
    fac = lane < dim
    return torch.stack([
        torch.where(fac, lams[0], torch.where(lane == dim, lams[2], z)),
        torch.where(fac, lams[1], torch.where(lane == dim + 1, lams[3], z))])


def adreg_segment_reference(theta: torch.Tensor, phi: torch.Tensor,
                            plan: DevicePlan, b0: int, b1: int, eta: float,
                            lams: torch.Tensor, gb: float, dim: int,
                            theta_groups: int = 8, phi_groups: int = 8,
                            work: torch.dtype = torch.bfloat16,
                            loss: int = 0) -> None:
    """Plain PyTorch AdaptReg segment over the plan batches [b0, b1), in
    place on the fused tables: ``window_reference`` with the per-lane,
    sign-aware decay and the activation."""
    dev = theta.device
    eta_t, gb_t = torch.tensor([eta, gb], dtype=torch.float32, device=dev)
    base = 1.0 - eta_t * build_adreg_lamvec(dim, lams.to(dev), theta.shape[1])
    ln = torch.log(torch.clamp(base.abs(), min=1e-30))
    neg = base < 0
    keep = window_keep(theta.shape[1], dim, dev)

    def apply(cur, d, side):
        k = d[:, dim + 2:dim + 3]
        mag = torch.exp(k * ln[side])
        odd = torch.remainder(k, 2.0) == 1.0
        fac = torch.where(neg[side] & odd, -mag, mag)
        fac = torch.where(k == 0, torch.ones_like(fac), fac)
        return cur * fac + d * keep[side]

    window_reference(theta, phi, plan, (b0, b1), eta_t, gb_t, dim,
                     theta_groups, phi_groups, work, False, apply,
                     (lambda x: activate(x, loss)))


def _adreg_lib() -> ctypes.CDLL:
    return bind_adreg_lib(_build.load("adreg_cells"))


def bind_adreg_lib(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``, a build of ``csrc/adreg_cells.cu``, with its entry points'
    argument types set."""
    fn = lib.tmf_adreg_segment
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    fn = lib.tmf_adreg_walk_clusters
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return lib


def adreg_segment(theta: torch.Tensor, phi: torch.Tensor, plan: DevicePlan,
                  b0: int, b1: int, eta: float, lams: torch.Tensor, gb: float,
                  dim: int, theta_groups: int = 8, phi_groups: int = 8,
                  work: torch.dtype = torch.bfloat16, loss: int = 0,
                  walk: DeviceWalk | None = None) -> None:
    """One AdaptReg segment (plan batches [b0, b1)), in place on the fused
    (theta_ext, phi_ext). CPU tensors take the plain version; CUDA tensors
    launch ``csrc/adreg_cells.cu`` on the tile walk of ``walk`` (the plan's
    ``DeviceWalk``, whose ranges include [b0, b1); ValueError without it),
    which reads the four lambdas (``lams``, float32, on the card) when it
    runs, or raise."""
    if theta_groups not in GROUPS or phi_groups not in GROUPS:
        raise ValueError(f"groups must divide the 8 columns, got "
                         f"{theta_groups}/{phi_groups}")
    if work not in WORK:
        raise ValueError(f"adreg_segment: unsupported working type {work}")
    if loss not in (0, 1):
        raise ValueError(f"adreg_segment: loss must be 0 or 1, got {loss}")
    nb, _, sub = plan.u.shape
    if not 0 <= b0 <= b1 <= nb:
        raise ValueError(f"adreg_segment: batches [{b0}, {b1}) outside the "
                         f"plan's {nb}")
    if theta.device.type == "cpu":
        adreg_segment_reference(theta, phi, plan, b0, b1, eta, lams, gb, dim,
                                theta_groups, phi_groups, work, loss)
        return
    if theta.device.type != "cuda":
        raise ValueError(f"adreg_segment: no kernel for device {theta.device}")
    if walk is None:
        raise ValueError("adreg_segment: a CUDA launch needs the plan's "
                         "tile walk")
    check_window_launch("adreg_segment", theta, phi, plan, phi_groups, dim,
                        (("lams", lams, torch.float32, (4,)),))
    lanes = theta.shape[1]
    acc = torch.zeros_like(phi)
    lib = _adreg_lib()
    with torch.cuda.device(theta.device):
        launch, d_theta = walk_launch(  # d_theta: held through the launch
            walk, b0, b1, phi_groups, ("adreg", WORK[work]),
            lambda c, out: lib.tmf_adreg_walk_clusters(WORK[work], c, out),
            plan.tile_u, lanes, theta.device)
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tmf_adreg_segment(
            theta.data_ptr(), phi.data_ptr(), plan.u.data_ptr(),
            plan.v.data_ptr(), plan.r.data_ptr(), plan.w.data_ptr(),
            plan.gv.data_ptr(), acc.data_ptr(), lams.data_ptr(), sub,
            plan.tile_u, plan.tile_v, lanes, dim, theta_groups, phi_groups,
            WORK[work], loss, eta, gb, ctypes.addressof(launch), stream)
    if rc != 0:
        raise RuntimeError(f"adreg_cells kernel launch failed: CUDA error "
                           f"{rc}")
    walk.counters.advance(launch.n_units, launch.n_clusters)
    adreg_segment.launches += 1
    adreg_segment.walks["tile"] += 1
    count("launches")
    count(WALK_KEYS["tile"])


adreg_segment.launches = 0  # kernel launches (CUDA calls), not CPU runs
# the launches by walk, every key of WALKS ("grid" stays 0: the kernel has
# the tile walk only)
adreg_segment.walks = dict.fromkeys(WALKS, 0)


def hypergrad_ext_rows(new_t: torch.Tensor, new_p: torch.Tensor,
                       old_t: torch.Tensor, old_p: torch.Tensor,
                       sr: torch.Tensor, lams: torch.Tensor, eta: float,
                       eta_reg: float, n_visits: torch.Tensor, gb: float,
                       dim: int, loss: int = 0) -> torch.Tensor:
    """The hypergradient step on lams = [lam_u, lam_v, lam_bu, lam_bv] from
    K sampled fused rows before (old) and after (new) a segment
    (model.h:86-102): factors in lanes [:dim], the user bias in lane dim,
    the item bias in lane dim + 1; scaled by eta_reg * eta * n_visits / K
    and clamped at 0. Scalars stay on the lambdas' device."""
    tf, tb = new_t[:, :dim], new_t[:, dim]
    pf, pb = new_p[:, :dim], new_p[:, dim + 1]
    grad = sr - activate((tf * pf).sum(1) + tb + pb + gb, loss)
    inner_u = (old_t[:, :dim] * pf).sum(1)
    inner_v = (tf * old_p[:, :dim]).sum(1)
    # eta_reg * eta in float32, as tpu_mf forms it; exact as a Python float
    ee = float(np.float32(eta_reg) * np.float32(eta))
    scale = n_visits * ee / sr.shape[0]
    steps = torch.stack([(grad * inner_u).sum(), (grad * inner_v).sum(),
                         (grad * old_t[:, dim]).sum(),
                         (grad * old_p[:, dim + 1]).sum()])
    return torch.clamp(lams - scale * steps, min=0.0)


def adreg_segment_step(tables, lams: torch.Tensor, plan: DevicePlan, b0: int,
                       b1: int, valid: Valid, samples: torch.Tensor,
                       eta: float, eta_reg: float, visits: torch.Tensor,
                       gb: float, dim: int, theta_groups: int = 8,
                       phi_groups: int = 8, work: torch.dtype = torch.bfloat16,
                       loss: int = 0, reference: bool = False,
                       walk: DeviceWalk | None = None,
                       segment: int = 0) -> torch.Tensor:
    """One segment and the step after it (``tpu_mf``'s
    ``_run_adreg_seg_step``): the validation rows of ``samples`` gathered
    from the segment-start tables, the segment (``adreg_segment``, in place
    on ``tables``, on the tile walk of ``walk``; its plain version on any
    device with ``reference``), the rows gathered again, and
    the hypergradient; returns the new lambdas. ``visits`` is the segment's
    user-visits (0-d). The two halves run in the spans
    ``tmf.adreg_segment`` and ``tmf.hyper_step`` of segment ``segment``
    (module docstring)."""
    theta, phi = tables
    uv, vv, rv = valid
    cuda = theta.device.type == "cuda"
    with span("tmf.adreg_segment", cuda, segment=segment, walk="tile"):
        su, sv, sr = uv[samples], vv[samples], rv[samples]
        old_t, old_p = theta[su], phi[sv]
        if reference:
            adreg_segment_reference(theta, phi, plan, b0, b1, eta, lams, gb,
                                    dim, theta_groups, phi_groups, work, loss)
        else:
            adreg_segment(theta, phi, plan, b0, b1, eta, lams, gb, dim,
                          theta_groups, phi_groups, work, loss, walk)
    with span("tmf.hyper_step", cuda, segment=segment):
        count("valid_rows", samples.shape[0])
        return hypergrad_ext_rows(theta[su], phi[sv], old_t, old_p, sr, lams,
                                  eta, eta_reg, visits, gb, dim, loss)


def segment_seed(key: int, seg: int) -> int:
    """The validation-sample seed of segment ``seg`` of the epoch keyed
    ``key``."""
    return (key * 1_000_003 + seg) & 0x7FFF_FFFF_FFFF_FFFF


class AdRegRunner:
    """What the AdaptReg runners add to a ``WindowRunner`` family (listed
    first among the bases): plans padded to whole segments, the
    validation set in the tables' row order, the four lambdas on the
    runner's device, and ``pad`` / ``epoch`` / ``trim`` / ``state`` as
    ``tpu_mf``'s runners have them. Each family counts its own
    ``launches``."""

    def _adreg_init(self, valid_ds: RatingsCOO, segments: int,
                    loss: int) -> None:
        if loss not in (0, 1):
            raise ValueError(f"loss must be 0 or 1, got {loss}")
        self.loss = loss
        # segments per plan: min(segments, batches), batches padded to
        # whole segments
        self._segs = [min(segments, p.u.shape[0]) for p in self.plans]
        self.segments = self._segs[0]
        vu, vv = valid_ds.u, valid_ds.v
        if self._map_u is not None:  # the tables' rows are relabeled ids
            vu, vv = self._map_u[vu], self._map_v[vv]
        self._valid_host = (vu.astype(np.int64), vv.astype(np.int64),
                            np.asarray(valid_ds.r, np.float32))
        self._valid: Optional[Valid] = None
        self._visits: list = []
        self.walks: list = []  # per plan, its segments' DeviceWalk
        self.lams: Optional[torch.Tensor] = None

    def seg_len(self, idx: int = 0) -> int:
        """Batches per segment of plan ``idx``."""
        return cdiv(self.plans[idx].u.shape[0], self._segs[idx])

    def materialize(self) -> "AdRegRunner":
        """Upload the plans as padded window plans, their per-segment
        user-visits, their segments' tile walks (``segment_walks`` at one
        column a window, the 8/8 groups) and the validation set to the
        runner's device (once)."""
        if not self._dev:
            with span("tmf.plan_upload"):
                self._upload()
        return self

    def _upload(self) -> None:
        dev = self.device
        p = self.plans[0]
        counters = TileWalkCounters(p.n_gv, p.n_gu, dev)
        for idx, plan in enumerate(self.plans):
            n = self.seg_len(idx)
            wp = pad_plan_nb(self._window_plan(plan), self._segs[idx] * n)
            nb = wp.u.shape[0]
            visits = distinct_counts(wp.u.reshape(nb, -1),
                                     wp.w.reshape(nb, -1) > 0)
            self._visits.append(torch.as_tensor(
                visits.reshape(self._segs[idx], -1).sum(1)).to(dev))
            self._dev.append(upload_plan(wp, dev))
            self.walks.append(upload_walk(
                segment_walks(wp, n, self._segs[idx]), counters))
        self._valid = tuple(torch.as_tensor(x).to(dev)
                            for x in self._valid_host)

    def pad(self, state: AdaptRegState):
        """The fused tables of the state's params; the lambdas move to the
        runner's device."""
        tables = super().pad(state.params)
        self.lams = torch.stack([state.lam_u, state.lam_v, state.lam_bu,
                                 state.lam_bv]).to(self.device, torch.float32)
        return tables

    def draw_samples(self, key: int, seg: int) -> torch.Tensor:
        """The K validation indices of segment ``seg``, drawn on the
        runner's device from a generator seeded by (key, seg)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(segment_seed(key, seg))
        return torch.randint(len(self._valid_host[0]), (N_REG_SAMPLES,),
                             generator=gen, device=self.device)

    def route(self, epoch_idx: int = 0) -> str:
        """The walk the kernel takes on plan ``epoch_idx``'s segments: the
        tile walk, its only one."""
        return "tile"

    def epoch(self, tables, eta: float, eta_reg: float, key: int,
              epoch_idx: int = 0, samples=None, reference: bool = False):
        """One epoch in place on the fused tables (returns them): per
        segment ``adreg_segment_step``; ``epoch_idx`` rotates the plans.
        The validation indices come from ``draw_samples(key, s)``, or from
        ``samples`` ((segments, K) indices) when given. ``reference`` runs
        the plain version on the runner's device (to hold the kernel to it
        on the card)."""
        idx = epoch_idx % len(self.plans)
        plan = self.materialize()._dev[idx]
        tg, pg = self.pick_theta_groups(eta), self.pick_phi_groups(eta)
        if samples is not None:
            samples = torch.as_tensor(samples).to(self.device, torch.int64)
        n = self.seg_len(idx)
        launched = adreg_segment.launches
        for s in range(self._segs[idx]):
            ks = samples[s] if samples is not None else self.draw_samples(
                key, s)
            self.lams = adreg_segment_step(
                tables, self.lams, plan, s * n, (s + 1) * n, self._valid, ks,
                eta, eta_reg, self._visits[idx][s], self.gb, self.dim, tg, pg,
                self.work_dtype, self.loss, reference, self.walks[idx],
                segment=s)
        type(self).launches += adreg_segment.launches - launched
        return tables

    def state(self, tables) -> AdaptRegState:
        """The state after the epochs: tables back in model order (copies),
        shadows that copy them, the learned lambdas."""
        params = MFParams(*(t.clone(memory_format=torch.contiguous_format)
                            for t in self.trim(tables)))
        return with_shadows(params, self.lams.unbind())


class AdRegCellRunner(AdRegRunner, WindowRunner):
    """Fused AdaptReg epochs over gen-1 cell plans, as ``tpu_mf``'s
    PallasAdRegRunner: 8/8 groups, ``segments`` launches per epoch,
    ``n_plans`` > 1 rotates independently shuffled plans (seeds
    seed + 7919 p) by epoch; ``mxu`` names the working type ("bfloat16",
    or "float32" for parity runs)."""

    launches = 0

    def __init__(self, train_ds: RatingsCOO, valid_ds: RatingsCOO,
                 tile_u: int = 512, tile_v: int = 512, batch: int = 4096,
                 segments: int = 8, seed: int = 0, mxu: str = "bfloat16",
                 loss: int = 0, n_plans: int = 1,
                 device: torch.device | str = "cuda"):
        batch = cdiv(batch, 8) * 8
        plans = [prepare_cells(train_ds, tile_u, tile_v, batch,
                               seed + 7919 * p)
                 for p in range(max(1, n_plans))]
        WindowRunner.__init__(self, plans, train_ds.nu, train_ds.nv, mxu, 8,
                              8, False, device)
        self.mxu_pred = False  # the TPU kernel sums unrounded t*p
        self.batch = batch
        self._adreg_init(valid_ds, segments, loss)
