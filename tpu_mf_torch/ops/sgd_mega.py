"""Mega plans on the window-plan kernel (counterpart of
``tpu_mf/ops/pallas_sgd_mega.py``), for dim <= 125.

On the TPU the mega kernel keeps both tables resident in VMEM for the
whole epoch and walks MEGA (<= 8) batches per grid step: layout, which a
Hopper kernel that gathers rows from device memory does not need. What it
computes is the lane-packed kernel's gen-1 math over ``prepare_cells_packed``
plans padded to a multiple of MEGA batches with all-sentinel batches:

    pred = t . p + bu + bv + gb,  err = eta * w * (r - pred)
    dtheta[u] += err * p,  dphi[v] += err * t

with gen-1's theta and phi groups, deferred item applies at the last
column of a phi group that touches a tile, decay (1 - eta*lam)^k and
optional saturation. At pack 1 (63 <= dim <= 125) the rows are gen-1's
homogeneous rows and t*p is rounded to the working type before the row
sum (``mxu_pred``); at P > 1 the TPU sums the products unrounded.

The TPU kernel weights a slot by its sentinel ids, not by ``w``; on these
plans the two agree (a slot is real exactly where its user id is not the
sentinel). So a padded plan is a window plan as it stands, and
``MegaEpochRunner`` runs ``csrc/cell_sgd.cu`` on it, on the fused
homogeneous rows of ``ops/rows.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_mf_torch.data.coo import RatingsCOO
from tpu_mf_torch.models.mf import MFParams
from tpu_mf_torch.ops.rows import LANES, cdiv
from tpu_mf_torch.ops.sgd_cells import WindowRunner
from tpu_mf_torch.ops.sgd_packed import PackedPlan, prepare_cells_packed


def mega_packing_factor(dim: int) -> int:
    """Rows per 128-lane register row on the TPU: 8, 4, 2 as the packed
    family, 1 for the homogeneous rows (dim + 3 lanes, so dim <= 125), and
    0 past that."""
    if dim + 2 <= 16:
        return 8
    if dim + 2 <= 32:
        return 4
    if dim + 2 <= 64:
        return 2
    if dim + 3 <= LANES:
        return 1
    return 0


def _pad_plan_nb(plan: PackedPlan, mega: int) -> PackedPlan:
    """Pad the batch axis to a multiple of ``mega`` with all-sentinel
    batches (w 0, gu and gv 0): they update nothing."""
    nb = plan.u.shape[0]
    pad = (-nb) % mega
    if pad == 0:
        return plan

    def padb(a, fill):
        return np.concatenate([a, np.full((pad,) + a.shape[1:], fill,
                                          a.dtype)])

    return plan._replace(
        u=padb(plan.u, plan.tile_u), v=padb(plan.v, plan.tile_v),
        r=padb(plan.r, 0), w=padb(plan.w, 0), gu=padb(plan.gu, 0),
        gv=padb(plan.gv, 0),
        gd=np.broadcast_to(np.arange(8, dtype=np.int32) % plan.pack,
                           (nb + pad, 8)).copy(),
    )


def mega_eligible(params: MFParams, batch_size: int = 8192) -> bool:
    """``tpu_mf``'s rule for the mega kernel: dim <= 125 and both packed
    tables, the item-sized scratch and the id streams within a 90 MiB VMEM
    budget. A TPU residency rule, kept so that both packages answer alike;
    it bounds nothing in ``csrc/cell_sgd.cu``."""
    dim = params.theta.shape[1]
    pack = mega_packing_factor(dim)
    if pack < 1:
        return False
    nu, nv = params.theta.shape[0], params.phi.shape[0]
    tile = min(128 * pack, 1024) if pack > 1 else 512
    vm_theta = cdiv(nu, tile) * tile // pack * LANES * 4
    vm_phi = cdiv(nv, tile) * tile // pack * LANES * 4
    sub = max(8, batch_size // 8)
    vm_streams = 2 * 2 * 8 * sub * LANES * 4
    return vm_theta + 2 * vm_phi + vm_streams <= 90 * 1024 * 1024


class MegaEpochRunner(WindowRunner):
    """Padded packed plans on a device and gen-1 epochs over them, as
    ``tpu_mf``'s MegaEpochRunner (options: ``WindowRunner``'s, and):

    - ``pack`` from ``dim`` (``mega_packing_factor``); tiles default to
      min(128 * pack, 1024), or 512 at pack 1; batch rounds up to a
      multiple of 8;
    - ``mega`` (default min(8, the fewest batches of a plan)) pads every
      plan to a multiple of it (``_pad_plan_nb``); ``n_plans`` > 1 rotates
      plans of seeds seed + 7919 p;
    - ``mxu_pred`` (default: pack 1) rounds t*p to the working type before
      the row sum.

    The TPU's layout options (``interpret``, ``scatter_dg``) are not
    taken."""

    kind = "mega"
    launches = 0

    def __init__(self, ds: RatingsCOO, tile_u: int | None = None,
                 tile_v: int | None = None, batch: int = 8192, seed: int = 0,
                 mxu: str = "bfloat16", theta_groups: int | None = None,
                 phi_groups: int | None = None, n_plans: int = 1,
                 dim: int | None = None, pack: int | None = None,
                 mega: int | None = None, mxu_pred: bool | None = None,
                 saturate: bool = False,
                 device: torch.device | str = "cuda"):
        if pack is None:
            if dim is None:
                raise ValueError("pass dim= or pack=")
            pack = mega_packing_factor(dim)
        if pack not in (1, 2, 4, 8):
            raise ValueError(f"mega plans need dim <= 125 (pack 1, 2, 4 or "
                             f"8), got pack {pack}")
        if mxu_pred and pack > 1:
            raise ValueError("mxu_pred needs the homogeneous rows of pack 1")
        self.pack = pack
        default_tile = min(128 * pack, 1024) if pack > 1 else 512
        tile_u = tile_u or default_tile
        tile_v = tile_v or default_tile
        self.batch = batch = cdiv(batch, 8) * 8
        plans = [prepare_cells_packed(ds, tile_u, tile_v, batch,
                                      seed + 7919 * p, pack)
                 for p in range(max(1, n_plans))]
        if mega is None:
            mega = max(1, min(8, min(p.u.shape[0] for p in plans)))
        self.mega = mega
        super().__init__([_pad_plan_nb(p, mega) for p in plans], ds.nu,
                         ds.nv, mxu, theta_groups, phi_groups, saturate,
                         device)
        self.mxu_pred = pack == 1 if mxu_pred is None else mxu_pred
