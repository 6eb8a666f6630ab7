"""Fused AdaptReg epochs on slot plans, for small rank (counterpart of
``tpu_mf/ops/pallas_adreg_slot.py``; reference semantics: src/admf.h:52-86).

On the TPU the slot-major layout packs P rows per 128-lane row; stacked
tables, lane rolls and multi-hot gathers are layout. What the kernel
computes is the AdaptReg segment of ``ops/adreg_cells.py`` over the columns
of a slot plan (sub * P ratings each), with the theta and phi groups the
runner picks from eta and the plans' window duplicates (the slot SGD rule:
the most parallel grouping with eta * duplicates <= 0.2) and deferred item
applies at each tile's last touching column of its group. AdaptReg runs at
SGD-scale etas, so that staleness envelope binds as it does for SGD.

The plans (plain or delta-striped, relabeled by the serpentine balance
maps) are ``ops/sgd_slot.py``'s, bit for bit ``tpu_mf``'s; they become
window plans through ``to_window_plan`` and run on the tile walk of
``csrc/adreg_cells.cu`` (the gen-1 runner's, ``ops/adreg_cells.py``). An
epoch is S = min(4, batches) segments with a
hypergradient step between them. The tables' rows are the relabeled ids,
so the validation ids ride the same maps and the hypergradient reads the
relabeled rows; ``trim`` inverts the maps.
"""

from __future__ import annotations

import torch

from tpu_mf_torch.data.coo import RatingsCOO
from tpu_mf_torch.models.admf import AdaptRegState
from tpu_mf_torch.ops.adreg_cells import AdRegRunner
from tpu_mf_torch.ops.sgd_slot import SlotEpochRunner, slot_packing_factor


def adreg_slot_eligible(state: AdaptRegState) -> bool:
    """Whether the slot plans take the state's rank: dim <= 61, a slot
    pack of 2 or more (``slot_packing_factor``). ``tpu_mf``'s VMEM limit
    on the slot-major item table routes nothing here: the kernel keeps the
    fused tables in HBM."""
    return slot_packing_factor(state.params.theta.shape[1]) >= 2


class SlotAdRegRunner(AdRegRunner, SlotEpochRunner):
    """Fused AdaptReg epochs over slot plans, as ``tpu_mf``'s
    SlotAdRegRunner (``pad`` / ``epoch`` / ``trim`` / ``state``): the plan
    options of ``SlotEpochRunner`` (``sub``, ``tile``, ``striped``, pinned
    or picked groups, ``n_plans``), always on the serpentine balance maps
    (every caller of ``tpu_mf``'s runner balances), no saturation, and
    ``segments`` launches per epoch."""

    launches = 0

    def __init__(self, train_ds: RatingsCOO, valid_ds: RatingsCOO,
                 sub: int | None = None, segments: int = 4, seed: int = 0,
                 mxu: str = "bfloat16", loss: int = 0, n_plans: int = 1,
                 dim: int | None = None, tile: int | None = None,
                 theta_groups: int | None = None,
                 phi_groups: int | None = None, striped: bool = False,
                 device: torch.device | str = "cuda"):
        SlotEpochRunner.__init__(
            self, train_ds, tile_u=tile, tile_v=tile, sub=sub, seed=seed,
            mxu=mxu, theta_groups=theta_groups, phi_groups=phi_groups,
            n_plans=n_plans, dim=dim, balance=True, saturate=False,
            striped=striped, device=device)
        self._adreg_init(valid_ds, segments, loss)
