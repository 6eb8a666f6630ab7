"""Eligibility rules of the lane-packed and slot-major kernel families
(``tpu_mf/ops/pallas_sgd_packed.py``, ``tpu_mf/ops/pallas_sgd_slot.py``).

Neither family is ported yet; the schedule reads these rules only to send
the same epochs to the same family as ``tpu_mf`` does (or to say it has
none yet). They are TPU residency rules and bound no kernel of this
package. They move to the families' own modules when those are ported.
"""

from __future__ import annotations

from tpu_mf_torch.models.mf import MFParams
from tpu_mf_torch.ops.rows import LANES, cdiv


def _packing_factor(dim: int, extra: int) -> int:
    for pack, width in ((8, 16), (4, 32), (2, 64)):
        if dim + extra <= width:
            return pack
    return 1


def packed_eligible(params: MFParams, batch_size: int) -> bool:
    """The lane-packed kernel: dim <= 62 and its item table plus scratch
    within 64 MiB."""
    del batch_size
    pack = _packing_factor(params.theta.shape[1], 2)
    if pack < 2:
        return False
    tile_v = LANES * pack
    vmem_phi = cdiv(params.phi.shape[0], tile_v) * tile_v // pack * LANES * 4
    return 2 * vmem_phi <= 64 * 1024 * 1024


def slot_eligible(params: MFParams, batch_size: int = 8192) -> bool:
    """The slot-major kernel: dim <= 61 and its item table plus scratch
    within 64 MiB."""
    del batch_size
    pack = _packing_factor(params.theta.shape[1], 3)
    if pack < 2:
        return False
    tile_v = LANES * pack
    vmem_phi = cdiv(params.phi.shape[0], tile_v) * tile_v * LANES * 4
    return 2 * vmem_phi <= 64 * 1024 * 1024
