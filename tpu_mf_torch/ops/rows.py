"""Fused-row table layout shared by the tile kernels (counterpart of the
layout helpers in ``tpu_mf/ops/pallas_sgd.py``).

Homogeneous rows fold the biases into the tile products:

    theta row = [fac_0 .. fac_{dim-1} | bu | 1 | 0 ...]
    phi row   = [fac_0 .. fac_{dim-1} | 1 | bv | 0 ...]

so theta_row . phi_row = theta.phi + bu + bv. Rows are ``row_lanes(dim)``
wide; pad rows (beyond nu / nv) are all zero.

Optional id maps (``balance_cells`` in ``ops/sgd_cells.py``) are
new-of-old: row i of the model lives at table row ``idmap[i]``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tpu_mf_torch.models.mf import MFParams
from tpu_mf_torch.train.metrics import count

LANES = 128
MAX_DIM = 2048


def row_lanes(dim: int) -> int:
    """Lane width of a fused row: ceil((dim+3)/128) groups of 128."""
    if dim > MAX_DIM:
        raise ValueError(f"fused kernels support dim <= {MAX_DIM}, got {dim}")
    return ((dim + 3 + LANES - 1) // LANES) * LANES


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def fuse_rows(fac: torch.Tensor, bias: torch.Tensor, rows: int, lanes: int,
              side: str, idmap: np.ndarray | None = None) -> torch.Tensor:
    """(rows, lanes) float32 fused table; side "u" is [fac | bias | 1],
    side "v" is [fac | 1 | bias]. With ``idmap``, row i goes to table row
    ``idmap[i]``. Tables of another dtype (bf16 storage) are widened to
    float32, as ``tpu_mf`` fuses them. The map's bytes sent to the
    table's device count as ``h2d_bytes`` on the innermost span."""
    n, dim = fac.shape
    out = torch.zeros(rows, lanes, dtype=torch.float32, device=fac.device)
    if idmap is None:
        at = slice(0, n)
    else:
        at = torch.as_tensor(idmap, dtype=torch.int64).to(fac.device)
        count("h2d_bytes", 8 * idmap.size)
    b_lane, one_lane = (dim, dim + 1) if side == "u" else (dim + 1, dim)
    out[at, :dim] = fac.to(torch.float32)
    out[at, b_lane] = bias.to(torch.float32)
    out[at, one_lane] = 1.0
    return out


def pad_params(params: MFParams, rows_u: int, rows_v: int,
               map_u: np.ndarray | None = None,
               map_v: np.ndarray | None = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused (theta_ext, phi_ext) tables padded to rows_u / rows_v rows."""
    lanes = row_lanes(params.theta.shape[1])
    return (fuse_rows(params.theta, params.bu, rows_u, lanes, "u", map_u),
            fuse_rows(params.phi, params.bv, rows_v, lanes, "v", map_v))


def split_params(theta_ext: torch.Tensor, phi_ext: torch.Tensor, nu: int,
                 nv: int, dim: int, gb, map_u: np.ndarray | None = None,
                 map_v: np.ndarray | None = None) -> MFParams:
    """MFParams of fused tables (inverse of ``pad_params``): views without
    maps, gathered copies with them (the maps' bytes sent to the tables'
    device count as ``h2d_bytes`` on the innermost span)."""
    def rows(ext, idmap):
        if idmap is None:
            return ext
        count("h2d_bytes", 8 * idmap.size)
        return ext[torch.as_tensor(idmap, dtype=torch.int64).to(ext.device)]

    th, ph = rows(theta_ext, map_u), rows(phi_ext, map_v)
    return MFParams(
        theta=th[:nu, :dim],
        phi=ph[:nv, :dim],
        bu=th[:nu, dim],
        bv=ph[:nv, dim + 1],
        gb=torch.as_tensor(gb, dtype=torch.float32, device=theta_ext.device),
    )
