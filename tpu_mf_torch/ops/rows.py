"""Fused-row table layout shared by the tile kernels (counterpart of the
layout helpers in ``tpu_mf/ops/pallas_sgd.py``).

Homogeneous rows fold the biases into the tile products:

    theta row = [fac_0 .. fac_{dim-1} | bu | 1 | 0 ...]
    phi row   = [fac_0 .. fac_{dim-1} | 1 | bv | 0 ...]

so theta_row . phi_row = theta.phi + bu + bv. Rows are ``row_lanes(dim)``
wide; pad rows (beyond nu / nv) are all zero.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpu_mf_torch.models.mf import MFParams

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
              side: str) -> torch.Tensor:
    """(rows, lanes) float32 fused table; side "u" is [fac | bias | 1],
    side "v" is [fac | 1 | bias]."""
    n, dim = fac.shape
    ext = torch.zeros(rows, lanes, dtype=torch.float32, device=fac.device)
    ext[:n, :dim] = fac
    b_lane, one_lane = (dim, dim + 1) if side == "u" else (dim + 1, dim)
    ext[:n, b_lane] = bias
    ext[:n, one_lane] = 1.0
    return ext


def pad_params(params: MFParams, rows_u: int,
               rows_v: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused (theta_ext, phi_ext) tables padded to rows_u / rows_v rows."""
    lanes = row_lanes(params.theta.shape[1])
    return (fuse_rows(params.theta, params.bu, rows_u, lanes, "u"),
            fuse_rows(params.phi, params.bv, rows_v, lanes, "v"))


def split_params(theta_ext: torch.Tensor, phi_ext: torch.Tensor, nu: int,
                 nv: int, dim: int, gb) -> MFParams:
    """MFParams views of fused tables (inverse of ``pad_params``)."""
    return MFParams(
        theta=theta_ext[:nu, :dim],
        phi=phi_ext[:nv, :dim],
        bu=theta_ext[:nu, dim],
        bv=phi_ext[:nv, dim + 1],
        gb=torch.as_tensor(gb, dtype=torch.float32, device=theta_ext.device),
    )
