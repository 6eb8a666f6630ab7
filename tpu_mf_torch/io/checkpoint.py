"""MF checkpoints (counterpart of the MF part of ``tpu_mf/io/checkpoint.py``).

Reference-binary layout, byte-compatible with the reference's dumps
(MF::save_model model.cc:98-122 / read_model model.cc:75-97):

    int32 nv, int32 nu, int32 dim, float lambda,
    float bv[nv], float phi[nv][dim], float bu[nu], float theta[nu][dim]

and a native npz of the tables.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tpu_mf_torch.models.mf import MFParams, params_from_numpy, params_to_numpy


def save_mf_binary(path: str, params: MFParams, lam: float) -> None:
    theta, phi, bu, bv, _ = params_to_numpy(params)
    nu, dim = theta.shape
    nv = phi.shape[0]
    with open(path, "wb") as f:
        np.asarray([nv, nu, dim], np.int32).tofile(f)
        np.asarray([lam], np.float32).tofile(f)
        for a in (bv, phi, bu, theta):
            np.ascontiguousarray(a).tofile(f)


def load_mf_binary(path: str, gb: float = 2.76,
                   device: torch.device | str = "cpu") -> Tuple[MFParams, float]:
    """(params, lambda) from a reference-format file. The file does not
    store gb (model.cc:106-107), so it is supplied, as the reference's
    --bias does."""
    with open(path, "rb") as f:
        nv, nu, dim = (int(x) for x in np.fromfile(f, np.int32, 3))
        (lam,) = np.fromfile(f, np.float32, 1)
        bv = np.fromfile(f, np.float32, nv)
        phi = np.fromfile(f, np.float32, nv * dim).reshape(nv, dim)
        bu = np.fromfile(f, np.float32, nu)
        theta = np.fromfile(f, np.float32, nu * dim).reshape(nu, dim)
    if theta.size != nu * dim:
        raise ValueError(f"{path}: truncated MF checkpoint")
    return params_from_numpy(theta, phi, bu, bv, gb, device), float(lam)


def save_npz(path: str, params: MFParams, **extra) -> None:
    """Native checkpoint of the tables (and any extra arrays)."""
    theta, phi, bu, bv, gb = params_to_numpy(params)
    np.savez(path, theta=theta, phi=phi, bu=bu, bv=bv, gb=gb, **extra)
