"""MF and DPMF checkpoints (counterpart of the MF and DPMF parts of
``tpu_mf/io/checkpoint.py``).

Reference-binary layouts, byte-compatible with the reference's dumps
(MF::save_model model.cc:98-122 / read_model model.cc:75-97):

    int32 nv, int32 nu, int32 dim, float lambda,
    float bv[nv], float phi[nv][dim], float bu[nu], float theta[nu][dim]

and for DPMF (DPMF::save_model / read_model / read_hyper,
model.cc:124-195) the precisions in place of lambda:

    int32 nv, int32 nu, int32 dim,
    float lambda_r, lambda_ub, lambda_vb, float lambda_u[dim],
    float lambda_v[dim], then the tables as above;

and a native npz of the tables and any extra state (``save_npz`` /
``load_npz``, keys theta, phi, bu, bv, gb and the extras' own), which
``io/resume.py`` writes each round. Tables are written as float32 whatever
their storage dtype (``params_to_numpy``, the part ``tpu_mf``'s
``_params_to_host`` plays), so either package reads the other's files.
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
                   device: torch.device | str = "cuda") -> Tuple[MFParams, float]:
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


def save_dpmf_binary(path: str, params: MFParams, lambda_r: float,
                     lambda_ub: float, lambda_vb: float, lambda_u,
                     lambda_v) -> None:
    theta, phi, bu, bv, _ = params_to_numpy(params)
    nu, dim = theta.shape
    nv = phi.shape[0]
    with open(path, "wb") as f:
        np.asarray([nv, nu, dim], np.int32).tofile(f)
        np.asarray([lambda_r, lambda_ub, lambda_vb], np.float32).tofile(f)
        np.asarray(lambda_u, np.float32).tofile(f)
        np.asarray(lambda_v, np.float32).tofile(f)
        for a in (bv, phi, bu, theta):
            np.ascontiguousarray(a).tofile(f)


def _read_dpmf_head(f):
    nv, nu, dim = (int(x) for x in np.fromfile(f, np.int32, 3))
    lambda_r, lambda_ub, lambda_vb = np.fromfile(f, np.float32, 3)
    lambda_u = np.fromfile(f, np.float32, dim)
    lambda_v = np.fromfile(f, np.float32, dim)
    if lambda_v.size != dim:
        raise ValueError(f"{f.name}: truncated DPMF checkpoint")
    return (nv, nu, dim), (float(lambda_r), float(lambda_ub),
                           float(lambda_vb), lambda_u, lambda_v)


def load_dpmf_hyper(path: str):
    """(lambda_r, lambda_ub, lambda_vb, lambda_u, lambda_v): the
    hyperparameter-only warm start (reference: DPMF::read_hyper,
    model.cc:153-167)."""
    with open(path, "rb") as f:
        return _read_dpmf_head(f)[1]


def load_dpmf_binary(path: str, gb: float = 2.76,
                     device: torch.device | str = "cuda"):
    """(params, (lambda_r, lambda_ub, lambda_vb, lambda_u, lambda_v)) of a
    full DPMF checkpoint (reference: DPMF::read_model, model.cc:169-195);
    gb is supplied, as for MF."""
    with open(path, "rb") as f:
        (nv, nu, dim), hyper = _read_dpmf_head(f)
        bv = np.fromfile(f, np.float32, nv)
        phi = np.fromfile(f, np.float32, nv * dim).reshape(nv, dim)
        bu = np.fromfile(f, np.float32, nu)
        theta = np.fromfile(f, np.float32, nu * dim)
    if theta.size != nu * dim:
        raise ValueError(f"{path}: truncated DPMF checkpoint")
    return (params_from_numpy(theta.reshape(nu, dim), phi, bu, bv, gb,
                              device), hyper)


_TABLES = ("theta", "phi", "bu", "bv", "gb")


def save_npz(path: str, params: MFParams, **extra) -> None:
    """Native checkpoint of the tables, float32 (bf16 tables widened), and
    any extra arrays."""
    theta, phi, bu, bv, gb = params_to_numpy(params)
    np.savez(path, theta=theta, phi=phi, bu=bu, bv=bv, gb=gb, **extra)


def load_npz(path: str, device: torch.device | str = "cuda"):
    """(params on ``device``, {extra name: numpy array}) of a native
    checkpoint; the tables as stored (float32)."""
    with np.load(path, allow_pickle=False) as z:
        params = MFParams(*(torch.as_tensor(z[k]).to(device)
                            for k in _TABLES[:4]),
                          torch.as_tensor(np.float32(z["gb"])).to(device))
        extras = {k: z[k] for k in z.files if k not in _TABLES}
    return params, extras
