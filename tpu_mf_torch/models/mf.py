"""Biased-MF model state and evaluation on torch tensors.

Counterpart of ``tpu_mf/models/mf.py``: factor tables theta (nu, dim) and
phi (nv, dim), bias vectors bu/bv and a scalar global bias gb. Gaussian(0,
scale) init as in the reference (model.cc:22-33), drawn from an explicit
``torch.Generator``; its draws differ from ``jax.random``'s, so tables that
must match across the two packages are made with numpy and carried over with
``params_from_numpy``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_mf_torch.ops.rating_sse import rating_sse


class MFParams(NamedTuple):
    """theta (nu, dim), phi (nv, dim), bu (nu,), bv (nv,), gb () — float32,
    or bfloat16 storage (``--dtype bfloat16``)."""

    theta: torch.Tensor
    phi: torch.Tensor
    bu: torch.Tensor
    bv: torch.Tensor
    gb: torch.Tensor


def init_mf(
    nu: int,
    nv: int,
    dim: int,
    gb: float,
    generator: torch.Generator,
    device: torch.device | str,
    scale: float = 1e-2,
    dtype: torch.dtype = torch.float32,
) -> MFParams:
    """Gaussian(0, scale) init of all tables (reference: model.cc:22-33).

    Draws float32 on the CPU from ``generator``, rounds to the storage
    ``dtype`` (gb too, as ``tpu_mf`` stores it) and moves the tables to
    ``device``, so one seed gives the same tables on every device."""
    def normal(*shape):
        x = torch.randn(*shape, generator=generator, dtype=torch.float32)
        return (x * scale).to(dtype).to(device)

    return MFParams(
        theta=normal(nu, dim),
        phi=normal(nv, dim),
        bu=normal(nu),
        bv=normal(nv),
        gb=torch.tensor(gb, dtype=dtype, device=device),
    )


def params_from_numpy(theta, phi, bu, bv, gb, device) -> MFParams:
    """Tables from host arrays (float32 copies on ``device``)."""
    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32)).to(device).clone()

    return MFParams(t(theta), t(phi), t(bu), t(bv), t(np.float32(gb)))


def params_to_numpy(params: MFParams):
    """(theta, phi, bu, bv, gb) as float32 numpy arrays / float."""
    def h(x):
        return x.detach().to("cpu", torch.float32).numpy()

    return (h(params.theta), h(params.phi), h(params.bu), h(params.bv),
            float(params.gb))


def predict(params: MFParams, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """theta_u . phi_v + bu_u + bv_v + gb for a batch of (user, item) pairs,
    float32: products in the storage dtype, sums in float32 (as
    ``tpu_mf``)."""
    f32 = torch.float32
    return ((params.theta[u] * params.phi[v]).to(f32).sum(-1)
            + params.bu[u].to(f32) + params.bv[v].to(f32)
            + params.gb.to(f32))


def calc_mse_reference(params: MFParams, u, v, r,
                       chunk: int = 1 << 20) -> float:
    """The plain version of ``calc_mse``: ``predict`` over chunks of
    ``chunk`` rows, each chunk's squared errors summed in float32 and the
    chunks' sums in a Python float (its memory: a few (chunk, dim) tables)."""
    n = int(len(u))
    if n == 0:
        return 0.0
    dev = params.theta.device
    total = 0.0
    for s in range(0, n, chunk):
        cu = torch.as_tensor(u[s:s + chunk]).to(dev, torch.int64)
        cv = torch.as_tensor(v[s:s + chunk]).to(dev, torch.int64)
        cr = torch.as_tensor(r[s:s + chunk]).to(dev, torch.float32)
        e = cr - predict(params, cu, cv)
        total += float((e * e).sum())
    return total / n


def calc_mse(params: MFParams, u, v, r, chunk: int = 1 << 20) -> float:
    """Mean squared error over a rating set (numpy arrays or tensors)
    (reference: MF::calc_mse, src/model.cc:41-73). Tables on the CPU take
    the plain version, ``calc_mse_reference`` in chunks of ``chunk`` rows.
    CUDA tables, float32 or bf16 (others raise), take one launch of
    ``csrc/rating_sse.cu`` (``ops/rating_sse.py``: predict's arithmetic,
    the squared errors summed in float64) and one read of its sum, and
    raise on an id outside the tables."""
    n = int(len(u))
    if n == 0:
        return 0.0
    if params.theta.device.type == "cpu":
        return calc_mse_reference(params, u, v, r, chunk)
    sse, bad = rating_sse(*params, u, v, r).tolist()
    if bad:
        raise IndexError("calc_mse: a rating's id lies outside the tables")
    return sse / n


def rmse(params: MFParams, ds, chunk: int = 1 << 20) -> float:
    """Test RMSE as printed per epoch by the reference (mf.h:35)."""
    return float(np.sqrt(calc_mse(params, ds.u, ds.v, ds.r, chunk)))
