"""The rating-set SSE of ``tpu_mf_torch``: ``models/mf.py calc_mse``, its
plain version ``calc_mse_reference`` (what CPU tables take), and what
``ops/rating_sse.py`` works out on the host for ``csrc/rating_sse.cu``
(the dtype checks, the row layout, the grid, the host vectors). The kernel
itself runs on the card: ``tests/test_torch_cuda.py`` holds it to the plain
version there.
"""

import numpy as np
import pytest
import torch

from tpu_mf.models.mf import MFParams as JaxParams
from tpu_mf.models.mf import calc_mse as jax_calc_mse
from tpu_mf_torch.data.coo import synthetic_ratings
from tpu_mf_torch.models.mf import (MFParams, calc_mse, calc_mse_reference,
                                    params_from_numpy, rmse)
from tpu_mf_torch.ops import rating_sse as rs
from tpu_mf_torch.ops.rows import pad_params, split_params
from tpu_mf_torch.train.metrics import recording, span

NU, NV = 300, 200


def tables(dim, seed=0, scale=0.1, gb=3.0):
    rng = np.random.default_rng(seed)
    return params_from_numpy(
        rng.normal(0, scale, (NU, dim)), rng.normal(0, scale, (NV, dim)),
        rng.normal(0, scale, NU), rng.normal(0, scale, NV), gb, "cpu")


def ratings(n, seed=1):
    ds = synthetic_ratings(NU, NV, n, rank=4, noise=0.5, seed=seed)
    return ds.u, ds.v, ds.r


def sse64(p: MFParams, u, v, r, round_products=False) -> float:
    """The squared errors' sum in float64 from the tables' values; with
    ``round_products`` each product rounded to bf16 first."""
    f = {k: getattr(p, k).to(torch.float32).numpy().astype(np.float64)
         for k in ("theta", "phi", "bu", "bv")}
    prod = f["theta"][u] * f["phi"][v]
    if round_products:
        prod = torch.from_numpy(prod.astype(np.float32)).to(
            torch.bfloat16).to(torch.float64).numpy()
    pred = (prod.sum(-1) + f["bu"][u] + f["bv"][v]
            + float(p.gb.to(torch.float32)))
    return float(((r.astype(np.float64) - pred) ** 2).sum())


@pytest.mark.parametrize("maps", [False, True], ids=["views", "mapped"])
def test_trimmed_views_match_contiguous_copies(maps):
    """``split_params``' trimmed views of fused tables (row stride 128
    lanes, biases at a stride; with maps, gathered copies first, as the
    gen-1 and item-sharded runners' ``trim``) give the SSE of their
    contiguous copies, bit for bit: the values gathered are the same."""
    p = tables(16)
    rng = np.random.default_rng(3)
    mu = rng.permutation(NU + 5)[:NU] if maps else None
    mv = rng.permutation(NV + 3)[:NV] if maps else None
    th, ph = pad_params(p, NU + 5, NV + 3, mu, mv)
    view = split_params(th, ph, NU, NV, 16, p.gb, mu, mv)
    assert view.theta.stride() == (128, 1) and view.bu.stride() == (128,)
    copy = MFParams(*(t.contiguous() for t in view))
    u, v, r = ratings(3000)
    assert calc_mse(view, u, v, r) == calc_mse(copy, u, v, r)
    assert calc_mse(copy, u, v, r) == calc_mse(p, u, v, r)


def test_int32_and_int64_ids_agree():
    """numpy int32 / int64 ids and tensors of either give the same bits."""
    p = tables(8)
    u, v, r = ratings(2000)
    want = calc_mse(p, u, v, r)
    for dt in (np.int32, np.int64):
        assert calc_mse(p, u.astype(dt), v.astype(dt), r) == want
        assert calc_mse(p, torch.from_numpy(u.astype(dt)),
                        torch.from_numpy(v.astype(dt)),
                        torch.from_numpy(r)) == want


def test_bf16_tables_round_each_product():
    """bf16 tables: each product rounded to bf16 (as ``predict`` takes
    ``theta[u] * phi[v]`` in the storage type), then summed in float32.
    Per rating, |r - pred| against a float64 sum of the rounded products
    to 1e-4: 66 float32 adds of partial sums under ~100 (a few 1e-6 each
    at most). Rounding the products moves |r - pred| by ~1e-2 at this
    scale (64 products of ~1, each by up to 2^-9), so the unrounded sum
    misses by over 1e-3 on most ratings."""
    p = MFParams(*(t.to(torch.bfloat16) for t in tables(64, scale=1.0)))
    u, v, r = ratings(60)
    far = 0
    for i in range(len(u)):
        one = (u[i:i + 1], v[i:i + 1], r[i:i + 1])
        got = np.sqrt(calc_mse(p, *one))
        assert abs(got - np.sqrt(sse64(p, *one, round_products=True))) <= 1e-4
        far += abs(got - np.sqrt(sse64(p, *one))) > 1e-3
    assert far >= len(u) // 2


def test_empty_and_ragged_chunks():
    """n = 0 gives 0.0; n not a multiple of ``chunk`` counts every row once:
    the chunks' sums agree with one chunk's and with float64 to 1e-5
    relative (float32 residuals and chunk sums, as below)."""
    p = tables(8)
    u, v, r = ratings(1000)
    assert calc_mse(p, u[:0], v[:0], r[:0]) == 0.0
    whole = calc_mse(p, u, v, r)
    for chunk in (64, 999):
        assert abs(calc_mse(p, u, v, r, chunk=chunk) - whole) <= 1e-5 * whole
    assert abs(whole * 1000 - sse64(p, u, v, r)) <= 1e-5 * whole * 1000


def test_total_agrees_with_float64():
    """50,000 ratings: the plain version's total against numpy's float64
    sum from the same tables, to 1e-5 relative. Its error: float32
    products, dot products and residuals (a few 1e-7 of |r| / |r - pred|
    each) and float32 chunk sums (~log2(chunk) float32 steps). ``rmse`` is
    its square root; ``tpu_mf``'s calc_mse (float32 products and sums)
    agrees to the same 1e-5."""
    p = tables(32)
    u, v, r = ratings(50_000)
    want = sse64(p, u, v, r) / len(u)
    got = calc_mse(p, u, v, r)
    assert abs(got - want) <= 1e-5 * want
    ds = synthetic_ratings(NU, NV, 50_000, rank=4, noise=0.5, seed=1)
    assert rmse(p, ds) == float(np.sqrt(got))
    jp = JaxParams(theta=p.theta.numpy(), phi=p.phi.numpy(),
                   bu=p.bu.numpy(), bv=p.bv.numpy(), gb=np.float32(p.gb))
    assert abs(jax_calc_mse(jp, u, v, r) - want) <= 1e-5 * want


@pytest.mark.parametrize("case", ["float16", "float64", "mixed", "shape"])
def test_unsupported_tables_raise(case):
    """The kernel's wrapper takes float32 or bf16 tables of one dtype and
    matching shapes (the kernel takes no other), and checks them before the
    device. CPU tables of other dtypes take the plain version, which casts
    them to float32 as ``predict`` does."""
    p = tables(8)
    if case in ("float16", "float64"):
        p = MFParams(*(t.to(getattr(torch, case)) for t in p))
    elif case == "mixed":
        p = p._replace(bu=p.bu.to(torch.bfloat16))
    else:
        p = p._replace(bv=p.bv[:-1])
    u, v, r = ratings(100)
    with pytest.raises(ValueError):
        rs.rating_sse(*p, u, v, r)
    if case != "shape":
        assert calc_mse(p, u, v, r) == calc_mse_reference(p, u, v, r)


def test_layout_and_grid():
    """How the kernel reads rows, worked out from the tables: 16-byte loads
    and a group of lanes a rating (one float4 a lane for dim 128 float32,
    read in place from ``split_params``' views of 256-lane rows), element
    loads where dim or an offset view does not allow them; the grid."""
    def lay(dim, dtype=torch.float32, view=False, offset=False):
        p = MFParams(*(t.to(dtype) for t in tables(dim)))
        if view:
            th, ph = pad_params(p, NU, NV)
            p = split_params(th, ph, NU, NV, dim, p.gb)
        th, ph = p.theta, p.phi
        if offset:
            th, ph = th[:, 1:], ph[:, 1:]
        return tuple(rs.sse_layout(th, ph))

    assert lay(128, view=True) == (True, 32, 5)
    assert lay(128) == (True, 32, 5)
    assert lay(64) == (True, 16, 4)
    assert lay(8) == (True, 2, 1)
    assert lay(4) == (True, 1, 0)
    assert lay(256) == (True, 64, 5)
    assert lay(30) == (False, 30, 5)
    assert lay(3) == (False, 3, 2)
    assert lay(128, torch.bfloat16) == (True, 16, 4)
    assert lay(12, torch.bfloat16) == (False, 12, 4)
    assert lay(8, view=True) == (True, 2, 1)
    assert lay(9, offset=True, view=True) == (False, 8, 3)  # 4 bytes in
    assert rs.grid_blocks(1, 132) == 1
    assert rs.grid_blocks(1000, 132) == 4
    assert rs.grid_blocks(9_000_000, 132) == 396


def test_host_vectors_cross_as_taken():
    """Host ids keep int32 / int64 and other integers become int64; host
    ratings become float32; lists and CPU tensors are taken too."""
    dev = torch.device("cpu")
    for x, want in ((np.arange(5, dtype=np.int32), torch.int32),
                    (np.arange(5, dtype=np.int64), torch.int64),
                    (np.arange(5, dtype=np.int16), torch.int64),
                    ([0, 1, 2], torch.int64),
                    (torch.arange(5, dtype=torch.int32), torch.int32)):
        t = rs.device_vector(x, dev, rs.IDS, torch.int64)
        assert t.dtype == want and t.is_contiguous() and t.dim() == 1
    t = rs.device_vector(np.ones(4), dev, (torch.float32,), torch.float32)
    assert t.dtype == torch.float32
    t = rs.device_vector(np.arange(10, dtype=np.int32)[::2], dev, rs.IDS,
                         torch.int64)
    assert t.tolist() == [0, 2, 4, 6, 8] and t.is_contiguous()


def test_cpu_tables_launch_nothing():
    """CPU tables take the plain version: no launch is counted, on the
    kernel's wrapper or in the enclosing span."""
    p = tables(8)
    u, v, r = ratings(500)
    before = rs.rating_sse.launches
    with recording() as recs:
        with span("tmf.eval"):
            calc_mse(p, u, v, r)
    assert rs.rating_sse.launches == before
    assert "launches" not in recs[0]["attrs"]
    assert calc_mse_reference(p, u, v, r) == calc_mse(p, u, v, r)
