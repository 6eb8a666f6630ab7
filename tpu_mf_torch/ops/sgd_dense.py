"""Dense-cell fused SGD epochs (counterpart of ``tpu_mf/ops/pallas_sgd_dense.py``).

Every (user-tile x item-tile) cell of the rating matrix is held densely as

    S[cell][i, j] = sum of ratings of (user i, item j) inside the cell
    W[cell][i, j] = count of those ratings (0 = no rating)

and one epoch is, per cell, three tile products against the cell-start
tiles (homogeneous fused rows fold the biases in, ``ops/rows.py``):

    pred = theta . phi^T + gb,  E = S - W * pred,
    dtheta = E . phi,  dphi = E^T . theta,  k = row / column sums of W

then the geometric decay (1 - eta*lam)^k and the step eta * min(1, cap/k)
per row. Cells are visited in row-major order: theta_i carries across its
row of cells and phi_c is written back after every cell. The cells of one
anti-diagonal touch disjoint tiles, so both the kernel and the plain
version below walk the diagonals in order and the cells of a diagonal at
once, which reproduces the row-major result exactly.

``dense_epoch`` runs the hand-written CUDA kernel (``csrc/dense_cell.cu``)
on CUDA tensors and the plain PyTorch version ``dense_epoch_reference`` on
CPU tensors. The schedule constants (``DENSE_BUDGET``, the tile and
``k_cells`` pickers, the engagement bounds) are those of ``tpu_mf``, so the
two packages choose the same kernel for the same epochs.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from tpu_mf.data.coo import RatingsCOO
from tpu_mf_torch.models.mf import MFParams
from tpu_mf_torch.ops import _build
from tpu_mf_torch.ops.rows import cdiv, pad_params, row_lanes, split_params

# device memory the dense matrices may take (the same budget as tpu_mf)
DENSE_BUDGET = 8 * 1024 ** 3


class DensePlan(NamedTuple):
    flat: np.ndarray  # int64 (n,) flattened (gu, gv, u%tu, v%tv) cell index
    r: np.ndarray     # float32 (n,) ratings, in flat order
    tile_u: int
    tile_v: int
    n_gu: int
    n_gv: int         # real item tiles (n_gvp = k_cells * ceil(n_gv / k_cells))
    n_gvp: int
    k_cells: int
    n_real: int
    max_ku: int       # max per-cell per-user-row count
    max_kv: int
    mean_ku: float    # mean count over occupied (row, cell) pairs
    mean_kv: float
    max_w: int        # max (u, v) pair multiplicity (int8 W eligibility)
    wless: bool       # unique pairs and no 0 rating: W == (S != 0)


def pick_dense_tiles(nu: int, nv: int) -> tuple[int, int]:
    """Cell tile sizes: 256x256 at ML-10M scale and above; smaller tables
    shrink the tiles so the grid keeps >= ~8 cells per axis."""
    def up(x, q):
        return cdiv(x, q) * q

    tu = min(256, max(64, up(cdiv(nu, 8), 8)))
    tv = min(256, max(128, up(cdiv(nv, 8), 128)))
    return tu, tv


def pick_k_cells(n_gv: int, dim: int) -> int:
    """Item tiles per grid step in ``tpu_mf``; here it only pads the item
    axis to n_gvp, which the schedule and the table shapes follow."""
    target = 48 if row_lanes(dim) <= 128 else 8
    chunks = cdiv(n_gv, target)
    return cdiv(n_gv, chunks)


def dense_engage_epoch(eta_at, iters, dim, plan, start=0):
    """First epoch whose eta clears the dense window bound, or None.

    A row hit k times in one cell takes k gradients from one stale point.
    The bounds eta*max_k <= 5.5 (dim >= 16) or 1.8 (dim < 16), and
    eta*mean_k <= 0.25, are the ones ``tpu_mf`` calibrated by RMSE A/Bs."""
    bound = 5.5 if dim >= 16 else 1.8
    max_k = max(plan.max_ku, plan.max_kv)
    mean_k = max(plan.mean_ku, plan.mean_kv)
    for it in range(start + 1, iters + 1):
        if eta_at(it) * max_k <= bound and eta_at(it) * mean_k <= 0.25:
            return it
    return None


def prepare_dense(ds: RatingsCOO, tile_u: int = 256, tile_v: int = 256,
                  k_cells: int = 8) -> DensePlan:
    """Flat per-cell indices (int64) and the envelope stats of a dataset."""
    n_gu = cdiv(ds.nu, tile_u)
    n_gv = cdiv(ds.nv, tile_v)
    n_gvp = cdiv(n_gv, k_cells) * k_cells
    u = ds.u.astype(np.int64)
    v = ds.v.astype(np.int64)
    gu, ul = u // tile_u, u % tile_u
    gv, vl = v // tile_v, v % tile_v
    flat = ((gu * n_gvp + gv) * tile_u + ul) * tile_v + vl
    order = np.argsort(flat, kind="stable")
    flat = flat[order]
    r = ds.r[order]
    ku = np.bincount(u * n_gv + gv, minlength=1)
    kv = np.bincount(v * n_gu + gu, minlength=1)
    if len(flat) > 1:
        bnd = np.flatnonzero(np.diff(flat))
        runs = np.diff(np.concatenate([[-1], bnd, [len(flat) - 1]]))
        max_w = int(runs.max())
    else:
        max_w = len(flat)
    return DensePlan(
        flat=flat, r=r.astype(np.float32),
        tile_u=tile_u, tile_v=tile_v,
        n_gu=n_gu, n_gv=n_gv, n_gvp=n_gvp, k_cells=k_cells, n_real=len(ds),
        max_ku=int(ku.max()), max_kv=int(kv.max()),
        mean_ku=float(len(ds) / max(1, (ku > 0).sum())),
        mean_kv=float(len(ds) / max(1, (kv > 0).sum())),
        max_w=max_w,
        wless=bool(max_w == 1 and np.all(r != 0.0)),
    )


def dense_eligible(params: MFParams, ds: RatingsCOO) -> bool:
    """The eligibility rule of ``tpu_mf``: four 2-byte dense matrices within
    DENSE_BUDGET, and the fused item table within 64 MiB."""
    tile_u, tile_v = pick_dense_tiles(ds.nu, ds.nv)
    try:
        lanes = row_lanes(params.theta.shape[1])
    except ValueError:
        return False
    pu = cdiv(ds.nu, tile_u) * tile_u
    pv = cdiv(ds.nv, tile_v) * tile_v
    dense_bytes = 4 * pu * pv * 2
    vmem_phi = pv * lanes * 4
    return dense_bytes <= DENSE_BUDGET and vmem_phi <= 64 * 1024 * 1024


class DenseCells(NamedTuple):
    """The dense cell matrices of a plan, on one device."""

    s: torch.Tensor   # (n_gu, n_gvp, tu, tv) sums, in the working type
    w: torch.Tensor   # (n_gu, n_gvp, tu, tv) counts: int8, or the working type
    ku: torch.Tensor  # (n_gu, n_gvp, tu) float32 row sums of w
    kv: torch.Tensor  # (n_gu, n_gvp, tv) float32 column sums of w


def densify(plan: DensePlan, work_dtype: torch.dtype,
            device: torch.device | str) -> DenseCells:
    """Scatter-add the plan's COO into the cell matrices on ``device``:
    only the 12-byte-per-rating COO crosses to the device."""
    shape = (plan.n_gu, plan.n_gvp, plan.tile_u, plan.tile_v)
    flat = torch.as_tensor(plan.flat).to(device)

    def scatter(vals, dtype):
        x = torch.zeros(int(np.prod(shape)), dtype=torch.float32, device=device)
        x.index_add_(0, flat, vals)
        return x.view(shape).to(dtype)

    r = torch.as_tensor(plan.r).to(device)
    s = scatter(r, work_dtype)
    # counts are exact small integers: int8 holds up to 127 duplicates
    w = scatter(torch.ones_like(r), torch.int8 if plan.max_w <= 127
                else work_dtype)
    return DenseCells(s=s, w=w, ku=w.sum(3, dtype=torch.float32),
                      kv=w.sum(2, dtype=torch.float32))


def dense_epoch_reference(theta: torch.Tensor, phi: torch.Tensor,
                          cells: DenseCells, eta: float, lam: float,
                          gb: float, cap: float, dim: int,
                          saturate: bool = True) -> None:
    """Plain PyTorch dense-cell epoch, in place on the fused tables.

    Walks the anti-diagonals with ``torch.bmm`` over each diagonal's cells.
    Operands are rounded to the working type (that of ``cells.s``) and the
    products run in float32 with TF32 off, as the kernel does."""
    n_gu, n_gvp, tu, tv = cells.s.shape
    lanes = theta.shape[1]
    dev = theta.device
    f32 = torch.float32
    work = cells.s.dtype
    th = theta.view(n_gu, tu, lanes)
    ph = phi.view(n_gvp, tv, lanes)
    eta_t, lam_t, gb_t, cap_t = torch.tensor([eta, lam, gb, cap], dtype=f32,
                                             device=dev)
    ln_decay = torch.log(1.0 - eta_t * lam_t)
    lane = torch.arange(lanes, device=dev)
    keep_u = (lane <= dim).to(f32)
    keep_v = ((lane < dim) | (lane == dim + 1)).to(f32)

    def sat(k):
        return torch.clamp(cap_t / torch.clamp(k, min=1.0), max=1.0)

    def apply(cur, d, k, keep):
        d = d * eta_t
        if saturate:
            d = d * sat(k)
        return cur * (1.0 + keep * (torch.exp(k * ln_decay) - 1.0)) + d * keep

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for diag in range(n_gu + n_gvp - 1):
            i = torch.arange(max(0, diag - n_gvp + 1), min(n_gu - 1, diag) + 1,
                             device=dev)
            c = diag - i
            tb = th[i].to(work).to(f32)
            pb = ph[c].to(work).to(f32)
            w = cells.w[i, c].to(f32)
            pred = torch.bmm(tb, pb.transpose(1, 2)) + gb_t
            e = (cells.s[i, c].to(f32) - w * pred).to(work).to(f32)
            k_u = w.sum(2, keepdim=True)
            k_v = w.sum(1).unsqueeze(2)
            th[i] = apply(th[i], torch.bmm(e, pb), k_u, keep_u)
            ph[c] = apply(ph[c], torch.bmm(e.transpose(1, 2), tb), k_v, keep_v)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


_S_CODE = {torch.float32: 0, torch.bfloat16: 1}
_W_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _dense_lib() -> ctypes.CDLL:
    lib = _build.load("dense_cell")
    fn = lib.tmf_dense_epoch
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                   + [ctypes.c_float] * 4 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def dense_epoch(theta: torch.Tensor, phi: torch.Tensor, cells: DenseCells,
                eta: float, lam: float, gb: float, cap: float, dim: int,
                saturate: bool = True) -> None:
    """One dense-cell epoch, in place on the fused (theta_ext, phi_ext).

    CPU tensors take the plain version; CUDA tensors launch the
    ``csrc/dense_cell.cu`` kernel or raise."""
    if theta.device.type == "cpu":
        dense_epoch_reference(theta, phi, cells, eta, lam, gb, cap, dim,
                              saturate)
        return
    if theta.device.type != "cuda":
        raise ValueError(f"dense_epoch: no kernel for device {theta.device}")
    n_gu, n_gvp, tu, tv = cells.s.shape
    lanes = theta.shape[1]
    for name, t in (("theta", theta), ("phi", phi), ("s", cells.s),
                    ("w", cells.w), ("ku", cells.ku), ("kv", cells.kv)):
        if t.device != theta.device or not t.is_contiguous():
            raise ValueError(f"dense_epoch: {name} must be contiguous on "
                             f"{theta.device}")
    if (theta.dtype != torch.float32 or phi.dtype != torch.float32
            or theta.shape != (n_gu * tu, lanes)
            or phi.shape != (n_gvp * tv, lanes)
            or cells.w.shape != cells.s.shape
            or cells.ku.shape != (n_gu, n_gvp, tu)
            or cells.kv.shape != (n_gu, n_gvp, tv)
            or cells.ku.dtype != torch.float32
            or cells.kv.dtype != torch.float32
            or dim + 2 > lanes):
        raise ValueError("dense_epoch: table or cell shapes do not match")
    work = cells.s.dtype
    if work not in _S_CODE or cells.w.dtype not in (torch.int8, work):
        raise ValueError(f"dense_epoch: unsupported s/w dtypes {work}, "
                         f"{cells.w.dtype}")
    nc = min(n_gu, n_gvp)
    e_buf = torch.empty(nc, tu, tv, dtype=work, device=theta.device)
    th_snap = torch.empty(nc, tu, lanes, dtype=work, device=theta.device)
    ph_snap = torch.empty(nc, tv, lanes, dtype=work, device=theta.device)
    # the kernel moves whole 16-byte vectors of 8 elements along rows
    if tu % 8 or tv % 8 or any(t.data_ptr() % 16 for t in (
            theta, phi, cells.s, cells.w, e_buf, th_snap, ph_snap)):
        raise ValueError("dense_epoch: tiles must be multiples of 8 and the "
                         "tables 16-byte aligned")
    lib = _dense_lib()
    with torch.cuda.device(theta.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tmf_dense_epoch(
            theta.data_ptr(), phi.data_ptr(), cells.s.data_ptr(),
            cells.w.data_ptr(), cells.ku.data_ptr(), cells.kv.data_ptr(),
            e_buf.data_ptr(), th_snap.data_ptr(), ph_snap.data_ptr(),
            n_gu, n_gvp, tu, tv, lanes, dim,
            _S_CODE[work], _W_CODE[cells.w.dtype],
            eta, lam, gb, cap, int(saturate), stream)
    if rc != 0:
        raise RuntimeError(f"dense_cell kernel launch failed: CUDA error {rc}")
    dense_epoch.launches += 1


dense_epoch.launches = 0  # kernel launches (CUDA calls), not CPU runs


class DenseEpochRunner:
    """Holds the dense cell matrices on a device and runs fused epochs
    (``pad`` / ``epoch`` / ``trim``, the fused row layout of ``ops/rows.py``).

    ``mxu`` names the working type: "bfloat16" (production: bf16 S and
    operands, f32 sums) or "float32" (everything f32, for parity runs)."""

    def __init__(self, ds: RatingsCOO, tile_u: int | None = None,
                 tile_v: int | None = None, k_cells: int | None = None,
                 mxu: str = "bfloat16", saturate: bool = True,
                 dim: int | None = None, device: torch.device | str = "cpu"):
        if tile_u is None or tile_v is None:
            pu, pv = pick_dense_tiles(ds.nu, ds.nv)
            tile_u, tile_v = tile_u or pu, tile_v or pv
        if k_cells is None:
            k_cells = pick_k_cells(cdiv(ds.nv, tile_v), dim or 8)
        self.saturate = saturate
        self.nu, self.nv = ds.nu, ds.nv
        self.work_dtype = {"bfloat16": torch.bfloat16,
                           "float32": torch.float32}[mxu]
        self.device = torch.device(device)
        self.plan = prepare_dense(ds, tile_u, tile_v, k_cells)
        self.tile_u, self.tile_v = tile_u, tile_v
        self.k_cells = k_cells
        self._cells = None
        self.dim = dim
        self.gb = 0.0

    def materialize(self) -> "DenseEpochRunner":
        """Build the cell matrices on the runner's device (once)."""
        if self._cells is None:
            self._cells = densify(self.plan, self.work_dtype, self.device)
        return self

    @property
    def cells(self) -> DenseCells:
        return self.materialize()._cells

    def epoch(self, tables, eta: float, lam: float, gb: float,
              epoch_idx: int = 0):
        """One epoch, in place on the fused tables; returns them."""
        del epoch_idx  # one static plan: the cell partition is the data's
        cap = max(1.0, 0.2 / max(eta, 1e-9))
        dense_epoch(tables[0], tables[1], self.cells, eta, lam, gb, cap,
                    self.dim, self.saturate)
        return tables

    def pad(self, params: MFParams):
        self.materialize()
        self.dim = params.theta.shape[1]
        self.gb = float(params.gb)
        p = self.plan
        return pad_params(params, p.n_gu * p.tile_u, p.n_gvp * p.tile_v)

    def trim(self, tables) -> MFParams:
        return split_params(tables[0], tables[1], self.nu, self.nv, self.dim,
                            self.gb)
