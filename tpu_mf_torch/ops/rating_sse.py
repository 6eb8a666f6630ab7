"""The sum of squared errors of a rating set on the card: one launch of
``csrc/rating_sse.cu``.

It replaces no TPU kernel (``tpu_mf``'s ``calc_mse`` and ``predict`` are
plain ``jnp``). ``models/mf.py calc_mse`` launches it for CUDA tables, and
keeps its plain version ``calc_mse_reference`` for CPU tables. The kernel
takes predict's arithmetic (products in the storage type, sums in float32)
and sums the squared residuals in float64, in a fixed order.

What it adapts to, it reads from its input (``sse_layout``): the table
dtype (float32 or bf16), the id dtype (int32 or int64, read in place), the
rows' width, pointers and strides (16-byte loads where they allow, and
trimmed views of the fused tables read in place), and the set's size (the
grid). Host arrays cross to the card once per call.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from tpu_mf_torch.ops import _build
from tpu_mf_torch.train.metrics import count

THREADS = 256       # csrc/rating_sse.cu: kThreads, a warp per 32 ratings
BLOCKS_PER_SM = 3   # its kBlocksPerSm
TABLES = {torch.float32: 0, torch.bfloat16: 1}
IDS = {torch.int32: 0, torch.int64: 1}
MAX_ROWS = 2 ** 31  # the kernel holds a row id in 32 bits


class Layout(NamedTuple):
    """How ``csrc/rating_sse.cu`` reads a table row."""

    vec: bool        # in 16-byte loads (else element by element)
    nchunks: int     # loads a row takes
    group_log2: int  # a rating's rows are read by 2 ** group_log2 lanes


def check_tables(theta, phi, bu, bv) -> None:
    """Raise ValueError unless the tables are float32 or bf16, all of one
    dtype, with theta (nu, dim), phi (nv, dim), bu (nu,), bv (nv,)."""
    dt = theta.dtype
    if dt not in TABLES or any(t.dtype != dt for t in (phi, bu, bv)):
        raise ValueError(
            "rating_sse: the tables must all be float32 or all bfloat16, got "
            f"{[str(t.dtype) for t in (theta, phi, bu, bv)]}")
    if (theta.dim() != 2 or phi.dim() != 2 or phi.shape[1] != theta.shape[1]
            or tuple(bu.shape) != theta.shape[:1]
            or tuple(bv.shape) != phi.shape[:1]):
        raise ValueError(
            "rating_sse: table shapes do not match: "
            f"{[tuple(t.shape) for t in (theta, phi, bu, bv)]}")


def sse_layout(theta: torch.Tensor, phi: torch.Tensor) -> Layout:
    """16-byte loads where dim is a whole number of them and both tables'
    pointers and row strides are 16-byte aligned; a group of lanes per
    rating, the least power of two (at most 32) that covers a row's
    loads."""
    item = theta.element_size()
    per = 16 // item
    dim = theta.shape[1]
    vec = dim % per == 0 and all(
        t.data_ptr() % 16 == 0 and t.stride(0) * item % 16 == 0
        for t in (theta, phi))
    nchunks = dim // per if vec else dim
    return Layout(vec, nchunks, min(max(nchunks - 1, 0).bit_length(), 5))


def grid_blocks(n: int, sms: int) -> int:
    """Blocks for n ratings on a card of ``sms`` SMs: as many as stay
    resident, or one per 256 ratings where that is fewer."""
    return max(1, min(-(-n // THREADS), BLOCKS_PER_SM * sms))


def device_vector(x, dev: torch.device, dtypes, cast) -> torch.Tensor:
    """``x`` as a contiguous 1-D tensor on ``dev`` of one of ``dtypes``.
    A tensor on ``dev`` is read in place and must be one already; host
    arrays (numpy, CPU tensors) cross once, cast to ``cast`` unless their
    dtype is one of ``dtypes``."""
    if isinstance(x, torch.Tensor) and x.device.type != "cpu":
        if (x.device != dev or x.dtype not in dtypes or x.dim() != 1
                or not x.is_contiguous()):
            raise ValueError(
                f"rating_sse: a rating vector on the card must be a "
                f"contiguous 1-D tensor of {[str(d) for d in dtypes]} on "
                f"{dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")
        return x
    t = (x if isinstance(x, torch.Tensor)
         else torch.as_tensor(np.asarray(x))).reshape(-1)
    if t.dtype not in dtypes:
        t = t.to(cast)
    return t.to(dev).contiguous()


def _lib() -> ctypes.CDLL:
    lib = _build.load("rating_sse")
    fn = lib.tmf_rating_sse
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 7
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    return lib


def rating_sse(theta, phi, bu, bv, gb, u, v, r) -> torch.Tensor:
    """One launch of ``csrc/rating_sse.cu`` on CUDA tables: a float64
    tensor [sse, bad] on their device, where bad is 1 if an id lay outside
    the tables (those ratings are left out), else 0. Does not synchronize.
    Checks the tables (``check_tables``, rows contiguous within), ids and
    ratings, and raises if the launch fails. Each launch adds one to
    ``rating_sse.launches`` and to the innermost open span's ``launches``."""
    check_tables(theta, phi, bu, bv)
    dev = theta.device
    if dev.type != "cuda" or any(t.device != dev for t in (phi, bu, bv)):
        raise ValueError("rating_sse: the tables must lie on one CUDA device")
    nu, nv, dim = theta.shape[0], phi.shape[0], theta.shape[1]
    if dim > 1 and (theta.stride(1) != 1 or phi.stride(1) != 1):
        raise ValueError("rating_sse: table rows must be contiguous")
    if max(nu, nv) > MAX_ROWS:
        raise ValueError(f"rating_sse: tables of more than {MAX_ROWS} rows")
    u = device_vector(u, dev, IDS, torch.int64)
    v = device_vector(v, dev, IDS, torch.int64)
    r = device_vector(r, dev, (torch.float32,), torch.float32)
    n = u.shape[0]
    if v.shape[0] != n or r.shape[0] != n or u.dtype != v.dtype:
        raise ValueError("rating_sse: u, v and r must be of one length, u "
                         "and v of one dtype")
    gb = torch.as_tensor(gb).to(dev, torch.float32).reshape(1)
    lay = sse_layout(theta, phi)
    grid = grid_blocks(n, torch.cuda.get_device_properties(dev)
                       .multi_processor_count)
    buf = torch.empty(grid + 2, dtype=torch.float64, device=dev)
    flags = torch.empty(2, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().tmf_rating_sse(
            theta.data_ptr(), phi.data_ptr(), bu.data_ptr(), bv.data_ptr(),
            gb.data_ptr(), u.data_ptr(), v.data_ptr(), r.data_ptr(), n, nu,
            nv, theta.stride(0), phi.stride(0), bu.stride(0), bv.stride(0),
            lay.nchunks, lay.group_log2, TABLES[theta.dtype], IDS[u.dtype],
            int(lay.vec), grid, buf[2:].data_ptr(), flags.data_ptr(),
            buf.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rating_sse kernel launch failed: CUDA error {rc}")
    rating_sse.launches += 1
    count("launches")
    return buf[:2]


rating_sse.launches = 0  # kernel launches (CUDA calls)
