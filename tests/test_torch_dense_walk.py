"""The wavefront walk of the dense-cell epoch (``csrc/dense_cell.cu``), on
the CPU: the order argument it rests on, its host planner, the numbering of
its hand-off counters across epochs, and the route by cell shape."""

import numpy as np
import pytest
import torch

from tpu_mf_torch.data.coo import RatingsCOO, synthetic_ratings
from tpu_mf_torch.models.mf import params_from_numpy
from tpu_mf_torch.ops import sgd_dense as td
from tpu_mf_torch.ops.rows import cdiv, row_lanes

torch.set_num_threads(1)


def np_tables(nu, nv, dim, seed, gb):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1e-1, (nu, dim)).astype(np.float32),
            rng.normal(0, 1e-1, (nv, dim)).astype(np.float32),
            rng.normal(0, 1e-1, nu).astype(np.float32),
            rng.normal(0, 1e-1, nv).astype(np.float32), np.float32(gb))


def wavefront_epoch(theta, phi, cells, eta, lam, gb, cap, dim, block_rows,
                    saturate=True):
    """The walk's order in plain PyTorch (f32): user-tile rows one after
    another, each row's cells left to right; within a cell, blocks of
    ``block_rows`` user rows whose dphi partials are summed in rank
    order."""
    n_gu, n_gvp, tu, tv = cells.s.shape
    lanes = theta.shape[1]
    th = theta.view(n_gu, tu, lanes)
    ph = phi.view(n_gvp, tv, lanes)
    lane = torch.arange(lanes)
    keep_u = (lane <= dim).float()
    keep_v = ((lane < dim) | (lane == dim + 1)).float()
    ln_decay = np.log(np.float32(1.0) - np.float32(eta) * np.float32(lam))
    blocks = [slice(b, b + block_rows) for b in range(0, tu, block_rows)]

    def apply(cur, d, k, keep):
        d = d * eta
        if saturate:
            d = d * torch.clamp(cap / torch.clamp(k, min=1.0), max=1.0)
        return cur * (1.0 + keep * (torch.exp(k * ln_decay) - 1.0)) + d * keep

    for i in range(n_gu):
        for c in range(n_gvp):
            t0, p0 = th[i].clone(), ph[c].clone()  # the cell-start tiles
            w = cells.w[i, c].float()
            e = cells.s[i, c].float() - w * (t0 @ p0.T + gb)
            dph = torch.zeros(tv, lanes)
            for b in blocks:
                dph += e[b].T @ t0[b]
            dth = e @ p0
            th[i] = apply(t0, dth, w.sum(1, keepdim=True), keep_u)
            ph[c] = apply(p0, dph, w.sum(0).unsqueeze(1), keep_v)


@pytest.mark.parametrize("grid", [(4, 4), (8, 4), (1, 6), (6, 1)])
def test_wavefront_order_matches_the_diagonal_walk(grid):
    """Row-major cells (each row's cells in order, rows in order), with the
    cell split into row blocks as the kernel splits it over a cluster,
    reproduce the anti-diagonal walk of the plain version: only f32 sums
    are taken in another order."""
    n_gu, n_gvp = grid
    tu, tv, dim = 16, 8, 10
    ds = synthetic_ratings(n_gu * tu, n_gvp * tv, n_gu * n_gvp * 40, rank=3,
                           noise=0.3, seed=n_gu * 10 + n_gvp)
    tabs = np_tables(ds.nu, ds.nv, dim, seed=3, gb=3.0)
    r = td.DenseEpochRunner(ds, tile_u=tu, tile_v=tv, k_cells=1,
                            mxu="float32", dim=dim, device="cpu")
    assert r.cells.s.shape[:2] == grid
    want = r.pad(params_from_numpy(*tabs, device="cpu"))
    got = tuple(t.clone() for t in want)
    start = tuple(t.clone() for t in want)
    for eta in (0.05, 0.02):
        td.dense_epoch_reference(*want, r.cells, eta, 0.01, 3.0,
                                 max(1.0, 0.2 / eta), dim)
        wavefront_epoch(*got, r.cells, eta, 0.01, 3.0, max(1.0, 0.2 / eta),
                        dim, block_rows=8)
    for a, b, s in zip(got, want, start):
        assert float((b - s).abs().max()) > 1e-2  # both trained
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=2e-6)


def simulate_walk(n_gu, n_gvp, cluster, n_clusters, counters, order):
    """The kernel's hand-off protocol, one launch, in Python: ``n_clusters``
    clusters of ``cluster`` blocks take units by ticket; block q of unit i
    waits for item tile c's counter to reach (ready_base + i) * cluster
    and adds one when it leaves the tile. Clusters move in the rotating
    ``order``; a cluster that cannot move waits. Returns the cells in the
    order they ran; the counters end where ``counters.advance`` puts the
    next launch's bases."""
    ready = [int(x) for x in counters.counters[:n_gvp]]
    ticket = int(counters.counters[n_gvp])
    tb, rb = counters.ticket_base, counters.ready_base
    m = 2 ** 32
    state = [None] * n_clusters  # (unit, next cell) or "done"
    ran = []
    step = 0
    while any(s != "done" for s in state):
        moved = False
        for k in order(step, n_clusters):
            s = state[k]
            if s == "done":
                continue
            if s is None:  # draw a ticket
                unit = (ticket - tb) % m
                ticket = (ticket + 1) % m
                state[k] = "done" if unit >= n_gu else (unit, 0)
                moved = True
                continue
            i, c = s
            if (ready[c] - (rb + i) * cluster) % m >= 2 ** 31:
                continue  # unit i - 1 has not left tile c
            ran.append((i, c))
            ready[c] = (ready[c] + cluster) % m  # every block of the cluster
            state[k] = None if c + 1 == n_gvp else (i, c + 1)
            moved = True
        assert moved, "the walk deadlocked"
        step += 1
    counters.counters[:n_gvp] = torch.tensor(
        [x - m if x >= 2 ** 31 else x for x in ready], dtype=torch.int32)
    counters.counters[n_gvp] = ticket - m if ticket >= 2 ** 31 else ticket
    return ran


@pytest.mark.parametrize("n_gu,n_gvp,n_clusters", [
    (6, 4, 3), (6, 4, 8), (1, 5, 2), (5, 1, 2), (273, 42, 30)])
@pytest.mark.parametrize("start", [0, 2 ** 32 - 700])
def test_walk_counters_are_numbered_across_epochs(n_gu, n_gvp, n_clusters,
                                                   start):
    """Three launches on one set of counters, nothing cleared between them:
    every cell runs once per epoch, each after the cell above it and the
    one to its left, whatever order the clusters move in, and the counters
    end each epoch where ``WalkCounters.advance`` puts the next bases,
    through the 2^32 wrap."""
    cluster = 4
    n_clusters = min(n_clusters, n_gu)
    counters = td.WalkCounters(n_gvp, "cpu")
    counters.ticket_base = counters.ready_base = start
    counters.counters[:n_gvp] = np.int64(start * cluster % 2 ** 32).astype(
        np.int32).item()
    counters.counters[n_gvp] = np.int64(start).astype(np.int32).item()
    orders = [lambda s, n: range(n), lambda s, n: reversed(range(n)),
              lambda s, n: [(k + s) % n for k in range(n)]]
    for order in orders:
        ran = simulate_walk(n_gu, n_gvp, cluster, n_clusters, counters, order)
        assert sorted(ran) == [(i, c) for i in range(n_gu)
                               for c in range(n_gvp)]
        at = {cell: k for k, cell in enumerate(ran)}
        assert all(at[(i - 1, c)] < at[(i, c)] for i, c in at if i)
        assert all(at[(i, c - 1)] < at[(i, c)] for i, c in at if c)
        counters.advance(n_gu, n_clusters)
        ready = counters.counters[:n_gvp].numpy().astype(np.int64) % 2 ** 32
        assert np.all(ready == counters.ready_base * cluster % 2 ** 32)
        assert (int(counters.counters[n_gvp]) % 2 ** 32
                == counters.ticket_base)


@pytest.mark.parametrize("tu,tv", [(256, 256), (72, 128), (64, 256),
                                   (128, 128), (512, 256), (8, 128)])
@pytest.mark.parametrize("dim", [1, 8, 40, 64, 126, 128, 130, 300, 1405])
@pytest.mark.parametrize("w_dtype", [torch.int8, torch.bfloat16])
def test_walk_plan_cluster_and_lane_chunks(tu, tv, dim, w_dtype):
    """One block per 64 user rows and the dim + 2 used lanes on chip in
    one piece, rounded up to 16 (the products' k step), never past the
    fused row; None exactly where those lanes exceed WALK_MAX_LC or the
    block's shared memory."""
    plan = td.plan_dense_walk(tu, tv, dim, torch.bfloat16, w_dtype)
    w_bytes = 1 if w_dtype == torch.int8 else 2
    kdim = dim + 2
    cluster = cdiv(tu, td.WALK_ROWS)
    lc = cdiv(kdim, 16) * 16
    smem = td.walk_smem_bytes(tv, lc, w_bytes, cluster)
    fits = lc <= td.WALK_MAX_LC and smem <= td.WALK_SMEM
    assert (plan is not None) == fits
    if plan is not None:
        assert plan == td.WalkPlan(cluster=cluster, lc=lc, smem=smem)
        assert kdim <= plan.lc <= row_lanes(dim)


def test_walk_smem_bytes_at_ml10m():
    """The footprint at the headline shape (256x256 cells, dim 64): 80
    lanes with int8 W; bf16 W's larger stage leaves no room for them. The
    S and W stages are whole TMA boxes of 64 rows x 128 bytes after a 1 KiB
    header, so they start 1024-aligned, and the bf16 tiles after them
    start on the 256-byte period of their 32-byte swizzle."""
    plan = td.plan_dense_walk(256, 256, 64, torch.bfloat16, torch.int8)
    assert plan == td.WalkPlan(cluster=4, lc=80, smem=219_136)
    assert (1024 + 64 * 256 * 2) % 1024 == 0
    assert (1024 + 64 * 256 * 3) % 1024 == 0
    assert (64 * 256 * 3 + 256 * 80 * 2) % 256 == 0
    assert td.walk_smem_bytes(256, 80, 2, 4) > td.WALK_SMEM
    assert td.plan_dense_walk(256, 256, 64, torch.bfloat16,
                              torch.bfloat16) is None


ML10M_GRID = (69_878, 10_677)


@pytest.mark.parametrize("dim,work,w_dtype,want", [
    (8, torch.bfloat16, torch.int8, "wavefront"),
    (64, torch.bfloat16, torch.int8, "wavefront"),
    (128, torch.bfloat16, torch.int8, "diagonal"),
    (1405, torch.bfloat16, torch.int8, "diagonal"),
    (8, torch.bfloat16, torch.bfloat16, "wavefront"),
    (64, torch.bfloat16, torch.bfloat16, "diagonal"),
    (128, torch.bfloat16, torch.bfloat16, "diagonal"),
    (1405, torch.bfloat16, torch.bfloat16, "diagonal"),
    (8, torch.float32, torch.int8, "diagonal"),
    (64, torch.float32, torch.int8, "diagonal"),
    (128, torch.float32, torch.float32, "diagonal"),
    (1405, torch.float32, torch.float32, "diagonal")])
def test_route_on_the_ml10m_grid(dim, work, w_dtype, want):
    """At ML-10M (273 x 42 cells of 256 x 256, every dim the dense path
    admits there up to 1405) the wavefront walk takes the bf16 rows whose
    lanes fit on chip (dim 8 and 64 with int8 W, dim 8 with bf16 W); wider
    rows and the f32 parity type take the diagonal walk."""
    nu, nv = ML10M_GRID
    tu, tv = td.pick_dense_tiles(nu, nv)
    assert (tu, tv, cdiv(nu, tu), cdiv(nv, tv)) == (256, 256, 273, 42)
    params = params_from_numpy(*np_tables(2, 2, dim, 0, 0.0), device="cpu")
    one = np.zeros(1, np.int32)
    ds = RatingsCOO(u=one, v=one, r=np.ones(1, np.float32), nu=nu, nv=nv)
    assert td.dense_eligible(params, ds)
    assert td.dense_route(tu, tv, dim, work, w_dtype) == want
    plan = td.plan_dense_walk(tu, tv, dim, work, w_dtype)
    assert (plan is not None) == (want == "wavefront")


@pytest.mark.parametrize("tu,tv,dim,want", [
    (72, 128, 8, "wavefront"), (72, 128, 64, "wavefront"),
    (72, 128, 300, "diagonal"), (16, 128, 8, "wavefront"),
    (512, 256, 64, "wavefront"), (64, 256, 64, "diagonal"),
    (256, 96, 8, "diagonal"), (256, 64, 8, "diagonal"),
    (256, 384, 8, "diagonal"), (520, 256, 8, "diagonal"),
    (68, 128, 8, "diagonal")])
def test_route_on_small_and_ragged_grids(tu, tv, dim, want):
    """Small and ragged cells: the wavefront walk takes tv 128 or 256 (its
    TMA boxes), tu up to 8 blocks of 64 rows in multiples of 8, and rows
    whose lanes fit on chip (a one-block cluster's larger slice of item
    rows leaves room for fewer lanes); every other shape takes the
    diagonal walk."""
    assert td.dense_route(tu, tv, dim, torch.bfloat16, torch.int8) == want


def test_densify_makes_walk_counters():
    """densify gives the cells zeroed counters (n_gvp ready counters and
    the ticket) at bases 0."""
    ds = synthetic_ratings(40, 30, 500, rank=2, seed=1)
    r = td.DenseEpochRunner(ds, tile_u=16, tile_v=16, k_cells=2,
                            mxu="float32", device="cpu")
    walk = r.cells.walk
    assert walk.counters.shape == (r.plan.n_gvp + 1,)
    assert walk.counters.dtype == torch.int32
    assert not walk.counters.any()
    assert (walk.ticket_base, walk.ready_base) == (0, 0)
    walk.advance(3, 2)
    assert (walk.ticket_base, walk.ready_base) == (5, 3)
