"""The tile walk of ``csrc/adreg_cells.cu`` and ``csrc/sgld_cells.cu`` on
the CPU: the host planner (units, waits, releases, the critical path
against a brute-force DAG depth, the route), a replay of the walk's
protocol in which units take tickets and run their windows, through the
plain versions' own window step, in any order the ready counters allow
(against the plan-order plain versions, and against tpu_mf's interpret-mode
kernels), and the counters' numbering across launches and the 2^32 wrap."""

import numpy as np
import jax
import pytest
import torch

from tpu_mf.models.dpmf import init_dpmf as jax_init_dpmf
from tpu_mf.ops import pallas_adreg as jpa
from tpu_mf_torch.data.coo import RatingsCOO, synthetic_ratings
from tpu_mf_torch.models.admf import admf_state_from_numpy, with_shadows
from tpu_mf_torch.models.dpmf import dpmf_state_from_numpy
from tpu_mf_torch.models.mf import params_from_numpy
from tpu_mf_torch.ops import adreg_cells as tac
from tpu_mf_torch.ops import adreg_slot as tas
from tpu_mf_torch.ops import sgld_cells as tg
from tpu_mf_torch.ops import sgd_cells as tc
from tpu_mf_torch.ops import sgld_slot as tss
from tpu_mf_torch.ops import tile_walk as tw
from tpu_mf_torch.ops.phi_shard import PhiShardedRunner
from tpu_mf_torch.ops.sgd_cells import (
    CellPlan,
    _apply_flags,
    pad_plan_nb,
    prepare_cells,
)

torch.set_num_threads(1)
MASK32 = 2 ** 32


def plan_of(gu, gv, w, tile=4):
    """A CellPlan from (nb,) user tiles, (nb, 8) item tiles and (nb, sub, 8)
    weights (ids 0, ratings 1)."""
    gu, gv, w = (np.asarray(x) for x in (gu, gv, w))
    z = np.zeros(w.shape, np.int32)
    return CellPlan(u=z, v=z, r=np.ones(w.shape, np.float32),
                    w=w.astype(np.float32), gu=gu.astype(np.int32),
                    gv=gv.astype(np.int32), tile_u=tile, tile_v=tile,
                    n_gu=int(gu.max()) + 1, n_gv=int(gv.max()) + 1,
                    n_real=int((w > 0).sum()))


def random_plan(rng, nb, n_gu, n_gv, pad=0.15):
    """Batches sorted by user tile, random item tiles, a share of padding
    columns and one all-padding batch."""
    gu = np.sort(rng.integers(0, n_gu, nb))
    gv = rng.integers(0, n_gv, (nb, 8))
    w = (rng.random((nb, 2, 8)) > pad).astype(np.float32)
    w[rng.integers(nb)] = 0
    return plan_of(gu, gv, w)


# ---- the planner ------------------------------------------------------------

def test_plan_units_waits_and_releases():
    """Two batches on user tile 0 (one all-padding between them, one
    padding column), then one on user tile 1: the first unit holds item
    tile 2 from its first to its last touch; the second waits on it once
    and on tile 5 not at all; padding columns carry no tile."""
    gv = np.array([[2, 3, 2, 0, 0, 0, 0, 0], [0] * 8, [2, 5, 2, 2, 2, 2, 2, 2],
                   [5, 2, 0, 0, 0, 0, 0, 0]])
    w = np.zeros((4, 1, 8))
    w[0, 0, :3] = 1
    w[2, 0, :] = 1
    w[2, 0, 7] = 0
    w[3, 0, :2] = 1
    walk = tw.plan_tile_walk(plan_of([0, 0, 0, 1], gv, w), 0, 4)
    assert walk.unit_c0.tolist() == [0, 24]
    assert walk.unit_c1.tolist() == [23, 26]
    assert walk.unit_gu.tolist() == [0, 1]
    assert walk.unit_wait.tolist() == [0, 0]
    ct = walk.col_tile
    assert ct[:3].tolist() == [2, 3, 2] and (ct[3:16] == -1).all()
    assert ct[23] == -1 and ct[24:26].tolist() == [5, 2]
    first = {c: int(walk.col_wait[c]) for c in np.flatnonzero(
        walk.col_wait >= 0)}
    assert first == {0: 0, 1: 0, 17: 0, 24: 1, 25: 1}
    rel = {c: int(walk.col_rel[c]) for c in np.flatnonzero(walk.col_rel)}
    assert rel == {1: 1, 17: 1, 22: 1, 24: 2, 25: 2}
    assert (walk.n_units, walk.n_windows) == (2, 12)


def test_padding_columns_are_dropped():
    """A plan padded to more batches (pad_plan_nb: all-padding batches on
    the last user tile, item tile 0) has the same units and waits as the
    plan itself: padding touches no tile, so it makes no unit wait."""
    ds = synthetic_ratings(200, 150, 3000, rank=3, seed=4, zipf=1.1)
    plan = prepare_cells(ds, 32, 32, 64, 1)
    nb = plan.u.shape[0]
    padded = pad_plan_nb(plan, nb + 9)
    a = tw.plan_tile_walk(plan, 0, nb)
    b = tw.plan_tile_walk(padded, 0, nb + 9)
    for f in ("unit_c0", "unit_c1", "unit_gu", "unit_wait"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for f in ("col_tile", "col_wait", "col_rel"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f)[:nb * 8])
        assert (getattr(b, f)[nb * 8:] == (-1 if f != "col_rel" else 0)).all()
    assert (a.crit, a.n_windows) == (b.crit, b.n_windows)


def brute_depth(plan, b0, b1, window):
    """The longest chain of windows, each after the last earlier window on
    its user tile and the last earlier window on each of its item tiles,
    from every pair of real windows."""
    real = tw.real_columns(plan.w)
    wins = []
    for i in range(b0, b1):
        for k0 in range(0, 8, window):
            cols = [i * 8 + k for k in range(k0, k0 + window)
                    if real[i * 8 + k]]
            if cols:
                wins.append((int(plan.gu[i]),
                             {int(plan.gv.reshape(-1)[c]) for c in cols}))
    depth = []
    for n, (g, vs) in enumerate(wins):
        preds = []
        last_u = max((m for m in range(n) if wins[m][0] == g), default=None)
        if last_u is not None:
            preds.append(last_u)
        for v in vs:
            last_v = max((m for m in range(n) if v in wins[m][1]),
                         default=None)
            if last_v is not None:
                preds.append(last_v)
        depth.append(1 + max((depth[m] for m in preds), default=0))
    return max(depth, default=0), len(wins)


@pytest.mark.parametrize("window", [1, 2, 8])
@pytest.mark.parametrize("seed", range(4))
def test_critical_path_is_the_dag_depth(seed, window):
    """The planner's critical path and window count equal a brute-force
    longest chain over the windows' dependency DAG, on random plans with
    padding columns and repeated user tiles, for a whole plan and for a
    middle range of its batches."""
    rng = np.random.default_rng(seed)
    plan = random_plan(rng, 24, 5, 4 + seed)
    for b0, b1 in ((0, 24), (5, 17)):
        walk = tw.plan_tile_walk(plan, b0, b1, window)
        assert (walk.crit, walk.n_windows) == brute_depth(plan, b0, b1,
                                                          window)
        assert (b0, b1) == (walk.b0, walk.b1)


def test_route_by_critical_path():
    """tile_walk_route compares the walks' modelled rounds: the critical
    path's windows at TILE_STEP_ROUNDS plus a cluster's rounds of slots
    against every window at GRID_STEP_ROUNDS plus the card's. One item
    tile shared by every unit chains them all (grid walk); a tile per user
    tile leaves the units independent (tile walk) until the windows hold so
    many slots that one cluster takes more rounds over the short chain than
    the card over every window (grid walk again), also on a card of 8 SMs,
    where the one cluster that fits runs every window in turn; the ML-10M
    plans' counts route as their runs measured."""
    w = np.ones((8, 1, 8))
    gu = np.repeat(np.arange(4), 2)
    chained = tw.plan_tile_walk(plan_of(gu, np.zeros((8, 8)), w), 0, 8)
    assert chained.crit == chained.n_windows == 64
    assert chained.slots == 1
    assert tw.tile_walk_route(chained) == "grid"
    free = tw.plan_tile_walk(plan_of(gu, np.repeat(gu[:, None], 8, 1), w),
                             0, 8)
    assert (free.crit, free.n_windows, free.n_units) == (16, 64, 4)
    assert tw.tile_walk_route(free) == "tile"  # 16 x 8 < 64 x 4
    assert tw.tile_walk_route([free, chained]) == "grid"  # 640 > 512
    # windows of 8 columns of 512 slots, 2 on the critical path of 8
    tall = np.ones((8, 512, 8))
    gv = np.repeat(gu[:, None], 8, 1)
    wide = tw.plan_tile_walk(plan_of(gu, gv, tall), 0, 8, 8)
    assert (wide.crit, wide.n_windows, wide.slots) == (2, 8, 4096)
    assert tw.tile_walk_route(wide, cluster=8) == "grid"  # 2 x 23 > 8 x 4
    # one cluster of 8 fits on 8 SMs: 8 windows in turn, 8 x 23 > 8 x 19
    assert tw.walk_steps(wide, 8, sms=8) == 8
    assert tw.tile_walk_route(wide, cluster=8, sms=8) == "grid"
    # (crit, windows, slots a window) of the ML-10M plans: gen-1 AdaptReg
    # and SGLD on clusters of 8, slot AdaptReg at 8/8 and slot SGLD on
    # clusters of 16
    for crit, n, slots, size, want in ((2136, 18135, 512, 8, "tile"),
                                       (660, 10217, 1024, 8, "tile"),
                                       (464, 3162, 3584, 16, "tile"),
                                       (134, 433, 28672, 16, "grid")):
        model = wide._replace(crit=crit, n_windows=n, slots=slots)
        assert tw.cluster_size(model) == size
        assert tw.tile_walk_route(model) == want
    with pytest.raises(ValueError):
        tw.plan_tile_walk(plan_of(gu, np.zeros((8, 8)), w), 0, 8, 3)


# (tile_u, tile_v, column slots, batches, window, critical path, windows,
# cluster size, walk) of the benchmark cells' csrc/cell_sgd.cu plans: gen-1
# at ML-10M and a Yahoo shard, as the host planner counts them, with the
# cluster size and the walk timed fastest on the H100 (PERF.md)
CELL_MODEL = [
    (256, 272, 1024, 1365, 1, 312, 10920, 4, "tile"),
    (256, 272, 1024, 1365, 4, 282, 2730, 16, "tile"),
    (256, 272, 1024, 1365, 8, 277, 1365, 16, "tile"),
    (4096, 2040, 512, 768, 1, 262, 4410, 8, "tile"),
    (4096, 2040, 512, 768, 2, 253, 2205, 16, "tile"),
    (4096, 2040, 512, 768, 4, 249, 1225, 16, "tile"),
    (4096, 2040, 512, 768, 8, 247, 735, 16, "grid"),
]


@pytest.mark.parametrize("case", CELL_MODEL,
                         ids=[f"{c[0]}x{c[1]}-w{c[4]}" for c in CELL_MODEL])
def test_cell_cluster_size_and_route(case):
    """csrc/cell_sgd.cu's model (cell_cluster_size, cell_walk_rows and
    tile_walk_route over the grid walk's every window) picks, from a plan's
    counts, the cluster size and the walk the H100 timed fastest: clusters
    of 4 for gen-1's 8/8 windows, whose count, not the chain, bounds the
    walk on 16 clusters; 16 for wide windows; the grid walk for a Yahoo
    shard's whole-batch windows (a tie on the card)."""
    tu, tv, sub, nb, window, crit, n, size, route = case
    base = tw.plan_tile_walk(plan_of([0], np.zeros((1, 8)),
                                     np.ones((1, 1, 8))), 0, 1)
    walk = base._replace(window=window, slots=window * sub, crit=crit,
                         n_windows=n)
    rows, grid_rows = tw.cell_walk_rows(tu, tv, sub, window)
    assert tw.cell_cluster_size(walk, rows) == size
    assert tw.tile_walk_route(walk, size, rows=rows,
                              grid_windows=nb * 8 // window,
                              grid_rows=grid_rows) == route


@pytest.mark.parametrize("groups", [1, 2, 4, 8])
def test_tile_apply_flags(groups):
    """Without padding the walk's flags are _apply_flags; a padding column
    takes no flag, and the real column before it on the same tile in its
    group takes the apply instead."""
    rng = np.random.default_rng(groups)
    gv = rng.integers(0, 3, (6, 8))
    np.testing.assert_array_equal(
        tw.tile_apply_flags(gv.reshape(-1), groups), _apply_flags(gv, groups))
    ct = gv.reshape(-1).copy()
    ct[7] = -1  # padding column of batch 0's last group
    flags = tw.tile_apply_flags(ct, groups)
    assert flags[0, 7] == 0
    w = 8 // groups
    for j in range(8 - w, 7):  # the group's real columns on each tile
        later = any(ct[k] == ct[j] for k in range(j + 1, 7))
        assert flags[0, j] == int(not later)


def test_item_noise_ranges_split_the_touch_list():
    """item_noise_ranges points the first real column of each batch on an
    item tile at exactly the batch's touched rows on that tile; the ranges
    cover each batch's list once."""
    ds = synthetic_ratings(200, 150, 3000, rank=3, seed=4, zipf=1.1)
    plan = prepare_cells(ds, 32, 32, 64, 1)
    tu_off, tu_ids, tv_off, tv_ids = tg._touch_lists(plan)
    walk = tw.plan_tile_walk(plan, 0, plan.u.shape[0])
    lo, hi = tw.item_noise_ranges(walk, tv_off, tv_ids, 32, plan.n_gv)
    nb = plan.u.shape[0]
    for i in range(nb):
        got = []
        for k in range(8):
            c = i * 8 + k
            rows = tv_ids[lo[c]:hi[c]]
            if hi[c] > lo[c]:
                v = walk.col_tile[c]
                assert (rows // 32 == v).all()
                real = plan.w[i, :, k] > 0
                assert set((v * 32 + plan.v[i, real, k]).tolist()) <= set(
                    rows.tolist())
            got += rows.tolist()
        assert sorted(got) == sorted(tv_ids[tv_off[i]:tv_off[i + 1]].tolist())


# ---- the replay -------------------------------------------------------------

class Device:
    """The walk's counters as a kernel sees them: a 64-bit ready counter per
    tile and the 32-bit ticket, both left as the last launch left them."""

    def __init__(self, cnt: tw.TileWalkCounters, ticket: int = 0):
        self.ready = [0] * (cnt.n_gv + cnt.n_gu)
        self.ticket = ticket


def stamp(gen, w):
    return (gen << 32) | w


def run_launch(dev, cnt, walk: tw.DeviceWalk, s, n_clusters, window, tap,
               step, rng, holds=None):
    """One launch of range s of ``walk`` on ``n_clusters`` simulated
    clusters, interleaved at random where the counters allow: tickets, the
    waits (value equality, as the kernel spins), ``step(i, lo, hi)`` for
    each window that holds a real column, and the releases; asserts that a
    unit holds every tile it touches and that no two hold one tile.
    Returns the most units that held tiles at once."""
    host = walk.walks[s]
    off = walk.unit_off[s]
    n_units = host.n_units
    col_tile = walk.col_tile.numpy()
    col_wait = walk.col_wait.numpy()
    col_rel = walk.col_rel.numpy()
    gen, base = cnt.gen, cnt.ticket_base
    holds = {} if holds is None else holds
    done, overlap = [], []

    def acquire(t, wv, unit):
        while wv > 0 and dev.ready[t] != stamp(gen, wv):
            yield t, wv
        assert holds.get(t) is None, f"tile {t} held by {holds[t]}"
        holds[t] = unit
        overlap.append(len(set(holds.values())))

    def release(t, w1, unit):
        assert holds.pop(t) == unit
        dev.ready[t] = stamp(gen, w1)

    def cluster():
        while True:
            t = dev.ticket
            dev.ticket = (t + 1) % MASK32
            unit = (t - base) % MASK32
            if unit >= n_units:
                return
            k = off + unit
            c0, c1 = int(host.unit_c0[unit]), int(host.unit_c1[unit])
            gu = int(host.unit_gu[unit])
            ut = cnt.n_gv + gu
            yield from acquire(ut, int(host.unit_wait[unit]), k)
            for s0 in range(c0 - c0 % window, c1, window):
                lo, hi = max(s0, c0), min(s0 + window, c1)
                real = [c for c in range(lo, hi) if col_tile[c] >= 0]
                if not real:
                    continue
                for c in real:
                    if col_wait[c] >= 0:
                        yield from acquire(int(col_tile[c]),
                                           int(col_wait[c]), k)
                assert holds.get(ut) == k
                assert all(holds.get(int(col_tile[c])) == k for c in real)
                assert all(tap[c // 8, c % 8] == 0 for c in range(lo, hi)
                           if col_tile[c] < 0)
                step(s0 // 8, lo, hi)
                yield None
                for c in real:
                    if col_rel[c] > 0:
                        release(int(col_tile[c]), int(col_rel[c]), k)
            release(ut, int(host.unit_wait[unit]) + 1, k)
            done.append(unit)
            yield None

    interleave(dev, gen, [cluster() for _ in range(n_clusters)], rng)
    assert sorted(done) == list(range(n_units))
    assert not holds
    assert dev.ticket == (base + n_units + n_clusters) % MASK32
    cnt.advance(n_units, n_clusters)
    return max(overlap, default=0)


def interleave(dev, gen, active, rng):
    """Run the simulated clusters (generators that yield the (tile, wait
    value) they spin on, or None at a step's end) one step at a time, in a
    random order among those whose wait the counters meet."""
    blocked = {}
    while active:
        ready = [g for g in active
                 if g not in blocked or dev.ready[blocked[g][0]]
                 == stamp(gen, blocked[g][1])]
        assert ready, "every cluster waits: the walk deadlocks"
        g = ready[rng.integers(len(ready))]
        blocked.pop(g, None)
        try:
            wait = next(g)
        except StopIteration:
            active.remove(g)
            continue
        if wait is not None:  # (tile, wait value) it spins on
            blocked[g] = wait


def masked(plan, i, lo, hi, flags=None):
    """Batch i of a DevicePlan alone (as batch 0) with only the columns
    [lo, hi) (numbered over the plan) kept, and ``flags`` ((nb, 8): the
    walk's apply flags) as its apply flags at every grouping, zero outside
    [lo, hi)."""
    k = torch.arange(8) + i * 8
    keep = ((k >= lo) & (k < hi)).to(plan.w.dtype)
    ap_host = plan.ap_host
    if flags is not None:
        row = flags[i:i + 1] * keep.numpy().astype(flags.dtype)
        ap_host = {g: row for g in plan.ap_host}
    else:
        ap_host = {g: a[i:i + 1] for g, a in ap_host.items()}
    return plan._replace(
        u=plan.u[i:i + 1], v=plan.v[i:i + 1], r=plan.r[i:i + 1],
        w=plan.w[i:i + 1] * keep[None, :, None], gu=plan.gu[i:i + 1],
        gv=plan.gv[i:i + 1], gu_host=plan.gu_host[i:i + 1],
        gv_host=plan.gv_host[i:i + 1], ap_host=ap_host)


def np_tables(nu, nv, dim, seed, gb):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1e-1, (nu, dim)).astype(np.float32),
            rng.normal(0, 1e-1, (nv, dim)).astype(np.float32),
            rng.normal(0, 1e-1, nu).astype(np.float32),
            rng.normal(0, 1e-1, nv).astype(np.float32), np.float32(gb))


def zipf_sets(loss=0, n=1500):
    ds = synthetic_ratings(300, 200, n, rank=3, noise=0.3, seed=5, zipf=1.1)
    va = synthetic_ratings(300, 200, 400, rank=3, noise=0.3, seed=6)
    if loss:
        ds, va = (RatingsCOO(d.u, d.v, (d.r > ds.mean_rating()).astype(
            np.float32), d.nu, d.nv) for d in (ds, va))
    return ds, va


def adreg_replay(r, tables, eta, lams, n_clusters, rng, dev, tg_=8, pg=8,
                 segments=None):
    """Segments of an AdaptReg runner's plan 0 on the replay (window =
    the group width); returns the most units in flight at once."""
    plan, walk = r.materialize()._dev[0], r.walks[0]
    window = 8 // tg_
    tap = walk.tap[pg].numpy()
    n = r.seg_len(0)
    overlap = 0
    for s in segments or range(r.segments):
        def step(i, lo, hi):
            tac.adreg_segment_reference(
                *tables, masked(plan, i, lo, hi, tap), 0, 1, eta, lams, r.gb,
                r.dim, tg_, pg, torch.float32, r.loss)
        assert walk.range_of(s * n, (s + 1) * n) == s
        overlap = max(overlap, run_launch(dev, walk.counters, walk, s,
                                          n_clusters, window, tap, step, rng))
    return overlap


ADREG_REPLAY = {
    # name: (family, loss, eta * lam, groups, clusters)
    "gen1": ("gen1", 0, 1e-3, 8, 3),
    "gen1_logistic": ("gen1", 1, 1e-3, 8, 5),
    "gen1_negbase": ("gen1", 0, 1.5, 8, 2),
    "slot_8": ("slot", 0, 1e-3, 8, 4),
    "slot_2": ("slot", 0, 1e-3, 2, 3),
    "stripe_1": ("stripe", 0, 1e-3, 1, 3),
}


@pytest.mark.parametrize("case", sorted(ADREG_REPLAY))
def test_adreg_replay_matches_plan_order(case):
    """Each segment of an AdaptReg runner's plan replayed on the walk
    (windows of the group width, a random interleaving) equals the
    plain version's segment in plan order, f32, within 1e-6: gen-1 plans
    at 8/8 (losses 0 and 1, a negative decay base), slot and striped plans
    at 8/8, 2/2 and 1/1."""
    family, loss, eta_lam, groups, n_clusters = ADREG_REPLAY[case]
    ds, va = zipf_sets(loss)
    dim = 8 if family != "gen1" else 12
    if family == "gen1":
        r = tac.AdRegCellRunner(ds, va, tile_u=32, tile_v=32, batch=64,
                                segments=3, seed=2, mxu="float32", loss=loss,
                                device="cpu")
    else:
        r = tas.SlotAdRegRunner(ds, va, sub=8, seed=2, mxu="float32",
                                loss=loss, dim=dim, tile=64,
                                striped=family == "stripe", segments=3,
                                theta_groups=groups, phi_groups=groups,
                                device="cpu")
    eta = 0.05
    params = params_from_numpy(*np_tables(ds.nu, ds.nv, dim, 3,
                                          0.0 if loss else 3.0), "cpu")
    state = with_shadows(params, (eta_lam / eta,) * 4)
    want = r.pad(state)
    start = tuple(t.clone() for t in want)
    lams = r.lams.clone()
    n = r.seg_len(0)
    for s in range(r.segments):
        tac.adreg_segment_reference(*want, r._dev[0], s * n, (s + 1) * n,
                                    eta, lams, r.gb, dim, groups, groups,
                                    torch.float32, loss)
    assert float((want[0] - start[0]).abs().max()) > 1e-3
    got = tuple(t.clone() for t in start)
    overlap = adreg_replay(r, got, eta, lams, n_clusters,
                           np.random.default_rng(n_clusters), Device(
                               r.walks[0].counters), groups, groups)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
    if family == "gen1":  # 10 user tiles: units ran side by side
        assert overlap >= 2


def test_adreg_replay_matches_interpret_kernel():
    """The first segment of a gen-1 plan replayed on the walk against
    tpu_mf's _run_adreg_seg_step in interpret mode (f32, the same
    validation draws): tables within 2e-5 (tests/test_torch_adreg.py's f32
    tolerance: the interpret kernel's one-hot products sum in another
    order), lambdas within 1e-6."""
    from tests.test_torch_adreg import (
        K, arrays_of, data, draws, jax_state, port, seg_hyper)

    ds, valid = data(n=2000)
    js = jax_state(ds, 8, 0.02)
    kw = dict(tile_u=64, tile_v=64, batch=128, segments=3, seed=2,
              mxu="float32", loss=0)
    jr = jpa.PallasAdRegRunner(ds, valid, interpret=True, **kw)
    pt = tac.AdRegCellRunner(port(ds), port(valid), device="cpu", **kw)
    tj = jr.pad(js)
    tp = pt.pad(admf_state_from_numpy(arrays_of(js), "cpu"))
    b = jr.bundles[0]
    eta, eta_reg, key = 0.05, 0.5, jax.random.PRNGKey(5)
    t0, t1, lj = jpa._run_adreg_seg_step(
        tj[0], tj[1], jr.lams, key, np.int32(0), *jr.valid, b["gu"][0],
        b["gv"][0], b["u"][0], b["v"][0], b["ut"][0], b["vt"][0], b["r"][0],
        b["w"][0], seg_hyper(eta, jr.gb), np.float32(eta),
        np.float32(eta_reg), np.asarray(b["visits_per_seg"]), tile_u=64,
        tile_v=64, batch=128, dim=8, n_gu=b["n_gu"], n_gv=b["n_gv"],
        mxu="float32", interpret=True, loss=0, n_samples=K)
    samples = torch.as_tensor(draws(key, 1, len(valid))[0])
    uv, vv, rv = pt._valid
    su, sv, sr = uv[samples], vv[samples], rv[samples]
    old_t, old_p = tp[0][su], tp[1][sv]
    adreg_replay(pt, tp, eta, pt.lams, 3, np.random.default_rng(0),
                 Device(pt.walks[0].counters), segments=[0])
    lp = tac.hypergrad_ext_rows(tp[0][su], tp[1][sv], old_t, old_p, sr,
                                pt.lams, eta, eta_reg, pt._visits[0][0],
                                pt.gb, 8, 0)
    np.testing.assert_allclose(tp[0].numpy(), np.asarray(t0), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(tp[1].numpy(), np.asarray(t1), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), rtol=0, atol=1e-6)


def np_dpmf_state(ds, dim, seed, gb=3.0, stamps=0):
    from tpu_mf_torch.models.dpmf import inverse_frequency

    theta, phi, bu, bv, gbv = np_tables(ds.nu, ds.nv, dim, seed, gb)
    ur, vr = inverse_frequency(ds)
    rng = np.random.default_rng(seed + 1)
    return dict(theta=theta, phi=phi, bu=bu, bv=bv, gb=gbv, lambda_r=1.0,
                lambda_ub=100.0, lambda_vb=80.0,
                lambda_u=rng.uniform(50, 150, dim),
                lambda_v=rng.uniform(50, 150, dim), ur=ur, vr=vr,
                gcountu=np.full(ds.nu + 1, stamps),
                gcountv=np.full(ds.nv + 1, stamps), gcount=stamps)


def gen1_sgld_replay(r, tables, clock0, hyper, dim, seed, n_clusters, rng,
                     dev, normals=None):
    """A gen-1 SGLD round on the replay: at each column the kernel's noise
    (the batch's user rows when the unit enters it, the batch's rows on
    the column's item tile at its first column there, from
    ``item_noise_ranges``), then the column through the plain version at
    temp 0 (its gradient and apply; its noise adds zero). ``normals``
    replaces the hash as in ``sgld_cell_epoch_reference``."""
    p = r.materialize()._dev[0]
    walk = p.walk
    cp = p.cells
    tu, tv = cp.tile_u, cp.tile_v
    theta, phi, st_u, st_v = tables
    _, gbt, _, te = tg._scalars(hyper, "cpu")
    tu_off, tu_ids = p.tu_off.numpy(), p.tu_ids.numpy()
    tv_ids = p.tv_ids.numpy()
    nz_lo, nz_hi = (a.numpy() for a in walk.nz)
    flat = (hyper[0], 0.0, *hyper[2:])  # temp 0: the column's noise is 0
    entered = {}

    def no_noise(i, side, col, row0, n):
        return torch.zeros(n, dim + 1)

    def step(i, lo, hi):
        gu = int(cp.gu_host[i])
        clock = clock0 + int(p.cum_host[i])
        if entered.get(gu) != i:  # the unit enters batch i
            entered[gu] = i
            rows = tu_ids[tu_off[i]:tu_off[i + 1]]
            mask = torch.zeros(tu, dtype=torch.bool)
            mask[rows] = True
            nz = (normals(i, 0, 8, gu * tu, tu) if normals else
                  tg.hash_normals(seed, i, 0, gu * tu + torch.arange(tu),
                                  dim + 1))
            us = slice(gu * tu, (gu + 1) * tu)
            tg._inject(theta[us], st_u[us], mask, clock, te,
                       tg._noise_lanes(dim, 0, "cpu"), nz)
        c = lo
        if nz_hi[c] > nz_lo[c]:
            v = int(walk.col_tile[c])
            rows = torch.as_tensor(tv_ids[nz_lo[c]:nz_hi[c]] - v * tv,
                                   dtype=torch.int64)
            mask = torch.zeros(tv, dtype=torch.bool)
            mask[rows] = True
            nz = (normals(i, 1, c % 8, v * tv, tv) if normals else
                  tg.hash_normals(seed, i, 1, v * tv + torch.arange(tv),
                                  dim + 1))
            vs = slice(v * tv, (v + 1) * tv)
            tg._inject(phi[vs], st_v[vs], mask, clock, te,
                       tg._noise_lanes(dim, 1, "cpu"), nz)
        sub = p._replace(cells=masked(cp, i, lo, hi),
                         cum_host=p.cum_host[i:i + 1])
        tg.sgld_cell_epoch_reference(theta, phi, st_u, st_v, *r.invf, r.lam,
                                     sub, clock0, flat, dim, seed,
                                     normals=no_noise)

    return run_launch(dev, walk.counters, walk, 0, n_clusters, 1,
                      np.zeros((cp.u.shape[0], 8), np.int32), step, rng)


def slot_sgld_replay(r, tables, clock0, hyper, dim, seed, ring, n_clusters,
                     rng, dev):
    """A slot SGLD round on the replay: each window (a batch) through the
    plain version, on a plan cut to batches [0, i] whose earlier batches
    are masked (so the batch keeps its index for the noise cadence and the
    ring offsets), with the walk's apply flags."""
    p = r.materialize()._dev[0]
    walk = p.walk
    cp = p.cells
    tap = walk.tap[1].numpy()
    cap = tss.saturation_cap(hyper[3])

    def step(i, lo, hi):
        cut = cp._replace(
            u=cp.u[:i + 1], v=cp.v[:i + 1], r=cp.r[:i + 1],
            w=torch.cat([torch.zeros_like(cp.w[:i]),
                         masked(cp, i, lo, hi).w]),
            gu=cp.gu[:i + 1], gv=cp.gv[:i + 1], gu_host=cp.gu_host[:i + 1],
            gv_host=cp.gv_host[:i + 1])
        flags = np.zeros((i + 1, 8), np.int32)
        flags[i] = tap[i]
        tss.sgld_slot_epoch_reference(
            *tables, *r.invf, r.lam, p._replace(cells=cut, ap_host=flags),
            clock0, hyper, dim, seed, ring, r.pack, r.noise_every, cap)

    return run_launch(dev, walk.counters, walk, 0, n_clusters, 8, tap, step,
                      rng)


def sgld_state(ds, dim, stamps=7):
    return dpmf_state_from_numpy(np_dpmf_state(ds, dim, 6, stamps=stamps),
                                 "cpu")


@pytest.mark.parametrize("dim,temp", [(8, 1.0), (20, 0.0)])
def test_gen1_sgld_replay_matches_plan_order(dim, temp):
    """A gen-1 SGLD round replayed on the walk (noise moved to each row's
    first touch in a batch, two random interleavings) equals the plain
    version's round in plan order, f32: tables within 1e-6, stamps equal
    as integers."""
    ds, _ = zipf_sets()
    r = tg.SgldCellRunner(ds, tile_u=32, tile_v=32, batch=64, seed=3,
                          mxu="float32", device="cpu")
    state = sgld_state(ds, dim)
    hyper = (0.02 / len(ds), temp, 1.0, 0.02, 3.0)
    want = r.pad(state)
    start = tuple(t.clone() for t in want)
    tg.sgld_cell_epoch_reference(*want, *r.invf, r.lam, r._dev[0], 7, hyper,
                                 dim, 11)
    dev = Device(r._counters)
    for seed in range(2):
        got = tuple(t.clone() for t in start)
        overlap = gen1_sgld_replay(r, got, 7, hyper, dim, 11, 4,
                                   np.random.default_rng(seed), dev)
        for a, b in zip(got[:2], want[:2]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-6)
        for a, b in zip(got[2:], want[2:]):
            assert torch.equal(a, b)
        assert overlap >= 2
    assert float((want[0] - start[0]).abs().max()) > (0.1 if temp else 1e-3)


@pytest.mark.parametrize("striped,noise_every,temp", [
    (False, 8, 0.0), (False, 1, 0.5), (True, 8, 0.5), (True, 1, 0.5)])
def test_slot_sgld_replay_matches_plan_order(striped, noise_every, temp):
    """A slot SGLD round replayed on the walk (a window is a batch; apply
    flags of the real columns) equals the plain version's round in plan
    order, f32: tables within 1e-6, stamps equal as integers."""
    ds, _ = zipf_sets()
    r = tss.SlotSgldRunner(ds, sub=16, seed=1, mxu="float32", dim=8,
                           tile=64, noise_every=noise_every,
                           striped=striped, device="cpu")
    state = sgld_state(ds, 8)
    hyper = (0.05 / len(ds), temp, 1.0, 0.05, 3.0)
    ring = tss.slot_ring(13, r.tile_u, r.tile_v, "cpu")
    cap = tss.saturation_cap(hyper[3])
    want = r.pad(state)
    start = tuple(t.clone() for t in want)
    tss.sgld_slot_epoch_reference(*want, *r.invf, r.lam, r._dev[0], 7, hyper,
                                  8, 13, ring, r.pack, noise_every, cap)
    dev = Device(r._counters)
    for seed in range(2):
        got = tuple(t.clone() for t in start)
        slot_sgld_replay(r, got, 7, hyper, 8, 13, ring, 3,
                         np.random.default_rng(seed), dev)
        for a, b in zip(got[:2], want[:2]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-6)
        for a, b in zip(got[2:], want[2:]):
            assert torch.equal(a, b)
    assert float((want[0] - start[0]).abs().max()) > 1e-3


def test_gen1_sgld_replay_matches_interpret_kernel():
    """A gen-1 SGLD round replayed on the walk against tpu_mf's
    interpret-mode _sgld_kernel (f32) at temp 2, both fed the interpret
    kernel's normals (a tile's first half of rows R, the rest 0): tables
    within 3e-5 (tests/test_pallas_sgld.py's tolerance), stamps exact."""
    from tpu_mf.ops.pallas_sgld import PallasSgldRunner

    from tests.test_torch_sgld import arrays_of, ds_pair, interpret_normals
    from tpu_mf_torch.models.dpmf import dpmf_state_to_numpy

    jds, ds = ds_pair(300, 200, 2000, rank=3, seed=0)
    dim = 8
    js = jax_init_dpmf(jax.random.PRNGKey(0), jds, dim)
    eta = 1e-5
    hyper = (eta, 2.0, 1.0, eta * len(ds) * float(js.lambda_r),
             float(js.params.gb))
    kw = dict(tile_u=64, tile_v=64, batch=128, seed=1)
    jr = PallasSgldRunner(jds, mxu="float32", interpret=True, **kw)
    want = arrays_of(jr.unpack(js, jr.epoch(jr.pad(js), 0, hyper,
                                            noise_seed=7)))
    r = tg.SgldCellRunner(ds, mxu="float32", device="cpu", **kw)
    st = dpmf_state_from_numpy(arrays_of(js), "cpu")
    tabs = r.pad(st)
    gen1_sgld_replay(r, tabs, 0, hyper, dim, 7, 3, np.random.default_rng(1),
                     Device(r._counters), interpret_normals(dim))
    got = dpmf_state_to_numpy(r.unpack(st, tabs))
    for k in ("theta", "phi", "bu", "bv"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=3e-5,
                                   err_msg=k)
    for k in ("gcountu", "gcountv"):
        np.testing.assert_array_equal(got[k].astype(np.int64),
                                      want[k].astype(np.int64))


# ---- csrc/cell_sgd.cu's tile walk -----------------------------------------

def mf_launch(dev, plan, dwalk, tables, eta, lam, gb, dim, tg, pg,
              n_clusters, rng):
    """One launch of ``cell_walk_kernel`` replayed (f32, saturating) on
    ``n_clusters`` simulated clusters: units by ticket, the waits and
    releases as the kernel makes them, interleaved at random where the
    counters allow; per window step of min(tg_w, pg_w) columns the scatter
    of its real columns into the cluster's own dtheta slice and acc
    (``window_scatter``), and at a theta group end (or the unit's last
    step) where the slice holds deltas, and at a phi group end with an
    apply flag, the applies (``window_apply``): of every row of the tiles,
    or, where a group holds fewer slots than the tile has rows, of the rows
    its slots touched, each applied by the first slot (in a random order)
    that claims its count. Asserts that a unit holds every tile it touches
    and leaves its slice zero, and that acc ends zero. Returns the most
    units that held tiles at once."""
    theta, phi = tables
    cnt = dwalk.counters
    host = dwalk.walks[0]
    n_units = host.n_units
    col_tile = dwalk.col_tile.numpy()
    col_wait = dwalk.col_wait.numpy()
    col_rel = dwalk.col_rel.numpy()
    tap = dwalk.tap[pg].numpy().reshape(-1)
    tu, tv, lanes = plan.tile_u, plan.tile_v, theta.shape[1]
    sub = plan.u.shape[2]
    tg_w, pg_w = 8 // tg, 8 // pg
    step = min(tg_w, pg_w)
    claim_u, claim_v = tg_w * sub < tu, sub < tv
    eta_t, lam_t, gb_t, cap_t = torch.tensor(
        [eta, lam, gb, max(1.0, 0.2 / eta)], dtype=torch.float32)
    apply = tc.window_apply(eta_t, lam_t, cap_t, lanes, dim, True)
    acc = torch.zeros_like(phi)
    gen, base = cnt.gen, cnt.ticket_base
    holds, done, overlap = {}, [], []

    def acquire(t, wv, unit):
        while wv > 0 and dev.ready[t] != stamp(gen, wv):
            yield t, wv
        assert holds.get(t) is None, f"tile {t} held by {holds[t]}"
        holds[t] = unit
        overlap.append(len(set(holds.values())))

    def release(t, w1, unit):
        assert holds.pop(t) == unit
        dev.ready[t] = stamp(gen, w1)

    def claimed(cols, ids, rows_of):
        """The rows the real slots of ``cols`` touched, one entry a slot,
        in a random order."""
        out = []
        for c in cols:
            if col_tile[c] >= 0:
                real = plan.w[c // 8, c % 8] > 0
                out += [rows_of(c, int(x)) for x in ids[c // 8, c % 8][real]]
        return [out[k] for k in rng.permutation(len(out))]

    def apply_rows(tab, d, rows, side):
        for r in rows:
            if d[r, dim + 2] != 0:  # the first claim takes the count
                tab[r:r + 1] = apply(tab[r:r + 1], d[r:r + 1], side)
                d[r] = 0.0

    def cluster():
        ds = torch.zeros(tu, lanes)
        while True:
            t = dev.ticket
            dev.ticket = (t + 1) % MASK32
            unit = (t - base) % MASK32
            if unit >= n_units:
                return
            c0, c1 = int(host.unit_c0[unit]), int(host.unit_c1[unit])
            gut = int(host.unit_gu[unit])
            ut = cnt.n_gv + gut
            th = theta[gut * tu:(gut + 1) * tu]
            yield from acquire(ut, int(host.unit_wait[unit]), unit)
            dirty = False
            for s in range(c0 - c0 % step, c1, step):
                end = s + step
                lo, hi = max(s, c0), min(end, c1)
                real = [c for c in range(lo, hi) if col_tile[c] >= 0]
                last = end >= c1
                th_apply = (dirty or bool(real)) and (end % tg_w == 0
                                                      or last)
                t0, g0 = (end - 1) // tg_w * tg_w, (end - 1) // pg_w * pg_w
                ph = (end % pg_w == 0 or last) and any(
                    tap[c] for c in range(max(g0, c0), hi))
                if not real and not th_apply and not ph:
                    continue
                if real:
                    for c in real:
                        if col_wait[c] >= 0:
                            yield from acquire(int(col_tile[c]),
                                               int(col_wait[c]), unit)
                    assert holds.get(ut) == unit
                    assert all(holds.get(int(col_tile[c])) == unit
                               for c in real)
                    for c in real:
                        i, k = divmod(c, 8)
                        tc.window_scatter(th, phi, plan, i, k, k + 1, eta_t,
                                          gb_t, dim, torch.float32, False,
                                          ds, acc)
                    dirty = True
                    yield None
                if not th_apply and not ph:
                    continue
                if th_apply:
                    if claim_u:
                        apply_rows(th, ds, claimed(
                            range(max(t0, c0), hi), plan.u,
                            lambda c, x: x), 0)
                    else:
                        th[:] = apply(th, ds, 0)
                        ds.zero_()
                    assert not ds.any()
                    dirty = False
                if ph:
                    cols = range(max(g0, c0), hi)
                    assert all(holds.get(int(col_tile[c])) == unit
                               for c in cols if col_tile[c] >= 0)
                    if claim_v:
                        apply_rows(phi, acc, claimed(
                            cols, plan.v,
                            lambda c, x: int(col_tile[c]) * tv + x), 1)
                    else:
                        for c in cols:
                            if tap[c]:
                                rows = slice(int(col_tile[c]) * tv,
                                             (int(col_tile[c]) + 1) * tv)
                                phi[rows] = apply(phi[rows], acc[rows], 1)
                                acc[rows] = 0.0
                yield None
                if ph:
                    for c in range(max(g0, c0), hi):
                        if col_rel[c] > 0:
                            release(int(col_tile[c]), int(col_rel[c]), unit)
            release(ut, int(host.unit_wait[unit]) + 1, unit)
            assert not ds.any()
            done.append(unit)
            yield None

    interleave(dev, gen, [cluster() for _ in range(n_clusters)], rng)
    assert sorted(done) == list(range(n_units))
    assert not holds and not acc.any()
    assert dev.ticket == (base + n_units + n_clusters) % MASK32
    cnt.advance(n_units, n_clusters)
    return max(overlap, default=0)


MF_REPLAY_GROUPS = [(8, 8), (4, 4), (4, 8), (2, 2), (1, 1)]


@pytest.mark.parametrize("groups", MF_REPLAY_GROUPS,
                         ids=[f"{t}x{p}" for t, p in MF_REPLAY_GROUPS])
@pytest.mark.parametrize("family", ["gen1", "shard"])
def test_mf_replay_matches_plan_order(family, groups):
    """csrc/cell_sgd.cu's tile walk replayed (``mf_launch``) equals
    cell_epoch_reference in plan order, f32, saturating, within 1e-6, at
    equal and unequal groupings: on a gen-1 plan whose applies cover whole
    tiles (the item side) or claimed rows (the user side at 8/8), and on
    an item-sharded epoch (two shards on one set of counters, theta
    chained) of tiles far taller than a column, padded with all-padding
    batches (``nb_round``), whose applies are claimed."""
    ds = synthetic_ratings(300, 200, 2500, rank=3, noise=0.3, seed=5,
                           zipf=1.1)
    tg, pg = groups
    dim, eta, lam, gb = 12, 0.1, 0.05, 3.0
    tabs = np_tables(ds.nu, ds.nv, dim, 3, gb)
    if family == "gen1":
        r = tc.CellEpochRunner(ds, tile_u=32, tile_v=16, batch=128, seed=2,
                               mxu="float32", theta_groups=tg, phi_groups=pg,
                               saturate=True, device="cpu")
        runners = [r]
    else:
        r = PhiShardedRunner(ds, dim=dim, tile_u=64, tile_v=48, batch=64,
                             seed=2, mxu="float32", budget=3 * 48 * 128 * 4,
                             theta_groups=tg, phi_groups=pg, nb_round=8,
                             device="cpu")
        assert r.n_shards == 2
        runners = r.inners
        assert any(not tw.real_columns(i.plan.w).reshape(-1, 8)[-1].any()
                   for i in runners)  # an all-padding batch
    want = r.pad(params_from_numpy(*tabs, "cpu"))
    start = r.pad(params_from_numpy(*tabs, "cpu"))
    got = r.pad(params_from_numpy(*tabs, "cpu"))
    split = (lambda t: [(t[0], p) for p in t[1]]) if family == "shard" \
        else (lambda t: [t])
    dev = Device(runners[0].walk_counters)
    rng = np.random.default_rng(tg * 10 + pg)
    overlap = 0
    for inner, (th_w, ph_w), (th_g, ph_g) in zip(runners, split(want),
                                                   split(got)):
        plan = inner._dev[0]
        tc.cell_epoch_reference(th_w, ph_w, plan, eta, lam, gb,
                                max(1.0, 0.2 / eta), dim, tg, pg,
                                torch.float32, True, True)
        assert inner.walk_counters is runners[0].walk_counters
        overlap = max(overlap, mf_launch(
            dev, plan, tc.cell_walk(plan, tg, pg), (th_g, ph_g), eta, lam,
            gb, dim, tg, pg, 3, rng))
    for a, b in zip(r.trim(got), r.trim(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
    moved = r.trim(want).theta - r.trim(start).theta
    assert float(moved.abs().max()) > 1e-3
    assert overlap >= 2  # units ran side by side


def test_cell_walk_arrays_built_once_per_plan(monkeypatch):
    """A window runner's materialize builds each plan's units and column
    arrays once (one plan_tile_walks call a plan, none at a second
    materialize), and the four window widths share them on the device:
    the widths differ in their window count, critical path, cluster size
    and route alone."""
    calls = []
    real = tw.plan_tile_walks

    def counted(*args, **kw):
        calls.append(args[1:3])
        return real(*args, **kw)

    monkeypatch.setattr(tw, "plan_tile_walks", counted)
    ds, _ = zipf_sets()
    r = tc.CellEpochRunner(ds, tile_u=32, tile_v=32, batch=64, n_plans=3,
                           device="cpu")
    r.materialize()
    r.materialize()
    assert len(calls) == 3
    for p in r._dev:
        assert sorted(p.walk) == [1, 2, 4, 8]
        one = p.walk[1]
        for window, dw in p.walk.items():
            assert dw.walks[0].window == window
            for f in ("unit_c0", "unit_c1", "unit_gu", "unit_wait",
                      "col_tile", "col_wait", "col_rel", "tap"):
                assert getattr(dw, f) is getattr(one, f)
            assert dw.walks[0].col_rel is one.walks[0].col_rel
        assert one.walks[0].n_windows > p.walk[8].walks[0].n_windows


# ---- the counters' numbering ------------------------------------------------

@pytest.mark.parametrize("start", [MASK32 - 3, MASK32 - 6])
def test_counters_are_numbered_across_launches(start):
    """Segments of two alternating AdaptReg plans and two SGLD rounds on
    one runner's counters, nothing cleared between launches, the
    generation and the ticket starting ``start`` below 2^32 ... across the
    wrap: every launch runs each unit once, each waits only for the
    releases of its own launch (a stale value from an earlier launch never
    lets a unit in), the ticket ends where ``advance`` puts the next base,
    and the tables equal the plan-order plain version."""
    ds, va = zipf_sets(n=800)
    r = tac.AdRegCellRunner(ds, va, tile_u=32, tile_v=32, batch=64,
                            segments=3, seed=2, mxu="float32", n_plans=2,
                            device="cpu")
    params = params_from_numpy(*np_tables(ds.nu, ds.nv, 12, 3, 3.0), "cpu")
    state = with_shadows(params, (0.02,) * 4)
    got = r.pad(state)
    want = tuple(t.clone() for t in got)
    cnt = r.walks[0].counters
    assert r.walks[1].counters is cnt
    cnt.gen = start % MASK32
    cnt.ticket_base = (start + 7) % MASK32
    dev = Device(cnt, cnt.ticket_base)
    # stale counters: every tile holds a value of the generation before
    dev.ready = [stamp((start - 1) % MASK32, w)
                 for w in range(len(dev.ready))]
    rng = np.random.default_rng(start % 97)
    gens = []
    for epoch in range(3):
        idx = epoch % 2
        plan, walk = r._dev[idx], r.walks[idx]
        tap = walk.tap[8].numpy()
        n = r.seg_len(idx)
        for s in range(r._segs[idx]):
            tac.adreg_segment_reference(*want, plan, s * n, (s + 1) * n,
                                        0.05, r.lams, r.gb, 12, 8, 8,
                                        torch.float32)

            def step(i, lo, hi, plan=plan, tap=tap):
                tac.adreg_segment_reference(
                    *got, masked(plan, i, lo, hi, tap), 0, 1, 0.05, r.lams,
                    r.gb, 12, 8, 8, torch.float32)

            gens.append(cnt.gen)
            run_launch(dev, cnt, walk, s, 1 + (epoch + s) % 4, 1, tap, step,
                       rng)
    assert gens == [(start + k) % MASK32 for k in range(len(gens))]
    assert 0 in gens  # the numbering crossed 2^32
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)


def test_counters_start_zeroed_and_advance():
    """TileWalkCounters: n_gv + n_gu ready counters and the ticket word,
    zero, at generation 1; advance moves the generation by one and the
    ticket by the launch's units plus clusters, modulo 2^32."""
    cnt = tw.TileWalkCounters(5, 3, "cpu")
    assert cnt.counters.shape == (9,) and cnt.counters.dtype == torch.int64
    assert not cnt.counters.any() and (cnt.gen, cnt.ticket_base) == (1, 0)
    cnt.advance(4, 2)
    assert (cnt.gen, cnt.ticket_base) == (2, 6)
    cnt.gen, cnt.ticket_base = MASK32 - 1, MASK32 - 2
    cnt.advance(4, 2)
    assert (cnt.gen, cnt.ticket_base) == (0, 4)


def cell_route(w, tile_u, tile_v):
    """The route ``upload_window_walks`` gives a window width's walk."""
    walk = w.walks[0]
    nb, sub = walk.col_tile.size // 8, walk.slots // walk.window
    rows, grid_rows = tw.cell_walk_rows(tile_u, tile_v, sub, walk.window)
    return tw.tile_walk_route(walk, w.cluster, rows=rows,
                              grid_windows=nb * 8 // walk.window,
                              grid_rows=grid_rows)


@pytest.mark.parametrize("family", ["adreg", "slot_adreg", "sgld",
                                    "slot_sgld", "cell", "phi_shard"])
def test_runners_build_walks_and_routes(family):
    """Every runner builds its plans' tile walks at materialize, on one set
    of counters per runner, with a route: "tile" for the AdaptReg runners
    (their kernel's only walk), the route model's for the SGLD runners and
    ``csrc/cell_sgd.cu``'s; a launch range of a plan is found by its
    batches."""
    ds, va = zipf_sets()
    if family == "adreg":
        r = tac.AdRegCellRunner(ds, va, tile_u=32, tile_v=32, batch=64,
                                segments=3, n_plans=2, device="cpu")
        walks = r.materialize().walks
        assert len(walks) == 2 and all(len(w.walks) == 3 for w in walks)
        n = r.seg_len(0)
        assert walks[0].range_of(n, 2 * n) == 1
        with pytest.raises(ValueError):
            walks[0].range_of(0, 1)
    elif family == "slot_adreg":
        r = tas.SlotAdRegRunner(ds, va, sub=8, dim=8, tile=64, segments=3,
                                device="cpu")
        walks = r.materialize().walks
    elif family == "sgld":
        r = tg.SgldCellRunner(ds, tile_u=32, tile_v=32, batch=64,
                              n_plans=2, device="cpu")
        walks = [p.walk for p in r.materialize()._dev]
        assert all(w.nz is not None for w in walks)
    elif family == "slot_sgld":
        r = tss.SlotSgldRunner(ds, sub=16, dim=8, tile=64, device="cpu")
        walks = [p.walk for p in r.materialize()._dev]
        assert set(np.unique(walks[0].tap[1].numpy())) <= {0, 1, 2}
    else:  # csrc/cell_sgd.cu: each plan's walk at every window width
        if family == "cell":
            r = tc.CellEpochRunner(ds, tile_u=32, tile_v=32, batch=64,
                                   n_plans=2, device="cpu")
            inners = [r]
        else:
            r = PhiShardedRunner(ds, dim=8, tile_u=32, tile_v=32, batch=64,
                                 budget=3 * 32 * 128 * 4, n_plans=2,
                                 device="cpu")
            assert r.n_shards == 3
            inners = r.inners
        walks = [dw for i in inners for p in i.materialize()._dev
                 for dw in p.walk.values()]
        assert len(walks) == 8 * len(inners)
        for w in walks:
            assert w.route == cell_route(w, 32, 32)
        for t, p in ((8, 8), (4, 8), (2, 4), (1, 1)):
            window = min(8 // t, 8 // p)
            assert inners[0].route(1, t, p) == \
                inners[0]._dev[1].walk[window].route
        r = inners[0]
    assert len({id(w.counters) for w in walks}) == 1
    for w in walks:
        assert w.route in tw.WALKS
        if family in ("adreg", "slot_adreg"):  # the kernel's only walk
            assert w.route == "tile"
        elif family in ("sgld", "slot_sgld"):
            assert w.route == tw.tile_walk_route(w.walks)
        assert w.unit_off[-1] == w.unit_c0.shape[0]
    assert r.route() == walks[0].route


def test_cell_walk_route_needs_units_sorted_by_user_tile():
    """upload_window_walks keeps a plan whose real columns visit a user
    tile in two units on the grid walk at every width; all-padding batches
    on another user tile (as the mega runner's padding, on user tile 0)
    leave a sorted plan on the tile walk. Each user tile has an item tile
    of its own, so the units are independent."""
    gu = np.repeat(np.arange(8), 2)
    w = np.ones((16, 4, 8))
    cnt = tw.TileWalkCounters(8, 8, "cpu")
    plans = {
        "sorted": plan_of(gu, np.repeat(gu[:, None], 8, 1), w),
        "padded": plan_of(np.r_[gu, [0, 0]],
                          np.repeat(np.r_[gu, [0, 0]][:, None], 8, 1),
                          np.r_[w, np.zeros((2, 4, 8))]),
        "revisit": plan_of(np.tile(np.arange(8), 2),
                           np.repeat(np.tile(np.arange(8), 2)[:, None], 8, 1),
                           w)}
    routes = {name: {k: d.route for k, d in tw.upload_window_walks(
        p, cnt).items()} for name, p in plans.items()}
    assert set(routes["sorted"].values()) == {"tile"}
    assert set(routes["padded"].values()) == {"tile"}
    assert set(routes["revisit"].values()) == {"grid"}
