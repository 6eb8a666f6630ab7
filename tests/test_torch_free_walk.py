"""The tile walk of the free-column kernel ``csrc/free_cells.cu`` on the
CPU: the planner on free plans (units, waits, releases, both sides' apply
flags, the critical path against a brute-force DAG depth), the planner on
window plans against the same brute force, the cluster size model's
throughput term, the runner's one walk, and a replay of the walk's
protocol in random interleavings of units
(``tests/test_torch_tile_walk.py``'s ``run_launch``) against the plan-order
plain version and against tpu_mf's interpret-mode ``_free_kernel``."""

import numpy as np
import pytest
import torch

from tests.test_torch_tile_walk import Device, random_plan, run_launch
from tpu_mf.data.coo import synthetic_ratings as jax_synthetic_ratings
from tpu_mf.ops import pallas_sgd_free as jf
from tpu_mf_torch.data.coo import synthetic_ratings
from tpu_mf_torch.models.mf import params_from_numpy
from tpu_mf_torch.ops import adreg_cells as tac
from tpu_mf_torch.ops import sgd_free as tf
from tpu_mf_torch.ops import tile_walk as tw
from tpu_mf_torch.ops.sgd_cells import pad_plan_nb, prepare_cells

torch.set_num_threads(1)
ETA, LAM = 2e-2, 5e-3


def np_tables(nu, nv, dim, seed, gb=2.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1e-1, (nu, dim)).astype(np.float32),
            rng.normal(0, 1e-1, (nv, dim)).astype(np.float32),
            rng.normal(0, 1e-1, nu).astype(np.float32),
            rng.normal(0, 1e-1, nv).astype(np.float32), np.float32(gb))


def zipf_data():
    """10 x 7 tiles of 32: user tiles of a few columns each, so windows of
    2-8 columns often span two units."""
    return synthetic_ratings(300, 200, 3100, rank=3, noise=0.3, seed=5,
                             zipf=1.0)


def sentinel_data():
    """tests/test_torch_free.py's sentinel case at tiles 128: one item
    tile, and the last batch's sentinel columns share it with its real
    columns."""
    return synthetic_ratings(300, 100, 3100, seed=5)


def free_runner(data, tile=32, batch=64, **kw):
    return tf.FreeEpochRunner(data, tile_u=tile, tile_v=tile, batch=batch,
                              mxu="float32", device="cpu", **kw)


# ---- the planner, by brute force -------------------------------------------

def brute_walk(plan, b0, b1):
    """Units, waits and releases from their definitions, column by column:
    a unit is a maximal run of consecutive real columns on one user tile;
    at a unit's first touch of an item tile its wait value counts the
    earlier units that touched the tile, at its last touch the release is
    that value + 1."""
    gu = tw.column_user_tiles(plan.gu)
    gv = plan.gv.reshape(-1)
    real = tw.real_columns(plan.w)
    cols = [c for c in range(b0 * 8, b1 * 8) if real[c]]
    units = []
    for c in cols:
        if units and gu[units[-1][-1]] == gu[c]:
            units[-1].append(c)
        else:
            units.append([c])
    n = gu.shape[0]
    col_tile = np.where(real, gv, -1)
    col_wait, col_rel = np.full(n, -1), np.zeros(n)
    unit_wait, touched_u, touched_v = [], {}, {}
    for u in units:
        g = int(gu[u[0]])
        unit_wait.append(touched_u.get(g, 0))
        touched_u[g] = unit_wait[-1] + 1
        for v in sorted({int(gv[c]) for c in u}):
            on = [c for c in u if gv[c] == v]
            col_wait[on[0]] = touched_v.get(v, 0)
            col_rel[on[-1]] = col_wait[on[0]] + 1
            touched_v[v] = col_wait[on[0]] + 1
    return dict(unit_c0=[u[0] for u in units],
                unit_c1=[u[-1] + 1 for u in units],
                unit_gu=[int(gu[u[0]]) for u in units], unit_wait=unit_wait,
                col_tile=col_tile, col_wait=col_wait, col_rel=col_rel)


def brute_depth(plan, b0, b1, window):
    """The longest chain of the walk's windows (the columns of one unit in
    one aligned window of ``window`` columns), each after the unit's
    previous window, the last earlier window on its user tile and the last
    earlier window on each of its item tiles; and the number of windows."""
    gu = tw.column_user_tiles(plan.gu)
    gv = plan.gv.reshape(-1)
    real = tw.real_columns(plan.w)
    wins = []  # (unit id, user tile, item tiles)
    unit = -1
    prev = None
    for c in range(b0 * 8, b1 * 8):
        if not real[c]:
            continue
        if prev is None or gu[c] != gu[prev]:
            unit += 1
        if (wins and wins[-1][0] == unit and prev // window == c // window):
            wins[-1][2].add(int(gv[c]))
        else:
            wins.append((unit, int(gu[c]), {int(gv[c])}))
        prev = c
    depth = []
    for n, (k, g, vs) in enumerate(wins):
        preds = [m for m in range(n) if wins[m][0] == k or wins[m][1] == g
                 or vs & wins[m][2]]
        depth.append(1 + max((depth[m] for m in preds), default=0))
    return max(depth, default=0), len(wins)


def assert_walk_is(walk, want):
    for name, value in want.items():
        np.testing.assert_array_equal(getattr(walk, name), value,
                                      err_msg=name)
        assert getattr(walk, name).dtype == np.int32, name


@pytest.mark.parametrize("window", [1, 2, 8])
@pytest.mark.parametrize("data", ["zipf", "sentinel", "balanced"])
def test_free_plan_walk_by_brute_force(data, window):
    """On free plans (per-column user tiles): every user tile is one unit,
    no unit waits on its user tile, and the units, waits, releases,
    critical path and window count are the brute force's; the critical
    path is far shorter than the windows."""
    ds = zipf_data() if data != "sentinel" else sentinel_data()
    r = free_runner(ds, **({"tile": 128, "batch": 256}
                           if data == "sentinel" else {}),
                    balance=data == "balanced")
    plan = r.plan
    nb = plan.u.shape[0]
    walk = tw.plan_tile_walk(plan, 0, nb, window)
    assert_walk_is(walk, brute_walk(plan, 0, nb))
    assert (walk.crit, walk.n_windows) == brute_depth(plan, 0, nb, window)
    assert len(set(walk.unit_gu.tolist())) == walk.n_units
    assert not walk.unit_wait.any()
    if data != "sentinel":
        assert walk.n_units == plan.n_gu and walk.crit < walk.n_windows / 2


@pytest.mark.parametrize("seed", range(3))
def test_window_plan_walk_unchanged(seed):
    """On window plans (one user tile per batch, gu of (nb,)) the planner
    gives the brute force's units, waits and releases, for whole plans,
    ranges and padded plans, and the same walk as the plan with its gu
    spelled out per column, array for array."""
    rng = np.random.default_rng(seed)
    ds = synthetic_ratings(200, 150, 3000, rank=3, seed=4 + seed, zipf=1.1)
    cells = prepare_cells(ds, 32, 32, 64, seed)
    nb = cells.u.shape[0]
    for plan, b0, b1 in ((cells, 0, nb), (cells, 3, nb - 2),
                         (pad_plan_nb(cells, nb + 5), 0, nb + 5),
                         (random_plan(rng, 24, 5, 6), 0, 24)):
        for window in (1, 4):
            walk = tw.plan_tile_walk(plan, b0, b1, window)
            assert_walk_is(walk, brute_walk(plan, b0, b1))
            per_col = tw.plan_tile_walk(plan._replace(
                gu=np.repeat(plan.gu[:, None], 8, 1)), b0, b1, window)
            for a, b in zip(walk, per_col):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("groups", [1, 2, 4, 8])
def test_free_walk_apply_flags_both_sides(groups):
    """The walk's flags on both sides of a free plan: where the plan has no
    sentinel column they are free_flags' (the plain version's); on the
    sentinel plan they agree with free_flags on the real columns where that
    flag lies on a real column, the sentinel columns take none, and in
    every window each tile that a real column touches is flagged once, on
    the last real column that touches it."""
    for data, tile, batch in ((zipf_data(), 32, 64),
                              (sentinel_data(), 128, 256)):
        r = free_runner(data, tile=tile, batch=batch).materialize()
        plan, dw = r.plan, r._dev[0].walk
        real = (plan.w > 0).any(axis=1)
        width = 8 // groups
        for side, g, flags in (("u", plan.gu, dw.tap_u),
                               ("v", plan.gv, dw.tap)):
            got = flags[groups].numpy()
            want = tf.free_flags(g)[groups]
            if real.all():
                np.testing.assert_array_equal(got, want, err_msg=side)
                continue
            assert not got[~real].any()
            for i in range(g.shape[0]):
                for g0 in range(0, 8, width):
                    cols = [k for k in range(g0, g0 + width) if real[i, k]]
                    for t in {int(g[i, k]) for k in cols}:
                        on = [k for k in cols if g[i, k] == t]
                        assert [k for k in on if got[i, k]] == [on[-1]], side
                        if want[i, on[-1]] and not any(
                                g[i, k] == t and not real[i, k]
                                for k in range(on[-1] + 1, g0 + width)):
                            assert got[i, on[-1]] == 1


def test_free_route_throughput_term():
    """walk_steps is the larger of the critical path and the windows over
    the clusters that fit (one block an SM); free_cluster_size is the size
    of least modelled time. A plan of independent units (each its own item
    tiles) is throughput-bound: larger clusters fit fewer at once, so a
    small one wins and the walk runs ~n_windows / resident steps. A plan
    whose units all share one item tile is chain-bound at every size: the
    cluster of the cheapest step wins."""
    n_gu = 400
    gu = np.repeat(np.arange(n_gu), 2)
    w = np.ones((2 * n_gu, 256, 8), np.float32)
    z = np.zeros(w.shape, np.int32)

    def walk_of(gv):
        plan = tf.FreePlan(u=z, v=z, r=w, w=w,
                           gu=np.repeat(gu[:, None], 8, 1).astype(np.int32),
                           gv=gv.astype(np.int32), tile_u=128, tile_v=128,
                           n_gu=n_gu, n_gv=int(gv.max()) + 1,
                           n_real=int(w.size))
        return tw.plan_tile_walk(plan, 0, 2 * n_gu)

    wide = walk_of(np.arange(2 * n_gu * 8).reshape(-1, 8))
    assert (wide.n_units, wide.crit, wide.n_windows) == (n_gu, 16, 6400)
    for c in tw.FREE_CLUSTERS:
        assert tw.walk_steps(wide, c) == -(-6400 // (132 // c))
        assert tw.walk_steps(wide, c, sms=100_000) == 16
    rounds = {c: tw.tile_rounds(wide, c, fixed=tw.FREE_STEP_ROUNDS[c],
                                rows=256) for c in tw.FREE_CLUSTERS}
    assert tw.free_cluster_size(wide, 256) == min(rounds, key=rounds.get)
    assert tw.free_cluster_size(wide, 256) <= 2
    chain = walk_of(np.zeros((2 * n_gu, 8)))
    assert chain.crit == chain.n_windows == 6400
    step = {c: tw.FREE_STEP_ROUNDS[c] + -(-256 // (32 * c)) * 2
            for c in tw.FREE_CLUSTERS}
    assert all(tw.walk_steps(chain, c) == 6400 for c in tw.FREE_CLUSTERS)
    assert tw.free_cluster_size(chain, 256) == min(step, key=step.get)


def test_free_runner_builds_walks_on_shared_counters():
    """materialize builds each rotated plan's walk on the runner's one
    TileWalkCounters, with both sides' flags at every grouping, a cluster
    size of FREE_CLUSTERS (free_cluster_size's) and route "tile", the
    kernel's only walk; CPU epochs run the plain version, the same on
    either plan's tables."""
    ds = zipf_data()
    r = free_runner(ds, n_plans=2).materialize()
    walks = [p.walk for p in r._dev]
    assert all(w.counters is r._counters for w in walks)
    for dw in walks:
        assert set(dw.tap_u) == set(dw.tap) == {1, 2, 4, 8}
        assert dw.cluster in tw.FREE_CLUSTERS
        assert dw.cluster == tw.free_cluster_size(dw.walks[0], 64)
        assert dw.route == "tile"
    assert r.route(1) == walks[1].route == "tile"
    tabs = np_tables(ds.nu, ds.nv, 8, seed=3)
    a = r.pad(params_from_numpy(*tabs, device="cpu"))
    b = tuple(t.clone() for t in a)
    r.epoch(a, ETA, LAM, 2.0)
    tf.free_epoch_reference(*b, r._dev[0], ETA, LAM, 2.0,
                            max(1.0, 0.2 / ETA), r.dim,
                            r.pick_theta_groups(ETA), r.pick_phi_groups(ETA),
                            r.work_dtype, r.saturate, r.mxu_pred)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_free_runner_takes_the_tile_walk_on_a_chain_bound_plan():
    """A free plan whose units all share one item tile is chain-bound: the
    route model of the two walks sends it to a grid walk (its steps are
    the cheaper), but the free-column kernel has the tile walk only, so the
    runner and its plan's walk say "tile". The AdaptReg wrapper keeps its
    launch counts under every walk name (WALKS), which the benchmark
    reads."""
    r = free_runner(sentinel_data(), tile=128, batch=256).materialize()
    dw = r._dev[0].walk
    assert dw.walks[0].crit == dw.walks[0].n_windows  # one chain
    assert tw.tile_walk_route(dw.walks, dw.cluster,
                              rows=r.plan.tile_u + r.plan.tile_v) == "grid"
    assert r.route() == dw.route == "tile"
    assert set(tac.adreg_segment.walks) == set(tw.WALKS)


# ---- the replay -------------------------------------------------------------

def free_replay(r, tables, eta, groups, n_clusters, rng, dev, idx=0,
                saturate=True, gb=2.0):
    """One epoch of plan ``idx`` on the walk's protocol: simulated clusters
    take units by ticket and run each window step of their unit (the
    plain version's scatter of the step's columns, then the applies the
    walk's flags hold in them, on either side) in a random interleaving the
    counters allow. Returns the most units that held tiles at once."""
    plan = r.materialize()._dev[idx]
    dw = plan.walk
    gu, gv = plan.gu_host.reshape(-1), plan.gv_host.reshape(-1)
    tap_u = dw.tap_u[groups[0]].numpy().reshape(-1)
    tap_v = dw.tap[groups[1]].numpy().reshape(-1)
    fs = tf.FreeStep.of(tables[0], eta, LAM, gb, max(1.0, 0.2 / eta), r.dim,
                        torch.float32, saturate, r.mxu_pred)
    acc_u, acc_v = torch.zeros_like(tables[0]), torch.zeros_like(tables[1])

    def step(i, lo, hi):
        fs.scatter(*tables, acc_u, acc_v, plan, i, lo - 8 * i, hi - 8 * i)
        for c in range(lo, hi):
            if tap_u[c]:
                fs.apply_tile(tables[0], acc_u, int(gu[c]), plan.tile_u, 0)
            if tap_v[c]:
                fs.apply_tile(tables[1], acc_v, int(gv[c]), plan.tile_v, 1)

    window = min(8 // groups[0], 8 // groups[1])
    overlap = run_launch(dev, dw.counters, dw, 0, n_clusters, window,
                         dw.tap[groups[1]].numpy(), step, rng)
    assert not acc_u.any() and not acc_v.any()  # every delta was applied
    return overlap


# (groups_u, groups_v) on the zipf plan (windows spanning units) and on the
# sentinel plan, saturation on and off
REPLAY = [(g, data, sat) for g in ((8, 8), (1, 1), (8, 1), (4, 2))
          for data in ("zipf", "sentinel") for sat in (True, False)]


@pytest.mark.parametrize("groups,data,saturate", REPLAY)
def test_free_replay_matches_plan_order(groups, data, saturate):
    """An epoch replayed on the walk (two random interleavings on 3 and 5
    clusters) equals the plain version's epoch in plan order, f32, within
    1e-6 (the same f32 terms; a window step split between two units sums
    its scatter in two parts). On the zipf plan units ran side by side and
    windows of 2+ columns span units; the sentinel plan's trailing columns
    flush like the plain version's."""
    ds = zipf_data() if data == "zipf" else sentinel_data()
    r = free_runner(ds, **({"tile": 128, "batch": 256}
                           if data == "sentinel" else {}),
                    groups_u=groups[0], groups_v=groups[1],
                    saturate=saturate)
    tabs = np_tables(ds.nu, ds.nv, 8, seed=2)
    start = r.pad(params_from_numpy(*tabs, device="cpu"))
    want = tuple(t.clone() for t in start)
    tf.free_epoch_reference(*want, r._dev[0], ETA, LAM, 2.0,
                            max(1.0, 0.2 / ETA), 8, *groups,
                            saturate=saturate)
    assert float((want[1] - start[1]).abs().max()) > 1e-3
    plan = r.plan
    if data == "sentinel":
        assert (plan.w.sum(axis=1) == 0).any()
    else:
        walk = r._dev[0].walk.walks[0]
        width = max(8 // g for g in groups)
        ends = walk.unit_c1[:-1]
        assert width == 1 or (ends % width != 0).any()  # windows span units
    dev = Device(r._counters)
    for seed, n_clusters in ((0, 3), (1, 5)):
        got = tuple(t.clone() for t in start)
        overlap = free_replay(r, got, ETA, groups, n_clusters,
                              np.random.default_rng(seed), dev,
                              saturate=saturate)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-6)
        if data == "zipf":
            assert overlap >= 2


def test_free_replay_matches_interpret_kernel():
    """The replay at 8/8 groups against tpu_mf's FreeEpochRunner, whose
    _free_kernel runs in interpret mode, on the same numpy tables and data
    (no sentinel column shares a tile with a real one, so tpu_mf's masked
    flags flush everything): tables within 2e-5, tests/test_torch_free.py's
    f32 tolerance (the interpret kernel's one-hot products sum in another
    order)."""
    import jax.numpy as jnp
    from tpu_mf.models.mf import MFParams as JaxParams

    kw = dict(tile_u=128, tile_v=128, batch=256, seed=0, mxu="float32",
              groups_u=8, groups_v=8, saturate=True)
    ds = jax_synthetic_ratings(300, 200, 4000, seed=5)
    jr = jf.FreeEpochRunner(ds, interpret=True, **kw)
    r = tf.FreeEpochRunner(ds, device="cpu", **kw)
    tabs = np_tables(300, 200, 8, seed=1)
    gb = float(tabs[4])
    jt = jr.pad(JaxParams(*(jnp.asarray(t) for t in tabs)))
    want = jr.trim(jr.epoch(jt, ETA, LAM, gb))
    got = r.pad(params_from_numpy(*tabs, device="cpu"))
    assert r.materialize()._dev[0].walk.walks[0].n_units == 3
    free_replay(r, got, ETA, (8, 8), 2, np.random.default_rng(3),
                Device(r._counters), gb=gb)
    got = r.trim(got)
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=2e-5)
    assert float(np.abs(got[1].numpy() - tabs[1]).max()) > 1e-3
