"""The DP-SGLD ops of the PyTorch port against tpu_mf on the CPU: the
batched path, the Gibbs draws, and the plain versions of the two SGLD
kernels against tpu_mf's Pallas kernels in interpret mode, on the same
numpy-made states."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_mf.data.coo import synthetic_ratings
from tpu_mf.models.dpmf import DPMFState as JaxState
from tpu_mf.models.dpmf import dp_bound as jax_dp_bound
from tpu_mf.models.dpmf import init_dpmf as jax_init_dpmf
from tpu_mf.models.mf import MFParams as JaxParams
from tpu_mf_torch.data.coo import RatingsCOO
from tpu_mf_torch.models.dpmf import (
    dp_bound,
    dpmf_state_from_numpy,
    dpmf_state_to_numpy,
    init_dpmf,
)
from tpu_mf_torch.ops import sgld_cells as tg
from tpu_mf_torch.ops import sgld_slot as tss
from tpu_mf_torch.ops.sgld import SgldHyper, finish_noise, sgld_batch_update

torch.set_num_threads(1)
TABLES = ("theta", "phi", "bu", "bv")
# what tpu_mf's interpret-mode PRNG gives every normal of a tile: zero bits,
# so u1 = 2^-25 and u2 = 0; the cos half (first rows) sqrt(-2 ln u1), the
# sin half 0
R_INTERPRET = float(np.sqrt(np.float32(-2.0) * np.log(np.float32(2.0 ** -25))))


def ds_pair(*args, **kw):
    """The same synthetic ratings as a tpu_mf and a port dataset."""
    j = synthetic_ratings(*args, **kw)
    return j, RatingsCOO(j.u, j.v, j.r, j.nu, j.nv)


def arrays_of(js: JaxState) -> dict:
    """A tpu_mf state as the host arrays the port's carry-over takes."""
    p = js.params
    return {k: np.asarray(v) for k, v in dict(
        theta=p.theta, phi=p.phi, bu=p.bu, bv=p.bv, gb=p.gb,
        lambda_r=js.lambda_r, lambda_ub=js.lambda_ub, lambda_vb=js.lambda_vb,
        lambda_u=js.lambda_u, lambda_v=js.lambda_v, ur=js.ur, vr=js.vr,
        gcountu=js.gcountu, gcountv=js.gcountv, gcount=js.gcount).items()}


def assert_states(got: dict, want: dict, atol: float) -> None:
    """Tables within atol, counters equal as integers."""
    for k in TABLES:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=k)
    for k in ("gcountu", "gcountv", "gcount"):
        np.testing.assert_array_equal(got[k].astype(np.int64),
                                      want[k].astype(np.int64), err_msg=k)


def test_decay_factors_match_tpu_mf():
    """decay_factors broadcasts a (B, D) base against (B,) masks, as
    tpu_mf's does; (B,) bases keep working. Exact."""
    from tpu_mf.ops.common import decay_factors as jax_decay
    from tpu_mf_torch.ops.common import decay_factors

    rng = np.random.default_rng(0)
    first = rng.random(16) < 0.5
    counts = rng.integers(1, 5, 16).astype(np.float32)
    for shape in ((16,), (16, 6)):
        base = rng.uniform(-0.5, 1.0, shape).astype(np.float32)
        want = np.asarray(jax_decay(jnp.asarray(base), jnp.asarray(first),
                                    jnp.asarray(counts)))
        got = decay_factors(torch.as_tensor(base), torch.as_tensor(first),
                            torch.as_tensor(counts)).numpy()
        assert got.shape == shape
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_dp_bound_and_init_weights_match_tpu_mf():
    """dp_bound, and init_dpmf's precisions, inverse-frequency weights and
    counters (int64, one pad slot), exactly as tpu_mf's."""
    for args in ((0.0, 10, 100), (1.0, 10, 100), (1.0, 0, 50), (2.5, 7, 3)):
        assert dp_bound(*args) == jax_dp_bound(*args)
    jds, ds = ds_pair(40, 30, 500, seed=0)
    js = jax_init_dpmf(jax.random.PRNGKey(0), jds, 6)
    st = init_dpmf(ds, 6, 2.76, torch.Generator().manual_seed(0), "cpu")
    want, got = arrays_of(js), dpmf_state_to_numpy(st)
    for k in ("lambda_r", "lambda_ub", "lambda_vb", "lambda_u", "lambda_v",
              "ur", "vr", "gcountu", "gcountv", "gcount"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert st.gcountu.dtype == torch.int64 and st.params.theta.shape == (40, 6)


def batches(ds, b, n, seed):
    """n numpy batches of b ratings with duplicate rows and padded tails."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        idx = rng.integers(0, len(ds), b)
        w = (rng.random(b) < 0.85).astype(np.float32)
        out.append((np.where(w > 0, ds.u[idx], 0).astype(np.int32),
                    np.where(w > 0, ds.v[idx], 0).astype(np.int32),
                    np.where(w > 0, ds.r[idx], 0).astype(np.float32), w))
    return out


def test_sgld_batch_update_temp0_matches_tpu_mf():
    """The batched update at temp 0 over the same numpy batches: tables
    within 1e-6 (f32; duplicate-row scatter sums in another order),
    stamps and the global counter exact."""
    from tpu_mf.ops.sgld import SgldHyper as JaxHyper
    from tpu_mf.ops.sgld import sgld_batch_update as jax_update

    jds, ds = ds_pair(30, 20, 600, rank=3, seed=1)
    js = jax_init_dpmf(jax.random.PRNGKey(0), jds, 8)
    st = dpmf_state_from_numpy(arrays_of(js), "cpu")
    eta, bound, n = 3e-5, 1.0, float(len(ds))
    jh = JaxHyper(*(jnp.float32(x) for x in (eta, 0.0, bound, n)))
    gen = torch.Generator().manual_seed(0)
    for i, b in enumerate(batches(ds, 64, 4, seed=2)):
        js = jax_update(js, tuple(jnp.asarray(x) for x in b), jh,
                        jax.random.PRNGKey(i))
        st = sgld_batch_update(
            st, (torch.as_tensor(b[0]).long(), torch.as_tensor(b[1]).long(),
                 torch.as_tensor(b[2]), torch.as_tensor(b[3])),
            SgldHyper(eta, 0.0, bound, n), gen)
    assert_states(dpmf_state_to_numpy(st), arrays_of(js), 1e-6)


def test_sgld_noise_telescopes():
    """Counters advance by the real ratings of a batch and touched rows are
    stamped with the batch-end clock; with the gradient and the decay off,
    a row first touched after c updates moves by one draw of variance
    temp * eta * c (tpu_mf's tests/test_sgld.py, statistically: within 35%
    over 256 lanes)."""
    _, ds = ds_pair(4, 3, 10, seed=3)
    dim, temp, eta, b = 256, 2.0, 1e-3, 64
    st = init_dpmf(ds, dim, 3.0, torch.Generator().manual_seed(0), "cpu")
    st = st._replace(lambda_r=torch.tensor(0.0),
                     lambda_u=torch.zeros(dim), lambda_v=torch.zeros(dim),
                     lambda_ub=torch.tensor(0.0), lambda_vb=torch.tensor(0.0))
    before = st.params.theta[0].clone()
    batch = (torch.zeros(b, dtype=torch.int64), torch.arange(b) % 3,
             torch.full((b,), 3.0), torch.ones(b))
    gen = torch.Generator().manual_seed(42)
    st = sgld_batch_update(st, batch, SgldHyper(eta, temp, 1.0, 10.0), gen)
    assert int(st.gcount) == b
    assert st.gcountu.tolist() == [b, 0, 0, 0, 0]
    diff = (st.params.theta[0] - before).numpy()
    assert np.var(diff) == pytest.approx(temp * eta * b, rel=0.35)
    # a second batch one slot short: the clock advances by its real ratings
    w = torch.ones(b)
    w[-1] = 0.0
    st = sgld_batch_update(st, (batch[0], batch[1], batch[2], w),
                           SgldHyper(eta, 0.0, 1.0, 10.0), gen)
    assert int(st.gcount) == 2 * b - 1 and int(st.gcountu[0]) == 2 * b - 1


def test_finish_noise_matches_tpu_mf():
    """At temp 0 the flush leaves the tables as they are and resets every
    counter, as tpu_mf's (exact); at temp > 0 a row c updates behind takes
    variance temp * eta * max(c, 0) (within 35% over 256 lanes)."""
    from tpu_mf.ops.sgld import finish_noise as jax_finish

    jds, ds = ds_pair(20, 10, 100, seed=4)
    js = jax_init_dpmf(jax.random.PRNGKey(0), jds, 4)
    js = js._replace(gcount=jnp.int32(50),
                     gcountu=js.gcountu.at[3].set(20))
    st = dpmf_state_from_numpy(arrays_of(js), "cpu")
    want = arrays_of(jax_finish(js, jnp.float32(1e-3), jnp.float32(0.0),
                                jax.random.PRNGKey(0)))
    got = dpmf_state_to_numpy(finish_noise(st, 1e-3, 0.0,
                                           torch.Generator().manual_seed(0)))
    assert_states(got, want, 0.0)
    dim = 256
    st = init_dpmf(ds, dim, 3.0, torch.Generator().manual_seed(1), "cpu")
    st.gcount.fill_(400)
    st.gcountu[1] = 480  # stamped past the clock: no noise (max(c, 0))
    before = st.params.theta.clone()
    st = finish_noise(st, 1e-3, 2.0, torch.Generator().manual_seed(1))
    moved = (st.params.theta - before).numpy()
    assert np.var(moved[0]) == pytest.approx(2.0 * 1e-3 * 400, rel=0.35)
    assert not moved[1].any() and int(st.gcount) == 0


def test_gamma_posterior_params_and_moments_match_tpu_mf():
    """alpha and beta of every posterior are tpu_mf's (exact f32); the
    draws have the posterior mean (tests/test_sgld.py:150-158, within 5%);
    sample_hyper gives positive precisions of the right shapes, one
    variate per dimension."""
    from tpu_mf_torch.ops.gibbs import (
        gamma_posterior,
        gamma_posterior_params,
        sample_hyper,
    )

    f32 = jnp.float32
    for a, b, s, n in ((1.0, 100.0, 500.0, 1000.0), (1.0, 1000.0, 3.5e6, 9e6),
                       (2.0, 10.0, np.arange(1, 7, dtype=np.float32), 321)):
        ja = f32(a) + 0.5 * (f32(n) if isinstance(n, float) else n)
        jb = f32(b) + 0.5 * jnp.asarray(s, f32)
        alpha, beta = gamma_posterior_params(a, b, s, n)
        np.testing.assert_array_equal(alpha, np.asarray(ja))
        np.testing.assert_array_equal(beta, np.asarray(jb))
    rng = np.random.default_rng(0)
    draws = np.array([gamma_posterior(rng, 1.0, 100.0, 500.0, 1000.0)
                      for _ in range(4000)])
    assert draws.mean() == pytest.approx(501.0 / 350.0, rel=0.05)
    _, ds = ds_pair(20, 10, 100, seed=5)
    st = init_dpmf(ds, 6, 3.0, torch.Generator().manual_seed(0), "cpu")
    out = sample_hyper(st, 50.0, 100.0, 1.0, 100.0, np.random.default_rng(1))
    assert out.lambda_u.shape == (6,) and out.lambda_u.dtype == torch.float32
    assert float(out.lambda_r) > 0 and bool((out.lambda_u > 0).all())
    assert len(set(out.lambda_u.tolist())) == 6  # independent per dimension


def interpret_normals(dim):
    """The normals tpu_mf's interpret-mode kernel draws for a tile."""
    def normals(i, side, col, row0, n):
        out = torch.zeros(n, dim + 1)
        out[:n // 2] = R_INTERPRET
        return out
    return normals


def run_gen1(jds, ds, dim, hyper, js, state_gcount=0, temp_normals=False,
             n_plans=1, seeds=(7,)):
    """tpu_mf's interpret-mode PallasSgldRunner and the port's plain
    version, one round per noise seed (rotating plans), from js."""
    from tpu_mf.ops.pallas_sgld import PallasSgldRunner

    kw = dict(tile_u=64, tile_v=64, batch=128, seed=1, n_plans=n_plans)
    jr = PallasSgldRunner(jds, mxu="float32", interpret=True, **kw)
    r = tg.SgldCellRunner(ds, mxu="float32", device="cpu", **kw)
    st = dpmf_state_from_numpy(arrays_of(js), "cpu")
    for e, seed in enumerate(seeds):
        gc = state_gcount + e * len(ds)
        js = jr.unpack(js, jr.epoch(jr.pad(js), gc, hyper, noise_seed=seed,
                                    epoch_idx=e))
        tabs = r.pad(st)
        tg.sgld_cell_epoch_reference(
            *tabs, *r.invf, r.lam, r._dev[e % n_plans], gc, hyper, dim, seed,
            normals=interpret_normals(dim) if temp_normals else None)
        st = r.unpack(st, tabs)
    return dpmf_state_to_numpy(st), arrays_of(js), r, jr


@pytest.mark.parametrize("dim,temp", [(8, 0.0), (128, 0.0), (8, 2.0)])
def test_sgld_cell_plain_matches_interpret_kernel(dim, temp):
    """sgld_cell_epoch_reference against tpu_mf's interpret-mode
    _sgld_kernel (f32), one round: at temp 0 (dim 8, and dim 128 on two
    lane groups), and at temp 2 fed the interpret-mode normals; tables
    within 3e-5 (tests/test_pallas_sgld.py's tolerance), stamps exact."""
    jds, ds = ds_pair(300, 200, 4000, rank=3, seed=0)
    js = jax_init_dpmf(jax.random.PRNGKey(0), jds, dim)
    eta = 1e-5
    hyper = (eta, temp, 1.0, eta * len(ds) * float(js.lambda_r),
             float(js.params.gb))
    got, want, _, _ = run_gen1(jds, ds, dim, hyper, js,
                               temp_normals=temp > 0)
    assert_states(got, want, 3e-5)
    assert int(got["gcount"]) == len(ds)
    moved = np.abs(want["theta"] - arrays_of(js)["theta"]).max()
    assert moved > (0.3 if temp else 0.01)  # the round did something


def test_sgld_cell_stamps_exact_past_2_24():
    """Stamps offset by 2^26 + 3 (a huge round's clock) come back exact
    and equal to tpu_mf's split-lane stamps, over two rotated plans."""
    jds, ds = ds_pair(80, 50, 600, rank=2, seed=5)
    base = (1 << 26) + 3
    js = jax_init_dpmf(jax.random.PRNGKey(0), jds, 8)
    js = js._replace(gcountu=jnp.full_like(js.gcountu, base),
                     gcountv=jnp.full_like(js.gcountv, base),
                     gcount=jnp.int32(base))
    hyper = (1e-6, 0.0, 1.0, 1e-6 * len(ds), 3.0)
    got, want, r, jr = run_gen1(jds, ds, 8, hyper, js, state_gcount=base,
                                n_plans=2, seeds=(11, 900))
    assert_states(got, want, 3e-5)
    assert int(got["gcount"]) == base + 2 * len(ds)
    assert got["gcountu"][:-1].min() > base + len(ds)
    assert not np.array_equal(r.plans[0].u, r.plans[1].u)
    np.testing.assert_array_equal(r.plans[1].u, jr.plans[1].u)


def test_hash_normals_bits_and_moments():
    """The int64 torch hash equals a plain-integer murmur3 finalizer, and
    its normals are standard (mean within 0.02, variance within 3%,
    finite) and depend on the seed."""
    def fmix(x):
        x ^= x >> 16
        x = (x * 0x85EBCA6B) & 0xFFFFFFFF
        x ^= x >> 13
        x = (x * 0xC2B2AE35) & 0xFFFFFFFF
        return x ^ (x >> 16)

    xs = [0, 1, 0x7FFFFFFF, 0xFFFFFFFF, 123456789, 0x9E3779B9]
    got = tg._fmix32(torch.tensor(xs, dtype=torch.int64)).tolist()
    assert got == [fmix(x) for x in xs]
    rows = torch.arange(5000, 5000 + 512)
    n = tg.hash_normals(77, 3, 1, rows, 129)
    assert n.shape == (512, 129) and bool(torch.isfinite(n).all())
    assert float(n.mean()) == pytest.approx(0.0, abs=0.02)
    assert float(n.var()) == pytest.approx(1.0, rel=0.03)
    assert torch.equal(n, tg.hash_normals(77, 3, 1, rows, 129))
    assert not torch.equal(n, tg.hash_normals(78, 3, 1, rows, 129))
    assert not torch.equal(n, tg.hash_normals(77, 3, 0, rows, 129))


SLOT_CASES = {
    # name: (dim, striped, noise_every, temp)
    "plain_ne8_temp0": (8, False, 8, 0.0),
    "plain_ne1_ring": (8, False, 1, 0.5),
    "striped_ne8_ring": (8, True, 8, 0.5),
    "striped_ne1_temp0": (8, True, 1, 0.0),
    # dim 11: the SGLD pack is 4 where the SGD pack would be 8
    "dim11_striped_ne8_ring": (11, True, 8, 0.5),
}


@pytest.mark.parametrize("case", sorted(SLOT_CASES))
def test_slot_sgld_plain_matches_interpret_kernel(case):
    """The slot runner's plain version against tpu_mf's interpret-mode
    _slot_sgld_kernel (f32), one round on zipfy data, balance and
    saturation on, plain and striped plans, noise_every 8 and 1; at temp >
    0 both read tpu_mf's own ring. Tables within 3e-5, stamps exact."""
    from tpu_mf.ops.pallas_sgld_slot import SlotSgldRunner as JaxSlot

    dim, striped, ne, temp = SLOT_CASES[case]
    jds, ds = ds_pair(300, 200, 4000, rank=3, seed=0, zipf=1.1)
    js = jax_init_dpmf(jax.random.PRNGKey(0), jds, dim)
    eta = 2e-5  # scal 0.08: cap 2.5, so head rows saturate
    hyper = (eta, temp, 1.0, eta * len(ds) * float(js.lambda_r),
             float(js.params.gb))
    kw = dict(sub=16, seed=1, dim=dim, tile=64, noise_every=ne,
              striped=striped)
    jr = JaxSlot(jds, mxu="float32", interpret=True, balance=True,
                 saturate=True, **kw)
    want = arrays_of(jr.unpack(js, jr.epoch(jr.pad(js), 0, hyper,
                                            noise_seed=7)))
    r = tss.SlotSgldRunner(ds, mxu="float32", device="cpu", **kw)
    assert r.pack == jr.pack
    ring = np.asarray(jax.random.normal(jax.random.PRNGKey(7),
                                        (4 * 64, 128), jnp.float32))
    st = dpmf_state_from_numpy(arrays_of(js), "cpu")
    tabs = r.pad(st)
    r.epoch(tabs, 0, hyper, 7, ring=torch.as_tensor(ring))
    got = dpmf_state_to_numpy(r.unpack(st, tabs))
    assert_states(got, want, 3e-5)
    moved = np.abs(want["theta"] - arrays_of(js)["theta"]).max()
    assert moved > (0.1 if temp else 0.01)


def test_sgld_routing_and_pickers_match_tpu_mf():
    """sgld_slot_pack and the slot runners' sub picks (plain: 1.25 x
    pick_sub; striped: pick_sub_stripe) are tpu_mf's, bit for bit. Both
    eligibility rules take every shape tpu_mf's take, and more: the
    kernels hold their tables in HBM, so tpu_mf's VMEM limits (gen-1: dim
    <= 251 and the item table within 64 MiB; slot: its item table within
    64 MiB) route nothing; rows within MAX_DIM and a round below 2^31
    ratings do."""
    from tpu_mf.ops.pallas_sgld import sgld_pallas_eligible as jax_gen1_ok
    from tpu_mf.ops.pallas_sgld_slot import SlotSgldRunner as JaxSlot
    from tpu_mf.ops.pallas_sgld_slot import sgld_slot_eligible as jax_slot_ok
    from tpu_mf.ops.pallas_sgld_slot import sgld_slot_pack as jax_pack

    for dim in (8, 10, 11, 26, 27, 58, 59, 64):
        assert tss.sgld_slot_pack(dim) == jax_pack(dim), dim
    assert tss.sgld_slot_pack(11) == 4  # the SGD pack would be 8

    def shaped(nu, nv, dim):
        z = np.zeros
        params = JaxParams(z((nu, dim)), z((nv, dim)), z(nu), z(nv), 0.0)
        return JaxState(params, *([None] * 10))

    # (nu, nv, dim, tpu_mf's gen-1 and slot rules take it at n < 2^31)
    for nu, nv, dim, jax_gen1, jax_slot in (
            (100, 60, 8, True, True), (100, 60, 58, True, True),
            (100, 60, 59, True, False), (100, 60, 128, True, False),
            (100, 60, 251, True, False), (100, 60, 252, False, False),
            (100, 60, 2048, False, False), (100, 60, 2049, False, False),
            (10, 65_000, 8, True, True), (10, 70_000, 8, True, False),
            (10, 70_000, 123, True, False), (10, 70_000, 124, False, False),
            (10, 40_000, 251, True, False)):
        s = shaped(nu, nv, dim)
        for n in (1000, (1 << 31) - 2, 1 << 31):
            small = n < (1 << 31) - 1
            assert jax_gen1_ok(s, n) == (jax_gen1 and small)
            assert jax_slot_ok(s, n) == (jax_slot and small)
            assert tg.sgld_cells_eligible(s, n) == (dim <= 2048 and small)
            assert tss.sgld_slot_eligible(s, n) == (dim <= 58 and small)
    jds, ds = ds_pair(3000, 2000, 60000, rank=3, seed=2, zipf=1.1)
    for dim in (8, 26):
        for striped in (False, True):
            kw = dict(seed=0, dim=dim, striped=striped)
            want = JaxSlot(jds, balance=True, saturate=True, **kw)
            got = tss.SlotSgldRunner(ds, device="cpu", **kw)
            assert (got.sub, got.tile_u, got.pack) == (
                want.sub, want.tile_u, want.pack)
            np.testing.assert_array_equal(got.plan.u, want.plan.u)
