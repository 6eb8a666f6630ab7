"""The span recorder of the PyTorch port (tpu_mf_torch/train/metrics.py):
off by default and free of records, CUDA calls and profiler ranges while
off; nesting, run ids and counters while on; the span tree the MF loop
records on the CPU routes (gen-1 with balance maps, item shards, a
handover); and one clock with torch.profiler's kineto ranges."""

import threading

import numpy as np
import pytest
import torch

from tpu_mf_torch.config import TrainConfig
from tpu_mf_torch.data.coo import synthetic_ratings
from tpu_mf_torch.models.mf import init_mf
from tpu_mf_torch.ops.phi_shard import PhiShardedRunner
from tpu_mf_torch.train import loop
from tpu_mf_torch.train import metrics as tm

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the recorder off and drained."""
    tm.disable()
    tm.drain()
    yield
    tm.disable()
    tm.drain()


def data(seed=0):
    ds = synthetic_ratings(200, 150, 6000, rank=3, noise=0.2, seed=seed)
    return ds.split(0.1, seed=seed + 1)


def params(ds, dim, gb):
    return init_mf(ds.nu, ds.nv, dim, gb, torch.Generator().manual_seed(0),
                   "cpu")


def fused(cfg, tr, te, log=None):
    """``train_mf``'s fused route on CPU tensors (the kernels' plain
    versions), as the benchmark's CPU tests run it."""
    log = [] if log is None else log
    return loop._train_mf_fused(cfg, tr, te, params(tr, cfg.dim, cfg.gb),
                                log.append,
                                loop._Observer(cfg, len(tr), log.append))


def by_start(recs):
    return sorted(recs, key=lambda r: r["t0"])


def kids(recs, rec, name=None):
    return [r for r in by_start(recs) if r["parent"] == rec["id"]
            and (name is None or r["name"] == name)]


def test_off_span_is_one_object_and_makes_no_record(monkeypatch):
    """Off: ``span`` returns the same object at every call, ``count`` and
    ``note`` do nothing, no record is made, and neither a profiler range
    nor a CUDA event is created, here or in a whole fused MF run."""
    def refuse(*a, **k):
        raise AssertionError("called while the recorder is off")

    monkeypatch.setattr(tm, "_RANGE", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert not tm.enabled()
    a = tm.span("tmf.epoch", True, epoch=1)
    assert a is tm.span("tmf.eval") is tm.span("x", device=True)
    with a, tm.span("tmf.trim"):
        tm.count("launches")
        tm.note("cached", True)
    tr, te = data()
    fused(TrainConfig(dim=64, iters=2, use_dense=False,
                      gb=tr.mean_rating()), tr, te)
    assert tm.drain() == []


def test_spans_nest_and_share_the_run_id():
    """Parents are the enclosing span on the same thread; every span opened
    while a ``tmf.run`` span is open carries its id (a span on another
    thread too, with no parent); outside a run the id is None."""
    def other():
        with tm.span("tmf.plan_build"):
            pass

    with tm.recording() as recs:
        with tm.span("tmf.plan_build"):
            pass
        with tm.span(tm.RUN, first=1, last=2):
            with tm.span("tmf.epoch", epoch=1):
                with tm.span("tmf.sub_epoch", shard=0):
                    pass
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
            with tm.span(tm.RUN, first=3, last=3):
                with tm.span("tmf.pad"):
                    pass
            with tm.span("tmf.eval"):
                pass
    assert not tm.enabled()
    names = [r["name"] for r in by_start(recs)]
    assert names == ["tmf.plan_build", "tmf.run", "tmf.epoch",
                     "tmf.sub_epoch", "tmf.plan_build", "tmf.run", "tmf.pad",
                     "tmf.eval"]
    build, run, epoch, sub, build2, run2, pad, ev = by_start(recs)
    assert build["parent"] is None and build["run"] is None
    assert run["run"] == run["id"] and run["attrs"] == {"first": 1, "last": 2}
    assert epoch["parent"] == run["id"] and sub["parent"] == epoch["id"]
    assert epoch["run"] == sub["run"] == ev["run"] == run["id"]
    assert build2["parent"] is None and build2["run"] == run["id"]
    assert build2["tid"] != run["tid"] == threading.get_ident()
    assert run2["parent"] == run["id"] and pad["run"] == run2["id"]
    assert ev["parent"] == run["id"]  # the inner run closed: back to run
    assert len({r["id"] for r in recs}) == len(recs)
    assert all(r["t0"] <= r["t1"] and r["device_ms"] is None for r in recs)
    assert run["t0"] <= epoch["t0"] <= sub["t0"] <= sub["t1"] <= epoch["t1"]


def test_count_lands_on_the_innermost_span():
    """``count`` adds to the innermost open span of the calling thread and
    ``note`` sets there; with no span open both do nothing."""
    with tm.recording() as recs:
        tm.count("launches")
        with tm.span("tmf.epoch", epoch=3):
            tm.count("launches")
            with tm.span("tmf.sub_epoch", shard=0):
                tm.count("launches", 2)
                tm.count("groups_8x8")
                tm.note("cached", False)
            tm.count("h2d_bytes", 800)
            tm.count("h2d_bytes", 8)
    epoch, sub = by_start(recs)
    assert epoch["attrs"] == {"epoch": 3, "launches": 1, "h2d_bytes": 808}
    assert sub["attrs"] == {"shard": 0, "launches": 2, "groups_8x8": 1,
                            "cached": False}


def test_fused_gen1_route_records_the_span_tree():
    """The balanced gen-1 route (dim 64, no dense) on the CPU records
    ``tmf.plan_build`` outside the run, then in one ``tmf.run``: the first
    ``tmf.pad`` holding the ``tmf.plan_upload``, and for every epoch a
    ``tmf.epoch`` (epoch, runner family, eta, one ``groups_*`` count)
    followed by a ``tmf.eval`` holding a ``tmf.trim``, then the final
    ``tmf.trim``. The trims and the pad count the balance maps' bytes."""
    tr, te = data()
    cfg = TrainConfig(dim=64, iters=3, use_dense=False, gb=tr.mean_rating())
    with tm.recording() as recs:
        fused(cfg, tr, te)
    top = [r for r in by_start(recs) if r["parent"] is None]
    assert [r["name"] for r in top] == ["tmf.plan_build", "tmf.run"]
    build, run = top
    assert build["run"] is None and build["t1"] <= run["t0"]
    assert run["attrs"] == {"first": 1, "last": 3}
    assert all(r["run"] == run["id"] for r in recs if r is not build)
    parts = kids(recs, run)
    assert [r["name"] for r in parts] == (
        ["tmf.pad"] + ["tmf.epoch", "tmf.eval"] * 3 + ["tmf.trim"])
    maps = 8 * (tr.nu + tr.nv)
    pad = parts[0]
    assert [r["name"] for r in kids(recs, pad)] == ["tmf.plan_upload"]
    assert pad["attrs"] == {"h2d_bytes": maps}
    for it, (ep, ev) in enumerate(zip(parts[1:-1:2], parts[2:-1:2]), 1):
        groups = {k: v for k, v in ep["attrs"].items()
                  if k.startswith("groups_")}
        assert ep["attrs"]["epoch"] == it
        assert ep["attrs"]["kernel"] == "CellEpochRunner"
        assert ep["attrs"]["eta"] == cfg.eta_at(it)
        assert list(groups.values()) == [1]
        assert "launches" not in ep["attrs"]  # CPU: no kernel launch
        (trim,) = kids(recs, ev)
        assert trim["name"] == "tmf.trim"
        assert trim["attrs"] == {"h2d_bytes": maps}
        assert ep["device_ms"] is None
    assert parts[-1]["attrs"] == {"h2d_bytes": maps}


def test_item_sharded_epochs_record_a_sub_epoch_per_shard():
    """An item-sharded schedule on the CPU: each ``tmf.epoch`` holds one
    ``tmf.sub_epoch`` per shard, in shard order, each with the grouping
    its inner runner took, and the pad holds one ``tmf.plan_upload`` per
    shard."""
    ds = synthetic_ratings(300, 260, 4000, rank=3, seed=2, zipf=0.8)
    runner = PhiShardedRunner(ds, dim=8, tile_u=64, tile_v=64, batch=256,
                              seed=3, budget=128 * 128 * 4, n_plans=2,
                              nb_round=4, device="cpu")
    assert runner.n_shards >= 2
    cfg = TrainConfig(dim=8, iters=2, gb=3.0)
    with tm.recording() as recs:
        loop._run_schedule(cfg, [(1, runner)], None, params(ds, 8, 3.0),
                           lambda _: None, loop._Observer(cfg, len(ds)))
    (run,) = [r for r in recs if r["name"] == tm.RUN]
    pad, *epochs, trim = kids(recs, run)
    assert pad["name"] == "tmf.pad" and trim["name"] == "tmf.trim"
    assert len(kids(recs, pad, "tmf.plan_upload")) == runner.n_shards
    assert [e["name"] for e in epochs] == ["tmf.epoch"] * 2
    for ep in epochs:
        subs = kids(recs, ep)
        assert [s["attrs"]["shard"] for s in subs] == list(
            range(runner.n_shards))
        for s, inner in zip(subs, runner.inners):
            eta = cfg.eta_at(ep["attrs"]["epoch"])
            key = (f"groups_{inner.pick_theta_groups(eta)}x"
                   f"{inner.pick_phi_groups(eta)}")
            assert s["name"] == "tmf.sub_epoch" and s["attrs"][key] == 1
        assert not any(k.startswith("groups_") for k in ep["attrs"])


def test_handover_records_its_trim_and_pad():
    """The rank-8 schedule at an eta above the dense bound (lane-packed
    epoch 1, dense from epoch 2) records a ``tmf.handover`` before epoch
    2, naming both runner families, holding the old runner's ``tmf.trim``
    and the new one's ``tmf.pad`` (which uploads the dense cells)."""
    tr, _ = data()
    cfg = TrainConfig(dim=8, iters=3, eta=0.04, gam=2.0, gb=tr.mean_rating())
    log = []
    with tm.recording() as recs:
        fused(cfg, tr, None, log)
    assert "# epoch 2: switching to DenseEpochRunner" in log
    (run,) = [r for r in recs if r["name"] == tm.RUN]
    parts = kids(recs, run)
    assert [r["name"] for r in parts] == [
        "tmf.pad", "tmf.epoch", "tmf.handover", "tmf.epoch", "tmf.epoch",
        "tmf.trim"]
    hand = parts[2]
    assert hand["attrs"] == {"src": "PackedEpochRunner",
                             "dst": "DenseEpochRunner"}
    trim, pad = kids(recs, hand)
    assert (trim["name"], pad["name"]) == ("tmf.trim", "tmf.pad")
    assert [r["name"] for r in kids(recs, pad)] == ["tmf.plan_upload"]
    assert [p["attrs"]["kernel"] for p in parts if p["name"] == "tmf.epoch"
            ] == ["PackedEpochRunner", "DenseEpochRunner", "DenseEpochRunner"]


def test_spans_are_profiler_ranges_on_one_clock():
    """Under a CPU-only torch.profiler, every span of a fused gen-1 run is
    a kineto range of the same name, in the same order, and each range
    lasts as long as its span (within 5% or 0.5 ms)."""
    tr, te = data()
    cfg = TrainConfig(dim=64, iters=2, use_dense=False, gb=tr.mean_rating())
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with tm.recording() as recs:
            fused(cfg, tr, te)
    ranges = sorted((e.start_ns(), e.duration_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("tmf."))
    spans = by_start(recs)
    assert len(spans) > 10
    assert [n for _, _, n in ranges] == [r["name"] for r in spans]
    for (_, dur, _), r in zip(ranges, spans):
        took = r["t1"] - r["t0"]
        assert abs(dur - took) <= max(0.05 * took, 500_000), r["name"]


def test_drained_records_are_cleared_and_json_ready(tmp_path):
    """``drain`` hands each record over once; ``write_spans`` appends them
    as JSON lines that read back equal; ``subtree`` walks the parents."""
    import json

    tm.enable()
    with tm.span("tmf.eval"):
        with tm.span("tmf.trim"):
            tm.count("h2d_bytes", np.int64(16).item())
    with tm.span("tmf.epoch", epoch=1, eta=0.02):
        pass
    first = tm.drain()
    assert tm.drain() == []
    tm.disable()
    path = tmp_path / "spans.jsonl"
    tm.write_spans(str(path), first)
    tm.write_spans(str(path), first[:1])
    back = [json.loads(x) for x in path.read_text().splitlines()]
    assert back == first + first[:1]
    ev = next(r for r in first if r["name"] == "tmf.eval")
    assert [r["name"] for r in tm.subtree(first, ev)] == ["tmf.eval",
                                                          "tmf.trim"]


def test_streamed_epochs_record_shard_spans(tmp_path):
    """``FusedStreamTrainer`` on the CPU: each shard's plan is built on the
    Prefetcher's thread in a ``tmf.plan_build`` span (shard, epoch,
    cached: built in epoch 1, loaded from the workdir cache in epoch 3),
    staged in a ``tmf.plan_upload`` span there too, and launched in a
    ``tmf.sub_epoch`` span on the calling thread whose real ratings sum
    to the file's."""
    from tpu_mf_torch.data.textfmt import write_raw
    from tpu_mf_torch.io.stream_fused import FusedStreamTrainer

    ds = synthetic_ratings(200, 100, 12000, rank=3, noise=0.1, seed=1)
    path = str(tmp_path / "train.txt")
    write_raw(path, ds)
    tt = FusedStreamTrainer(path, tile_u=32, tile_v=32, batch=128,
                            mem_limit=3000, seed=3, mxu="float32",
                            workdir=str(tmp_path / "wk"), device="cpu")
    k = tt.store.n_shards
    assert k > 1
    tabs = tt.pad(params(tt, 8, 3.0))
    with tm.recording() as recs:
        for it in (1, 3):  # plan variants 1 and 1: built, then cached
            tt.epoch(tabs, 0.02, 0.01, 3.0, epoch_idx=it)
    tt.close()
    me = threading.get_ident()
    for name in ("tmf.plan_build", "tmf.plan_upload", "tmf.sub_epoch"):
        got = [r for r in by_start(recs) if r["name"] == name]
        assert [(r["attrs"]["epoch"], r["attrs"]["shard"]) for r in got] == [
            (it, s) for it in (1, 3) for s in range(k)], name
        assert all((r["tid"] == me) == (name == "tmf.sub_epoch")
                   for r in got), name
        assert all(r["parent"] is None and r["device_ms"] is None
                   for r in got), name
    builds = [r for r in by_start(recs) if r["name"] == "tmf.plan_build"]
    assert [r["attrs"]["cached"] for r in builds] == [False] * k + [True] * k
    subs = [r for r in by_start(recs) if r["name"] == "tmf.sub_epoch"]
    assert sum(r["attrs"]["n_real"] for r in subs) == 2 * len(ds)
