"""Host-side streaming input pipeline (counterpart of ``tpu_mf/io/stream.py``).

Reference: a 3-stage tbb::pipeline with ``fly`` tokens — serial fread of
length-prefixed frames into a recycled buffer pool, parallel protobuf decode,
parallel Hogwild update (src/mf.h:6-70, src/main.cc:42-50). Here a
background thread parses the file into fixed-size COO batches and stages
them onto the device up to ``fly`` batches ahead of the update step
(``Prefetcher``), so host parsing and copies overlap device work.

The per-batch epochs below (``streaming_sgd_epoch``, ``streaming_sgld_round``,
``streaming_adreg_epoch``, ``streaming_mse``) run the port's batched updates
(``ops/sgd.py``, ``ops/sgld.py``, ``ops/adreg.py``) on each staged batch, in
file order. Their randomness comes from an explicit ``torch.Generator``:
SGLD's noise, and AdaptReg's K validation indices, one draw per batch as
``tpu_mf`` folds the batch index into its key. The fused out-of-core MF path
is ``io/stream_fused.py``.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch


def stream_batches(
    path: str, batch_size: int
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Yield (u, v, r, w) batches by incrementally parsing any rating file
    (proto frames / raw / userwise / MovieLens — data/streamfmt.py).

    The tail batch is padded with weight-0 slots, like RatingsCOO.to_batches.
    """
    from tpu_mf_torch.data.streamfmt import iter_ratings

    for u, v, r in iter_ratings(path, chunk=batch_size):
        n = len(u)
        if n == batch_size:
            yield u, v, r, np.ones(batch_size, np.float32)
        else:  # tail
            pad = batch_size - n
            yield (
                np.concatenate([u, np.zeros(pad, np.int32)]),
                np.concatenate([v, np.zeros(pad, np.int32)]),
                np.concatenate([r, np.zeros(pad, np.float32)]),
                np.concatenate(
                    [np.ones(n, np.float32), np.zeros(pad, np.float32)]
                ),
            )


def scan_dims(path: str) -> Tuple[int, int, int]:
    """One bounded-memory pass over any rating file: (nu, nv, n_ratings)."""
    from tpu_mf_torch.data.streamfmt import scan_stats

    return scan_stats(path)


def _map_tree(fn, item):
    """``item`` with ``fn`` applied to every leaf of its tuples, lists,
    NamedTuples and dicts."""
    if isinstance(item, dict):
        return {k: _map_tree(fn, x) for k, x in item.items()}
    if isinstance(item, tuple) and hasattr(item, "_fields"):
        return type(item)(*(_map_tree(fn, x) for x in item))
    if isinstance(item, (tuple, list)):
        return type(item)(_map_tree(fn, x) for x in item)
    return fn(item)


def to_device(x, device: torch.device):
    """A numpy array as a tensor on ``device`` (other values as they are):
    on the CPU a view of it, on CUDA a copy from pinned host memory with
    ``non_blocking`` on the current stream."""
    if not isinstance(x, np.ndarray):
        return x
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class Prefetcher:
    """Stage items onto the device from a background thread, ``fly`` ahead.

    The moral equivalent of the reference's pipeline tokens (--fly,
    main.cc:19): bounded lookahead that overlaps host parse/transfer with
    device compute. Iterate it like the source iterator; raises the source's
    exception, if any, at the point of consumption.

    ``stage(item)`` makes the device form of an item; by default every
    numpy array in it becomes a tensor on ``device`` (``to_device``). On
    CUDA the worker stages on a side stream of its own and records an event
    after each item; the consumer's current stream waits on that event, and
    every staged tensor is marked as used by that stream (``record_stream``),
    so the caching allocator does not hand its memory to the side stream
    while the consumer's work still reads it."""

    _DONE = object()

    def __init__(self, source, fly: int = 8,
                 device: torch.device | str = "cuda",
                 stage: Optional[Callable] = None):
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self._stage = stage or (lambda item: _map_tree(
            lambda x: to_device(x, dev), item))
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, fly))
        self._err: Optional[BaseException] = None
        self._closed = threading.Event()

        def put(x) -> bool:
            # bounded put so an abandoned consumer doesn't pin `fly` device
            # items forever (see close())
            while not self._closed.is_set():
                try:
                    self._q.put(x, timeout=0.2)
                    break
                except queue.Full:
                    continue
            if self._closed.is_set():  # close() raced this put: drop it
                self._drain()
                return False
            return True

        def worker():
            try:
                if dev.type == "cuda":
                    torch.cuda.set_device(dev)
                    side = torch.cuda.Stream(dev)
                for item in source:
                    if dev.type == "cuda":
                        with torch.cuda.stream(side):
                            staged = self._stage(item)
                            done = torch.cuda.Event()
                            done.record(side)
                    else:
                        staged, done = self._stage(item), None
                    if not put((staged, done)):
                        return
            except BaseException as e:  # surfaced on the consumer side
                self._err = e
            finally:
                # the sentinel must not be dropped on a full queue, or the
                # consumer blocks forever; bounded-put like the items
                put(self._DONE)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Release the worker and its staged items (idempotent)."""
        self._closed.set()
        self._drain()

    def _drain(self) -> None:
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            if self._err is not None:
                raise self._err
            raise StopIteration
        staged, done = item
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)

            def mark(x):
                if isinstance(x, torch.Tensor) and x.is_cuda:
                    x.record_stream(stream)
                return x

            _map_tree(mark, staged)
        return staged


def _counted(src, counts):
    """``src``'s batches, adding each batch's real ratings to
    ``counts["n"]`` on the host as they flow through the parser, so the
    device loop never synchronizes per batch."""
    for b in src:
        counts["n"] += int(b[3].sum())
        yield b


def streaming_batches(path: str, batch_size: int, fly: int = 8,
                      device: torch.device | str = "cuda"):
    """Prefetched device-staged (u, v, r, w) batches from an on-disk stream,
    with a host-side real-rating counter (reads counter after exhaustion).
    Ids are widened to int64 (index tensors) on the host, so the worker
    thread runs no torch operator beside the consumer's."""
    counts = {"n": 0}
    dev = torch.device(device)

    def stage(b):
        u, v, r, w = b
        return tuple(to_device(x, dev) for x in (
            u.astype(np.int64), v.astype(np.int64), r, w))

    return Prefetcher(_counted(stream_batches(path, batch_size), counts),
                      fly=fly, device=dev, stage=stage), counts


def streaming_sgd_epoch(params, path: str, eta: float, lam: float,
                        batch_size: int = 8192, fly: int = 8):
    """One SGD pass over an on-disk block stream without loading it in RAM,
    in place on ``params``; returns (params, real ratings).

    Mirrors the reference's epoch structure: serial read -> decode ->
    update, with ``fly`` batches in flight (reference: run(MF&),
    src/main.cc:36-52).
    """
    from tpu_mf_torch.ops.sgd import sgd_batch_update

    pf, counts = streaming_batches(path, batch_size, fly,
                                   params.theta.device)
    try:
        for batch in pf:
            params = sgd_batch_update(params, batch, eta, lam)
    finally:
        pf.close()
    return params, counts["n"]


def streaming_sgld_round(state, path: str, hyper, generator: torch.Generator,
                         batch_size: int = 8192, fly: int = 8):
    """One DP-SGLD round over an on-disk stream (reference: the TBB pipeline
    feeding DPMF, src/dpmf.h:6-34) — out-of-core dpmf training, in place;
    the noise comes from ``generator``. Returns (state, real ratings)."""
    from tpu_mf_torch.ops.sgld import sgld_batch_update

    pf, counts = streaming_batches(path, batch_size, fly,
                                   state.params.theta.device)
    try:
        for batch in pf:
            state = sgld_batch_update(state, batch, hyper, generator)
    finally:
        pf.close()
    return state, counts["n"]


def streaming_adreg_epoch(state, path: str, valid, hyper, samples,
                          batch_size: int = 8192, fly: int = 8):
    """One AdaptReg epoch over an on-disk stream (reference: src/admf.h:6-46)
    — out-of-core admf training, in place. ``hyper`` is an
    ops.adreg.AdRegHyper; ``valid`` the (u, v, r) validation tensors.
    ``samples`` gives each batch's K validation indices: a
    ``torch.Generator`` draws them, one draw per batch, or a callable
    ``samples(i)`` returns batch i's (tests inject ``tpu_mf``'s draws).
    Returns (state, real ratings)."""
    from tpu_mf_torch.ops.adreg import N_REG_SAMPLES, adreg_batch_update

    dev = state.params.theta.device
    draw = samples
    if isinstance(samples, torch.Generator):
        def draw(i):
            del i
            return torch.randint(int(valid[0].shape[0]), (N_REG_SAMPLES,),
                                 generator=samples, device=dev)

    pf, counts = streaming_batches(path, batch_size, fly, dev)
    try:
        for i, batch in enumerate(pf):
            state = adreg_batch_update(state, batch, valid, hyper, draw(i))
    finally:
        pf.close()
    return state, counts["n"]


def streaming_mse(params, path: str, batch_size: int = 1 << 16,
                  fly: int = 8) -> float:
    """Weighted train MSE over an on-disk stream (drives the Gibbs SSE for
    streamed dpmf; in-memory path: models/mf.calc_mse). Each chunk's sums
    are float32, their total a Python float, as ``tpu_mf``'s."""
    from tpu_mf_torch.models.mf import predict

    sse = 0.0
    n = 0.0
    pf, _ = streaming_batches(path, batch_size, fly, params.theta.device)
    try:
        for u, v, r, w in pf:
            e = (r - predict(params, u, v)) * w
            sse += float(torch.sum(e * e))
            n += float(torch.sum(w))
    finally:
        pf.close()
    return sse / max(n, 1.0)
