"""Structured metrics, spans and profiling (counterpart of
``tpu_mf/train/metrics.py``, which cannot be imported without JAX).

The reference's per-epoch line ``iter#N <time> tRMSE=<x>`` (src/mf.h:35) is
printed by the training loop; this module adds JSONL metrics with update
throughput, a ``torch.profiler`` trace, and a span recorder.

The recorder (``span``, ``count``, ``note``; ``enable``, ``disable``,
``drain``) is off by default. While off, ``span`` returns one shared no-op
object and ``count`` / ``note`` return at once: one flag read each, no
record, no CUDA call, no profiler range. While on, each span keeps a
record (a dict):

- ``name``; ``t0`` / ``t1``: ``time.perf_counter_ns()`` at its ends (the
  clock of the ``iter#`` lines);
- ``id``; ``parent``: the id of the enclosing span on the same thread (the
  span that caused it), or None; ``run``: the id of the ``tmf.run`` span
  open when it started (one training-loop call), or None; ``tid``: its
  thread's ``threading.get_ident()``;
- ``attrs``: the keywords it was opened with, the counts ``count`` added
  while it was the innermost open span of its thread, and what ``note``
  set;
- ``device_ms``: with ``device=True``, the milliseconds between the CUDA
  events recorded on the current stream at its two ends, read at
  ``drain``; otherwise None.

Each span is also entered as a profiler range of its name (``_RANGE``), so
that under a profiler it lands in the kineto trace on the clock of the
device's events. No span synchronizes the device or reads a device value;
``drain`` waits for the events it reads.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Optional

import torch

RUN = "tmf.run"  # the span whose id the spans opened inside it share
# The profiler range of a span: the RecordFunction that
# ``torch.profiler.record_function`` makes, entered without its dispatch
# through ``torch.ops`` (under a microsecond a span, against tens in the
# training loop); the public form where a torch build lacks it.
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast",
                 torch.profiler.record_function)
# the counters the port's spans carry, besides the ``groups_<t>x<p>``
# grouping of each window-plan launch (``valid_rows``: the validation rows
# of AdaptReg's hypergradient steps)
COUNTS = ("launches", "h2d_bytes", "valid_rows")

_on = False
_records: list = []  # (record, CUDA event pair or None), appended under _lock
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()
_run_id: Optional[int] = None


class _Off:
    """The span of a recorder that is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Span:
    __slots__ = ("rec", "device", "rf", "ev", "prev_run")

    def __init__(self, name: str, device: bool, attrs: dict):
        self.rec = {"name": name, "id": next(_ids), "parent": None,
                    "run": None, "tid": threading.get_ident(), "t0": 0,
                    "t1": 0, "attrs": attrs, "device_ms": None}
        self.device = device
        self.ev = None

    def __enter__(self):
        global _run_id
        rec, st = self.rec, _stack()
        if st:
            rec["parent"] = st[-1]["id"]
        self.prev_run = _run_id
        if rec["name"] == RUN:
            _run_id = rec["id"]
        rec["run"] = _run_id
        self.rf = _RANGE(rec["name"])
        self.rf.__enter__()
        if self.device:
            self.ev = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
            self.ev[0].record()
        st.append(rec)
        rec["t0"] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _run_id
        rec = self.rec
        rec["t1"] = time.perf_counter_ns()
        if self.ev is not None:
            self.ev[1].record()
        self.rf.__exit__(*exc)
        _stack().pop()
        if rec["name"] == RUN:
            _run_id = self.prev_run
        with _lock:
            _records.append((rec, self.ev))
        return False


def span(name: str, device: bool = False, **attrs):
    """A context manager that records a span named ``name`` with
    ``attrs`` while the recorder is on (module docstring); with ``device``
    also a CUDA event pair on the current stream."""
    if not _on:
        return _OFF
    return _Span(name, device, attrs)


def count(key: str, n: int = 1) -> None:
    """Add ``n`` to attribute ``key`` of the innermost open span of the
    calling thread (none open: nothing)."""
    if not _on:
        return
    st = _stack()
    if st:
        attrs = st[-1]["attrs"]
        attrs[key] = attrs.get(key, 0) + n


def note(key: str, value) -> None:
    """Set attribute ``key`` of the innermost open span of the calling
    thread to ``value`` (none open: nothing)."""
    if not _on:
        return
    st = _stack()
    if st:
        st[-1]["attrs"][key] = value


def enabled() -> bool:
    return _on


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    """Stop recording new spans; spans already open still close into the
    records."""
    global _on
    _on = False


def drain() -> list:
    """The records of every span closed since the last drain, in the order
    they closed, and clears them. Reads each device span's event pair
    (waiting for its end event)."""
    global _records
    with _lock:
        taken, _records = _records, []
    out = []
    for rec, ev in taken:
        if ev is not None:
            ev[1].synchronize()
            rec["device_ms"] = ev[0].elapsed_time(ev[1])
        out.append(rec)
    return out


@contextlib.contextmanager
def recording():
    """The recorder on for the ``with`` block (and off after it, unless it
    was on before); yields a list that holds the records drained at the
    block's end."""
    was_on = enabled()
    out: list = []
    enable()
    try:
        yield out
    finally:
        if not was_on:
            disable()
        out.extend(drain())


def write_spans(path: str, records: list) -> None:
    """Append ``records`` to the JSONL file ``path``, one per line."""
    with open(path, "a") as fh:
        for rec in records:
            fh.write(json.dumps(rec) + "\n")


def subtree(records: list, root: dict) -> list:
    """``root`` and the records among ``records`` nested in it (through
    their parents)."""
    kids: dict = {}
    for r in records:
        kids.setdefault(r["parent"], []).append(r)
    out, todo = [], [root]
    while todo:
        r = todo.pop()
        out.append(r)
        todo.extend(kids.get(r["id"], ()))
    return out


class MetricsLogger:
    """Append-only JSONL metrics with throughput accounting: a line's
    ``updates_per_sec`` is the updates counted so far over its ``elapsed``
    seconds, the training loop's clock (the ``iter#`` lines count it from
    the loop's start, after the plans are built); ``t`` counts from the
    logger's opening."""

    def __init__(self, path: str):
        self._fh = open(path, "a")
        self._t0 = time.perf_counter()
        self._updates = 0

    def count_updates(self, n: int) -> None:
        self._updates += int(n)

    def log(self, **fields) -> None:
        fields.setdefault("t", round(time.perf_counter() - self._t0, 6))
        elapsed = fields.get("elapsed")
        if self._updates and elapsed:
            fields.setdefault("updates_per_sec",
                              round(self._updates / elapsed))
        self._fh.write(json.dumps(fields) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


def spans_path(logdir: str) -> str:
    return os.path.join(logdir, "spans.jsonl")


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """When logdir is set: capture a ``torch.profiler`` trace into
    ``logdir/trace.json`` (Chrome trace format; CUDA activity when a GPU
    is present), with the span recorder on, and append the spans still
    undrained at the end to ``logdir/spans.jsonl`` (started empty). Where
    the recorder was on already, its records are left to whoever turned it
    on."""
    if not logdir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    open(spans_path(logdir), "w").close()
    was_on = enabled()
    enable()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            yield
    finally:
        if not was_on:
            disable()
            write_spans(spans_path(logdir), drain())
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
