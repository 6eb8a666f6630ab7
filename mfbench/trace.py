"""Reading the traced window: ``torch.profiler`` (CPU and CUDA activity)
runs from the window's opening to its close, and the harness marks each
epoch end with a ``mfbench.epoch_end`` range. Everything is read in the
profiler's own clock, in memory.

- device busy time: the union of every device operation's interval
  (kernels, copies, sets) inside the window;
- each epoch's eval: from the end of the training loop's
  ``cudaDeviceSynchronize`` to the harness's mark of that epoch;
- the breakdown: device operations by total time, and idle time on the
  device by what the host thread was in (its innermost range), "python"
  where it was in no range.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

MARK_OPEN, MARK_CLOSE, MARK_EPOCH = ("mfbench.open", "mfbench.close",
                                     "mfbench.epoch_end")


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    evals_s: list = field(default_factory=list)
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def _span(e) -> tuple[float, float]:
    """(start, end) seconds of a kineto event."""
    if hasattr(e, "start_ns"):
        s = e.start_ns() * 1e-9
        return s, s + e.duration_ns() * 1e-9
    s = e.start_us() * 1e-6
    return s, s + e.duration_us() * 1e-6


def _union(spans: list) -> list:
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def summarize(prof, top: int = 10) -> TraceSummary:
    """The window's numbers from a stopped ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    device, host, marks, syncs = [], [], defaultdict(list), []
    main_tid = None
    for e in events:
        name = e.name()
        s, t = _span(e)
        if e.device_type() == DeviceType.CUDA:
            device.append((s, t, name))
            continue
        if name in (MARK_OPEN, MARK_CLOSE, MARK_EPOCH):
            marks[name].append(s)
            main_tid = e.start_thread_id()
            continue
        host.append((s, t, name, e.start_thread_id()))
    if not marks[MARK_OPEN] or not marks[MARK_CLOSE]:
        raise RuntimeError("the trace holds no window marks")
    w0, w1 = min(marks[MARK_OPEN]), max(marks[MARK_CLOSE])
    clipped = [(max(s, w0), min(t, w1), n) for s, t, n in device
               if t > w0 and s < w1]
    busy = _union([(s, t) for s, t, _ in clipped])
    busy_s = sum(t - s for s, t in busy)

    per_op = defaultdict(float)
    for s, t, n in clipped:
        per_op[n] += t - s
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]

    main = sorted((s, t, n) for s, t, n, tid in host if tid == main_tid)
    for s, t, n in main:
        if n == "cudaDeviceSynchronize":
            syncs.append(t)
    evals = []
    for m in sorted(marks[MARK_EPOCH]):
        i = bisect.bisect_right(syncs, m)
        if i and w0 <= syncs[i - 1] <= m:
            evals.append(m - syncs[i - 1])

    gaps = []
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    idle = defaultdict(float)
    stack: list = []
    j = 0
    for a, b in gaps:             # gaps in time order; ranges nest per thread
        mid = 0.5 * (a + b)
        while j < len(main) and main[j][0] <= mid:
            stack.append(main[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        inner = next((r for r in reversed(stack) if r[1] >= mid), None)
        idle[inner[2] if inner else "python"] += b - a
    gaps_named = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return TraceSummary(window_s=w1 - w0, busy_s=busy_s, evals_s=evals,
                        device_ops=[[n, v] for n, v in ops],
                        idle_gaps=[[n, v] for n, v in gaps_named])
