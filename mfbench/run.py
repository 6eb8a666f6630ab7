"""Run one benchmark cell of tpu_mf_torch once and print its result line.

    python3 mfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout on a machine with the card(s) the cell asks
for. The run makes its ratings and initial tables from ``--seed`` on the
device and trains them as the program's trainer for the traffic's
``alg`` does, through that trainer's driver (``algs/<alg>.py``): the
driver builds the trainer's runners once (plans built and uploaded) and
runs jobs of the traffic's ``job_epochs`` epochs or rounds on them, each
job from the seed's initial tables, with a ``log`` callback that the
harness times on the host:

- set-up: process start to the window's opening (imports, kernel load
  or build, data generation, the runners and their plan builds, and the
  warm-up: at least ``warmup_jobs`` jobs and ``warmup_seconds`` after
  the first epoch line);
- the window: whole jobs from the warm-up's end to the first job end at
  least ``--seconds`` later; the rate is all its epochs' ratings over
  all its host seconds (evals, the jobs' table copies and hand-overs
  included).

Every job runs epochs 1 to ``job_epochs`` at the trainer's step sizes, so
the window times the epochs a user's job runs, whatever its length.
Then the run reads the device's peak memory, frees the program's state,
and holds what the jobs produced (the test RMSE every job logged, the
first warm-up job's tables after epoch 1, the last timed job's final
tables, and what else the driver kept) against the plain reference
trained for a whole job (the driver's ``compare``). With ``--trace 1``
the window runs under ``torch.profiler`` and the line carries the
per-layer metrics and a breakdown instead of the end-to-end ones.

Exits non-zero, printing no result, without a CUDA device (or fewer than
the cell asks for), without the program, or if JAX or the JAX package
was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from mfbench.trace import MARK_CLOSE, MARK_EPOCH, MARK_OPEN  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_mf")


def forbidden_modules() -> list:
    """Loaded modules of JAX or the JAX package, by whole top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def setup_env(root: Path = ROOT) -> None:
    """Caches inside the checkout, at fixed paths; no plan cache (every
    run's ratings are new, so it could only miss, and it writes each
    plan to disk); no JAX behind a library."""
    cache = root / "build" / "mfbench-cache"
    os.environ["TPU_MF_PLAN_CACHE"] = "0"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


@dataclass
class Window:
    """The log callback's and the job loop's state: every job's epoch
    lines (read by the driver's ``parse``), the warm-up, the window, and
    the first job's epoch-1 tables (``snap1``: from ``snap``, called with
    the log callback's caller's frame at job 0's epoch-1 line, or set by
    the driver's job). ``rec`` keeps what the driver's jobs record, one
    entry a job. Job 0 is the first warm-up job."""

    seconds: float
    warmup_jobs: int
    warmup_seconds: float
    parse: object = None
    snap: object = None
    profile: bool = False
    job: int = 0                                # the job now running
    lines: list = field(default_factory=list)   # per job {epoch: (t, rmse)}
    snap1: dict | None = None
    t_first: float | None = None
    t_open: float | None = None
    t_close: float | None = None
    open_job: int = 0
    close_job: int = 0
    job_ends: list = field(default_factory=list)
    rec: list = field(default_factory=list)
    prof: object = None

    def log(self, line: str) -> None:
        t = time.perf_counter()
        got = self.parse(line)
        if got is None:           # not an epoch line
            return
        ep, elapsed, rmse = got
        if self.prof is not None:
            self._mark(MARK_EPOCH)
        while len(self.lines) <= self.job:
            self.lines.append({})
        self.lines[self.job][ep] = (t, elapsed, rmse)
        if self.t_first is None:
            self.t_first = t
        if self.job == 0 and ep == 1 and self.snap is not None:
            self.snap1 = self.snap(sys._getframe(1))

    def job_done(self) -> bool:
        """Mark the end of a job; True once it closes the window. The
        window opens at the end of the warm-up's last job (warm-up
        seconds count from the first epoch line: epoch 1 of a first run
        builds the kernels, and the window should open at the same job
        either way) and closes at the first job end ``seconds`` later."""
        t = time.perf_counter()
        self.job += 1
        self.job_ends.append(t)
        if self.t_open is None:
            if (self.job >= self.warmup_jobs
                    and t - self.t_first >= self.warmup_seconds):
                if self.profile:
                    self._start_profiler()
                self.open_job = self.job
                self.t_open = time.perf_counter()
            return False
        if t >= self.t_open + self.seconds:
            self.t_close, self.close_job = t, self.job
            if self.prof is not None:
                self._mark(MARK_CLOSE)
                self.prof.stop()
            return True
        return False

    def logged(self, jobs=None) -> list:
        """{epoch: logged test RMSE} of each job (all by default)."""
        rows = self.lines if jobs is None else self.lines[jobs]
        return [{e: x[2] for e, x in r.items()} for r in rows]

    def _start_profiler(self) -> None:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self._mark(MARK_OPEN)

    @staticmethod
    def _mark(name: str) -> None:
        import torch

        with torch.profiler.record_function(name):
            pass


@dataclass
class Context:
    """What the per-layer metric readers read: the cell, its epoch lines
    and window (``Window``), one epoch's work (``work/``), the schedule's
    seconds and the traced window's summary (``trace.TraceSummary``)."""

    spec: dict
    window: Window | None
    epoch_work: dict
    schedule_s: float | None
    trace: object = None
    trace_epochs: int = 0
    trace_window_s: float = 0.0


def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda") -> dict:
    """One run of the cell: the result line's dict (before ``device``)
    and the numbers the check compared."""
    import torch

    from mfbench import check, reference
    from mfbench.spec import driver, reader
    from mfbench.trace import summarize

    tr = spec["traffic"]
    drv = driver(tr["alg"])
    n_ep = int(tr["job_epochs"])
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t_gen = time.perf_counter()
    drawn = drv.draw(spec, seed, device)
    train, test, gb, route = drawn[0], drawn[1], drawn[3], drawn[5]
    win = Window(seconds=seconds, warmup_jobs=int(tr["warmup_jobs"]),
                 warmup_seconds=float(tr["warmup_seconds"]), parse=drv.parse,
                 profile=trace)
    t_call = time.perf_counter()
    job = drv.setup(spec, drawn, win, device)
    final = None
    while True:
        final = None                 # one job's tables alive at a time
        final = job()
        if win.job_done():
            break
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    final = {k: final[k].detach() for k in check.LEAVES}
    del job
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    summary = summarize(win.prof) if win.prof is not None else None
    win.prof = None

    n_jobs = win.close_job - win.open_job
    n_epochs = n_jobs * n_ep
    window_s = win.t_close - win.t_open
    work = drv.epoch_work(drawn, spec)
    t_line1, elapsed1, _ = win.lines[0][1]
    schedule_s = t_line1 - elapsed1 - t_call
    dev_test = test.on(device)
    test_rmse = reference.rmse(final, gb, *dev_test, chunk=1 << 18)
    e2e = {
        "updates_per_s": len(train) * n_epochs / window_s,
        "test_rmse": test_rmse,
        "peak_device_gib": peak / 2 ** 30,
        "setup_s": win.t_open - T_START,
    }

    # the check, once the program's state is gone
    t_check = time.perf_counter()
    values, extras = drv.compare(spec, drawn, win, final, test_rmse, device)
    correct, compared = check.judge(values, spec["limits"], drv.NUMBERS)
    check_s = time.perf_counter() - t_check

    out = {"correct": correct, "attempted": n_epochs, "failed": 0}
    if trace:
        ctx = Context(spec=spec, window=win, epoch_work=work,
                      schedule_s=schedule_s, trace=summary,
                      trace_epochs=n_epochs, trace_window_s=window_s)
        metrics = {}
        for m in spec["per_layer"]:
            v = reader(m["name"])(ctx)
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["metrics"] = metrics
        out["breakdown"] = {"device_ops": summary.device_ops,
                            "idle_gaps": summary.idle_gaps}
        out["busy_s"], out["window_s"] = summary.busy_s, summary.window_s
    else:
        out["metrics"] = {m["name"]: {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
                          for m in spec["end_to_end"]}
    out["peak_bytes"] = int(peak)
    out["route"] = reference.describe(route)
    ends = [win.t_open] + win.job_ends[win.open_job:win.close_job]
    per = sorted(b - a for a, b in zip(ends, ends[1:]))
    loop_t0 = t_line1 - elapsed1
    out["epochs"] = {"open_job": win.open_job, "close_job": win.close_job,
                     "epochs": n_epochs, "window_s": window_s,
                     "check_s": check_s,
                     "job_s": [per[0], per[len(per) // 4],
                               per[len(per) // 2], per[3 * len(per) // 4],
                               per[-1]],
                     "setup": {"import_s": t_gen - T_START,
                               "data_s": t_call - t_gen,
                               "schedule_s": schedule_s,
                               "warmup_s": win.t_open - loop_t0}}
    out["extras"] = extras
    out["checks"] = compared
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    setup_env()
    from mfbench.spec import cell_spec

    spec = cell_spec(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("mfbench: no CUDA device", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < spec["chips"]:
        print(f"mfbench: the cell needs {spec['chips']} devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    try:
        import tpu_mf_torch  # noqa: F401
    except ImportError as e:
        print(f"mfbench: the program is not here: {e}", file=sys.stderr)
        return 4
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"mfbench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 5
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": spec["chips"], "memory_peak_bytes": out.pop("peak_bytes")}
    if args.trace:
        dev["busy_s"], dev["window_s"] = out.pop("busy_s"), out.pop("window_s")
    checks = out.pop("checks")
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"],
            "device": dev}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["route"] = out["route"]
    line["window"] = out["epochs"]
    line.update(out["extras"])    # the driver's keys (mf: "groupings")
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
