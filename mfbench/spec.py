"""Finding a cell's parts by name: ``BENCHMARK.json`` names the cell's
configuration and traffic mix, and each lives in a file of its own.

- ``mfbench/configs/<config>.json``: the deployment (catalog, scale,
  generator calibration, rank and storage type, what was cut and assumed);
- ``mfbench/traffic/<traffic>.json``: the job (trainer, its options,
  epochs, warm-up, whether every seed keeps one route);
- ``mfbench/limits/<cell>.json``: the limit of each number the check
  compares, and the readings it was set from;
- ``mfbench/metrics/<metric>.py``: a per-layer metric's reader;
- ``mfbench/algs/<alg>.py``: the driver of the traffic's trainer
  (``alg``): its draw, set-up, job, line parse and check.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(name: str, bench: dict | None = None, pkg: Path = PKG,
              root: Path = ROOT) -> dict:
    """Everything one cell's run needs, read from its files."""
    bench = load_benchmark(root) if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    limits_path = pkg / "limits" / f"{name}.json"

    def metrics(kind):
        return [m for m in bench[kind]
                if name in m.get("workloads", [name])]

    return {
        "name": name,
        "chips": int(cell["chips"]),
        "config": _json(root / configs[cell["config"]]["file"]),
        "traffic": _json(pkg / "traffic" / f"{cell['traffic']}.json"),
        "limits": _json(limits_path) if limits_path.exists() else None,
        "end_to_end": metrics("end_to_end"),
        "per_layer": metrics("per_layer"),
    }


def reader(metric: str, pkg: Path = PKG):
    """The ``read(ctx)`` function of per-layer metric ``metric``, from
    ``metrics/<metric>.py``."""
    path = pkg / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"mfbench.metrics.{metric}", path)
    if spec is None:
        raise KeyError(f"no reader {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(alg: str, pkg: Path = PKG):
    """The driver module of trainer ``alg``, from ``algs/<alg>.py``, loaded
    once a process as ``mfbench.algs.<alg>``."""
    name = f"mfbench.algs.{alg}"
    if name in sys.modules:
        return sys.modules[name]
    path = pkg / "algs" / f"{alg}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no driver for --alg {alg}: {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


def train_config(spec: dict, seed: int, gb: float, iters: int):
    """The program's ``TrainConfig`` of the cell: the configuration's rank,
    storage type and catalog, the traffic's trainer and options."""
    from tpu_mf_torch.config import TrainConfig

    cfg, tr = spec["config"], spec["traffic"]
    return TrainConfig(alg=tr["alg"], dim=int(cfg["dim"]), dtype=cfg["dtype"],
                       nu=int(cfg["nu"]), nv=int(cfg["nv"]), gb=gb,
                       iters=iters, seed=seed, **tr["train_config"])
