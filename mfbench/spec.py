"""Finding a cell's parts by name: ``BENCHMARK.json`` names the cell's
configuration and traffic mix, and each lives in a file of its own.

- ``mfbench/configs/<config>.json``: the deployment (catalog, scale,
  generator calibration, rank and storage type, what was cut and assumed);
- ``mfbench/traffic/<traffic>.json``: the job (trainer, its options,
  epochs, warm-up, whether every seed keeps one route);
- ``mfbench/limits/<cell>.json``: the limit of each number the check
  compares, and the readings it was set from;
- ``mfbench/metrics/<metric>.py``: a per-layer metric's reader.
"""

from __future__ import annotations

import importlib.util
import json
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
