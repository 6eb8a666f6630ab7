"""The check's control and planted faults, at a cell's own size, on the
card: readings that set the upper end of each limit in
``limits/<cell>.json``.

    python3 mfbench/control.py --workload <cell> --seeds 11,12,13

For each seed the cell's driver (``algs/<alg>.py: readings``) makes the
cell's ratings and initial tables, trains the plain reference in the
configuration's precision for one job (what a sound program is held
to), and reads the check's numbers of each stand-in it puts in the
program's place (its docstring lists them), for one job. A step that
returns its state unchanged reads 1 on both norm gaps and needs no run.
One JSON line per seed and stand-in.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--orders", type=int, choices=(0, 1), default=1,
                    help="also read the stand-ins in other update orders")
    args = ap.parse_args(argv)
    from mfbench.run import setup_env

    setup_env()
    import torch

    from mfbench.spec import cell_spec, driver

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    spec = cell_spec(args.workload)
    readings = driver(spec["traffic"]["alg"]).readings
    for seed in (int(s) for s in args.seeds.split(",")):
        for row in readings(spec, seed, orders=bool(args.orders)):
            print(json.dumps({"workload": args.workload, **row}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
