"""Experiment grid runner — the reference's ``run.py`` rebuilt (C15);
the port's counterpart of ``tpu_mf/tools/grid.py``, on the port's trainers.

Reference: src/run.py — nested loops over eta/eta_reg/temp/gam/dim shelling
out to ``./mf``, with hard-coded Netflix/Yahoo dataset shapes. Here the grid
is declared as CLI flags (comma-separated value lists), each run invokes the
in-process trainer (no shell round trip), and every configuration's per-epoch
log lines are printed under a header echoing the full flag set — the same
reproducibility convention as the reference's printed command lines.

Usage:
    python -m tpu_mf_torch.tools.grid --alg mf --train train.pb --test test.pb \\
        --eta 2.4e-2,4e-2 --dim 16,64 --lambda 4e-2 --iter 10 [--device cpu]
"""

from __future__ import annotations

import argparse
import itertools
import sys


GRID_FLAGS = ["eta", "eta_reg", "temp", "gam", "dim", "lam", "batch_size"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu-mf-torch-grid",
        description="grid-search runner (reference: src/run.py)",
    )
    p.add_argument("--train", required=True)
    p.add_argument("--test")
    p.add_argument("--valid")
    p.add_argument("--alg", default="mf", choices=["mf", "dpmf", "admf"])
    p.add_argument("--iter", type=int, default=10, dest="iters")
    p.add_argument("--nu", type=int, default=0)
    p.add_argument("--nv", type=int, default=0)
    p.add_argument("--bias", type=float, default=2.76)
    p.add_argument("--mineta", type=float, default=1e-13)
    p.add_argument("--epsilon", type=float, default=0.0)
    p.add_argument("--tau", type=int, default=0)
    p.add_argument("--hypera", type=float, default=1.0)
    p.add_argument("--hyperb", type=float, default=100.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--result", help="checkpoint prefix; grid point id appended")
    # Grid axes: comma-separated lists (reference loops run.py:32-36).
    p.add_argument("--eta", default="2e-2")
    p.add_argument("--eta_reg", default="2e-3")
    p.add_argument("--temp", default="1.0")
    p.add_argument("--gam", default="1.0")
    p.add_argument("--dim", default="128")
    p.add_argument("--lambda", default="5e-3", dest="lam")
    p.add_argument("--batch_size", default="4096")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, cuda:N or cpu)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print(f"--device {args.device}: no CUDA device is available "
              "(use --device cpu for the CPU path)", file=sys.stderr)
        return 1
    from tpu_mf_torch.config import TrainConfig
    from tpu_mf_torch.data.textfmt import read_any
    from tpu_mf_torch.train.loop import train_admf, train_dpmf, train_mf

    nu = args.nu or None
    nv = args.nv or None
    train_ds = read_any(args.train, nu=nu, nv=nv)
    test_ds = (
        read_any(args.test, nu=train_ds.nu, nv=train_ds.nv) if args.test else None
    )
    valid_ds = (
        read_any(args.valid, nu=train_ds.nu, nv=train_ds.nv) if args.valid else None
    )

    axes = {}
    for name in GRID_FLAGS:
        raw = str(getattr(args, name))
        cast = int if name in ("dim", "batch_size") else float
        axes[name] = [cast(x) for x in raw.split(",")]

    for point in itertools.product(*axes.values()):
        pv = dict(zip(axes.keys(), point))
        tag = "_".join(f"{k}{v:g}" if isinstance(v, float) else f"{k}{v}"
                       for k, v in pv.items())
        cfg = TrainConfig(
            alg=args.alg, iters=args.iters, gb=args.bias, mineta=args.mineta,
            epsilon=args.epsilon, tau=args.tau, hypera=args.hypera,
            hyperb=args.hyperb, seed=args.seed,
            eta=pv["eta"], eta_reg=pv["eta_reg"], temp=pv["temp"],
            gam=pv["gam"], dim=pv["dim"], lam=pv["lam"],
            batch_size=pv["batch_size"],
            result=f"{args.result}_{tag}" if args.result else None,
        )
        # Echo the full configuration, as the reference prints its command
        # line before each run (run.py:37).
        print(f"### {args.alg} {tag}")
        sys.stdout.flush()
        if args.alg == "mf":
            train_mf(cfg, train_ds, test_ds=test_ds, device=args.device)
        elif args.alg == "dpmf":
            train_dpmf(cfg, train_ds, test_ds=test_ds, device=args.device)
        else:
            if valid_ds is None:
                print("admf requires --valid", file=sys.stderr)
                return 1
            train_admf(cfg, train_ds, valid_ds, test_ds=test_ds,
                       device=args.device)
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
