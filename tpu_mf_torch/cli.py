"""Command-line trainer for the PyTorch port, with the flags and defaults of
``tpu_mf.cli`` (the reference's ``./mf`` flags) plus ``--device``.

Usage:
    python -m tpu_mf_torch.cli --alg mf --train train.csv --test test.csv \
        --dim 64 --iter 15 --result model

Only ``--alg mf`` on one device, in memory, is ported so far; the other
modes raise ``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from tpu_mf.config import TrainConfig

# Modes the port accepts but does not run yet, and the ROADMAP item for each.
_NOT_PORTED = {
    "dpmf": "--alg dpmf (ROADMAP Queue 1 item 7)",
    "admf": "--alg admf (ROADMAP Queue 1 item 8)",
    "stream": "--stream (ROADMAP Queue 1 item 9)",
    "measure": "--measure 1 ranking metrics (ROADMAP Queue 1 item 11)",
}


def build_parser() -> argparse.ArgumentParser:
    """The flags and defaults of ``tpu_mf.cli`` (reference: src/main.cc:
    106-137), plus ``--device``."""
    p = argparse.ArgumentParser(
        prog="tpu-mf-torch",
        description="Matrix factorization trainer, PyTorch port (SGD)",
    )
    p.add_argument("--train", help="training data file (any supported format)")
    p.add_argument("--test", help="test data file")
    p.add_argument("--valid", help="validation data file (admf)")
    p.add_argument("--result", help="checkpoint output prefix")
    p.add_argument("--model", help="warm-start checkpoint to load")
    p.add_argument("--alg", default="mf", choices=["mf", "dpmf", "admf"])
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--iter", type=int, default=15, dest="iters")
    p.add_argument("--nu", type=int, default=0)
    p.add_argument("--nv", type=int, default=0)
    p.add_argument("--fly", type=int, default=8, help="accepted for parity")
    p.add_argument("--stride", type=int, default=2, help="accepted for parity")
    p.add_argument("--eta", type=float, default=2e-2)
    p.add_argument("--lambda", type=float, default=5e-3, dest="lam")
    p.add_argument("--gam", type=float, default=1.0)
    p.add_argument("--bias", type=float, default=2.76, dest="gb")
    p.add_argument("--mineta", type=float, default=1e-13)
    p.add_argument("--epsilon", type=float, default=0.0)
    p.add_argument("--tau", type=int, default=0)
    p.add_argument("--hypera", type=float, default=1.0)
    p.add_argument("--hyperb", type=float, default=100.0)
    p.add_argument("--temp", type=float, default=1.0)
    p.add_argument("--noise_size", type=int, default=2_000_000_000,
                   help="accepted for parity")
    p.add_argument("--eta_reg", type=float, default=2e-3)
    p.add_argument("--loss", type=int, default=0, choices=[0, 1])
    p.add_argument("--measure", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=4096)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--mesh", type=int, default=1,
                   help="devices for diagonal-block DSGD (1 = one device)")
    p.add_argument("--no-pallas", action="store_true",
                   help="disable the fused kernels (batched path only)")
    p.add_argument("--no-dense", action="store_true",
                   help="disable the dense-cell kernel")
    p.add_argument("--stream", action="store_true",
                   help="stream the training file from disk each epoch")
    p.add_argument("--metrics", metavar="PATH",
                   help="append JSONL metrics per epoch")
    p.add_argument("--trace", metavar="DIR",
                   help="write a torch.profiler trace to DIR/trace.json")
    p.add_argument("--resume", action="store_true",
                   help="checkpoint state each round and resume from it")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, cuda:N or cpu)")
    return p


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    return TrainConfig(
        train=args.train, test=args.test, valid=args.valid,
        result=args.result, model=args.model, alg=args.alg,
        dim=args.dim, iters=args.iters, nu=args.nu, nv=args.nv,
        fly=args.fly, stride=args.stride, eta=args.eta, lam=args.lam,
        gam=args.gam, gb=args.gb, mineta=args.mineta, epsilon=args.epsilon,
        tau=args.tau, hypera=args.hypera, hyperb=args.hyperb, temp=args.temp,
        noise_size=args.noise_size, eta_reg=args.eta_reg, loss=args.loss,
        measure=args.measure, batch_size=args.batch_size, seed=args.seed,
        dtype=args.dtype, mesh=args.mesh, use_pallas=not args.no_pallas,
        use_dense=not args.no_dense,
        metrics=args.metrics, trace=args.trace, resume=args.resume,
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    if cfg.train is None:
        print("Note that train_data is not optional!", file=sys.stderr)
        build_parser().print_help()
        return 1
    why = [_NOT_PORTED[k] for k, on in (
        ("dpmf", cfg.alg == "dpmf"), ("admf", cfg.alg == "admf"),
        ("stream", args.stream), ("measure", cfg.measure == 1)) if on]
    if why:
        raise NotImplementedError(f"tpu_mf_torch does not port {why[0]} yet")

    import numpy as np
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"--device {args.device}: no CUDA device is available "
              "(use --device cpu for the CPU path)", file=sys.stderr)
        return 1

    from tpu_mf.data.textfmt import read_any
    from tpu_mf_torch.io.checkpoint import load_mf_binary, save_mf_binary, save_npz
    from tpu_mf_torch.train.loop import train_mf

    train_ds = read_any(cfg.train, nu=cfg.nu or None, nv=cfg.nv or None)
    test_ds = (read_any(cfg.test, nu=train_ds.nu, nv=train_ds.nv)
               if cfg.test else None)
    params0 = None
    if cfg.model:
        # warm start adopts the checkpoint's lambda (model.cc:81)
        params0, lam = load_mf_binary(cfg.model, gb=cfg.gb, device=device)
        cfg = dataclasses.replace(cfg, lam=lam)
    params = train_mf(cfg, train_ds, test_ds=test_ds, params=params0,
                      device=device)
    if cfg.result:
        if cfg.result.endswith(".npz"):
            save_npz(cfg.result, params, lam=np.float32(cfg.lam))
        else:
            save_mf_binary(f"{cfg.result}_{cfg.iters}", params, cfg.lam)
    return 0


if __name__ == "__main__":
    sys.exit(main())
