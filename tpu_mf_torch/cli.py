"""Command-line trainer for the PyTorch port, with the flags and defaults of
``tpu_mf.cli`` (the reference's ``./mf`` flags) plus ``--device``.

Usage:
    python -m tpu_mf_torch.cli --alg mf --train train.csv --test test.csv \
        --dim 64 --iter 15 --result model

``--alg mf``, ``--alg dpmf`` and ``--alg admf`` (which needs ``--valid``)
run on one device, in memory or out of core (``--stream``: the training
file is never loaded whole; dims come from ``--nu/--nv`` or one scan of
it), and ``--measure 1`` prints recall, precision and ndcg at 10 after
training. ``--mesh > 1`` raises ``NotImplementedError`` naming the ROADMAP
item that ports it.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from tpu_mf_torch.config import TrainConfig

def build_parser() -> argparse.ArgumentParser:
    """The flags and defaults of ``tpu_mf.cli`` (reference: src/main.cc:
    106-137), plus ``--device``."""
    p = argparse.ArgumentParser(
        prog="tpu-mf-torch",
        description="Matrix factorization trainer, PyTorch port (SGD, "
                    "DP-SGLD, adaptive regularization)",
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
    p.add_argument("--fly", type=int, default=8,
                   help="host prefetch depth of --stream's per-batch path "
                        "(reference: TBB pipeline tokens)")
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
    if cfg.resume and not cfg.result:
        print("--resume requires --result (checkpoint prefix)", file=sys.stderr)
        return 1

    import numpy as np
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"--device {args.device}: no CUDA device is available "
              "(use --device cpu for the CPU path)", file=sys.stderr)
        return 1

    from tpu_mf_torch.data.textfmt import read_any
    from tpu_mf_torch.io.checkpoint import load_mf_binary, save_mf_binary, save_npz

    if args.stream:
        # out of core: never load the training file; table sizes come from
        # --nu/--nv or one bounded-memory scan of it
        if cfg.nu and cfg.nv:
            nu, nv = cfg.nu, cfg.nv
        else:
            from tpu_mf_torch.io.stream import scan_dims

            nu, nv, _ = scan_dims(cfg.train)
        train_ds = None
    else:
        train_ds = read_any(cfg.train, nu=cfg.nu or None, nv=cfg.nv or None)
        nu, nv = train_ds.nu, train_ds.nv
    test_ds = read_any(cfg.test, nu=nu, nv=nv) if cfg.test else None

    def report_ranking(params):
        # --measure 1: ranking quality beside RMSE (the reference's
        # --measure only "supports RMSE", main.cc:33; this is additive)
        if cfg.measure != 1 or test_ds is None:
            return
        from tpu_mf_torch.models.eval import ranking_metrics

        m = ranking_metrics(params, test_ds, train_ds=train_ds, k=10)
        print(f"recall@{m['k']}={m['recall@k']:f}\t"
              f"precision@{m['k']}={m['precision@k']:f}\t"
              f"ndcg@{m['k']}={m['ndcg@k']:f}\tn_users={m['n_users']}")

    if cfg.alg == "dpmf":
        return _main_dpmf(cfg, train_ds, test_ds, device, args.stream,
                          report_ranking)
    if cfg.alg == "admf":
        return _main_admf(cfg, train_ds, test_ds, nu, nv, device,
                          args.stream, report_ranking)

    from tpu_mf_torch.train.loop import train_mf, train_mf_stream

    params0 = None
    if cfg.model:
        # warm start adopts the checkpoint's lambda (model.cc:81)
        params0, lam = load_mf_binary(cfg.model, gb=cfg.gb, device=device)
        cfg = dataclasses.replace(cfg, lam=lam)
    if args.stream:
        params = train_mf_stream(cfg, cfg.train, test_ds=test_ds,
                                 params=params0, nu=nu, nv=nv, device=device)
    else:
        params = train_mf(cfg, train_ds, test_ds=test_ds, params=params0,
                          device=device)
    report_ranking(params)
    if cfg.result:
        if cfg.result.endswith(".npz"):
            save_npz(cfg.result, params, lam=np.float32(cfg.lam))
        else:
            save_mf_binary(f"{cfg.result}_{cfg.iters}", params, cfg.lam)
    return 0


def _main_dpmf(cfg, train_ds, test_ds, device, stream, report_ranking
               ) -> int:
    """--alg dpmf: ``--model`` is a hyper-only warm start (main.cc:57);
    checkpoints on the reference's cadence and ``{result}_{iters}``."""
    import torch

    from tpu_mf_torch.io.checkpoint import load_dpmf_hyper, save_dpmf_binary
    from tpu_mf_torch.models.dpmf import init_dpmf
    from tpu_mf_torch.train.loop import (
        _storage_dtype,
        train_dpmf,
        train_dpmf_stream,
    )

    state0 = hyper0 = None
    if cfg.model:
        hyper0 = load_dpmf_hyper(cfg.model)
    if cfg.model and not stream:
        lr, lub, lvb, lu, lv = hyper0
        state0 = init_dpmf(train_ds, cfg.dim, cfg.gb,
                           torch.Generator().manual_seed(cfg.seed), device,
                           dtype=_storage_dtype(cfg))
        f32 = dict(dtype=torch.float32, device=device)
        state0 = state0._replace(
            lambda_r=torch.tensor(lr, **f32),
            lambda_ub=torch.tensor(lub, **f32),
            lambda_vb=torch.tensor(lvb, **f32),
            lambda_u=torch.as_tensor(lu).to(**f32),
            lambda_v=torch.as_tensor(lv).to(**f32))

    def save_fn(state, rnd):
        if cfg.result:
            save_dpmf_binary(f"{cfg.result}_{rnd}", state.params,
                             float(state.lambda_r), float(state.lambda_ub),
                             float(state.lambda_vb),
                             state.lambda_u.cpu().numpy(),
                             state.lambda_v.cpu().numpy())

    if stream:
        state = train_dpmf_stream(cfg, cfg.train, test_ds=test_ds,
                                  save_fn=save_fn, hyper0=hyper0,
                                  device=device)
    else:
        state = train_dpmf(cfg, train_ds, test_ds=test_ds, state=state0,
                           save_fn=save_fn, device=device)
    report_ranking(state.params)
    save_fn(state, cfg.iters)
    return 0


def _main_admf(cfg, train_ds, test_ds, nu, nv, device, stream,
               report_ranking) -> int:
    """--alg admf: needs --valid; --model is not read (as in tpu_mf);
    writes {result}_{iters} as the reference MF binary with lam_u."""
    from tpu_mf_torch.data.textfmt import read_any
    from tpu_mf_torch.io.checkpoint import save_mf_binary
    from tpu_mf_torch.train.loop import train_admf, train_admf_stream

    if not cfg.valid:
        print("admf requires --valid", file=sys.stderr)
        return 1
    valid_ds = read_any(cfg.valid, nu=nu, nv=nv)
    if stream:
        state = train_admf_stream(cfg, cfg.train, valid_ds, test_ds=test_ds,
                                  device=device)
    else:
        state = train_admf(cfg, train_ds, valid_ds, test_ds=test_ds,
                           device=device)
    report_ranking(state.params)
    if cfg.result:
        save_mf_binary(f"{cfg.result}_{cfg.iters}", state.params,
                       float(state.lam_u))
    return 0


if __name__ == "__main__":
    sys.exit(main())
