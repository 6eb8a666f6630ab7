"""Data preparation tool — the reference's ``getdata`` rebuilt (C13/C14);
the port's copy of ``tpu_mf/tools/prepare.py``.

Reference: data/getdata.cc (modes ``userwise`` and ``protobuf``,
getdata.cc:128-173) and the rawToProto*.py scripts. Converts between:

* raw rating-wise text (``n`` then ``u,v,r,t`` lines),
* userwise text (``uid:`` + ``vid,rating`` lines),
* the length-prefixed protobuf block stream the trainer consumes,
* MovieLens native files,

with shuffling, train/test/valid splitting, and user-grouped block packing
(``--size`` users per block, reference default 1000: getdata.cc:19). The
reference's out-of-core shuffle variant (rawToProto_xlarge.py: split into
chunks, shuffle each, round-robin merge) is ``--mem-limit N`` here
(tools/xlarge.py): never more than N ratings in host RAM, any input format,
optional splitting on the fly.

Usage:
    python -m tpu_mf_torch.tools.prepare -r ratings.dat -w train.pb \\
        --method protobuf --size 1000 [--split 0.1] [--seed 0]
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu-mf-torch-prepare",
        description="convert/shuffle/split rating data (reference: getdata)",
    )
    p.add_argument("-r", "--read", required=True, help="input ratings file (any format)")
    p.add_argument("-w", "--write", required=True, help="output file (prefix if --split)")
    p.add_argument(
        "--method",
        default="protobuf",
        choices=["protobuf", "userwise", "raw"],
        help="output format (reference: --method userwise|protobuf)",
    )
    p.add_argument("--size", type=int, default=1000,
                   help="users per protobuf block (reference default 1000)")
    p.add_argument("--split", type=float, default=0.0,
                   help="fraction < 1: held-out split, writes "
                        "<out>.train/.test; integer N >= 2: the reference "
                        "getdata's N-way mode (getdata.cc:128-173) — shard "
                        "the shuffled ratings into N user-grouped files "
                        "<out>.part0..N-1")
    p.add_argument("--valid", type=float, default=0.0,
                   help="validation fraction (from the train part)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-shuffle", action="store_true")
    p.add_argument(
        "--mem-limit", type=int, default=0, metavar="N",
        help="out-of-core mode: never hold more than N ratings in host RAM "
             "(chunked shuffle + round-robin merge, reference: "
             "rawToProto_xlarge.py); 0 = in-memory",
    )
    return p


def _write(path: str, ds, method: str, size: int) -> None:
    from tpu_mf_torch.data import proto, textfmt

    if method == "protobuf":
        proto.write_block_frames(path, ds, users_per_block=size)
    elif method == "userwise":
        textfmt.write_userwise(path, ds)
    else:
        textfmt.write_raw(path, ds)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from tpu_mf_torch.data.textfmt import read_any

    if args.mem_limit > 0:
        if args.no_shuffle:
            print("--mem-limit implies shuffling; drop --no-shuffle",
                  file=sys.stderr)
            return 1
        from tpu_mf_torch.tools.xlarge import xlarge_convert

        counts = xlarge_convert(
            args.read, args.write, method=args.method,
            users_per_block=args.size, mem_limit=args.mem_limit,
            split=args.split, valid=args.valid, seed=args.seed,
        )
        print(f"wrote {args.write} parts: {counts} ratings (out-of-core, "
              f"<= {args.mem_limit} ratings in RAM)")
        return 0

    try:
        ds = read_any(args.read)
    except (OSError, ValueError) as e:
        print(f"error: cannot read {args.read}: {e}", file=sys.stderr)
        return 1
    if not args.no_shuffle:
        # Reference shuffles the raw ratings (4x random_shuffle,
        # getdata.cc:31-34); one Fisher-Yates pass is equivalent.
        ds = ds.shuffled(args.seed)

    if args.split >= 2.0 and args.split == int(args.split):
        # Reference getdata --split N: shard the shuffled ratings into N
        # chunks by position and write each user-grouped (getdata.cc:37-80:
        # read_raw shuffles, userwise groups each chunk by user).
        import numpy as np

        from tpu_mf_torch.data.coo import RatingsCOO

        parts = np.array_split(np.arange(len(ds)), int(args.split))
        for i, idx in enumerate(parts):
            part = RatingsCOO(ds.u[idx], ds.v[idx], ds.r[idx], ds.nu, ds.nv)
            _write(f"{args.write}.part{i}", part, args.method, args.size)
            print(f"wrote {args.write}.part{i} ({len(part)} ratings)")
        return 0

    if args.split > 0.0:
        train, test = ds.split(args.split, seed=args.seed + 1)
        if args.valid > 0.0:
            train, valid = train.split(args.valid, seed=args.seed + 2)
            _write(f"{args.write}.valid", valid, args.method, args.size)
            print(f"wrote {args.write}.valid ({len(valid)} ratings)")
        _write(f"{args.write}.train", train, args.method, args.size)
        _write(f"{args.write}.test", test, args.method, args.size)
        print(f"wrote {args.write}.train ({len(train)}) and .test ({len(test)})")
    else:
        _write(args.write, ds, args.method, args.size)
        print(f"wrote {args.write} ({len(ds)} ratings, nu={ds.nu}, nv={ds.nv})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
