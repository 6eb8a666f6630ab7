"""Chunked streaming readers for every supported rating format (the port's
copy of ``tpu_mf/data/streamfmt.py``).

The in-memory loaders (data/textfmt.py, data/proto.py) materialize whole
files; everything out-of-core — ``--stream`` training, dimension scans, and
the xlarge ETL re-shard — builds on this module instead: ``iter_ratings``
yields bounded (u, v, r) numpy chunks from any format without ever holding
the dataset in host RAM.

Reference counterparts: the TBB read pipeline consumes length-prefixed
protobuf frames only (src/mf.h:6-34); the out-of-core ETL splits raw text
(data/rawToProto_xlarge.py). Here one reader covers raw / userwise /
MovieLens text and proto frames, auto-detected.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from tpu_mf_torch.data.proto import iter_frames, parse_block
from tpu_mf_torch.data.textfmt import detect_format

Chunk = Tuple[np.ndarray, np.ndarray, np.ndarray]  # (u i32, v i32, r f32)


def _emit(us, vs, rs) -> Chunk:
    return (
        np.asarray(us, np.int32),
        np.asarray(vs, np.int32),
        np.asarray(rs, np.float32),
    )


def _iter_proto(path: str, chunk: int) -> Iterator[Chunk]:
    us: list = []
    vs: list = []
    rs: list = []
    for payload in iter_frames(path):
        fu, fv, fr = parse_block(payload)
        us += fu
        vs += fv
        rs += fr
        while len(us) >= chunk:  # a single frame may exceed the chunk bound
            yield _emit(us[:chunk], vs[:chunk], rs[:chunk])
            del us[:chunk], vs[:chunk], rs[:chunk]
    if us:
        yield _emit(us, vs, rs)


def _iter_raw(path: str, chunk: int) -> Iterator[Chunk]:
    with open(path) as f:
        f.readline()  # count header; stream to EOF regardless
        us, vs, rs = [], [], []
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(",")
            us.append(int(parts[0]))
            vs.append(int(parts[1]))
            rs.append(float(parts[2]))
            if len(us) >= chunk:
                yield _emit(us, vs, rs)
                us, vs, rs = [], [], []
        if us:
            yield _emit(us, vs, rs)


def _iter_userwise(path: str, chunk: int) -> Iterator[Chunk]:
    uid = -1
    us: list = []
    vs: list = []
    rs: list = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.endswith(":"):
                uid = int(line[:-1])
                continue
            vid_s, r_s = line.split(",")
            us.append(uid)
            vs.append(int(vid_s))
            rs.append(float(r_s))
            if len(us) >= chunk:
                yield _emit(us, vs, rs)
                us, vs, rs = [], [], []
    if us:
        yield _emit(us, vs, rs)


def _iter_movielens(path: str, chunk: int) -> Iterator[Chunk]:
    # Ids are taken VERBATIM, matching the in-memory reader (read_any ->
    # read_movielens(one_indexed=False)): the streamed and in-memory paths
    # must agree on every file. (A silent -1 shift here made --stream turn
    # 0-based csv ids negative.) 1-based MovieLens exports simply leave
    # row 0 unused.
    with open(path) as f:
        first = f.readline()
    sep = "::" if "::" in first else ("\t" if "\t" in first else ",")
    with open(path) as f:
        us, vs, rs = [], [], []
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(sep)
            us.append(int(parts[0]))
            vs.append(int(parts[1]))
            rs.append(float(parts[2]))
            if len(us) >= chunk:
                yield _emit(us, vs, rs)
                us, vs, rs = [], [], []
        if us:
            yield _emit(us, vs, rs)


def iter_ratings(path: str, chunk: int = 1 << 18) -> Iterator[Chunk]:
    """Yield (u, v, r) numpy chunks of <= ``chunk`` ratings from any format."""
    fmt = detect_format(path)
    it = {
        "proto": _iter_proto,
        "raw": _iter_raw,
        "userwise": _iter_userwise,
        "movielens": _iter_movielens,
    }[fmt]
    return it(path, chunk)


def scan_stats(path: str, chunk: int = 1 << 18) -> Tuple[int, int, int]:
    """(nu, nv, n_ratings) from one bounded-memory pass over any format."""
    max_u = -1
    max_v = -1
    n = 0
    for u, v, _ in iter_ratings(path, chunk):
        if len(u):
            max_u = max(max_u, int(u.max()))
            max_v = max(max_v, int(v.max()))
            n += len(u)
    return max_u + 1, max_v + 1, n


def scan_profile(path: str, chunk: int = 1 << 18):
    """One bounded-memory pass: (nu, nv, n, user_counts, item_counts, rsum).

    The counts/mean are what the DPMF initializer needs (inverse-frequency
    weights, reference: model.cc:263-297) without materializing the file.
    """
    max_u = -1
    max_v = -1
    n = 0
    rsum = 0.0
    uc = np.zeros(0, np.int64)
    vc = np.zeros(0, np.int64)
    for u, v, r in iter_ratings(path, chunk):
        if not len(u):
            continue
        max_u = max(max_u, int(u.max()))
        max_v = max(max_v, int(v.max()))
        n += len(u)
        rsum += float(r.sum())
        if len(uc) <= max_u:
            uc = np.concatenate([uc, np.zeros(max_u + 1 - len(uc), np.int64)])
        if len(vc) <= max_v:
            vc = np.concatenate([vc, np.zeros(max_v + 1 - len(vc), np.int64)])
        np.add.at(uc, u, 1)
        np.add.at(vc, v, 1)
    return max_u + 1, max_v + 1, n, uc, vc, rsum
