"""Text rating formats of the reference ETL chain (the port's copy of
``tpu_mf/data/textfmt.py``).

Three formats exist in the reference's data pipeline (reference:
data/getdata.cc, data/rawToProto.py):

1. *raw* rating-wise: first line ``n``, then ``u,v,r,t`` lines
   (reference: getdata.cc:21-37 read_raw).
2. *userwise*: ``uid:`` header lines followed by ``vid,rating`` lines
   (reference: getdata.cc:39-51 write_by_dict).
3. MovieLens native files: ``u \\t v \\t r \\t ts`` (ML-100K u.data) and
   ``u::v::r::ts`` (ML-1M/10M) — the upstream sources the reference's raw
   format is derived from.

``read_any`` detects the format, including the reference's protobuf frames
(``data/proto.py``), and gives the same COO as ``tpu_mf``'s reader;
``write_raw`` and ``write_userwise`` write the same bytes as ``tpu_mf``'s
(``tests/test_torch_copies.py``).
"""

from __future__ import annotations

import numpy as np

from tpu_mf_torch.data.coo import RatingsCOO


def _finish(u, v, r, nu, nv) -> RatingsCOO:
    u = np.asarray(u, np.int32)
    v = np.asarray(v, np.int32)
    r = np.asarray(r, np.float32)
    if nu is None:
        nu = int(u.max()) + 1 if len(u) else 0
    if nv is None:
        nv = int(v.max()) + 1 if len(v) else 0
    return RatingsCOO(u, v, r, nu, nv)


def read_raw(path: str, nu=None, nv=None) -> RatingsCOO:
    """Read the reference's raw format: ``n`` then ``u,v,r,t`` lines
    (reference: getdata.cc:21-37)."""
    with open(path) as f:
        n = int(f.readline())
        data = np.loadtxt(f, delimiter=",", max_rows=n, ndmin=2)
    return _finish(data[:, 0], data[:, 1], data[:, 2], nu, nv)


def write_raw(path: str, ds: RatingsCOO) -> None:
    with open(path, "w") as f:
        f.write(f"{len(ds)}\n")
        for u, v, r in zip(ds.u, ds.v, ds.r):
            f.write(f"{u},{v},{r:.9g},0\n")


def read_userwise(path: str, nu=None, nv=None) -> RatingsCOO:
    """Read userwise text: ``uid:`` then ``vid,rating`` lines
    (reference: getdata.cc:39-51, consumed by get_message getdata.cc:82-126)."""
    us, vs, rs = [], [], []
    uid = -1
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.endswith(":"):
                uid = int(line[:-1])
            else:
                vid_s, r_s = line.split(",")
                us.append(uid)
                vs.append(int(vid_s))
                rs.append(float(r_s))
    return _finish(us, vs, rs, nu, nv)


def write_userwise(path: str, ds: RatingsCOO) -> None:
    order = np.argsort(ds.u, kind="stable")
    with open(path, "w") as f:
        last = None
        for i in order:
            u = int(ds.u[i])
            if u != last:
                f.write(f"{u}:\n")
                last = u
            f.write(f"{int(ds.v[i])},{float(ds.r[i]):.9g}\n")


def read_movielens(path: str, sep=None, one_indexed=True, nu=None, nv=None) -> RatingsCOO:
    """Read MovieLens rating files (u.data tab-separated or ratings.dat '::')."""
    if sep is None:
        with open(path) as f:
            first = f.readline()
        sep = "::" if "::" in first else ("\t" if "\t" in first else ",")
    us, vs, rs = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(sep)
            us.append(int(parts[0]))
            vs.append(int(parts[1]))
            rs.append(float(parts[2]))
    u = np.asarray(us, np.int64)
    v = np.asarray(vs, np.int64)
    if one_indexed:
        u -= 1
        v -= 1
    return _finish(u, v, np.asarray(rs), nu, nv)


def detect_format(path: str) -> str:
    """Sniff which on-disk format a ratings file uses.

    Returns one of {"proto", "raw", "userwise", "movielens"}.
    """
    with open(path, "rb") as f:
        head = f.read(256)
    try:
        text = head.decode("utf-8")
    except UnicodeDecodeError:
        return "proto"
    lines = text.splitlines()
    if not lines:
        return "raw"
    first = lines[0].strip()
    if "::" in first or "\t" in first:
        return "movielens"
    if first.endswith(":"):
        return "userwise"
    if "," in first:
        return "movielens"  # headerless u,v,r[,t] csv
    try:
        int(first)
        return "raw"
    except ValueError:
        return "userwise"


def read_any(path: str, nu=None, nv=None) -> RatingsCOO:
    """Load a ratings file in any supported format (auto-detected)."""
    fmt = detect_format(path)
    if fmt == "proto":
        from tpu_mf_torch.data.proto import read_block_frames

        return read_block_frames(path, nu=nu, nv=nv)
    if fmt == "raw":
        return read_raw(path, nu, nv)
    if fmt == "userwise":
        return read_userwise(path, nu, nv)
    return read_movielens(path, one_indexed=False, nu=nu, nv=nv)
