"""Reader and writer for the reference's length-prefixed protobuf block
streams (the port's copy of ``tpu_mf/data/proto.py``).

The reference's on-disk training format is a stream of frames
``[uint32 size][serialized mf.Block]`` — not one ``mf.Blocks`` message
(reference: src/blocks.proto:1-18; frame framing getdata.cc:100-103; reader
plain_read util.h:76-88). Schema:

    message User   { required int32 uid = 1;
                     message Record { required int32 vid = 1;
                                      required float rating = 2; }
                     repeated Record record = 2; }
    message Block  { repeated User user = 1; }

This module implements the wire format directly (varints + fixed32) with no
generated code or protobuf runtime dependency — the schema is three fields.
``read_block_frames`` takes the C++ fast path of ``tpu_mf_torch/native``
where it builds, and this parser otherwise.
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

from tpu_mf_torch.data.coo import RatingsCOO

# Wire tags (field_number << 3 | wire_type)
_TAG_USER = (1 << 3) | 2        # Block.user, length-delimited
_TAG_UID = (1 << 3) | 0         # User.uid, varint
_TAG_RECORD = (2 << 3) | 2      # User.record, length-delimited
_TAG_VID = (1 << 3) | 0         # Record.vid, varint
_TAG_RATING = (2 << 3) | 5      # Record.rating, fixed32 float


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _write_varint(out: bytearray, value: int) -> None:
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def parse_block(buf: bytes) -> Tuple[List[int], List[int], List[float]]:
    """Decode one serialized mf.Block into (uids, vids, ratings) triples."""
    us: List[int] = []
    vs: List[int] = []
    rs: List[float] = []
    pos, end = 0, len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        if tag != _TAG_USER:
            raise ValueError(f"unexpected tag {tag} in Block at {pos}")
        ulen, pos = _read_varint(buf, pos)
        uend = pos + ulen
        uid = 0
        while pos < uend:
            utag, pos = _read_varint(buf, pos)
            if utag == _TAG_UID:
                uid, pos = _read_varint(buf, pos)
            elif utag == _TAG_RECORD:
                rlen, pos = _read_varint(buf, pos)
                rend = pos + rlen
                vid = 0
                rating = 0.0
                while pos < rend:
                    rtag, pos = _read_varint(buf, pos)
                    if rtag == _TAG_VID:
                        vid, pos = _read_varint(buf, pos)
                    elif rtag == _TAG_RATING:
                        (rating,) = struct.unpack_from("<f", buf, pos)
                        pos += 4
                    else:
                        raise ValueError(f"unexpected tag {rtag} in Record")
                us.append(uid)
                vs.append(vid)
                rs.append(rating)
            else:
                raise ValueError(f"unexpected tag {utag} in User")
    return us, vs, rs


def serialize_block(uids: np.ndarray, vids: np.ndarray, ratings: np.ndarray) -> bytes:
    """Encode user-grouped ratings as one mf.Block (users in uid order of
    first appearance; consecutive equal uids merge into one User message)."""
    out = bytearray()
    i, n = 0, len(uids)
    while i < n:
        uid = int(uids[i])
        j = i
        while j < n and int(uids[j]) == uid:
            j += 1
        user = bytearray()
        _write_varint(user, _TAG_UID)
        _write_varint(user, uid)
        for k in range(i, j):
            rec = bytearray()
            _write_varint(rec, _TAG_VID)
            _write_varint(rec, int(vids[k]))
            _write_varint(rec, _TAG_RATING)
            rec += struct.pack("<f", float(ratings[k]))
            _write_varint(user, _TAG_RECORD)
            _write_varint(user, len(rec))
            user += rec
        _write_varint(out, _TAG_USER)
        _write_varint(out, len(user))
        out += user
        i = j
    return bytes(out)


def iter_frames(path: str) -> Iterator[bytes]:
    """Yield raw serialized Block payloads from a length-prefixed stream
    (framing: reference getdata.cc:100-103 / util.h:76-88)."""
    with open(path, "rb") as f:
        while True:
            hdr = f.read(4)
            if len(hdr) < 4:
                return
            (size,) = struct.unpack("<I", hdr)
            payload = f.read(size)
            if len(payload) < size:
                raise EOFError(f"truncated frame in {path}")
            yield payload


def read_block_frames(
    path: str, nu: Optional[int] = None, nv: Optional[int] = None
) -> RatingsCOO:
    """Load a reference-format protobuf block stream into COO."""
    from tpu_mf_torch.native import parse_frames_native

    coo = parse_frames_native(path)
    if coo is not None:
        us, vs, rs = coo
        nu = nu if nu is not None else (int(us.max()) + 1 if len(us) else 0)
        nv = nv if nv is not None else (int(vs.max()) + 1 if len(vs) else 0)
        return RatingsCOO(us, vs, rs, nu, nv)
    us: List[int] = []
    vs: List[int] = []
    rs: List[float] = []
    for payload in iter_frames(path):
        bu, bv, br = parse_block(payload)
        us += bu
        vs += bv
        rs += br
    u = np.asarray(us, np.int32)
    v = np.asarray(vs, np.int32)
    r = np.asarray(rs, np.float32)
    nu = nu if nu is not None else (int(u.max()) + 1 if len(u) else 0)
    nv = nv if nv is not None else (int(v.max()) + 1 if len(v) else 0)
    return RatingsCOO(u, v, r, nu, nv)


def write_block_frames(
    path: str, ds: RatingsCOO, users_per_block: int = 1000
) -> None:
    """Write COO ratings as a reference-compatible block stream.

    Groups ratings by user and packs ``users_per_block`` users per Block
    (reference default 1000: getdata.cc:19, packing loop getdata.cc:82-126).
    """
    order = np.argsort(ds.u, kind="stable")
    u, v, r = ds.u[order], ds.v[order], ds.r[order]
    # boundaries where uid changes
    if len(u):
        change = np.nonzero(np.diff(u))[0] + 1
        starts = np.concatenate([[0], change])
    else:
        starts = np.zeros(0, np.int64)
    with open(path, "wb") as f:
        for b0 in range(0, len(starts), users_per_block):
            s = starts[b0]
            e = (
                starts[b0 + users_per_block]
                if b0 + users_per_block < len(starts)
                else len(u)
            )
            payload = serialize_block(u[s:e], v[s:e], r[s:e])
            f.write(struct.pack("<I", len(payload)))
            f.write(payload)
