"""Native (C++) data plane: the ctypes frame parser and writer (the port's
copy of ``tpu_mf/native``).

``mfdata.cpp`` parses and writes the reference's length-prefixed protobuf
block streams at memory speed. It is built at first use with the host C++
compiler into ``build/libmfdata-<hash>.so`` beside the package (the hash
covers the source and the flags), as ``ops/_build.py`` builds the CUDA
kernels. Where it cannot be built or loaded, the callers use the
pure-Python codec (``data/proto.py``), and this module says so once on
standard error. This is host parsing: no device path depends on it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "mfdata.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
CXX_FLAGS = ("-std=c++17", "-O3", "-fPIC", "-shared")

_lock = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False


def _build() -> Path:
    """Compile ``mfdata.cpp`` unless an up-to-date library exists."""
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    key = SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
    out = BUILD_DIR / f"libmfdata-{hashlib.sha256(key).hexdigest()[:12]}.so"
    if out.exists():
        return out
    if cxx is None:
        raise RuntimeError("no host C++ compiler (c++ or g++) found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed on {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_TRIED
    with _lock:
        if _LIB_TRIED:
            return _LIB
        _LIB_TRIED = True
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, RuntimeError) as e:
            print(f"# tpu_mf_torch.native: the frame parser could not be "
                  f"built or loaded ({str(e).splitlines()[0]}); using the "
                  "pure-Python codec", file=sys.stderr)
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.mfdata_count_frames.restype = ctypes.c_longlong
        lib.mfdata_count_frames.argtypes = [ctypes.c_char_p]
        lib.mfdata_parse_frames.restype = ctypes.c_longlong
        lib.mfdata_parse_frames.argtypes = [
            ctypes.c_char_p, i32p, i32p, f32p, ctypes.c_longlong]
        lib.mfdata_write_frames.restype = ctypes.c_longlong
        lib.mfdata_write_frames.argtypes = [
            ctypes.c_char_p, i32p, i32p, f32p, ctypes.c_longlong,
            ctypes.c_int]
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def _ptrs(u, v, r):
    i32p = ctypes.POINTER(ctypes.c_int32)
    return (u.ctypes.data_as(i32p), v.ctypes.data_as(i32p),
            r.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))


def parse_frames_native(
    path: str,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Parse a length-prefixed protobuf block stream with the C++ fast path.

    Returns (u, v, r) arrays, or None if the native library is unavailable
    (callers fall back to the pure-Python codec).
    """
    lib = _load()
    if lib is None:
        return None
    n = lib.mfdata_count_frames(path.encode())
    if n < 0:
        raise IOError(f"native frame count failed for {path} (code {n})")
    u = np.empty(n, np.int32)
    v = np.empty(n, np.int32)
    r = np.empty(n, np.float32)
    got = lib.mfdata_parse_frames(path.encode(), *_ptrs(u, v, r), n)
    if got < 0:
        raise IOError(f"native frame parse failed for {path} (code {got})")
    return u[:got], v[:got], r[:got]


def write_frames_native(
    path: str,
    u: np.ndarray,
    v: np.ndarray,
    r: np.ndarray,
    users_per_block: int = 1000,
) -> bool:
    """Write a block stream with the C++ fast path. Input must be sorted by u.
    Returns False if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return False
    u = np.ascontiguousarray(u, np.int32)
    v = np.ascontiguousarray(v, np.int32)
    r = np.ascontiguousarray(r, np.float32)
    rc = lib.mfdata_write_frames(path.encode(), *_ptrs(u, v, r), len(u),
                                 users_per_block)
    if rc < 0:
        raise IOError(f"native frame write failed for {path} (code {rc})")
    return True
