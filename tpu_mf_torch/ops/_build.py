"""Build the package's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface. It is compiled with
``nvcc`` for Hopper (``sm_90a``) into ``build/<name>-<hash>.so`` beside the
package, where the hash covers the source, the headers it includes from
``csrc/`` (``#include "name.cuh"``) and the flags, so an edited source or
header is rebuilt and an unchanged one is loaded as it is. Nothing here
runs at import time: the CPU paths never need a compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}  # by name and defines
# ptxas register / shared-memory report of the builds made by this process
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def source_bytes(src: Path) -> bytes:
    """The bytes of ``src`` and of every header it includes from
    ``csrc/`` by a quoted ``#include``, recursively, each once."""
    seen, todo, out = set(), [src], b""
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        text = path.read_bytes()
        out += path.name.encode() + b"\0" + text
        for name in re.findall(rb'^\s*#\s*include\s+"([^"]+)"', text,
                               re.MULTILINE):
            todo.append(CSRC / name.decode())
    return out


def build_all(names, defines=()) -> list[Path]:
    """Compile each ``csrc/<name>.cu`` that has no up-to-date library, one
    nvcc process per source, all started together; ``defines`` are macros
    for a diagnostic build (``-D``), kept apart by the hash."""
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    jobs = []
    for name in names:
        src = CSRC / f"{name}.cu"
        key = source_bytes(src) + " ".join(flags).encode()
        out = BUILD_DIR / f"{name}-{hashlib.sha256(key).hexdigest()[:12]}.so"
        proc = tmp = None
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [_nvcc(), *flags, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((name, src, out, tmp, proc))
    # wait for every process before raising, so none outlives a failure
    errs = [proc.communicate()[1] if proc else "" for *_, proc in jobs]
    for (name, src, out, tmp, proc), err in zip(jobs, errs):
        if proc is None:
            continue
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{err}")
        build_logs[" ".join((name, *defines))] = err
        os.replace(tmp, out)
    return [out for _, _, out, _, _ in jobs]


def build(name: str, defines=()) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists."""
    return build_all([name], defines)[0]


def load(name: str, defines=()) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built with ``defines``),
    built if needed."""
    key = " ".join((name, *defines))
    with _lock:
        if key not in _libs:
            _libs[key] = ctypes.CDLL(str(build(name, defines)))
        return _libs[key]
