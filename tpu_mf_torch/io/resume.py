"""Per-round training state for restart after preemption (counterpart of
``tpu_mf/io/resume.py``, written over the port's ``io/checkpoint.py``).

Each round's state (tables plus an algorithm's extras and the round
number) goes to ``<prefix>.r%06d.npz`` by an atomic rename, and the newest
three are kept. The files are ``tpu_mf``'s, key for key, so either package
resumes the other's state:

    start = resume_round(prefix)        # 0 if there is none
    for rnd in range(start + 1, iters + 1):
        ...train...
        save_round(prefix, rnd, params, **extras)
"""

from __future__ import annotations

import glob
import os
import re
from typing import Optional, Tuple

import numpy as np
import torch

from tpu_mf_torch.io.checkpoint import load_npz, save_npz


def _path(prefix: str, rnd: int) -> str:
    return f"{prefix}.r{rnd:06d}.npz"


def save_round(prefix: str, rnd: int, params, keep: int = 3,
               **extras) -> str:
    """Write round ``rnd``'s state atomically and keep the newest ``keep``
    files; returns the path written."""
    path = _path(prefix, rnd)
    # np.savez appends .npz to a name without it, and the temp name must
    # not match the prune glob below
    tmp = f"{prefix}.tmp-npz"
    save_npz(tmp, params, round=np.int32(rnd), **extras)
    os.replace(tmp + ".npz", path)
    for old in sorted(glob.glob(f"{prefix}.r*.npz"))[:-keep]:
        os.remove(old)
    return path


def latest(prefix: str) -> Optional[str]:
    """The newest round file of ``prefix``, or None."""
    paths = sorted(glob.glob(f"{prefix}.r*.npz"))
    return paths[-1] if paths else None


def resume_round(prefix: str) -> int:
    """The round of the newest state file (0: start afresh)."""
    path = latest(prefix)
    if path is None:
        return 0
    m = re.search(r"\.r(\d+)\.npz$", path)
    return int(m.group(1)) if m else 0


def load_round(prefix: str, device: torch.device | str = "cuda"
               ) -> Optional[Tuple]:
    """(params on ``device``, extras) of the newest state file, or None."""
    path = latest(prefix)
    if path is None:
        return None
    return load_npz(path, device)
