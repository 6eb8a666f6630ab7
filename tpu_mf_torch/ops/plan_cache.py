"""Disk cache for epoch plans (counterpart of ``tpu_mf/ops/plan_cache.py``).

Plan construction is argsort-bound: tens of seconds for a Netflix-scale
plan on one host core. The plan builders consult a disk cache keyed by
(data fingerprint, seed, kernel geometry) before building.

The environment variable, the key, the kind names ("cell", "packed",
"slot", "stripe") and the npz layout are those of ``tpu_mf``, so either
package reads the plans the other wrote.

Policy:
* Only plans for datasets with >= MIN_RATINGS ratings are cached (small
  plans build in milliseconds).
* The data fingerprint is a blake2b over the raw id/rating bytes: any
  change to the data rebuilds.
* ``TPU_MF_PLAN_CACHE``: a directory overrides the default
  (~/.cache/tpu_mf/plans); ``0`` disables caching.
"""

from __future__ import annotations

import hashlib
import os
import warnings
from typing import Callable

import numpy as np

MIN_RATINGS = 2_000_000


def cache_dir() -> str | None:
    env = os.environ.get("TPU_MF_PLAN_CACHE")
    if env == "0":
        return None
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "tpu_mf", "plans")


def _fingerprint(ds, kind: str, seed: int, geom: tuple) -> str:
    h = hashlib.blake2b(digest_size=20)
    h.update(repr((kind, seed, geom, ds.nu, ds.nv, len(ds))).encode())
    h.update(np.ascontiguousarray(ds.u).tobytes())
    h.update(np.ascontiguousarray(ds.v).tobytes())
    h.update(np.ascontiguousarray(ds.r).tobytes())
    return h.hexdigest()


def cached_build(kind: str, cls, ds, seed: int, geom: tuple,
                 builder: Callable):
    """builder(), through the disk cache when the dataset is large enough.

    ``cls`` is the plan NamedTuple: its ndarray fields round-trip through one
    npz, its integer fields through the ``plan_meta_*`` entries."""
    cdir = cache_dir()
    if cdir is None or len(ds) < MIN_RATINGS:
        return builder()
    key = _fingerprint(ds, kind, seed, geom)
    path = os.path.join(cdir, f"{kind}.{key}.npz")
    try:
        if os.path.exists(path):
            with np.load(path, allow_pickle=False) as z:
                meta = {}
                if "plan_meta_keys" in z:
                    keys = str(z["plan_meta_keys"]).split(",")
                    meta = {k: int(v) for k, v in
                            zip([k for k in keys if k], z["plan_meta_vals"])}
                return cls(**{name: meta[name] if name in meta else z[name]
                              for name in cls._fields})
    except (OSError, KeyError, ValueError):
        pass  # unreadable or stale entry: rebuild below
    plan = builder()
    arrays, meta = {}, {}
    for name in cls._fields:
        val = getattr(plan, name)
        if isinstance(val, np.ndarray):
            arrays[name] = val
        else:
            meta[name] = int(val)
    tmp = path + f".{os.getpid()}.tmp.npz"
    try:
        os.makedirs(cdir, exist_ok=True)
        np.savez(tmp, plan_meta_keys=",".join(meta),
                 plan_meta_vals=np.asarray(list(meta.values()), np.int64),
                 **arrays)
        os.replace(tmp, path)
    except OSError as e:  # the cache is best-effort, but say so
        warnings.warn(f"plan cache write failed ({path}): {e}")
    return plan
