"""The work of one biased-MF SGD epoch and its test eval, counted from the
ratings and the rank alone: what any implementation has to read, write
and compute, whatever its plans, layouts or kernels.

Bytes: each training rating read once (user id, item id, rating: 12
bytes); each user and item row that a training rating touches read once
and written once (dim factors and a bias at the table's storage width);
each test rating read once, and each row a test rating touches read once.

Operations: per rating update a dot product and two scaled adds over the
dim factors and the bias lanes, 6 (dim + 2); per test rating a dot
product, 2 (dim + 2).
"""

from __future__ import annotations

import numpy as np


def distinct(ids: np.ndarray, n: int) -> int:
    return int(np.count_nonzero(np.bincount(ids, minlength=n)))


def epoch_work(train, test, dim: int, storage_bytes: int) -> dict:
    """{"bytes", "ops", "model_flops"} of one epoch and its eval.
    ``model_flops`` counts the updates alone."""
    row = (dim + 1) * storage_bytes
    rows_train = distinct(train.u, train.nu) + distinct(train.v, train.nv)
    rows_test = distinct(test.u, test.nu) + distinct(test.v, test.nv)
    n, m = len(train), len(test)
    update_flops = 6 * (dim + 2) * n
    return {
        "bytes": 12 * n + 2 * row * rows_train + 12 * m + row * rows_test,
        "ops": update_flops + 2 * (dim + 2) * m,
        "model_flops": update_flops,
    }
