"""The work of one AdaptReg epoch, counted from the ratings, the rank and
the step's size alone: what any implementation has to read, write and
compute, whatever its plans, layouts or kernels.

- The segment walks: one MF epoch's update work (``work/mf.py``: each
  training rating read once, 12 bytes; each row a training rating touches
  read once and written once; 6 (dim + 2) operations a rating), however
  the epoch is cut into segments.
- The hypergradient steps, ``segments`` of them: each reads its K
  validation records (12 bytes each) and gathers their user and item rows
  before and after its segment (4 K rows); per record a prediction,
  2 (dim + 2) operations, two inner products of the old and new rows,
  4 dim, and the four products and sums of the step, 8.
- The test eval, as ``work/mf.py`` counts it.

``segment_bytes`` and ``segment_ops`` are the walks' alone.
"""

from __future__ import annotations

from mfbench.work.mf import distinct, epoch_work as mf_work


def epoch_work(train, test, dim: int, storage_bytes: int, segments: int,
               k: int) -> dict:
    """{"bytes", "ops", "model_flops", "segment_bytes", "segment_ops"} of
    one epoch, its ``segments`` steps of ``k`` records and its eval.
    ``model_flops`` counts the updates' 6 (dim + 2) alone."""
    mf = mf_work(train, test, dim, storage_bytes)
    row = (dim + 1) * storage_bytes
    rows_train = distinct(train.u, train.nu) + distinct(train.v, train.nv)
    steps_bytes = segments * (12 * k + 4 * k * row)
    steps_ops = segments * k * (2 * (dim + 2) + 4 * dim + 8)
    return {
        "bytes": mf["bytes"] + steps_bytes,
        "ops": mf["ops"] + steps_ops,
        "model_flops": mf["model_flops"],
        "segment_bytes": 12 * len(train) + 2 * row * rows_train,
        "segment_ops": mf["model_flops"],
    }
