"""The work of one DP-SGLD round, counted from the ratings and the rank
alone: what any implementation has to read, write and compute, whatever
its plans, layouts or kernels. A row is dim factors and a bias at the
table's storage width; a stamp, a row's last-touch count, 8 bytes.

Bytes:
- the SGLD pass: one MF epoch's update bytes (``work/mf.py``: each
  training rating read once, 12 bytes; each row a training rating touches
  read once and written once), and each such row's stamp read and
  written;
- the noise flush: every row of both tables and its stamp, read and
  written;
- the training set's squared errors: each training rating and each row
  it touches, read;
- the test eval, as ``work/mf.py`` counts it.

Operations: per rating update a dot product and two scaled adds over the
dim factors and the bias lanes, 6 (dim + 2), and the lazy noise of both
rows it touches, a multiply and an add on each of their dim + 1 noise
lanes, 4 (dim + 1); per test rating a dot product, 2 (dim + 2). The flush
and the squared errors are counted in bytes alone.
"""

from __future__ import annotations

from mfbench.work.mf import distinct, epoch_work


def round_work(train, test, dim: int, storage_bytes: int) -> dict:
    """{"bytes", "ops", "model_flops"} of one round and its eval.
    ``model_flops`` counts the updates' 6 (dim + 2) alone."""
    mf = epoch_work(train, test, dim, storage_bytes)
    row = (dim + 1) * storage_bytes
    rows_train = distinct(train.u, train.nu) + distinct(train.v, train.nv)
    rows_all = train.nu + train.nv
    n = len(train)
    return {
        "bytes": (mf["bytes"] + 2 * 8 * rows_train
                  + 2 * (row + 8) * rows_all
                  + 12 * n + row * rows_train),
        "ops": mf["ops"] + 4 * (dim + 1) * n,
        "model_flops": mf["model_flops"],
    }
