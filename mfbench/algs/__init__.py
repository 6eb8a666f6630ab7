"""Drivers, one per trainer of the program (``<alg>.py``, found by the
traffic's ``alg``; ``spec.driver``). A driver owns what depends on the
algorithm, as module-level names:

- ``NUMBERS``: the names of the numbers its check compares;
- ``parse(line)``: (index, elapsed, logged test RMSE or None) of an epoch
  or round line, None for any other line;
- ``draw(spec, seed, device)``: (train, test, tables0, gb, cfg, route),
  the cell's ratings, initial tables, the training mean, the program's
  ``TrainConfig`` and the routes the reference follows;
- ``setup(spec, drawn, win, device)``: builds the program's runners once
  (set-up, ``schedule_s``) and returns ``job``, which runs one job from
  the initial tables, returns its final tables (``check.LEAVES``) and
  leaves the first job's tables after epoch 1 in ``win.snap1``;
- ``epoch_work(drawn, spec)``: one epoch's or round's work (``work/``);
- ``compare(spec, drawn, win, final, test_rmse, device)``: (the numbers,
  the result line's extra keys), from the plain reference;
- ``readings(spec, seed, device, orders)``: the readings of the control
  and the planted faults that ``control.py`` prints, for one seed.
"""
