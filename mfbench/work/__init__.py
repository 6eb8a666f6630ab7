"""Work counts of one epoch or round, by algorithm (``<alg>.py``)."""
