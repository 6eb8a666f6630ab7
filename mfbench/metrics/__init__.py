"""Per-layer metric readers: ``<name>.py`` holds ``read(ctx)``, which
returns the metric's value from the traced run's context (``run.Context``)
or None where it finds nothing to read."""
