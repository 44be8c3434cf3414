"""Per-layer metrics: each ``<name>.py`` holds ``read(ctx)``, which takes
the run's ``harness.Context`` and returns the metric's number, or ``None``
where it finds nothing to read.  The harness finds a reader by the
metric's name in ``BENCHMARK.json``."""
