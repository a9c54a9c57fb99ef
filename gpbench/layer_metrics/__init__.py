"""One reader per per-layer metric: ``read(run) -> float or None`` (None
where the trace holds nothing to read), and ``COUNTERS``, the program
counters it reads, as ``{key: (module, attribute)}``; the harness hands
their change over the traced window in ``run.counters``."""
