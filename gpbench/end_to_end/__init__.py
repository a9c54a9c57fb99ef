"""One reader per end-to-end metric: ``read(run) -> float or None``."""
