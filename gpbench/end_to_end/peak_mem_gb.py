"""The device memory peak (``torch.cuda.max_memory_allocated``), reset
just before ``GP.compute`` and read when the window closes, so that the
benchmark's reference is left out; in GB (1e9 bytes)."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
