"""Megabytes (1e6 bytes) copied between host and device, or on the device,
per call: the copies of the traced window by the profiler's byte counts."""


def read(run):
    t = run.trace
    if not run.calls or not any(e.get("cat") == "gpu_memcpy"
                                for e in t.device):
        return None
    return t.copy_bytes() / 1e6 / run.calls
