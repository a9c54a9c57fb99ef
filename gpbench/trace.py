"""Reduction of a ``torch.profiler`` trace to what the per-layer metrics read,
and the roofline arithmetic.

The trace is the profiler's Chrome export: a list of events with ``cat``,
``name``, ``ts`` and ``dur`` (microseconds on one clock for the host and
the device) and ``args``. Device operations are the kernels, copies and
sets. The benchmark marks its traced window with the host annotation
``gpbench.window``.
"""

import bisect
import json
import os

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime",
             "cuda_driver")
WINDOW = "gpbench.window"
# host operations looked through, back from a gap, for the one spanning it
SCAN = 4096
_PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "peaks.json")


def peaks():
    """The published peaks of the card (``peaks.json``)."""
    with open(_PEAKS) as f:
        return json.load(f)


def bound_seconds(flops, nbytes, dtype, table=None):
    """The least time the card could take for ``flops`` operations in
    ``dtype`` and ``nbytes`` bytes moved: the larger of the two times."""
    table = table or peaks()
    return max(flops / table["flops_per_s"][dtype],
               nbytes / table["bytes_per_s"])


def union_seconds(intervals):
    """The length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def merged(intervals):
    """The union of ``(start, end)`` intervals as disjoint sorted ones."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace(object):
    """The events of a traced window, in seconds."""

    def __init__(self, events):
        spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
        win = [e for e in spans if e.get("name") == WINDOW]
        if not win:
            raise ValueError("the trace has no %s annotation" % WINDOW)
        w = max(win, key=lambda e: e["dur"])
        self.start = w["ts"] * 1e-6
        self.end = (w["ts"] + w["dur"]) * 1e-6
        inside = [e for e in spans
                  if e["ts"] * 1e-6 < self.end
                  and (e["ts"] + e["dur"]) * 1e-6 > self.start]
        self.device = [e for e in inside if e.get("cat") in DEVICE_CATS]
        self.host = [e for e in inside if e.get("cat") in HOST_CATS
                     and e.get("name") != WINDOW]

    @property
    def window_s(self):
        return self.end - self.start

    def _clip(self, e):
        a = max(e["ts"] * 1e-6, self.start)
        return a, min((e["ts"] + e["dur"]) * 1e-6, self.end)

    def busy_s(self):
        """Seconds in which some device operation ran."""
        return union_seconds(self._clip(e) for e in self.device)

    def kernels(self, match):
        """The kernel events whose name ``match(name)`` accepts."""
        return [e for e in self.device
                if e.get("cat") == "kernel" and match(e["name"])]

    def copy_bytes(self):
        return sum(float(e.get("args", {}).get("bytes", 0))
                   for e in self.device if e.get("cat") == "gpu_memcpy")

    def top_ops(self, k=10):
        """The ``k`` device operations that took most time, by name."""
        by = {}
        for e in self.device:
            by[e["name"]] = by.get(e["name"], 0.0) + e["dur"] * 1e-6
        return sorted(([n, s] for n, s in by.items()),
                      key=lambda v: -v[1])[:k]

    def idle_gaps(self, k=10):
        """The device's idle time in the window, by the innermost host
        operation running at the middle of each gap (``host outside torch
        ops`` where none runs: numpy, Python), the ``k`` largest."""
        busy = merged(self._clip(e) for e in self.device)
        gaps, t = [], self.start
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.end > t:
            gaps.append((t, self.end))
        host = sorted((e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6,
                       e["name"]) for e in self.host)
        starts = [h[0] for h in host]
        by = {}
        for a, b in gaps:
            mid = 0.5 * (a + b)
            name = "host outside torch ops"
            # the latest-starting host operation that spans the middle is
            # the innermost one of its thread
            i = bisect.bisect_right(starts, mid)
            for h in reversed(host[max(0, i - SCAN):i]):
                if h[1] >= mid:
                    name = h[2]
                    break
            by[name] = by.get(name, 0.0) + (b - a)
        return sorted(([n, s] for n, s in by.items()),
                      key=lambda v: -v[1])[:k]


def load(path):
    with open(path) as f:
        data = json.load(f)
    return Trace(data["traceEvents"] if isinstance(data, dict) else data)
