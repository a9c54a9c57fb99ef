"""The program's spans and counters in a traced window, as the per-layer
metrics read them.

A span is a host ``user_annotation`` event of the profiler's Chrome export
(``george_tpu_torch.diagnostics.annotate``), on the device trace's clock.
Its self time is the union of its intervals inside the window on each host
thread, less the part of them covered by the other program spans that
start inside them on the same thread (its children), so that the self
times of one call add up. A counter is a module-level integer of the
program; a reader lists it in ``COUNTERS`` only where the program has it,
so that a program without it leaves the metric out.
"""

import importlib

from .trace import merged

SPAN_CAT = "user_annotation"


def _measure(intervals):
    return sum(b - a for a, b in intervals)


def _intersection(a, b):
    """The intersection of two lists of disjoint sorted intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo < hi:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def self_seconds(trace, name):
    """Seconds of span ``name``'s self time in the window of ``trace`` (a
    ``gpbench.trace.Trace``), over every host thread; None where the
    window holds no such span."""
    threads = {}
    for e in trace.host:
        if e.get("cat") == SPAN_CAT:
            threads.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    total, found = 0.0, False
    for events in threads.values():
        own = merged(trace._clip(e) for e in events if e["name"] == name)
        if not own:
            continue
        found = True
        children = merged(
            c for c in (trace._clip(e) for e in events if e["name"] != name)
            if any(a <= c[0] < b for a, b in own))
        total += _measure(own) - _measure(_intersection(own, children))
    return total if found else None


def span_ms_per_call(run, name):
    """Span ``name``'s self time a call in ms, or None (see
    :func:`self_seconds`)."""
    s = self_seconds(run.trace, name)
    return None if s is None or not run.calls else 1e3 * s / run.calls


def counters(specs):
    """``specs`` (``{key: (module, attribute)}``) less the counters the
    program does not have."""
    out = {}
    for key, (mod, attr) in specs.items():
        try:
            if hasattr(importlib.import_module(mod), attr):
                out[key] = (mod, attr)
        except ImportError:
            pass
    return out


def per_call(run, key):
    """Counter ``key``'s change over the window a call, or None where the
    program has no such counter or it did not move."""
    n = run.counters.get(key)
    return n / run.calls if n and run.calls else None
