# -*- coding: utf-8 -*-
"""Structured timing and profiling (PyTorch port of
``george_tpu/diagnostics.py``), zero-cost when off:

* :class:`timer` — a context manager accumulating named wall-clock spans
  into a process-wide registry, synchronized with the device when a result
  is marked with :meth:`timer.sync`;
* :func:`report` — the collected spans; :func:`reset` clears them;
* :func:`trace` — a ``torch.profiler`` trace of the host and the card;
* :func:`annotate` — a named region in such a trace, one check while no
  profiler runs; :func:`backward_mark` — one over a reverse pass;
* ``host_reads`` — a count of the device-to-host reads the evaluation
  paths make (:func:`count_host_read`);
* :func:`memory_trace` — the device memory of each :func:`memory_stage`
  that runs inside it (the H-matrix likelihood's stages);
* the solvers' ``verbose=True`` prints go through :func:`log_span`.

The registry layout, ``{name: (count, total_s, best_s)}``, and the names
are the JAX module's.
"""

import contextlib
import os
import tempfile
import time

import torch

__all__ = ["timer", "report", "reset", "trace", "log_span", "annotate",
           "backward_mark", "profiling", "count_host_read", "memory_trace",
           "memory_stage"]

_REGISTRY = {}
# what :func:`annotate` returns while no profiler runs
_NULL = contextlib.nullcontext()
# the reverse-pass span of :func:`backward_mark` that is open, if any
_BACKWARD = None
# the program's own device-to-host reads on the evaluation paths: the CG
# stopping test, GP.predict's answer and the HODLR solve's answer
host_reads = 0
# the open memory trace: its records and the stack of open stages
_MEMORY = None


def _cuda_devices(value, out):
    """The CUDA devices of the tensors in ``value`` (a tensor, or nested
    tuples, lists and dicts of them)."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            out.add(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _cuda_devices(v, out)
    return out


class timer(object):
    """``with timer("hodlr.factor") as tm: out = tm.sync(f(...))`` —
    accumulate a named span, which is also an :func:`annotate` region.

    A value marked with :meth:`sync` (a tensor, or nested tuples, lists
    and dicts of tensors) has its CUDA devices synchronized before the
    clock stops, so device work is included; CPU tensors need no wait.
    """

    def __init__(self, name, verbose=False):
        self.name = name
        self.verbose = verbose
        self._sync = None

    def sync(self, value):
        """Mark a value to synchronize on at exit; returns it unchanged."""
        self._sync = value
        return value

    def __enter__(self):
        self._span = annotate(self.name)
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync is not None:
            for device in _cuda_devices(self._sync, set()):
                torch.cuda.synchronize(device)
        dt = time.perf_counter() - self._t0
        self._span.__exit__(*exc)
        count, total, best = _REGISTRY.get(self.name, (0, 0.0, float("inf")))
        _REGISTRY[self.name] = (count + 1, total + dt, min(best, dt))
        if self.verbose:
            log_span(self.name, dt)
        return False


def log_span(name, seconds):
    print("[george-tpu] {0}: {1:.4f} s".format(name, seconds), flush=True)


def report():
    """``{name: {"count", "total_s", "mean_s", "best_s"}}`` for all spans."""
    return {
        name: {
            "count": c,
            "total_s": t,
            "mean_s": t / c if c else 0.0,
            "best_s": b,
        }
        for name, (c, t, b) in _REGISTRY.items()
    }


def reset():
    _REGISTRY.clear()


@contextlib.contextmanager
def trace(log_dir=None):
    """``torch.profiler`` trace of the block, host and (where there is one)
    the card, written as ``trace.json`` under ``log_dir`` (default: a
    ``george_tpu_torch_trace`` folder in the temporary directory) for
    ``chrome://tracing`` or Perfetto; yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "george_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def profiling():
    """Whether a ``torch.profiler`` records this thread's operations."""
    return torch._C._autograd._profiler_enabled()


def annotate(name):
    """Named region (a context manager) that shows up in profiler traces,
    on the profiler's clock, as a ``user_annotation`` event. While no
    profiler runs it is a shared null context: one check, no record. It
    neither synchronizes nor reads the device."""
    if not profiling():
        return _NULL
    return torch.profiler.record_function(name)


def _close_backward():
    global _BACKWARD
    if _BACKWARD is not None:
        _BACKWARD.__exit__(None, None, None)
        _BACKWARD = None


class _BackwardMark(torch.autograd.Function):
    """The identity, whose backward opens the span ``name`` (closing one
    left open) or, with ``name`` None, closes it. Arguments: ``(x,
    name)``."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, name):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.name = inputs[1]

    @staticmethod
    def backward(ctx, g):
        global _BACKWARD
        _close_backward()
        if ctx.name is not None and profiling():
            _BACKWARD = torch.profiler.record_function(ctx.name)
            _BACKWARD.__enter__()
        return g, None


def backward_mark(x, name=None):
    """A function's reverse pass as a span: ``out = backward_mark(out,
    "hodlr.backward")`` on the result, whose backward opens the span, and
    ``x = backward_mark(x)`` on the input, whose backward closes it, on the
    thread autograd runs them on (under ``torch.func.vmap`` once for the
    batch). The identity in value; ``x`` itself while no profiler runs."""
    if not profiling():
        return x
    return _BackwardMark.apply(x, name)


def count_host_read():
    """Count one device-to-host read in ``host_reads``."""
    global host_reads
    host_reads += 1


@contextlib.contextmanager
def memory_trace(device):
    """Record every :func:`memory_stage` that runs inside the block, in the
    order the stages close; yields the list of records. Each record holds
    ``stage`` (the names of the open stages, outermost first, joined by
    ``/``), ``seconds``, and on a CUDA ``device`` the bytes allocated at
    the stage's start and end and the peak while it ran, nested stages
    included (``start_gb``, ``end_gb``, ``peak_gb``; None on the CPU). A
    stage synchronizes the device at both ends, so a trace slows what it
    measures."""
    global _MEMORY
    device = torch.device(device)
    records = []
    _MEMORY = {"cuda": device.type == "cuda", "device": device,
               "records": records, "open": []}
    try:
        yield records
    finally:
        _MEMORY = None


def _fold_peak(mem):
    """Fold the device's peak since the last reset into every open stage,
    then reset it; returns the bytes allocated now."""
    dev = mem["device"]
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    for st in mem["open"]:
        st["peak"] = max(st["peak"], peak)
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev)


@contextlib.contextmanager
def memory_stage(name):
    """A named stage of :func:`memory_trace`; nothing when no trace is
    open."""
    mem = _MEMORY
    if mem is None:
        yield
        return
    start = _fold_peak(mem) if mem["cuda"] else None
    st = {"name": name, "peak": start or 0}
    mem["open"].append(st)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        end = _fold_peak(mem) if mem["cuda"] else None
        path = "/".join(s["name"] for s in mem["open"])
        mem["open"].pop()
        gb = (lambda b: None if b is None else b / 1e9)
        mem["records"].append({
            "stage": path, "seconds": time.perf_counter() - t0,
            "start_gb": gb(start), "end_gb": gb(end),
            "peak_gb": gb(st["peak"] if mem["cuda"] else None)})
