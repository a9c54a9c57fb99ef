"""One run of one cell: set-up, warm-up, the measured (or traced) window,
the metrics, and the comparison with the plain reference that decides
``correct``.

Everything that belongs to one configuration, traffic mix or metric is
found by its name in ``BENCHMARK.json``:

* ``configs/<config>.json`` (the file ``BENCHMARK.json`` names): the
  dataset recipe (``datasets/<recipe>.py``),
  the kernel spec, the solver and its options, the dtype, the reference's
  method;
* ``traffic/<mix>.json``: the entry it drives (``entries/<entry>.py``) and
  its parameters;
* ``limits/<workload>.json``: the limit of each number compared;
* ``end_to_end/<metric>.py`` and ``layer_metrics/<metric>.py``: a reader
  ``read(run)`` that returns the metric's value, or None where it finds
  nothing to read. A quantity split by the cells it is read in
  (``call_ms.sparse``) has the reader of its name up to the first dot.
"""

import gc
import importlib
import importlib.util
import json
import math
import os
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# the streams drawn from --seed besides the dataset's own
STREAM_INPUTS, STREAM_PROBES, STREAM_GRAD_PROBES, STREAM_WARMUP, \
    STREAM_CHECK = 1, 2, 3, 4, 5


def _module(root, kind, name):
    """The module ``gpbench/<kind>/<name>.py`` of the checkout ``root``."""
    path = os.path.join(root, "gpbench", kind, name + ".py")
    if not os.path.exists(path):
        raise KeyError("no %s named %r (%s)" % (kind, name, path))
    key = "gpbench.%s.%s" % (kind, name)
    if root == ROOT:
        return importlib.import_module(key)
    spec = importlib.util.spec_from_file_location(key + "@" + root, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reader(root, kind, name):
    """A metric's reader: the module named by the metric's name up to its
    first dot (``call_ms.sparse`` is ``call_ms`` read in another cell)."""
    return _module(root, kind, name.split(".", 1)[0])


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def _merge(base, over):
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(base[k], v) if isinstance(v, dict) and isinstance(
            base.get(k), dict) else v
    return out


def rademacher(rng, shape):
    """``+-1`` probes, float64."""
    return np.where(rng.random(shape) < 0.5, -1.0, 1.0)


def stream(seed, k):
    """The ``k``-th random stream of ``seed`` (0 is the dataset's)."""
    seed = int(seed) % (1 << 64)
    return np.random.default_rng(seed if k == 0 else [seed, k])


class Data(object):
    def __init__(self, x, y, yerr, domain):
        self.x, self.y, self.yerr, self.domain = x, y, yerr, domain


class Cell(object):
    """A workload of ``BENCHMARK.json`` at one seed: its configuration,
    traffic mix, limits and data, and the metrics it reports."""

    def __init__(self, workload, seed, root=ROOT, overrides=None,
                 traffic=None):
        bench = _json(root, "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError("no workload %r in BENCHMARK.json (%s)"
                           % (workload, ", ".join(sorted(cells))))
        self.bench = bench
        self.workload = cells[workload]
        self.name = workload
        self.seed = int(seed)
        conf = {c["name"]: c for c in bench["configs"]}[
            self.workload["config"]]
        self.config = _merge(_json(root, conf["file"]), overrides or {})
        self.root = root
        self.traffic = _merge(_json(root, "gpbench", "traffic",
                                    self.workload["traffic"] + ".json"),
                              traffic or {})
        self.limits = _json(root, "gpbench", "limits", workload + ".json")
        self.entry = _module(root, "entries", self.traffic["entry"])
        ds = self.config["dataset"]
        x, y, yerr, domain = _module(root, "datasets", ds["recipe"]).make(
            stream(seed, 0), **ds["params"])
        self.data = Data(x, y, yerr, domain)
        from .reference import kernel
        self.node = kernel.build(self.config["kernel"])
        frozen = set(self.config["frozen"])
        self.active = np.array([i for i, nm in enumerate(self.node.names)
                                if nm not in frozen])
        self.theta_full0 = np.array(self.node.theta0, dtype=np.float64)
        self.theta0 = self.theta_full0[self.active]
        self.solver_inputs = {}
        if self.config["solver"].get("probes"):
            k = self.config["solver"]["options"]["num_probes"]
            n = len(x)
            self.solver_inputs = {
                "probes": rademacher(stream(seed, STREAM_PROBES), (k, n)),
                "grad_probes": rademacher(stream(seed, STREAM_GRAD_PROBES),
                                          (k, n))}

    def full_theta(self, active):
        full = self.theta_full0.copy()
        full[self.active] = active
        return full

    def metrics(self, kind):
        """The ``end_to_end`` or ``per_layer`` metrics this cell
        reports."""
        out = []
        e2e = {m["name"]: m for m in self.bench["end_to_end"]}
        for m in self.bench[kind]:
            if "workloads" in m:
                if self.name in m["workloads"]:
                    out.append(m)
            elif kind == "end_to_end" or self.name in e2e[m["moves"]].get(
                    "workloads", [self.name]):
                out.append(m)
        return out

    def reference(self, device, precision="float64"):
        from .reference.gp import BandedGP
        return BandedGP(self.node, self.data.x,
                        self.data.yerr ** 2 + self.config["white_noise"],
                        device, precision=precision,
                        min_block=self.config["reference"]["min_block"])


class Run(object):
    """What a metric reader reads: the cell, the timings, the trace and
    the counters of one run."""

    def __init__(self, cell):
        self.cell = cell
        self.setup_s = None
        self.spans = {}
        self.latencies = []
        self.window_s = None
        self.peak_bytes = None
        self.trace = None
        self.counters = {}
        self.calls = 0


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _counter(spec):
    mod, attr = spec
    return getattr(importlib.import_module(mod), attr)


def run_cell(workload, seed, seconds, trace, device="cuda", t_start=None,
             root=ROOT, overrides=None, traffic=None, log=None):
    """Run one cell once; returns ``(result, checks)``: the result line's
    object and the numbers compared, each ``(name, value, limit)``.
    ``overrides`` and ``traffic`` replace keys of the configuration and
    of the traffic mix (small sizes for tests)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell(workload, seed, root=root, overrides=overrides,
                traffic=traffic)
    run = Run(cell)
    entry, traffic = cell.entry, cell.traffic
    cuda = torch.device(device).type == "cuda"
    n_calls = int(math.ceil(traffic["max_calls_per_s"] * seconds)) + 1
    inputs = entry.draw(stream(seed, STREAM_INPUTS), cell, n_calls)
    warm = entry.draw(stream(seed, STREAM_WARMUP), cell,
                      traffic["warmup_calls"])

    from . import program
    gp = program.build_gp(cell.config, device, cell.solver_inputs)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    t0 = time.perf_counter()
    gp.compute(cell.data.x, cell.data.yerr)
    _sync(device)
    run.spans["compute"] = time.perf_counter() - t0
    call = entry.make_call(gp, cell)
    for w in warm:
        call(w)
    _sync(device)
    run.setup_s = time.perf_counter() - t_start

    layer = cell.metrics("per_layer") if trace else []
    readers = {m["name"]: _reader(root, "layer_metrics", m["name"])
               for m in layer}
    counters = {}
    for r in readers.values():
        counters.update(getattr(r, "COUNTERS", {}))
    outputs, failed = [], 0

    def timed(x):
        nonlocal failed
        t = time.perf_counter()
        try:
            out = call(x)
            if not entry.finite(out):
                failed += 1
        except (RuntimeError, ValueError, ArithmeticError,
                np.linalg.LinAlgError) as err:
            failed += 1
            out = None
            if log:
                log("call %d failed: %r" % (len(outputs), err))
        run.latencies.append(time.perf_counter() - t)
        outputs.append(out)

    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        before = {k: _counter(v) for k, v in counters.items()}
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            with record_function("gpbench.window"):
                t0 = time.perf_counter()
                for x in inputs[:traffic["trace_calls"]]:
                    timed(x)
                _sync(device)
                run.window_s = time.perf_counter() - t0
        run.counters = {k: _counter(v) - before[k]
                        for k, v in counters.items()}
        from . import trace as tr
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            run.trace = tr.load(path)
    else:
        t0 = time.perf_counter()
        for x in inputs:
            if time.perf_counter() - t0 >= seconds:
                break
            timed(x)
        run.window_s = time.perf_counter() - t0
    run.calls = len(outputs)
    if cuda:
        run.peak_bytes = torch.cuda.max_memory_allocated(device)
    else:
        run.peak_bytes = 0

    kinds = layer if trace else cell.metrics("end_to_end")
    values = {}
    for m in kinds:
        reader = readers[m["name"]] if trace else \
            _reader(root, "end_to_end", m["name"])
        v = reader.read(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # the comparison, on a sample of the window's calls, after the
    # program's state is freed
    done = [i for i, o in enumerate(outputs) if o is not None]
    k = min(traffic["check_calls"], len(done))
    pick = sorted(stream(seed, STREAM_CHECK).choice(done, k, replace=False)
                  .tolist()) if k else []
    got = [outputs[i] for i in pick]
    asked = [inputs[i] for i in pick]
    del call, gp, outputs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = []
    if got:
        expected = entry.reference(cell.reference(device), cell, asked)
        for name, value in entry.gaps(got, expected).items():
            checks.append((name, value, float(cell.limits[name])))
    correct = bool(got) and failed == 0 and all(
        math.isfinite(v) and v <= lim for _, v, lim in checks)

    result = {"correct": correct, "attempted": run.calls, "failed": failed,
              "metrics": values, "device": _device(device, run)}
    if trace:
        result["device"]["busy_s"] = run.trace.busy_s()
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    return result, checks


def _device(device, run):
    import torch
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(run.peak_bytes)}
