"""The program spans' self times and the counter readers, on synthetic
events."""

import importlib

import pytest

from gpbench import spans
from gpbench import trace as tr

SPAN_READERS = {
    "hodlr_factor_ms": "hodlr.factor", "hodlr_solve_ms": "hodlr.solve",
    "hodlr_backward_ms": "hodlr.backward", "cg_ms": "sparse.cg",
    "slq_ms": "sparse.slq", "sparse_adjoint_ms": "sparse.adjoint",
    "predict_cross_cov_ms": "gp.predict.cross_cov",
    "predict_solve_ms": "gp.predict.solve", "predict_self_ms": "gp.predict"}
COUNTER_READERS = {"cg_iters_per_call": "cg_iters",
                   "host_reads_per_call": "host_reads"}


def ev(name, ts, dur, tid=1, cat="user_annotation"):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 7, "tid": tid, "args": {}}


class _Run(object):
    def __init__(self, events, calls=2, counters=None):
        self.trace = tr.Trace(events)
        self.calls = calls
        self.counters = counters or {}


def synthetic():
    return [
        ev(tr.WINDOW, 100, 1000),
        # outer span 150..550 with two children, one nested in the other
        ev("gp.predict", 150, 400),
        ev("gp.predict.cross_cov", 200, 100),
        ev("aten::mm", 210, 50, cat="cpu_op"),       # not a span
        ev("gp.predict.solve", 350, 150),
        ev("inner", 400, 50),                         # inside the solve
        # the same name again, in the second call
        ev("gp.predict", 700, 100),
        # another thread: overlaps the outer span, is not its child
        ev("hodlr.backward", 160, 300, tid=2),
        ev("sparse.adjoint", 170, 100, tid=2),
        # cut by the window's end (1100)
        ev("sparse.cg", 1050, 200),
        # outside the window
        ev("sparse.slq", 2000, 10),
    ]


def test_children_leave_the_parents_self_time():
    t = tr.Trace(synthetic())
    # 400 + 100 - (100 + 150) = 250 us
    assert spans.self_seconds(t, "gp.predict") == pytest.approx(250e-6)
    assert spans.self_seconds(t, "gp.predict.cross_cov") == pytest.approx(
        100e-6)
    assert spans.self_seconds(t, "gp.predict.solve") == pytest.approx(
        100e-6)
    assert spans.self_seconds(t, "inner") == pytest.approx(50e-6)
    # the self times of one thread add up to its outermost spans
    total = sum(spans.self_seconds(t, n) for n in (
        "gp.predict", "gp.predict.cross_cov", "gp.predict.solve", "inner"))
    assert total == pytest.approx(500e-6)


def test_spans_on_another_thread_are_not_taken_out():
    t = tr.Trace(synthetic())
    assert spans.self_seconds(t, "hodlr.backward") == pytest.approx(200e-6)
    assert spans.self_seconds(t, "sparse.adjoint") == pytest.approx(100e-6)


def test_spans_are_clipped_to_the_window():
    t = tr.Trace(synthetic())
    assert spans.self_seconds(t, "sparse.cg") == pytest.approx(50e-6)
    assert spans.self_seconds(t, "sparse.slq") is None
    assert spans.self_seconds(t, "absent") is None


def test_a_repeated_parent_is_counted_once():
    events = [ev(tr.WINDOW, 0, 100), ev("a", 10, 50), ev("a", 20, 10),
              ev("b", 30, 20)]
    assert spans.self_seconds(tr.Trace(events), "a") == pytest.approx(
        30e-6)


def test_span_readers():
    run = _Run(synthetic(), calls=2)
    for reader, span in SPAN_READERS.items():
        mod = importlib.import_module("gpbench.layer_metrics." + reader)
        want = spans.self_seconds(run.trace, span)
        got = mod.read(run)
        if want is None:
            assert got is None, reader
        else:
            assert got == pytest.approx(1e3 * want / 2), reader
    empty = _Run([ev(tr.WINDOW, 0, 100), ev("aten::mm", 10, 5,
                                             cat="cpu_op")])
    for reader in SPAN_READERS:
        mod = importlib.import_module("gpbench.layer_metrics." + reader)
        assert mod.read(empty) is None, reader


def test_counter_readers():
    for reader, key in COUNTER_READERS.items():
        mod = importlib.import_module("gpbench.layer_metrics." + reader)
        assert mod.COUNTERS[key][1] in ("cg_iteration_count", "host_reads")
        assert mod.read(_Run(synthetic(), 4, {key: 10})) == 2.5
        assert mod.read(_Run(synthetic(), 4, {})) is None, reader
        assert mod.read(_Run(synthetic(), 4, {key: 0})) is None, reader


def test_counters_the_program_lacks_are_left_out():
    got = spans.counters({
        "a": ("george_tpu_torch.diagnostics", "host_reads"),
        "b": ("george_tpu_torch.diagnostics", "no_such_counter"),
        "c": ("george_tpu_torch.no_such_module", "x")})
    assert got == {"a": ("george_tpu_torch.diagnostics", "host_reads")}
