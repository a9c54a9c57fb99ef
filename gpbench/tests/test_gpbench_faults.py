"""A run with the timed path broken underneath comes out not correct: each
fault a cell can have, planted where the answer is produced, at a small
size on the CPU (the harness's look for a card is skipped). The cells run
on one card, so no exchange between cards can be left out."""

import numpy as np
import pytest

from gpbench import harness
from gpbench.entries import predict, value_and_grad

from .conftest import SMALL, TRAFFIC


def stale(make_call):
    """Every call returns the first call's answer: state left unchanged."""
    def make(gp, cell):
        call, first = make_call(gp, cell), []

        def broken(x):
            out = call(x)
            if not first:
                first.append(out)
            return first[0]
        return broken
    return make


def half_batch(make_call):
    """Half of the batch (chains, or test points) left out, the mean of the
    rest in its place."""
    def make(gp, cell):
        call = make_call(gp, cell)

        def broken(x):
            a, b = call(x)
            h = len(a) // 2
            a, b = a.copy(), b.copy()
            a[h:] = a[:h].mean(axis=0)
            b[h:] = b[:h].mean(axis=0)
            return a, b
        return broken
    return make


def altered(which):
    """One output's (0: the value or the mean; 1: the gradient or the
    variance) largest entry moved by 20% where it is produced."""
    def fault(make_call):
        def make(gp, cell):
            call = make_call(gp, cell)

            def broken(x):
                out = [o.copy() for o in call(x)]
                i = np.unravel_index(np.argmax(np.abs(out[which])),
                                     out[which].shape)
                out[which][i] *= 1.2
                return tuple(out)
            return broken
        return make
    fault.__name__ = "altered_%d" % which
    return fault


altered_value, altered_second = altered(0), altered(1)


CASES = [
    ("hodlr_smooth_1e5.fit", value_and_grad, stale),
    ("hodlr_smooth_1e5.fit", value_and_grad, altered_value),
    ("hodlr_smooth_1e5.fit", value_and_grad, altered_second),
    ("hodlr_smooth_1e5.chains8", value_and_grad, stale),
    ("hodlr_smooth_1e5.chains8", value_and_grad, half_batch),
    ("hodlr_smooth_1e5.chains8", value_and_grad, altered_value),
    ("hodlr_smooth_1e5.chains8", value_and_grad, altered_second),
    ("sparse_dia_2e5.fit", value_and_grad, stale),
    ("sparse_dia_2e5.fit", value_and_grad, altered_value),
    ("sparse_dia_2e5.fit", value_and_grad, altered_second),
    ("hodlr_smooth_1e5.predict", predict, stale),
    ("hodlr_smooth_1e5.predict", predict, half_batch),
    ("hodlr_smooth_1e5.predict", predict, altered_value),
    ("hodlr_smooth_1e5.predict", predict, altered_second),
]


@pytest.mark.parametrize("workload,entry,fault", CASES,
                         ids=["%s-%s" % (w, f.__name__) for w, _, f in CASES])
def test_fault_is_not_correct(monkeypatch, workload, entry, fault):
    monkeypatch.setattr(entry, "make_call", fault(entry.make_call))
    result, checks = harness.run_cell(
        workload, 2 ** 33 + 21, 0.5, False, device="cpu",
        overrides=SMALL[workload.split(".")[0]], traffic=TRAFFIC)
    assert result["correct"] is False, checks
