"""Factorization self-checks a call: the program's counter
``george_tpu_torch.solvers.hodlr.self_checks`` over the traced window, the
``HODLRSolver.compute``s whose one-probe residual ran (a configuration,
n included, new to the process; the memo skips the rest). 1.0 where every
call's n is new; a program without the counter leaves the metric out."""

from gpbench.spans import counters

COUNTERS = counters({"self_checks": ("george_tpu_torch.solvers.hodlr",
                                     "self_checks")})


def read(run):
    n = run.counters.get("self_checks")
    return None if n is None or not run.calls else n / run.calls
