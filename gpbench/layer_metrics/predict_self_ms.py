"""Milliseconds a call in ``GP.predict`` outside its two inner spans (the
span ``gp.predict``'s self time): the host numpy, the mean's ``np.dot``
and the variance's reduction."""

from gpbench.spans import span_ms_per_call


def read(run):
    return span_ms_per_call(run, "gp.predict")
