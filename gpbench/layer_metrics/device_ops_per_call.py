"""Device operations (kernels, copies, sets) in the traced window per
call."""


def read(run):
    t = run.trace
    return len(t.device) / run.calls if t.device and run.calls else None
