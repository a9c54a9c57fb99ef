"""The share of the traced window in which no device operation ran: 100
(1 - union of the busy intervals / the window's wall time)."""


def read(run):
    t = run.trace
    if not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
