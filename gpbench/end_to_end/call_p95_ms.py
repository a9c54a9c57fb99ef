"""The 95th percentile of every call's wall latency in the window, the host
read included (host clock; numpy's linear interpolation)."""

import numpy as np


def read(run):
    if not run.latencies:
        return None
    return 1e3 * float(np.percentile(run.latencies, 95))
