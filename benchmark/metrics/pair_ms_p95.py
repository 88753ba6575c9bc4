"""pair_ms_p95 (ms, host clock): the 95th percentile (linear interpolation)
of the latency of every pair completed in the window, each from the host
clock at the ``run_pair`` call to its return."""

import numpy as np


def read(record, cell):
    lat = record.get("latencies_s")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat) * 1e3, 95))
