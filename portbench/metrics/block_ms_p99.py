"""block_ms_p99: the 99th percentile, over every block delivered in the
window, of the host-clock time from the source handing the block over to
the sink receiving it (the session's whole path: upload, step, fetch,
delivery)."""

import numpy as np


def read(run):
    lat = run.latencies_ms()
    return float(np.percentile(lat, 99)) if len(lat) else None
