"""block_ms_p50: the median of the per-block time from the source handing
a block over to the sink receiving it, over the blocks of the traced run
before its profiled slice (the source's and the sink's stamps)."""

import numpy as np


def read(run):
    lat = run.latencies_ms()
    return float(np.percentile(lat, 50)) if len(lat) else None
