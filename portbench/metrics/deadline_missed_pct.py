"""deadline_missed_pct: the share, in percent, of the traced run's blocks
before its profiled slice whose stamp-to-stamp time exceeds one block
period (256 / 44100 s = 5.805 ms)."""

import numpy as np


def read(run):
    lat = run.latencies_ms()
    if not len(lat):
        return None
    return float(np.mean(lat > run.deadline_ms) * 100.0)
