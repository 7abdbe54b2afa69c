"""select_ms: the mean, over the traced window's re-select blocks before
its profiled slice, of the session's ``select`` span (runtime/stream.py
_collapse: the re-selected channels' fades re-based, collapse_pure while
every fade stays in the bank's span), in milliseconds."""

import numpy as np


def read(run):
    ms = getattr(run, "span_ms", {}).get("select")
    return float(np.mean(ms)) if ms else None
