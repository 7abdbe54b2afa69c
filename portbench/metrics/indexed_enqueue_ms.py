"""indexed_enqueue_ms: the mean host wall time of one crossfading step
call, the session's ``step.indexed`` span (engine/fmajor.py
step_coef_indexed: the steady block plus the span fade term, run
eagerly), over the traced window's blocks before its profiled slice, in
milliseconds."""

import numpy as np


def read(run):
    ms = getattr(run, "span_ms", {}).get("step.indexed")
    return float(np.mean(ms)) if ms else None
