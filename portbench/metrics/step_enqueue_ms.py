"""step_enqueue_ms: the mean host wall time of one engine step call
(engine/fmajor.py step_coef_steady and the fade steps, wrapped from
portbench/trace.py) outside the profiled slice: the time the host spends
enqueuing a step's device work."""

import numpy as np


def read(run):
    return float(np.mean(run.step_host_s)) * 1e3 if run.step_host_s else None
