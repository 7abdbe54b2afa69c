"""step_device_ms: the mean time between CUDA events recorded before and
after each engine step call, outside the profiled slice: the device's
span of one step, its waits for the host's enqueue inside it
included."""

import numpy as np


def read(run):
    return float(np.mean(run.step_device_ms)) if run.step_device_ms else None
