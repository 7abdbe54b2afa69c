"""bounce_loop_s: the mean, over the traced window's bounces, of the
program's ``bounce.loop`` span (the pinned output buffer and the step
loop's enqueue) plus its ``bounce.drain`` span (the wait for the device),
in seconds: the step loop as the host sees it."""

import numpy as np


def read(run):
    stages = getattr(run, "stages", None)
    if not stages:
        return None
    return float(np.mean([s.get("bounce.loop", 0.0)
                          + s.get("bounce.drain", 0.0) for s in stages]))
