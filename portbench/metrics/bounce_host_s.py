"""bounce_host_s: the mean, over the traced window's bounces, of the
program's ``bounce`` span less its ``bounce.loop`` and ``bounce.drain``
children (runtime/offline.py render_offline): the host's own work around
the step loop, from the input checks and the block tensor to the output's
transpose and decode, in seconds."""

import numpy as np


def read(run):
    stages = getattr(run, "stages", None)
    if not stages:
        return None
    return float(np.mean([s["bounce"] - s.get("bounce.loop", 0.0)
                          - s.get("bounce.drain", 0.0) for s in stages]))
