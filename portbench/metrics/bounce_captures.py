"""bounce_captures: the steady ring step's CUDA graph captures per bounce,
the mean over the traced window's bounces of the program's
``steady_captures`` counter (render_offline's counters, read after each
bounce): 0 when every bounce replays the graph captured before the window,
1 when each one captures anew."""

import numpy as np


def read(run):
    counters = getattr(run, "counters", None)
    if not counters:
        return None
    return float(np.mean([c["steady_captures"] for c in counters]))
