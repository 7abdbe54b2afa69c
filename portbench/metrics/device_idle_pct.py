"""device_idle_pct: 100 * (1 - the union of device activity intervals
over the wall time of the profiled slice), from torch.profiler."""

def read(run):
    prof = run.profile
    if prof is None or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
