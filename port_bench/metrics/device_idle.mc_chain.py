"""device_idle.mc_chain (%): 100 (1 - device busy / traced window), busy the
union of the profiler's device records, over the MC chain calls."""


def read(trace):
    if trace.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
