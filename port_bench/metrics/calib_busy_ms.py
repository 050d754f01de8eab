"""calib_busy_ms: device busy time per LM fit (the union of the profiler's
device records)."""


def read(trace):
    if not trace.n_requests:
        return None
    return 1e3 * trace.busy_s / trace.n_requests
