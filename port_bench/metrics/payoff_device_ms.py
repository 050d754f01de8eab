"""payoff_device_ms: device time per MC chain call of every record but the
path kernel's (the payoff panels, their reductions and copies), from the
profiler."""


def read(trace):
    info = trace.info
    if not trace.n_requests:
        return None
    other_s = trace.kernel_seconds() - trace.kernel_seconds(info["path_kernel"])
    return 1e3 * other_s / trace.n_requests
