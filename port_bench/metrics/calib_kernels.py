"""calib_kernels (kernels/fit): the profiler's device records per LM fit."""


def read(trace):
    if not trace.n_requests:
        return None
    return len(trace.kernels) / trace.n_requests
