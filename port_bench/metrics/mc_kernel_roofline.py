"""mc_kernel_roofline (%): the least time of the traced calls' path loops
(the larger of their frozen operation count over the float32 peak and their
state bytes over HBM) over the profiler's summed time of the path kernel's
records."""
from bench_lib import yardstick


def read(trace):
    info = trace.info
    kernel_s = trace.kernel_seconds(info["path_kernel"])
    return yardstick.share_percent(trace.n_requests * yardstick.path_loop_least_s(info), kernel_s)
