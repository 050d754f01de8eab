"""mc_chain_mfu (%): the least time of the traced MC chain calls at the
card's peaks (frozen path-loop operations at the float32 peak, float64
payoff operations counted from the shapes at the float64 peak) over the
traced window."""
from bench_lib import yardstick


def read(trace):
    info = trace.info
    return yardstick.share_percent(trace.n_requests * yardstick.chain_call_least_s(info),
                                   trace.window_s)
