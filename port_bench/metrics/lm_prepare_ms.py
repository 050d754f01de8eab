"""lm_prepare_ms: the program's ``svt.lm.prepare`` spans (a fit from its
entry to its graph replay: vol scaler, chain lowering, target panels, host
vegas and the input uploads), summed over the traced fits, per fit
(profiler clock); None where the trace holds no such span."""
try:
    from stochvolmodels_torch.utils.profiling import LM_PREPARE_SPAN
except ImportError:     # a program without the span
    LM_PREPARE_SPAN = None


def read(trace):
    durations = [d for n, _, d in trace.host if n == LM_PREPARE_SPAN]
    if not durations or not trace.n_requests:
        return None
    return 1e-6 * sum(durations) / trace.n_requests
