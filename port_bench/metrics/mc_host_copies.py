"""mc_host_copies (copies/call): the program's transfer spans (``svt.upload``
host to device, ``svt.fetch`` device to host) that start inside the traced
MC chain calls' request spans, per call; None where the trace holds no such
span."""
try:
    from stochvolmodels_torch.utils.profiling import FETCH_SPAN, UPLOAD_SPAN
except ImportError:     # a program without the spans
    FETCH_SPAN = UPLOAD_SPAN = None


def read(trace):
    copies = [s for n, s, _ in trace.host if n in (UPLOAD_SPAN, FETCH_SPAN)
              and any(rs <= s < rs + rd for _, rs, rd in trace.spans)]
    if not copies or not trace.n_requests:
        return None
    return len(copies) / trace.n_requests
