"""mc_sync_idle_ms: device-idle time per MC chain call that the program's
blocking fetches cost.  For each ``svt.fetch`` span, the device-idle
interval of the window (the complement of the union of the device records)
that holds the span's end, clipped to the request span that holds the
fetch; each interval counted once, summed, over the traced calls.  None
where the trace holds no fetch span or no device record."""
try:
    from stochvolmodels_torch.utils.profiling import FETCH_SPAN
except ImportError:     # a program without the span
    FETCH_SPAN = None


def read(trace):
    fetches = [(s, s + d) for n, s, d in trace.host if n == FETCH_SPAN]
    if not fetches or not trace.kernels or not trace.n_requests:
        return None
    edges = [trace.window[0]]
    for s, e in trace.busy_intervals():
        edges += [s, e]
    edges.append(trace.window[1])
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    counted = set()
    for start, end in fetches:
        request = next(((rs, rs + rd) for _, rs, rd in trace.spans if rs <= start < rs + rd), None)
        gap = next(((a, b) for a, b in idle if a <= end < b), None)
        if request is None or gap is None:
            continue
        a, b = max(gap[0], request[0]), min(gap[1], request[1])
        if b > a:
            counted.add((a, b))
    return 1e-6 * sum(b - a for a, b in counted) / trace.n_requests
