"""
The traced window: torch.profiler (CPU and CUDA activity) around a fixed
number of requests, each inside a ``bench.request`` span, reduced to the
device's kernel records, its busy time and the longest idle gaps.  Requests
that the profiler runs before the first span (the traffic's
``trace_warmup``) stay outside the window.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

REQUEST_SPAN = "bench.request"


@dataclass
class Trace:
    """what the readers of per-layer metrics see of a traced window."""
    kernels: List[Tuple[str, int, int]]          # (name, start ns, duration ns), device records
    host: List[Tuple[str, int, int]]             # CPU events: (name, start ns, duration ns)
    window: Tuple[int, int]                      # first request start, last request end (ns)
    n_requests: int
    spans: List[Tuple[str, int, int]] = field(default_factory=list)   # the request spans
    info: Dict = field(default_factory=dict)     # the entry's counts (work per call, names)
    setup: Dict = field(default_factory=dict)    # the entry's set-up spans and counters

    @property
    def window_s(self) -> float:
        return 1e-9 * (self.window[1] - self.window[0])

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """the union of the device records' intervals inside the window."""
        spans = sorted((max(s, self.window[0]), min(s + d, self.window[1]))
                       for _, s, d in self.kernels)
        merged: List[List[int]] = []
        for s, e in spans:
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return 1e-9 * sum(e - s for s, e in self.busy_intervals())

    def kernel_seconds(self, contains: str = "") -> float:
        return 1e-9 * sum(d for n, _, d in self.kernels if contains in n)

    def device_ops(self, top: int = 10) -> List[List]:
        totals: Dict[str, int] = {}
        for n, _, d in self.kernels:
            totals[n[:160]] = totals.get(n[:160], 0) + d
        return [[n, 1e-9 * t] for n, t in sorted(totals.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """the longest device-idle gaps of the window, each named by the
        innermost host event that covers its start ("host: between
        requests" where none does)."""
        edges = [self.window[0]]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(self.window[1])
        gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:top]
        out = []
        for length, start in gaps:
            covering = [(s, n) for n, s, d in self.host if s <= start < s + d]
            if covering:
                name = f"host: {max(covering)[1]}"[:160]
            elif any(s <= start < s + d for _, s, d in self.spans):
                name = "host: inside a request, no op recorded"
            else:
                name = "host: between requests"
            out.append([name, 1e-9 * length])
        return out


def record(run_requests, n_requests: int) -> Trace:
    """run ``run_requests()`` (which calls each request inside a
    ``REQUEST_SPAN`` record_function) under the profiler and reduce it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.cuda.is_available()
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    sync()
    with profile(activities=activities) as prof:
        run_requests()
        sync()
    kernels, host, spans = [], [], []
    for ev in prof.profiler.kineto_results.events():
        item = (ev.name(), int(ev.start_ns()), int(ev.duration_ns()))
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if ev.name() != REQUEST_SPAN:      # the span's own device-side annotation
                kernels.append(item)
        elif ev.name() == REQUEST_SPAN:
            spans.append(item)
        else:
            host.append(item)
    if len(spans) != n_requests:
        raise RuntimeError(f"the trace holds {len(spans)} request spans, not {n_requests}")
    window = (min(s for _, s, _ in spans), max(s + d for _, s, d in spans))
    # what ran before the first span (requests that warm the profiler) is
    # not the window's
    kernels = [k for k in kernels if window[0] <= k[1] < window[1]]
    host = [h for h in host if h[1] + h[2] > window[0] and h[1] < window[1]]
    return Trace(kernels=kernels, host=host, window=window, n_requests=n_requests,
                 spans=spans)
