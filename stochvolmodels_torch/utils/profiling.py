"""
Profiling: a device trace around a block, named regions in it, and a wall
clock that waits for the card.

PyTorch counterpart of ``stochvolmodels_tpu/utils/profiling.py``: the trace
is ``torch.profiler``'s (host operators, plus the CUDA kernels where a card
is present), written as a Chrome/Perfetto JSON file; a named region is a
``torch.profiler.record_function`` range, plus an NVTX range on a card, so
that it shows in the trace and in any NVTX-aware tool.  The pricers carry
no annotations of their own, as the JAX package's do not: the caller wraps
what it wants to see.
"""
from __future__ import annotations

import contextlib
import functools
import os
import tempfile
import time
from typing import Iterator, Optional

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str] = None,
                 create_perfetto_link: bool = False) -> Iterator[str]:
    """trace the body with ``torch.profiler`` and write
    ``<trace_dir>/trace.json`` (Chrome trace format) on exit.

    >>> with device_trace("/tmp/svm_trace") as d:
    ...     pricer.price_chain(option_chain=chain, params=params)

    Open the file in ui.perfetto.dev or chrome://tracing.  CPU activity is
    always recorded, CUDA activity where a card is present.  ``trace_dir``
    defaults to a new temporary directory; the directory is what the block
    receives.  ``create_perfetto_link`` is accepted for the JAX package's
    signature (there is no server to link to).
    """
    del create_perfetto_link
    from torch.profiler import ProfilerActivity, profile

    trace_dir = trace_dir or tempfile.mkdtemp(prefix="svm_trace_")
    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield trace_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))


class annotate:
    """a named region of the trace; a context manager or a decorator.

    >>> with annotate("fourier_inversion"):
    ...     prices = vanilla_prices_with_mgf_grid(...)

    Opens ``torch.profiler.record_function(name)`` and, on a card, an NVTX
    range of the same name.
    """

    def __init__(self, name: str):
        self.name = name
        self._stack: Optional[contextlib.ExitStack] = None

    def __enter__(self):
        stack = contextlib.ExitStack()
        stack.enter_context(torch.profiler.record_function(self.name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(self.name))
        self._stack = stack
        return self

    def __exit__(self, *exc):
        stack, self._stack = self._stack, None
        return stack.__exit__(*exc)

    def __call__(self, fn):
        # a fresh region per call, so that nested and recursive calls each get their own
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with annotate(self.name):
                return fn(*args, **kwargs)
        return wrapped


@contextlib.contextmanager
def wall_and_device_time() -> Iterator[dict]:
    """wall-clock seconds of the body, the card's queued work included: the
    yielded dict gets ``wall_s`` on exit, after a synchronise where there is
    a card."""
    out = {}
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        yield out
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        out["wall_s"] = time.perf_counter() - t0
