"""
Profiling: a device trace around a block, the program's named spans in it,
its host-device transfers, and a wall clock that waits for the card.

PyTorch counterpart of ``stochvolmodels_tpu/utils/profiling.py``: the trace
is ``torch.profiler``'s (host operators, plus the CUDA kernels where a card
is present), written as a Chrome/Perfetto JSON file.  A span
(:class:`annotate`) is a profiler range on the host's timeline, plus an
NVTX range on a card.  It records only while a profiler runs
(``torch.profiler.profile``, or ``torch.autograd.profiler.emit_nvtx``) and
costs a flag read otherwise.  The profiler keeps the spans on the clock of
its device records, so a reader of the trace finds each layer's boundaries
beside the kernels and copies issued inside them.

The program's spans are the ``*_SPAN`` names below, at its layer
boundaries.  None sits inside a function that ``ops/graphs.py`` captures:
such a span would record once, at the capture, and never at a replay.
Every host-to-device and device-to-host transfer of the MC chain call and
of the LM fits goes through :func:`to_device` and :func:`to_host`, one span
each, so that counting the spans counts the transfers.
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
# throwaway kernels that open every device_trace on a card: torch.profiler
# (CUPTI) drops the first device records of a session, more of them the more
# sessions the process has traced (0-26 in a row of traces on an H100, 406 at
# one session's start), and these absorb the loss
TRACE_WARMUP_KERNELS = 512

# one MC chain call (LogSVPricer / HestonPricer .model_mc_price_chain)
MC_CHAIN_SPAN = "svt.mc_chain"
# a slice's path-kernel launch (ops/cuda_mc.py simulate_*_terminal_kernel)
MC_PATH_SPAN = "svt.mc.path"
# a slice's payoff panels and reductions, as enqueued (ops/payoffs.py mc_vars_payoff)
MC_PAYOFF_SPAN = "svt.mc.payoff"
# one LM fit (calibrate_logsv_lm_on_device, calibrate_heston_lm)
LM_FIT_SPAN = "svt.lm_fit"
# a fit from its entry to its graph (or eager) run: vol scaler, chain
# lowering, target panels, host vegas and the input uploads
LM_PREPARE_SPAN = "svt.lm.prepare"
# a captured graph's static-input copies, replay and output clones
GRAPH_REPLAY_SPAN = "svt.graph.replay"
# a graph's warm-up and capture, at the first call of its key
GRAPH_CAPTURE_SPAN = "svt.graph.capture"
# one host-to-device transfer (to_device)
UPLOAD_SPAN = "svt.upload"
# one device-to-host transfer (to_host)
FETCH_SPAN = "svt.fetch"


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str] = None,
                 create_perfetto_link: bool = False) -> Iterator[str]:
    """trace the body with ``torch.profiler`` and write
    ``<trace_dir>/trace.json`` (Chrome trace format) on exit.

    >>> with device_trace("/tmp/svm_trace") as d:
    ...     pricer.price_chain(option_chain=chain, params=params)

    Open the file in ui.perfetto.dev or chrome://tracing.  CPU activity is
    always recorded, CUDA activity where a card is present; the card is
    synchronised before the profiler starts, so that work queued before the
    block does not straddle its start, and the trace opens with
    ``TRACE_WARMUP_KERNELS`` one-element ``add_`` kernels, which take the
    device records that the profiler drops at a session's start in place of
    the block's.  ``trace_dir`` defaults to a new
    temporary directory; the directory is what the block receives.
    ``create_perfetto_link`` is accepted for the JAX package's signature
    (there is no server to link to).
    """
    del create_perfetto_link
    from torch.profiler import ProfilerActivity, profile

    trace_dir = trace_dir or tempfile.mkdtemp(prefix="svm_trace_")
    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        if torch.cuda.is_available():
            warm = torch.zeros(1, device="cuda")
            for _ in range(TRACE_WARMUP_KERNELS):
                warm.add_(1)
            torch.cuda.synchronize()
        yield trace_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))


class annotate:
    """a named span of the trace; a context manager or a decorator.

    >>> with annotate("fourier_inversion"):
    ...     prices = vanilla_prices_with_mgf_grid(...)

    While a profiler runs, opens a profiler range of the name (a host-side
    record function: the device's records stay the kernels' and copies'
    own) and, on a card, an NVTX range of the same name.  With no profiler
    running it records nothing.
    """

    def __init__(self, name: str):
        self.name = name
        self._stack: Optional[contextlib.ExitStack] = None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            stack = contextlib.ExitStack()
            stack.enter_context(torch._C._profiler._RecordFunctionFast(self.name))
            if torch.cuda.is_available():
                stack.enter_context(torch.cuda.nvtx.range(self.name))
            self._stack = stack
        return self

    def __exit__(self, *exc):
        stack, self._stack = self._stack, None
        return stack.__exit__(*exc) if stack is not None else False

    def __call__(self, fn):
        # a fresh span per call, so that nested and recursive calls each get their own
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with annotate(self.name):
                return fn(*args, **kwargs)
        return wrapped


def to_device(array, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.as_tensor(array, dtype=dtype, device=device)`` in an
    ``UPLOAD_SPAN``: the program's host-to-device transfers."""
    with annotate(UPLOAD_SPAN):
        return torch.as_tensor(array, dtype=dtype, device=device)


def to_host(tensor: torch.Tensor):
    """the tensor as a numpy array on the host, in a ``FETCH_SPAN``: the
    program's device-to-host transfers (each waits for the card)."""
    with annotate(FETCH_SPAN):
        return tensor.detach().cpu().numpy()


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
