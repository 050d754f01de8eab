"""
CUDA graphs for the port's launch-bound loops.

The analytic paths are thousands of small elementwise kernels, each behind a
few microseconds of host work.  A captured CUDA graph launches them all with
one host call.  These calls go through this module: the 200-step BSM
bisection (``ops/bsm.py``, one graph per panel shape), the whole
Levenberg-Marquardt fit of LogSV and of Heston
(``models/logsv/fast_calibration.py``, ``models/heston.py``), the Hawkes
chain reprice, plain or risk-premia, and the Hawkes LM's initial state and
its one iteration, replayed once per iteration (``models/hawkes_jd.py``),
the LogSV Q_VAR reprice, densities and QMC slices and the Heston QMC slices
(``models/logsv/pricer.py``, ``models/heston.py``), each chain-greeks
program (``models/greeks.py``), the exponential-Euler affine solve
(``models/logsv/affine.py``), the factor-HJM swaption cube reprice, frozen
or traced, and each of its greeks, the rates Riccati RK4 of the adaptive
tanh-sinh pricer, the cube LM's initial state and its iteration, and each
rates Monte-Carlo segment (``models/factor_hjm/``); each is one graph per
shape and static configuration.

A graph replays the exact kernels that the eager call launches, on the same
inputs, so its outputs equal the eager call's bit for bit.  There is no
fallback: a capture that fails raises, and ``run_captured`` called inside a
``torch.func`` transform or inside another capture raises.  ``use_graph``
says False there, so the model code runs such a call eagerly and the
enclosing program (the greeks' jvps, or a graph that holds the whole
program) takes its kernels.  ``eager()``
switches capture off for a block, explicitly, so that a caller can time the
eager call or hold the two against each other.  On the CPU nothing is
captured.

Each capture's two phases are timed (``WARMUP_S``, ``RECORD_S``); a replay
and a capture are the spans ``GRAPH_REPLAY_SPAN`` and ``GRAPH_CAPTURE_SPAN``
of ``utils/profiling.py``, seen where a profiler runs.
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Callable, Hashable, Sequence, Tuple

import torch

from stochvolmodels_torch.utils.profiling import GRAPH_CAPTURE_SPAN, GRAPH_REPLAY_SPAN, annotate

# at most this many graphs are kept; the least recently used one goes first
MAX_GRAPHS = 16
# graph replays by the name of the call, for launch checks
REPLAYS: collections.Counter = collections.Counter()
# graph captures by the name of the call
CAPTURES: collections.Counter = collections.Counter()
# seconds of the captures by the name of the call: the eager warm-up on a
# side stream, to the end of its device work, and the stream capture with
# the graph's instantiation
WARMUP_S: collections.Counter = collections.Counter()
RECORD_S: collections.Counter = collections.Counter()

_capture_enabled = True
_graphs: "collections.OrderedDict[Hashable, _Captured]" = collections.OrderedDict()
# one capture stream a device: torch.cuda.graph's default stream is made once, on the device
# current at the first capture, and a graph of another device cannot be captured on it
_capture_streams: "dict[torch.device, torch.cuda.Stream]" = {}


@contextlib.contextmanager
def eager():
    """run the captured calls eagerly inside the block (on the card too)."""
    global _capture_enabled
    before, _capture_enabled = _capture_enabled, False
    try:
        yield
    finally:
        _capture_enabled = before


def use_graph(tensor: torch.Tensor) -> bool:
    """True where a call on this tensor's device runs through a graph:
    capture is on, the tensor lies on a CUDA device, and the call is not
    made inside a ``torch.func`` transform or inside another capture (the
    enclosing program, or its graph, holds the call's kernels then)."""
    return (_capture_enabled and tensor.is_cuda
            and torch._C._functorch.maybe_current_level() is None
            and not torch.cuda.is_current_stream_capturing())


class _Captured:
    """one captured call of ``fn`` on static copies of its inputs."""

    def __init__(self, name: str, fn: Callable[..., Tuple[torch.Tensor, ...]],
                 inputs: Sequence[torch.Tensor]):
        device = inputs[0].device
        t0 = time.perf_counter()
        self.static_inputs = [torch.empty(x.shape, dtype=x.dtype, device=x.device)
                              for x in inputs]
        for s, x in zip(self.static_inputs, inputs):
            s.copy_(x)
        with torch.cuda.device(device):
            # warm up on a side stream: first-use allocations, lazy cuBLAS
            # set-up and cached constants happen outside the captured region
            side = torch.cuda.Stream(device=device)
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn(*self.static_inputs)
            torch.cuda.current_stream().wait_stream(side)
            # the capture below synchronises the card first anyway
            side.synchronize()
            t1 = time.perf_counter()
            if device not in _capture_streams:
                _capture_streams[device] = torch.cuda.Stream(device=device)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=_capture_streams[device]):
                self.static_outputs = fn(*self.static_inputs)
        WARMUP_S[name] += t1 - t0
        RECORD_S[name] += time.perf_counter() - t1

    def __call__(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        with annotate(GRAPH_REPLAY_SPAN):
            for s, x in zip(self.static_inputs, inputs):
                s.copy_(x)
            self.graph.replay()
            return tuple(o.clone() for o in self.static_outputs)


def run_captured(name: str, key: Hashable, fn: Callable[..., Tuple[torch.Tensor, ...]],
                 inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """``fn(*inputs)`` (a tuple of tensors) through the graph cached under
    ``(name, key)``, captured at its first use.

    ``fn`` must launch the same kernels for every input of the key's shapes
    and never wait for the host; the graph reads its inputs from static
    buffers that each call copies ``inputs`` into, and the outputs are
    cloned out of the graph's pool.
    """
    if torch._C._functorch.maybe_current_level() is not None:
        raise RuntimeError(f"{name}: a captured graph cannot run inside a torch.func transform")
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{name}: a captured graph cannot run inside another capture")
    full_key = (name, key)
    entry = _graphs.get(full_key)
    if entry is None:
        while len(_graphs) >= MAX_GRAPHS:
            _graphs.popitem(last=False)
        try:
            with annotate(GRAPH_CAPTURE_SPAN):
                entry = _Captured(name, fn, inputs)
        except RuntimeError as exc:
            raise RuntimeError(f"{name}: CUDA graph capture failed: {exc}") from exc
        _graphs[full_key] = entry
        CAPTURES[name] += 1
    else:
        _graphs.move_to_end(full_key)
    REPLAYS[name] += 1
    return entry(inputs)
