"""
CPU tests of the readers of the program's spans and capture counters, on
traces and counters built by hand: the transfer counts inside the request
spans, the preparation time a fit, the capture phases behind their guard,
and the device-idle time behind the blocking fetches (an idle interval
clipped to its request, one interval shared by two fetches counted once);
each reader gives None where the trace holds none of what it reads.

    python -m pytest port_bench/tests -q
"""
from __future__ import annotations

import collections
import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
for _p in (ROOT, BENCH_DIR):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from bench_lib import cells, trace  # noqa: E402
from stochvolmodels_torch.ops import graphs  # noqa: E402
from stochvolmodels_torch.utils import profiling  # noqa: E402

UP, FETCH = profiling.UPLOAD_SPAN, profiling.FETCH_SPAN
REQ = trace.REQUEST_SPAN


def _reader(name: str):
    return cells.load_module(BENCH_DIR / "metrics" / f"{name}.py", f"test_spans_{name}").read


def _trace(kernels=(), host=(), spans=(), window=(0, 1000), n=1, setup=None):
    return trace.Trace(kernels=list(kernels), host=list(host), window=window, n_requests=n,
                       spans=list(spans), setup=dict(setup or {}))


@pytest.mark.parametrize("name", ["lm_host_copies", "mc_host_copies"])
def test_host_copies_count_the_transfer_spans_inside_the_requests(name):
    read = _reader(name)
    host = [(UP, 10, 5), (UP, 20, 5), (FETCH, 400, 50), ("aten::copy_", 30, 5),
            (FETCH, 600, 10),                   # inside the second request
            (UP, 900, 5)]                       # between the requests: not a request's
    spans = [(REQ, 0, 500), (REQ, 550, 300)]
    assert read(_trace(host=host, spans=spans, n=2)) == pytest.approx(4 / 2)
    assert read(_trace(host=[("aten::copy_", 10, 5)], spans=spans, n=2)) is None
    assert read(_trace()) is None


def test_lm_prepare_ms_sums_the_spans_a_fit():
    read = _reader("lm_prepare_ms")
    host = [(profiling.LM_PREPARE_SPAN, 0, 40_000_000), (profiling.LM_FIT_SPAN, 0, 900_000_000),
            (profiling.LM_PREPARE_SPAN, 1_000_000_000, 60_000_000)]
    t = _trace(host=host, window=(0, 2_000_000_000), n=2)
    assert read(t) == pytest.approx(50.0, rel=1e-12)
    assert read(_trace(host=[(profiling.LM_FIT_SPAN, 0, 10)])) is None


@pytest.mark.parametrize("name,counter", [("graph_warmup_s", "WARMUP_S"),
                                          ("graph_record_s", "RECORD_S")])
def test_capture_phases_behind_the_capture_guard(name, counter, monkeypatch):
    read = _reader(name)
    monkeypatch.setattr(graphs, "CAPTURES", collections.Counter({"lm": 1}))
    monkeypatch.setattr(graphs, "WARMUP_S", collections.Counter({"lm": 17.25}))
    monkeypatch.setattr(graphs, "RECORD_S", collections.Counter({"lm": 36.5}))
    one = {"graph_capture_s": 55.0, "graph_captures": 1}
    assert read(_trace(setup=one)) == {"WARMUP_S": 17.25, "RECORD_S": 36.5}[counter]
    # no capture in the set-up's first fit, or a cell without the span
    assert read(_trace(setup=dict(one, graph_captures=0))) is None
    assert read(_trace()) is None
    # another graph captured in the process: the counter is not the fit's alone
    monkeypatch.setattr(graphs, "CAPTURES", collections.Counter({"lm": 1, "bisection": 1}))
    assert read(_trace(setup=one)) is None
    # a program without the counters
    monkeypatch.delattr(graphs, counter)
    monkeypatch.setattr(graphs, "CAPTURES", collections.Counter({"lm": 1}))
    assert read(_trace(setup=one)) is None


def test_mc_sync_idle_ms_clips_and_counts_each_interval_once():
    read = _reader("mc_sync_idle_ms")
    # one request [0, 10_000) ns: the device busy [0, 1_000), [1_100, 1_200), [1_250, 1_300),
    # [6_000, 7_000); a second request [10_000, 11_800) busy [10_000, 10_500)
    kernels = [("kernel", 0, 1000), ("Memcpy DtoH", 1100, 100), ("Memcpy DtoH", 1250, 50),
               ("kernel", 6000, 1000), ("kernel", 10_000, 500)]
    spans = [(REQ, 0, 10_000), (REQ, 10_000, 1800)]
    host = [(FETCH, 1050, 170),     # ends at 1_220, in the idle [1_200, 1_250): 50 ns
            (FETCH, 1240, 100),     # ends at 1_340, in [1_300, 6_000): 4_700 ns
            (FETCH, 1300, 200),     # ends at 1_500, the same interval: counted once
            (FETCH, 7100, 12_000),  # ends at 19_100: past the window, no interval holds it
            (FETCH, 10_600, 100)]   # ends at 10_700: [10_500, 12_000) clipped to 11_800
    t = _trace(kernels, host, spans, window=(0, 12_000), n=2)
    assert read(t) == pytest.approx(1e-6 * (50 + 4_700 + 1_300) / 2, rel=1e-12)
    # an idle interval that runs past its request is clipped to it
    t = _trace([("kernel", 0, 100)], [(FETCH, 50, 100)], [(REQ, 0, 350)], window=(0, 400))
    assert read(t) == pytest.approx(1e-6 * 250, rel=1e-12)
    # a fetch whose end falls on a busy device costs no idle time
    t = _trace([("kernel", 0, 1000)], [(FETCH, 100, 100)], [(REQ, 0, 1000)])
    assert read(t) == 0.0


def test_mc_sync_idle_ms_none_without_fetches_or_device_records():
    read = _reader("mc_sync_idle_ms")
    spans = [(REQ, 0, 1000)]
    assert read(_trace([("kernel", 0, 10)], [("aten::copy_", 20, 5)], spans)) is None
    assert read(_trace([], [(FETCH, 20, 5)], spans)) is None


def test_new_readers_read_nothing_from_a_trace_without_spans():
    """the accepted cells' traces as a program without the spans leaves them:
    every new reader gives None."""
    empty = _trace([("kernel", 0, 10)], setup={"graph_capture_s": 1.0, "graph_captures": 1})
    for name in ("lm_prepare_ms", "lm_host_copies", "mc_host_copies", "mc_sync_idle_ms"):
        assert _reader(name)(empty) is None, name
