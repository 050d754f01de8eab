"""The port's profiling helpers (``utils/profiling.py``), on the CPU.

``device_trace`` writes a Chrome trace that holds every ``annotate``
region, opened as a decorator and as a context manager (each decorated
call its own region), around a real port call (the BTC chain's Heston
reprice); ``wall_and_device_time`` sets ``wall_s > 0``; the JAX package's
``create_perfetto_link`` is accepted.

The program's spans: with no profiler running a span opens nothing; under
``torch.profiler`` one ``engine='cuda'`` MC chain call (its kernels' plain
versions on the CPU) is one ``svt.mc_chain`` span holding a path and a
payoff span a slice and four transfer spans a slice, and an LM fit is one
``svt.lm_fit`` holding one ``svt.lm.prepare``, 12 uploads and 3 fetches;
the MC chain call prints nothing.
"""
import collections
import json
import os

import numpy as np
import pytest
import torch
from _torch_port import svt  # noqa: F401

from stochvolmodels_torch.ops import graphs
from stochvolmodels_torch.utils import profiling
from stochvolmodels_torch.utils.profiling import (
    TRACE_FILE,
    annotate,
    device_trace,
    to_device,
    to_host,
    wall_and_device_time,
)


@annotate("heston_reprice")
def reprice(pricer, chain):
    return pricer.price_chain(chain, svt.BTC_HESTON_PARAMS)


def test_device_trace_holds_the_annotations(tmp_path):
    chain = svt.get_btc_test_chain_data()
    pricer = svt.HestonPricer(device="cpu")
    trace_dir = str(tmp_path / "trace")
    with device_trace(trace_dir, create_perfetto_link=True) as d:
        assert d == trace_dir
        with annotate("two_reprices"):
            reprice(pricer, chain)
            prices = reprice(pricer, chain)
    path = os.path.join(trace_dir, TRACE_FILE)
    assert os.path.getsize(path) > 0
    events = json.load(open(path))["traceEvents"]
    names = [e.get("name") for e in events]
    assert names.count("two_reprices") == 1 and names.count("heston_reprice") == 2
    # the regions nest: the decorated calls lie inside the context manager's
    outer = next(e for e in events if e.get("name") == "two_reprices")
    for inner in (e for e in events if e.get("name") == "heston_reprice"):
        assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert len(prices) == len(chain.ttms)


def test_device_trace_makes_its_own_directory():
    with device_trace() as d:
        with annotate("noop"):
            pass
    assert os.path.isfile(os.path.join(d, TRACE_FILE))


def test_annotate_keeps_the_function_and_its_result():
    assert reprice.__name__ == "reprice"
    with annotate("outside_a_trace") as region:
        assert region.name == "outside_a_trace"


def test_wall_and_device_time_sets_a_positive_wall():
    with wall_and_device_time() as t:
        assert "wall_s" not in t
        svt.HestonPricer(device="cpu").price_chain(svt.get_btc_test_chain_data(),
                                                   svt.BTC_HESTON_PARAMS)
    assert t["wall_s"] > 0.0


# a small MC chain call: the BTC chain's 4 slices, 256 paths, 30 steps a year
MC_SIZES = dict(nb_path=256, seed=5, engine="cuda")
PRICERS = {"logsv": (lambda: svt.LogSVPricer(device="cpu"), svt.LOGSV_BTC_PARAMS,
                     dict(nb_steps=30)),
           "heston": (lambda: svt.HestonPricer(device="cpu"), svt.BTC_HESTON_PARAMS, {})}


def _mc_call(model):
    make, params, extra = PRICERS[model]
    return make().model_mc_price_chain(svt.get_btc_test_chain_data(), params, **MC_SIZES,
                                       **extra)


def _spans(run):
    """the program's spans recorded by ``torch.profiler`` around ``run()``:
    (name, start ns, end ns) in start order, and run's result."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = run()
    spans = sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name())
                   for ev in prof.profiler.kineto_results.events()
                   if ev.name().startswith("svt."))
    return [(n, s, e) for s, e, n in spans], out


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_no_profiler_no_span(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span opened a range with no profiler running")

    for module, name in ((torch._C._profiler, "_RecordFunctionFast"),
                         (torch.profiler, "record_function"),
                         (torch.autograd.profiler, "record_function"),
                         (torch.cuda.nvtx, "range")):
        monkeypatch.setattr(module, name, refuse)
    assert not torch.autograd._profiler_enabled()
    prices, stds = _mc_call("logsv")
    assert len(prices) == 4 and all(np.all(np.isfinite(p)) for p in prices)
    with annotate(profiling.MC_CHAIN_SPAN) as span:
        assert span.name == profiling.MC_CHAIN_SPAN
        back = to_host(to_device(np.arange(3.0), torch.float64, "cpu"))
    np.testing.assert_array_equal(back, np.arange(3.0))


@pytest.mark.parametrize("model", ["logsv", "heston"])
def test_mc_chain_call_spans(model):
    spans, (prices, _) = _spans(lambda: _mc_call(model))
    counts = collections.Counter(n for n, _, _ in spans)
    # per slice: the path kernel, the payoff, strikes and codes up, prices and stderrs back
    assert counts == {profiling.MC_CHAIN_SPAN: 1, profiling.MC_PATH_SPAN: 4,
                      profiling.MC_PAYOFF_SPAN: 4, profiling.UPLOAD_SPAN: 8,
                      profiling.FETCH_SPAN: 8}
    call = next(s for s in spans if s[0] == profiling.MC_CHAIN_SPAN)
    assert all(_inside(s, call) for s in spans)
    # a slice's order: its path launch, two uploads, its payoff, two fetches
    order = [n for n, _, _ in spans if n != profiling.MC_CHAIN_SPAN]
    slice_order = [profiling.MC_PATH_SPAN, profiling.UPLOAD_SPAN, profiling.UPLOAD_SPAN,
                   profiling.MC_PAYOFF_SPAN, profiling.FETCH_SPAN, profiling.FETCH_SPAN]
    assert order == 4 * slice_order
    assert len(prices) == 4


def test_lm_fit_spans():
    chain = svt.get_btc_test_chain_data()
    spans, (fit, cost) = _spans(lambda: svt.calibrate_logsv_lm_on_device(
        chain, svt.LOGSV_BTC_PARAMS, nb_iters=2, year_steps=180, device="cpu"))
    counts = collections.Counter(n for n, _, _ in spans)
    # to_grid's six panels and the fit's six inputs up; the mask, the parameters and the cost back
    assert counts == {profiling.LM_FIT_SPAN: 1, profiling.LM_PREPARE_SPAN: 1,
                      profiling.UPLOAD_SPAN: 12, profiling.FETCH_SPAN: 3}
    fit_span = next(s for s in spans if s[0] == profiling.LM_FIT_SPAN)
    prepare = next(s for s in spans if s[0] == profiling.LM_PREPARE_SPAN)
    assert all(_inside(s, fit_span) for s in spans)
    uploads = [s for s in spans if s[0] == profiling.UPLOAD_SPAN]
    assert all(_inside(s, prepare) for s in uploads)
    # the last two fetches, parameters and cost, follow the preparation
    fetches = [s for s in spans if s[0] == profiling.FETCH_SPAN]
    assert _inside(fetches[0], prepare) and all(s[1] >= prepare[2] for s in fetches[1:])
    assert np.isfinite(cost) and np.isfinite(fit.sigma0)


def test_mc_chain_call_prints_nothing(capsys):
    _mc_call("logsv")
    _mc_call("heston")
    assert capsys.readouterr().out == ""


def test_capture_phase_counters_start_empty_on_the_cpu():
    # nothing is captured on the CPU; the counters sit beside CAPTURES, keyed by call name
    assert isinstance(graphs.WARMUP_S, collections.Counter)
    assert isinstance(graphs.RECORD_S, collections.Counter)
    assert set(graphs.WARMUP_S) == set(graphs.RECORD_S) <= set(graphs.CAPTURES)
