"""The port's profiling helpers (``utils/profiling.py``), on the CPU.

``device_trace`` writes a Chrome trace that holds every ``annotate``
region, opened as a decorator and as a context manager (each decorated
call its own region), around a real port call (the BTC chain's Heston
reprice); ``wall_and_device_time`` sets ``wall_s > 0``; the JAX package's
``create_perfetto_link`` is accepted.
"""
import json
import os

from _torch_port import svt  # noqa: F401

from stochvolmodels_torch.utils.profiling import (
    TRACE_FILE,
    annotate,
    device_trace,
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
