"""The CUDA graphs of the launch-bound calls (``stochvolmodels_torch/ops/graphs.py``).

On the CPU nothing is captured: the calls run eagerly because their tensors
lie on the CPU, and the guards that make a misplaced capture raise hold.  On
a card (``gpu``-marked, skipped here) the captured bisection and LM fit
equal the eager calls bit for bit.
"""
import numpy as np
import pytest
import torch

from _torch_port import btc_chains, cuda_device  # noqa: F401

import stochvolmodels_torch as svt
from stochvolmodels_torch.ops import graphs

PARAMS0 = dict(sigma0=0.8, theta=1.0, kappa1=2.21, kappa2=2.18, beta=0.15, volvol=1.85)


def test_calls_on_cpu_tensors_are_not_captured():
    cpu = torch.zeros(3, dtype=torch.float64)
    assert not graphs.use_graph(cpu)
    with graphs.eager():
        assert not graphs.use_graph(cpu)
    before = dict(graphs.REPLAYS)
    _, ct = btc_chains()
    svt.LogSVPricer(device="cpu").compute_model_ivols_for_chain(ct, svt.LOGSV_BTC_PARAMS)
    assert dict(graphs.REPLAYS) == before


def test_eager_restores_capture_after_an_error():
    with pytest.raises(ValueError):
        with graphs.eager():
            raise ValueError
    assert graphs._capture_enabled


def test_a_graph_cannot_run_inside_a_torch_func_transform():
    def inside(x):
        return graphs.run_captured("probe", (), lambda a: (a,), (x,))[0]

    with pytest.raises(RuntimeError, match="torch.func"):
        torch.func.vmap(inside)(torch.zeros(2, 3, dtype=torch.float64))


@pytest.mark.gpu
def test_captured_bisection_equals_eager(cuda_device):  # noqa: F811
    _, ct = btc_chains()
    pricer = svt.LogSVPricer(device=cuda_device)
    prices = pricer.price_chain(ct, svt.LOGSV_BTC_PARAMS)
    with graphs.eager():
        eager = ct.compute_model_ivols_from_chain_data(prices, device=cuda_device)
    before = graphs.REPLAYS["bisection"]
    captured = ct.compute_model_ivols_from_chain_data(prices, device=cuda_device)
    assert graphs.REPLAYS["bisection"] == before + 1
    for a, b in zip(captured, eager):
        np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_captured_lm_fit_equals_eager(cuda_device):  # noqa: F811
    _, ct = btc_chains()
    kw = dict(nb_iters=2, year_steps=60, device=cuda_device)
    with graphs.eager():
        eager_fit, eager_cost = svt.calibrate_logsv_lm_on_device(ct, svt.LogSvParams(**PARAMS0),
                                                                 **kw)
    fit, cost = svt.calibrate_logsv_lm_on_device(ct, svt.LogSvParams(**PARAMS0), **kw)
    assert cost == eager_cost and fit.to_dict() == eager_fit.to_dict()
