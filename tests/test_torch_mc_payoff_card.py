"""The MC payoff kernels (``csrc/mc_payoff.cu``) on a card.

This file imports no JAX, so that it runs where the card is
(``python3 -m pytest --noconftest tests/test_torch_mc_payoff_card.py``).
Every test is marked ``gpu`` and skips without a CUDA device: the kernels
have no CPU mode.

``mc_vars_payoff_cuda`` is held to the plain version ``mc_vars_payoff`` on
the same card at 1e-12 relative on prices and standard errors, NaN where
it gives NaN: the kernels take each element through the same float64
operations and sum in another order.  The cases: the benchmark's shapes
(4,194,304 float32 paths, the BTC chain's four slices, strikes and codes),
float64 input, Q_VAR, inverse and plain options with NaN and inf paths, a
slice whose paths are all NaN, 40 strikes (three tiles), a path count that
is no multiple of a block, antithetic pairs and 8 replicates.  Two calls on
one input give equal bits, and a LogSV MC chain call with ``engine='cuda'``
launches the payoff kernels once a slice.
"""
import numpy as np
import pytest
import torch

import stochvolmodels_torch as svt
from stochvolmodels_torch.config import VariableType
from stochvolmodels_torch.ops import payoffs

RTOL = 1e-12
BENCH_PATHS = 4_194_304


@pytest.fixture
def cuda_device():
    """a CUDA device, or a skip: the hand-written kernels run on the card only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernel has no CPU mode")
    return torch.device("cuda")


def _state(device, nb_path, ttm, dtype=torch.float32, seed=0):
    """terminal log-returns and quadratic variances of a BTC-like slice (vol ~0.9)."""
    g = torch.Generator(device=device).manual_seed(seed)
    vol = 0.9
    x = (torch.randn(nb_path, generator=g, device=device, dtype=torch.float64)
         * (vol * np.sqrt(ttm)) - 0.5 * vol * vol * ttm).to(dtype)
    q = (vol * vol * ttm * (0.5 + torch.rand(nb_path, generator=g, device=device,
                                              dtype=torch.float64))).to(dtype)
    return x, q


def _both(x, q, ttm, forward, strikes, codes, **kw):
    device = x.device
    strikes = torch.as_tensor(np.asarray(strikes, dtype=np.float64), device=device)
    codes = torch.as_tensor(np.asarray(codes, dtype=np.int8), device=device)
    out = payoffs.mc_vars_payoff_cuda(x, q, ttm, forward, strikes, codes, **kw)
    ref = payoffs.mc_vars_payoff(x, q, ttm, forward, strikes, codes, **kw)
    torch.cuda.synchronize()
    return out, ref


def _assert_matches(out, ref):
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, r, rtol=RTOL, atol=0.0, equal_nan=True)


def _codes(optiontypes, inverse=False):
    codes = np.array([1 if t in ("C", "IC") else 0 for t in optiontypes], dtype=np.int8)
    return codes | (2 if inverse else 0)


@pytest.mark.gpu
def test_benchmark_shapes_on_the_btc_chain(cuda_device):
    chain = svt.get_btc_test_chain_data()
    for i, ttm in enumerate(chain.ttms):
        x, q = _state(cuda_device, BENCH_PATHS, float(ttm), seed=i)
        out, ref = _both(x, q, float(ttm), float(chain.forwards[i]), chain.strikes_ttms[i],
                         _codes(chain.optiontypes_ttms[i]),
                         discfactor=float(chain.discfactors[i]))
        assert torch.all(torch.isfinite(out[0])) and torch.all(out[1] > 0)
        _assert_matches(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["f64", "qvar", "nan_inf_plain", "nan_inf_inverse", "all_nan",
                                  "forty_strikes", "ragged_path_count", "antithetic",
                                  "replicates"])
def test_kernel_matches_plain_version(cuda_device, case):
    nb_path = {"ragged_path_count": 1_000_003, "antithetic": 1_000_002}.get(case, 1 << 20)
    dtype = torch.float64 if case in ("f64", "antithetic") else torch.float32
    ttm, forward = 0.25, 60_000.0
    x, q = _state(cuda_device, nb_path, ttm, dtype=dtype, seed=7)
    strikes = np.linspace(40_000.0, 90_000.0, 40 if case == "forty_strikes" else 13)
    optiontypes = np.where(strikes < forward, "P", "C")
    kw = dict(discfactor=0.98)
    if case == "qvar":
        strikes = np.linspace(0.2, 1.4, 13) ** 2
        kw["variable_type"] = VariableType.Q_VAR
    if case.startswith("nan_inf"):
        idx = torch.randperm(nb_path, device=cuda_device)[:300]
        x[idx[:200]] = float("nan")
        x[idx[200:250]] = float("inf")
        x[idx[250:]] = -float("inf")
    if case == "all_nan":
        x[:] = float("nan")
    if case == "antithetic":
        kw["antithetic"] = True
    if case == "replicates":
        kw["nb_replicates"] = 8
    inverse = case in ("nan_inf_inverse", "all_nan", "antithetic")
    out, ref = _both(x, q, ttm, forward, strikes, _codes(optiontypes, inverse), **kw)
    _assert_matches(out, ref)
    if case == "all_nan":
        assert torch.all(torch.isnan(out[0])) and torch.all(torch.isnan(out[1]))


@pytest.mark.gpu
def test_two_calls_give_equal_bits(cuda_device):
    x, q = _state(cuda_device, BENCH_PATHS, 0.1, seed=3)
    strikes = np.linspace(50_000.0, 90_000.0, 15)
    codes = _codes(np.where(strikes < 67_000.0, "P", "C"))
    first, _ = _both(x, q, 0.1, 67_000.0, strikes, codes)
    second, _ = _both(x, q, 0.1, 67_000.0, strikes, codes)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_a_chain_call_launches_the_payoff_kernels_once_a_slice(cuda_device):
    chain = svt.get_btc_test_chain_data()
    before = payoffs.mc_vars_payoff_cuda.launches
    svt.LogSVPricer(device=cuda_device).model_mc_price_chain(
        chain, svt.LOGSV_BTC_PARAMS, nb_path=1 << 18, nb_steps=360, seed=5, engine="cuda")
    assert payoffs.mc_vars_payoff_cuda.launches == before + len(chain.ttms)
