"""Shared helpers of the ``tests/test_torch_*.py`` parity tests.

Each test feeds the same inputs, made with numpy, to the JAX package (the
reference, on the CPU in float64 as its own tests run it) and to its PyTorch
port, and holds the two against a stated tolerance.  Importing this module
pins torch to one intra-op thread: the suite runs with several xdist
workers on a few cores.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import stochvolmodels_tpu as svj  # noqa: E402
import stochvolmodels_torch as svt  # noqa: E402

# the README quick-start parameters
README_PARAMS = dict(sigma0=0.8, theta=1.0, kappa1=5.0, kappa2=5.0, beta=0.15, volvol=2.0)


def btc_chains():
    """the bundled BTC chain in both packages, the port's built from the JAX
    chain's ragged arrays."""
    cj = svj.get_btc_test_chain_data()
    ct = svt.chain_from_numpy(ttms=cj.ttms, forwards=cj.forwards,
                              strikes_ttms=cj.strikes_ttms,
                              optiontypes_ttms=cj.optiontypes_ttms,
                              discfactors=cj.discfactors, ids=cj.ids, ticker=cj.ticker,
                              bid_ivs=cj.bid_ivs, ask_ivs=cj.ask_ivs)
    return cj, ct


def param_pair(**kw):
    """the same LogSV parameters in both packages, carried through to_dict()."""
    pj = svj.LogSvParams(**kw)
    return pj, svt.params_from_numpy(pj.to_dict())


@pytest.fixture
def cuda_device():
    """a CUDA device, or a skip: the hand-written kernels run on the card only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernel has no CPU mode")
    return torch.device("cuda")


def assert_same_nan_pattern(a, b):
    np.testing.assert_array_equal(np.isnan(np.asarray(a)), np.isnan(np.asarray(b)))
