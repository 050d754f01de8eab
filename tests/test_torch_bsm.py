"""BSM layer of the PyTorch port against the JAX package.

Same ~500 random (forward, strike, ttm, vol, type) through both packages:
``erfcc``/``ncdf``/``npdf``, prices and vegas to 1e-13 relative, and the
200-iteration bisection implied vol to 1e-10 absolute with an identical NaN
pattern (out-of-bracket prices, both ways, are part of the sample).
"""
import numpy as np
import pytest
import torch
from _torch_port import assert_same_nan_pattern

from stochvolmodels_tpu.ops import bsm as jbsm
from stochvolmodels_tpu.ops import gauss as jgauss
from stochvolmodels_torch.ops import bsm as tbsm
from stochvolmodels_torch.ops import gauss as tgauss

N = 500
PRICE_RTOL = 1e-13   # same closed form, float64, libm-level differences only
IV_ATOL = 1e-10      # bisection on prices that agree to ~1e-16


def _sample(seed: int = 0):
    rng = np.random.default_rng(seed)
    forward = rng.uniform(50.0, 150.0, N)
    strike = forward * np.exp(rng.uniform(-0.8, 0.8, N))
    ttm = rng.uniform(0.01, 2.0, N)
    vol = rng.uniform(0.05, 2.0, N)
    types = rng.choice(np.array(['C', 'P', 'IC', 'IP']), N)
    return forward, strike, ttm, vol, types


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


@pytest.mark.parametrize("fn", ["erfcc", "ncdf", "npdf"])
def test_gauss(fn):
    x = np.random.default_rng(1).uniform(-8.0, 8.0, 2000)
    ref = np.asarray(getattr(jgauss, fn)(x))
    out = getattr(tgauss, fn)(_t(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=PRICE_RTOL, atol=1e-300)


def test_price_and_vega():
    forward, strike, ttm, vol, types = _sample()
    # intrinsic corner cases: zero/negative ttm or vol, NaN vol
    ttm[:4] = [0.0, -0.1, 0.5, 0.5]
    vol[:4] = [0.3, 0.3, 0.0, np.nan]
    ref = np.asarray(jbsm.compute_bsm_vanilla_price(forward, strike, ttm, vol, types, 0.97))
    out = tbsm.compute_bsm_vanilla_price(_t(forward), _t(strike), _t(ttm), _t(vol),
                                         types, 0.97).numpy()
    np.testing.assert_allclose(out, ref, rtol=PRICE_RTOL, atol=1e-12)
    vref = np.asarray(jbsm.compute_bsm_vanilla_vega(ttm, forward, strike, vol))
    vout = tbsm.compute_bsm_vanilla_vega(_t(ttm), _t(forward), _t(strike), _t(vol)).numpy()
    np.testing.assert_allclose(vout, vref, rtol=PRICE_RTOL, atol=1e-12)


def _iv_prices(seed: int = 2):
    """prices from vols inside and outside [0.01, 5], plus prices below
    intrinsic and above the forward."""
    forward, strike, ttm, vol, types = _sample(seed)
    vol = np.random.default_rng(seed + 1).uniform(0.002, 6.0, N)
    price = np.array(jbsm.compute_bsm_vanilla_price(forward, strike, ttm, vol, types))
    price[:10] = -1.0
    price[10:20] = forward[10:20] * 1.5
    return forward, strike, ttm, price, types


@pytest.mark.parametrize("bounds_to_nan", [True, False])
def test_bisection_implied_vol(bounds_to_nan):
    forward, strike, ttm, price, types = _iv_prices()
    ref = np.asarray(jbsm.infer_bsm_implied_vol(forward, ttm, strike, price, 1.0, types,
                                                is_bounds_to_nan=bounds_to_nan))
    out = tbsm.infer_bsm_implied_vol(_t(forward), _t(ttm), _t(strike), _t(price), 1.0, types,
                                     is_bounds_to_nan=bounds_to_nan).numpy()
    assert_same_nan_pattern(out, ref)
    if bounds_to_nan:
        assert np.isnan(ref).sum() > 20   # the out-of-bracket rows are exercised
    live = ~np.isnan(ref)
    np.testing.assert_allclose(out[live], ref[live], rtol=0.0, atol=IV_ATOL)


def test_chain_panel_inversion():
    """the padded-panel entry point used by OptionChain."""
    forward, strike, ttm, price, types = _iv_prices(seed=5)
    shape = (4, N // 4)
    codes = np.vectorize({'P': 0, 'C': 1, 'IP': 2, 'IC': 3}.get)(types).astype(np.int8)
    ttms, fwds, dfs = ttm[:4], forward[:4], np.array([1.0, 0.99, 0.98, 0.95])
    strikes = strike.reshape(shape)
    prices = price.reshape(shape)
    ref = np.asarray(jbsm.infer_bsm_ivols_from_model_chain_prices(
        ttms, fwds, dfs, strikes, codes.reshape(shape), prices))
    out = tbsm.infer_bsm_ivols_from_model_chain_prices(
        _t(ttms), _t(fwds), _t(dfs), _t(strikes), torch.as_tensor(codes.reshape(shape)),
        _t(prices)).numpy()
    assert_same_nan_pattern(out, ref)
    live = ~np.isnan(ref)
    np.testing.assert_allclose(out[live], ref[live], rtol=0.0, atol=IV_ATOL)
