"""LogSV analytic pricing of the PyTorch port against the JAX package.

The JAX side is its float64 engine, which ``exact_engine='auto'`` picks on
the CPU: both run the same RK4 scheme, step counts and Simpson weights, so
prices agree to 1e-10 x forward and implied vols to 1e-8 (measured: ~1e-15
and ~1e-14).
"""
import numpy as np
import pandas as pd
import pytest
import torch
from _torch_port import README_PARAMS, btc_chains, param_pair

import stochvolmodels_tpu as svj
import stochvolmodels_torch as svt

PRICE_TOL = 1e-10   # x forward
IVOL_TOL = 1e-8
BTC_PARAMS = dict(sigma0=0.8376, theta=1.0413, kappa1=3.1844, kappa2=3.058,
                  beta=0.1514, volvol=1.8458)
PARAM_SETS = {"btc": BTC_PARAMS, "readme": README_PARAMS}


def _assert_prices(pt, pj, forwards):
    for a, b, f in zip(pt, pj, forwards):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0.0, atol=PRICE_TOL * f)


def test_btc_params_match():
    assert svt.LOGSV_BTC_PARAMS.to_dict() == svt.params_from_numpy(
        svj.LOGSV_BTC_PARAMS.to_dict()).to_dict()


def test_chain_grid_padding_contract():
    cj, ct = btc_chains()
    gj, gt = cj.to_grid(), ct.to_grid(device="cpu")
    for name in ("ttms", "forwards", "discfactors", "strikes", "optioncodes", "mask"):
        np.testing.assert_array_equal(getattr(gt, name).numpy(), np.asarray(getattr(gj, name)))
    moved = gt.to("cpu")
    assert moved.strikes.dtype == torch.float64 and moved.optioncodes.dtype == torch.int8


@pytest.mark.parametrize("is_spot_measure", [True, False])
@pytest.mark.parametrize("name", sorted(PARAM_SETS))
def test_price_chain(name, is_spot_measure):
    cj, ct = btc_chains()
    pj, pt = param_pair(**PARAM_SETS[name])
    ref = svj.LogSVPricer().price_chain(cj, pj, is_spot_measure=is_spot_measure)
    out = svt.LogSVPricer(device="cpu").price_chain(ct, pt, is_spot_measure=is_spot_measure)
    _assert_prices(out, ref, ct.forwards)


@pytest.mark.parametrize("name", sorted(PARAM_SETS))
def test_model_ivols_for_chain(name):
    cj, ct = btc_chains()
    pj, pt = param_pair(**PARAM_SETS[name])
    ref = svj.LogSVPricer().compute_model_ivols_for_chain(cj, pj)
    out = svt.LogSVPricer(device="cpu").compute_model_ivols_for_chain(ct, pt)
    for a, b in zip(out, ref):
        assert np.all(np.isfinite(a)) and np.all((a > 0.5) & (a < 1.5))
        np.testing.assert_allclose(a, np.asarray(b), rtol=0.0, atol=IVOL_TOL)


def test_fast_precision_is_f64_at_360_steps():
    """precision='fast' runs the float64 solver at 360 steps/yr: the JAX f64
    engine at year_steps=360 is its reference."""
    cj, ct = btc_chains()
    pj, pt = param_pair(**BTC_PARAMS)
    ref = svj.LogSVPricer().price_chain(cj, pj, year_steps=360)
    out = svt.LogSVPricer(device="cpu").price_chain(ct, pt, precision="fast")
    _assert_prices(out, ref, ct.forwards)
    ivols = svt.LogSVPricer(device="cpu").compute_model_ivols_for_chain(ct, pt, precision="fast")
    exact = svt.LogSVPricer(device="cpu").compute_model_ivols_for_chain(ct, pt)
    for a, b in zip(ivols, exact):
        np.testing.assert_allclose(a, b, rtol=0.0, atol=1e-6)


def test_vol_backbone():
    """a term structure of backbone etas, carried from a pandas Series."""
    cj, ct = btc_chains()
    pj = svj.LogSvParams(**BTC_PARAMS)
    pj.set_vol_backbone(pd.Series([1.1, 0.95, 1.0, 1.05], index=cj.ttms))
    pt = svt.params_from_numpy(pj.to_dict())
    np.testing.assert_array_equal(pt.get_vol_backbone_etas(ct.ttms),
                                  pj.get_vol_backbone_etas(cj.ttms))
    _assert_prices(svt.LogSVPricer(device="cpu").price_chain(ct, pt),
                   svj.LogSVPricer().price_chain(cj, pj), ct.forwards)


def test_vol_backbone_setter_takes_a_series():
    """the JAX package's setter call, one pandas Series, on both packages:
    the same etas, and the BTC prices and ivols to 1e-12 x forward and 1e-10
    (measured ~1e-15); the constructor and the two-array form read the same."""
    cj, ct = btc_chains()
    series = pd.Series([1.1, 0.95, 1.0, 1.05], index=cj.ttms)
    pj = svj.LogSvParams(**BTC_PARAMS)
    pj.set_vol_backbone(series)
    pt = svt.LogSvParams(**BTC_PARAMS)
    pt.set_vol_backbone(series)
    etas = pj.get_vol_backbone_etas(cj.ttms)
    np.testing.assert_array_equal(pt.get_vol_backbone_etas(ct.ttms), etas)
    np.testing.assert_array_equal(
        svt.LogSvParams(**BTC_PARAMS, vol_backbone=series).get_vol_backbone_etas(ct.ttms), etas)
    pair = svt.LogSvParams(**BTC_PARAMS)
    pair.set_vol_backbone(cj.ttms, series.to_numpy())
    np.testing.assert_array_equal(pair.get_vol_backbone_etas(ct.ttms), etas)

    prices_j, ivols_j = svj.LogSVPricer().compute_chain_prices_with_vols(cj, pj)
    prices_t, ivols_t = svt.LogSVPricer(device="cpu").compute_chain_prices_with_vols(ct, pt)
    for a, b, f in zip(prices_t, prices_j, ct.forwards):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0.0, atol=1e-12 * f)
    for a, b in zip(ivols_t, ivols_j):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0.0, atol=1e-10)
    # the backbone moves the prices (by ~7.7e-3 x forward)
    plain = svt.LogSVPricer(device="cpu").price_chain(ct, svt.LogSvParams(**BTC_PARAMS))
    assert max(np.max(np.abs(a - b)) / f for a, b, f in zip(prices_t, plain, ct.forwards)) > 1e-3


@pytest.mark.parametrize("strike,optiontype", [(1.0, 'C'), (0.8, 'P'), (1.3, 'C')])
def test_price_vanilla(strike, optiontype):
    pj, pt = param_pair(**README_PARAMS)
    kw = dict(ttm=0.25, forward=1.0, strike=strike, optiontype=optiontype)
    price_j, ivol_j = svj.LogSVPricer().price_vanilla(params=pj, **kw)
    price_t, ivol_t = svt.LogSVPricer(device="cpu").price_vanilla(params=pt, **kw)
    assert abs(price_t - float(price_j)) <= PRICE_TOL
    assert abs(ivol_t - float(ivol_j)) <= IVOL_TOL
