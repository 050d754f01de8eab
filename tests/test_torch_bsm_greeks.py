"""BSM greeks, digitals, strikes from deltas and the slice/chain helpers of
the PyTorch port against the JAX package (CPU, float64): 1e-13 absolute on
the same numpy inputs, intrinsic corners (ttm 0, vol 0, NaN vol) included;
and LogSV and Heston chain prices and ivols beyond BTC (the bundled SPY and
VIX chains): 1e-12 x forward in price, 1e-10 in ivol, the same NaN pattern.
"""
import numpy as np
import pytest
import torch
from _torch_port import README_PARAMS, assert_same_nan_pattern, param_pair

import stochvolmodels_torch as svt
import stochvolmodels_tpu as svj
from stochvolmodels_tpu.ops import bsm as jbsm
from stochvolmodels_torch.ops import bsm as tbsm

TOL = 1e-13
RNG = np.random.default_rng(11)
N = 64
FWD = RNG.uniform(50.0, 150.0, N)
STRIKE = FWD * np.exp(RNG.uniform(-0.6, 0.6, N))
TTM = RNG.uniform(0.01, 2.0, N)
VOL = RNG.uniform(0.05, 1.5, N)
TTM[:3] = 0.0            # intrinsic corners
VOL[3:5] = 0.0
VOL[5] = np.nan
TYPES = np.where(RNG.uniform(size=N) < 0.5, 'C', 'P').astype('<U2')
TYPES[6:9] = ['IC', 'IP', 'IC']
DF = RNG.uniform(0.9, 1.0, N)


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _close(ours, ref, tol=TOL):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=0, atol=tol)


def test_deltas_gamma_theta_vega():
    _close(tbsm.compute_bsm_vanilla_delta(_t(TTM), _t(FWD), _t(STRIKE), _t(VOL), TYPES, _t(DF)),
           jbsm.compute_bsm_vanilla_delta(TTM, FWD, STRIKE, VOL, TYPES, DF))
    _close(tbsm.compute_bsm_vanilla_gamma(_t(TTM), _t(FWD), _t(STRIKE), _t(VOL)),
           jbsm.compute_bsm_vanilla_gamma(TTM, FWD, STRIKE, VOL))
    vanilla = np.where(np.char.startswith(TYPES.astype(str), 'I'), 'C', TYPES)
    _close(tbsm.compute_bsm_vanilla_theta(_t(TTM), _t(FWD), _t(STRIKE), _t(VOL), vanilla,
                                          _t(DF), 0.03),
           jbsm.compute_bsm_vanilla_theta(TTM, FWD, STRIKE, VOL, vanilla, DF, 0.03))
    _close(tbsm.compute_bsm_vanilla_slice_vegas(_t(TTM), _t(FWD), _t(STRIKE), _t(VOL)),
           jbsm.compute_bsm_vanilla_slice_vegas(TTM, FWD, STRIKE, VOL))


def test_grid_and_slice_helpers():
    forwards = np.linspace(60.0, 140.0, 9)
    _close(tbsm.compute_bsm_forward_grid_prices(_t(0.5), _t(forwards), _t(100.0), _t(0.3), 'P'),
           jbsm.compute_bsm_forward_grid_prices(0.5, forwards, 100.0, 0.3, 'P'))
    _close(tbsm.compute_bsm_vanilla_grid_deltas(_t(0.5), _t(forwards), _t(100.0), _t(0.3), 'C'),
           jbsm.compute_bsm_vanilla_grid_deltas(0.5, forwards, 100.0, 0.3, 'C'))
    strikes, vols = STRIKE[10:20], VOL[10:20]
    types = np.array(['C', 'P'] * 5)
    _close(tbsm.compute_bsm_vanilla_slice_deltas(_t(0.7), _t(100.0), _t(strikes), _t(vols),
                                                 types),
           jbsm.compute_bsm_vanilla_slice_deltas(0.7, 100.0, strikes, vols, types))
    prices = tbsm.compute_bsm_vanilla_slice_prices(_t(0.7), _t(100.0), _t(strikes), _t(vols),
                                                   types)
    _close(prices, jbsm.compute_bsm_vanilla_slice_prices(0.7, 100.0, strikes, vols, types))
    ivols = tbsm.infer_bsm_ivols_from_slice_prices(_t(0.7), _t(100.0), _t(1.0), _t(strikes),
                                                   types, prices)
    _close(ivols, jbsm.infer_bsm_ivols_from_slice_prices(0.7, 100.0, 1.0, strikes, types,
                                                         np.asarray(prices)), 1e-12)
    ttms, fwds = [0.2, 0.9], [100.0, 105.0]
    strikes_ttms, vols_ttms = [STRIKE[20:25], STRIKE[25:32]], [VOL[20:25], VOL[25:32]]
    types_ttms = [np.full(5, 'C'), np.full(7, 'P')]
    for ours, ref in zip(
            tbsm.compute_bsm_vanilla_deltas_ttms(ttms, fwds, strikes_ttms, vols_ttms, types_ttms,
                                                 device="cpu"),
            jbsm.compute_bsm_vanilla_deltas_ttms(ttms, fwds, strikes_ttms, vols_ttms,
                                                 types_ttms)):
        _close(ours, ref)
    for ours, ref in zip(tbsm.compute_bsm_vegas_ttms(ttms, fwds, strikes_ttms, vols_ttms,
                                                     device="cpu"),
                         jbsm.compute_bsm_vegas_ttms(ttms, fwds, strikes_ttms, vols_ttms)):
        _close(ours, ref)


def test_digitals_and_strike_from_delta():
    vanilla = np.where(np.char.startswith(TYPES.astype(str), 'I'), 'P', TYPES)
    _close(tbsm.compute_bsm_digital_price(_t(FWD), _t(STRIKE), _t(TTM), _t(VOL), vanilla, _t(DF)),
           jbsm.compute_bsm_digital_price(FWD, STRIKE, TTM, VOL, vanilla, DF))
    _close(tbsm.compute_bsm_digital_delta(_t(FWD), _t(STRIKE), _t(TTM), _t(VOL), vanilla, _t(DF)),
           jbsm.compute_bsm_digital_delta(FWD, STRIKE, TTM, VOL, vanilla, DF))
    deltas = np.concatenate([np.linspace(0.05, 0.95, 10), -np.linspace(0.05, 0.95, 10)])
    ours = tbsm.compute_bsm_strike_from_delta(_t(0.5), 100.0, _t(deltas), _t(0.4)).numpy()
    ref = np.asarray(jbsm.compute_bsm_strike_from_delta(0.5, 100.0, deltas, 0.4))
    np.testing.assert_allclose(ours, ref, rtol=1e-13)


# each chain with Heston parameters near its own vol level (VIX options trade near 100% vol)
CHAINS = {"spy": ("get_spy_test_chain_data",
                  dict(v0=0.3 ** 2, theta=0.35 ** 2, kappa=3.0, rho=-0.6, volvol=1.0)),
          "vix_20220715": ("get_vix_test_chain_data",
                           dict(v0=0.8 ** 2, theta=0.9 ** 2, kappa=4.0, rho=0.4, volvol=2.0))}


@pytest.mark.parametrize("model", ["logsv", "heston"])
@pytest.mark.parametrize("name", list(CHAINS))
def test_chain_parity_beyond_btc(name, model):
    loader, hp = CHAINS[name]
    cj, ct = getattr(svj, loader)(), getattr(svt, loader)()
    for a, b in zip(ct.strikes_ttms, cj.strikes_ttms):
        np.testing.assert_array_equal(a, b)
    if model == "logsv":
        pj, pt = param_pair(**README_PARAMS)
        jpricer, tpricer = svj.LogSVPricer(), svt.LogSVPricer(device="cpu")
    else:
        pj, pt = svj.HestonParams(**hp), svt.HestonParams(**hp)
        jpricer, tpricer = svj.HestonPricer(), svt.HestonPricer(device="cpu")
    jprices, jivols = jpricer.compute_chain_prices_with_vols(cj, pj)
    tprices, tivols = tpricer.compute_chain_prices_with_vols(ct, pt)
    for tp, jp, ti, ji, fwd in zip(tprices, jprices, tivols, jivols, cj.forwards):
        np.testing.assert_allclose(tp, np.asarray(jp), rtol=0, atol=1e-12 * fwd)
        assert_same_nan_pattern(ti, ji)
        np.testing.assert_allclose(ti, np.asarray(ji), rtol=0, atol=1e-10)
