"""The A prefit, the full two-stage fit and the rate pricer's calibration
entry point of the PyTorch port against the JAX package, on the CPU in
float64, on the two-slice fixture of ``tests/test_qa_traced.py`` (24 or 48
RK4 steps/yr), the market normal vols those of the traced cube at the
fixture's parameters:

* ``prefit_A_to_atm``, traced (one program for every outer iteration) and
  frozen (re-frozen panels each iteration), three outer iterations from A
  x 1.1: A 1e-8 relative and the ATM error equal to 1e-8 bp;
* ``calibrate_rate_logsv_full`` (one round: one prefit iteration, one LM
  iteration, segment 0): the fitted parameters and the cost, 1e-8;
* ``RateLogSVPricer.calibrate_model_params_to_chain`` on a two-slice
  ``SwOptionChain`` at one iteration and 24 steps/yr: the same, 1e-8.
"""
import jax
import numpy as np
import pytest
from test_torch_rates_calibration import market_ivols, start_pair
from test_torch_rates_calibration_fit import assert_fits_match
from test_torch_rates_traced import FWDS_FD, SLICES_FD, STRIKES_FD

import stochvolmodels_torch as svt
from stochvolmodels_tpu.data.option_chain import SwOptionChain as JSwOptionChain
from stochvolmodels_tpu.models.factor_hjm import fast_calibration as jfc
from stochvolmodels_tpu.models.factor_hjm import rate_logsv_pricer as jrp
from stochvolmodels_torch.models.factor_hjm import fast_calibration as tfc

FD_CUBE = (SLICES_FD, FWDS_FD, STRIKES_FD)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    import gc
    jax.clear_caches()
    gc.collect()


@pytest.mark.parametrize("traced", [True, False], ids=["traced", "frozen"])
def test_prefit_matches(traced):
    ivols = market_ivols(FD_CUBE)
    pj, pt = start_pair(A_scale=1.1)
    fit_j, err_j = jfc.prefit_A_to_atm(pj, *FD_CUBE, ivols, nb_outer=3, traced=traced)
    fit_t, err_t = tfc.prefit_A_to_atm(pt, *FD_CUBE, ivols, nb_outer=3, traced=traced,
                                       device="cpu")
    np.testing.assert_allclose(fit_t.A, fit_j.A, rtol=1e-8)
    assert abs(err_t - err_j) <= 1e-8 and np.isfinite(err_t)
    # the prefit moves the key-term levels the slices inform, and contracts
    assert not np.array_equal(fit_t.A, pt.A)
    _, err_1 = tfc.prefit_A_to_atm(pt, *FD_CUBE, ivols, nb_outer=1, traced=traced,
                                   device="cpu")
    assert err_t < err_1


def test_full_fit_matches():
    ivols = market_ivols(FD_CUBE)
    pj, pt = start_pair(A_scale=1.1)
    kw = dict(nb_rounds=1, nb_outer_atm=1, nb_iters_lm=1, year_steps=24, segments=[0])
    assert_fits_match(jfc.calibrate_rate_logsv_full(pj, *FD_CUBE, ivols, **kw),
                      tfc.calibrate_rate_logsv_full(pt, *FD_CUBE, ivols, device="cpu", **kw))


def test_pricer_calibration_matches():
    ivols = market_ivols(FD_CUBE)
    pj, pt = start_pair()
    rows = dict(ccy="USD", ttms=np.array([1.0]), tenors=np.array([1.0, 10.0]),
                ttms_ids=["1y"], tenors_ids=["1y", "10y"],
                forwards=[np.array([f]) for f in FWDS_FD],
                strikes_ttms=[[s] for s in STRIKES_FD], bid_ivs=[[iv] for iv in ivols],
                ask_ivs=[[iv] for iv in ivols])
    kw = dict(nb_iters=1, year_steps=24)
    fit_j = jrp.RateLogSVPricer().calibrate_model_params_to_chain(
        JSwOptionChain(**rows), pj, engine="f64", **kw)
    fit_t = svt.RateLogSVPricer(device="cpu").calibrate_model_params_to_chain(
        svt.SwOptionChain(**rows), pt, **kw)
    assert_fits_match(fit_j, fit_t)
