"""Whole LogSV fits of the port against the JAX package's, from
``bench.py``'s ``params0``.

* Levenberg-Marquardt on the BTC chain: two iterations of
  ``calibrate_logsv_lm_on_device`` agree in cost and parameters to 1e-7
  relative, at the 180 steps/yr that ``method='lm'`` runs.  (At 60 steps/yr
  the RK4 diverges on the third BTC slice at the first candidate in both
  packages, and the packages' last-bit gaps there grow past 1e-7 in the
  second iteration; ``tests/test_torch_calibration.py`` shows the
  divergence.)
* SLSQP on the BTC chain's first slice (28 RK4 steps at 720 steps/yr),
  through scipy in both packages, lands on the same parameters to 1e-6.
"""
import numpy as np

from _torch_port import btc_chains

import stochvolmodels_torch as svt
import stochvolmodels_tpu as svj
import stochvolmodels_tpu.models.logsv.pricer as jax_pricer
from stochvolmodels_tpu.models.logsv import fast_calibration as jfc
from stochvolmodels_tpu.models.logsv.params import LogSvParams as JaxLogSvParams

PARAMS0 = dict(sigma0=0.8, theta=1.0, kappa1=2.21, kappa2=2.18, beta=0.15, volvol=1.85)
NAMES = ("sigma0", "theta", "kappa1", "kappa2", "beta", "volvol")


def assert_fit_close(fit, cost, j_fit, j_cost, rtol):
    assert np.isfinite(cost)
    np.testing.assert_allclose(cost, float(j_cost), rtol=rtol)
    for name in NAMES:
        np.testing.assert_allclose(getattr(fit, name), getattr(j_fit, name), rtol=rtol)


def test_lm_fit_matches_jax():
    cj, ct = btc_chains()
    j_fit, j_cost = jfc.calibrate_logsv_lm_on_device(cj, JaxLogSvParams(**PARAMS0), nb_iters=2,
                                                     year_steps=180)
    fit, cost = svt.calibrate_logsv_lm_on_device(ct, svt.LogSvParams(**PARAMS0), nb_iters=2,
                                                 year_steps=180, device="cpu")
    assert cost < 1e-3
    assert_fit_close(fit, cost, j_fit, j_cost, 1e-7)


def test_whole_fit_on_one_slice_matches_jax():
    cj, ct = btc_chains()
    first = [cj.ids[0]]
    cj1 = svj.OptionChain.get_slices_as_chain(cj, first)
    ct1 = svt.OptionChain.get_slices_as_chain(ct, first)
    kw = dict(constraints_type="MMA_MARTINGALE", model_calibration_type="PARAMS5")
    j_fit = jax_pricer.LogSVPricer().calibrate_model_params_to_chain(
        cj1, svj.LogSvParams(**PARAMS0),
        model_calibration_type=jax_pricer.LogsvModelCalibrationType[kw["model_calibration_type"]],
        constraints_type=jax_pricer.ConstraintsType[kw["constraints_type"]])
    pricer = svt.LogSVPricer(device="cpu")
    fit = pricer.calibrate_model_params_to_chain(
        ct1, svt.LogSvParams(**PARAMS0),
        model_calibration_type=svt.LogsvModelCalibrationType[kw["model_calibration_type"]],
        constraints_type=svt.ConstraintsType[kw["constraints_type"]])
    assert pricer.calibration_result.nfev > 3
    for name in ("sigma0", "theta", "kappa1", "kappa2", "beta", "volvol"):
        np.testing.assert_allclose(getattr(fit, name), getattr(j_fit, name), rtol=1e-6)
    assert fit.kappa2 >= fit.beta - 1e-9
    ivols = pricer.compute_model_ivols_for_chain(ct1, fit)
    err = np.nanmean(np.abs(ivols[0] - ct1.get_mid_vols()[0]))
    start = pricer.compute_model_ivols_for_chain(ct1, svt.LogSvParams(**PARAMS0))
    assert err < np.nanmean(np.abs(start[0] - ct1.get_mid_vols()[0]))
