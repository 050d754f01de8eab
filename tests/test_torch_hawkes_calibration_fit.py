"""Whole Hawkes JD fits of the port against the JAX package's, each
capped at one iteration (each module's ``minimize`` wrapped to set
``maxiter``), on the 2-week BTC slice (the gamma fit on its
forward-normalised strikes).

Both packages hand scipy's SLSQP the same problem and scipy's finite
differences amplify last-bit gaps of the objective, so the fits are held to
the gap measured, with room: the 8-parameter fit to 1e-6 relative (measured
3.4e-7), the (sigma, gamma) fit to 1e-10 (measured 3.6e-13).
"""
import numpy as np

from _torch_port import btc_chains

import stochvolmodels_torch as svt
import stochvolmodels_tpu as svj
from stochvolmodels_torch.models import hawkes_jd as th
from stochvolmodels_tpu.models import hawkes_jd as jh

GAMMA = 0.5


def first_slice(normalised=False):
    cj, ct = btc_chains()
    cj = svj.OptionChain.get_slices_as_chain(cj, [cj.ids[0]])
    ct = svt.OptionChain.get_slices_as_chain(ct, [ct.ids[0]])
    if normalised:
        return (svj.OptionChain.to_forward_normalised_strikes(cj),
                svt.OptionChain.to_forward_normalised_strikes(ct))
    return cj, ct


def capped_minimize(module, maxiter, monkeypatch):
    real = module.minimize

    def capped(*args, **kw):
        kw["options"] = dict(kw.get("options") or {}, maxiter=maxiter)
        return real(*args, **kw)

    monkeypatch.setattr(module, "minimize", capped)


def test_slsqp_fit_capped_at_one_iteration_matches_jax(monkeypatch):
    cj, ct = first_slice()
    for module in (jh, th):
        capped_minimize(module, 1, monkeypatch)
    j_fit = jh.HawkesJDPricer().calibrate_model_params_to_chain(cj, jh.HawkesJDParams())
    pricer = svt.HawkesJDPricer(device="cpu")
    fit = pricer.calibrate_model_params_to_chain(ct, svt.HawkesJDParams())
    assert pricer.calibration_result.nit == 1
    names = ("sigma", "mean_p", "mean_m", "theta_p", "theta_m", "kappa_p", "beta1_p", "beta1_m")
    np.testing.assert_allclose([getattr(fit, k) for k in names],
                               [getattr(j_fit, k) for k in names], rtol=1e-6)
    assert fit.sigma != svt.HawkesJDParams().sigma


def test_gamma_fit_capped_at_one_iteration_matches_jax(monkeypatch):
    cj, ct = first_slice(normalised=True)
    for module in (jh, th):
        capped_minimize(module, 1, monkeypatch)
    pj, pt = jh.HawkesJDParams(risk_premia_gamma=GAMMA), svt.HawkesJDParams(risk_premia_gamma=GAMMA)
    j_fit = jh.HawkesJDPricer().calibrate_risk_premia_gamma_to_chain(cj, pj)
    pricer = svt.HawkesJDPricer(device="cpu")
    fit = pricer.calibrate_risk_premia_gamma_to_chain(ct, pt)
    assert fit is pt and pricer.calibration_result.nit == 1
    np.testing.assert_allclose([fit.sigma, fit.risk_premia_gamma],
                               [j_fit.sigma, j_fit.risk_premia_gamma], rtol=1e-10)
    assert (fit.sigma, fit.risk_premia_gamma) != (0.45, GAMMA)
