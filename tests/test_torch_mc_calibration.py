"""The MC, rough-MC and varswap-backbone calibration objectives of the
PyTorch port against the JAX package (CPU, float64), on the first two BTC
slices: objective and gradient to 1e-9 relative.

The JAX side is built here from its own pieces on the same numpy blocks
(``simulate_logsv_terminal_fixed`` or the rough ``_log_spot_scan_fixed``,
``compute_mc_vars_payoff`` and ``infer_bsm_implied_vol``, masked as its
calibration masks NaN vols, under ``jax.value_and_grad``), because its MC
engines draw their own threefry streams; the port takes the blocks through
``randoms=``.  Then two short fits: the QMC-engine fit of
``tests/test_qmc.py`` (the fit's ivols within 0.02 of the target smile),
and a varswap-backbone fit, which must set the fitted backbone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import btc_chains

import stochvolmodels_torch as svt
import stochvolmodels_tpu as svj
from stochvolmodels_tpu.models.logsv import pricer as jpricer
from stochvolmodels_tpu.models.rough.simulation import _log_spot_scan_fixed
from stochvolmodels_tpu.ops import bsm as jbsm
from stochvolmodels_tpu.ops.payoffs import compute_mc_vars_payoff
from stochvolmodels_torch.models.logsv import pricer as tpricer

CPU = torch.device("cpu")
P0 = dict(sigma0=0.8, theta=1.0, kappa1=2.21, kappa2=2.21, beta=0.15, volvol=1.85)
X0 = np.array([P0["sigma0"], P0["theta"], P0["kappa1"], P0["beta"], P0["volvol"]])
NB_PATH, NB_STEPS = 2000, 360
MCT, CT = svt.LogsvModelCalibrationType, svt.ConstraintsType


def _two_slices():
    cj, ct = btc_chains()
    ids = cj.ids[:2]
    return (svj.OptionChain.get_slices_as_chain(cj, ids=ids),
            svt.OptionChain.get_slices_as_chain(ct, ids=ids))


def _jax_problem(cj):
    """the JAX calibration's padded grid, vega weights and market vols."""
    grid = cj.to_grid()
    market = jpricer._pad_panel(cj.get_mid_vols(), grid)
    vegas = [v / np.sum(v) for v in cj.get_chain_vegas()]
    mask = np.asarray(grid.mask)
    weights = jnp.asarray(np.where(mask, jpricer._pad_panel(vegas, grid), 0.0))
    return grid, weights, jnp.asarray(np.where(mask, market, 0.0))


def _masked(model_vols, market, weight):
    nan_mask = jnp.isnan(model_vols)
    clean = jnp.where(nan_mask, market, model_vols)
    return jnp.sum(jnp.where(nan_mask, 0.0, weight * jnp.square(clean - market)))


def _slice_resid(grid, weights, market, i, x, qv):
    prices, _ = compute_mc_vars_payoff(
        x0=x, sigma0=x, qvar0=qv, ttm=grid.ttms[i], forward=grid.forwards[i],
        strikes_ttm=grid.strikes[i], optiontypes_ttm=grid.optioncodes[i],
        discfactor=grid.discfactors[i])
    vols = jbsm.infer_bsm_implied_vol(forward=grid.forwards[i], ttm=grid.ttms[i],
                                      strike=grid.strikes[i], given_price=prices,
                                      discfactor=grid.discfactors[i],
                                      optiontype=grid.optioncodes[i])
    return _masked(vols, market[i], weights[i])


def _port_objective(ct, params0, **kw):
    pricer = svt.LogSVPricer(device=CPU)
    objective, *_ = pricer._slsqp_problem(
        ct, params0, svt.LogSvParams(sigma0=0.1, theta=0.1, kappa1=0.25, kappa2=0.25, beta=-3.0,
                                     volvol=0.2),
        svt.LogSvParams(sigma0=1.5, theta=1.5, kappa1=10.0, kappa2=10.0, beta=3.0, volvol=3.0),
        True, False, kw.pop("mct", MCT.PARAMS5), CT.UNCONSTRAINT, **kw)
    return objective


def _close(ours, ref):
    loss, grad = ours
    jloss, jgrad = ref
    assert np.isfinite(loss) and np.all(np.isfinite(grad))
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-9)
    np.testing.assert_allclose(grad, np.asarray(jgrad), rtol=1e-9, atol=1e-12 * np.abs(grad).max())


def test_mc_objective_and_gradient_match_jax():
    cj, ct = _two_slices()
    W0s, W1s, dts = jpricer.get_randoms_for_chain_valuation(cj.ttms, nb_path=NB_PATH,
                                                            nb_steps_per_year=NB_STEPS, seed=10)
    grid, weights, market = _jax_problem(cj)

    def jloss(pars):
        sigma0, theta, kappa1, beta, volvol = (pars[k] for k in range(5))
        x, qv = jnp.zeros(NB_PATH), jnp.zeros(NB_PATH)
        sig = sigma0 * jnp.ones(NB_PATH)
        total = 0.0
        for i in range(len(cj.ttms)):
            x, sig, qv = jpricer.simulate_logsv_terminal_fixed(
                W0=W0s[i], W1=W1s[i], dt=float(dts[i]), x0=x, sigma0=sig, qvar0=qv, theta=theta,
                kappa1=kappa1, kappa2=kappa1 / theta, beta=beta, volvol=volvol,
                vol_backbone_eta=1.0)
            total = total + _slice_resid(grid, weights, market, i, x, qv)
        return total

    ref = jax.value_and_grad(jloss)(jnp.asarray(X0))
    ours = _port_objective(ct, svt.LogSvParams(**P0), calibration_engine=svt.CalibrationEngine.MC,
                           nb_path=NB_PATH, nb_steps=NB_STEPS, randoms=(W0s, W1s))(X0)
    _close(ours, ref)


def test_rough_mc_objective_and_gradient_match_jax():
    cj, ct = _two_slices()
    p0 = svt.LogSvParams(**P0, H=0.1)
    p0.approximate_kernel(T=float(ct.ttms[-1]))
    Z0, Z1, grids = jpricer.get_randoms_for_rough_vol_chain_valuation(
        cj.ttms, nb_path=NB_PATH, nb_steps_per_year=NB_STEPS, seed=11)
    grid, weights, market = _jax_problem(cj)
    nodes, wts = jnp.asarray(p0.nodes), jnp.asarray(p0.weights)

    def jloss(pars):
        sigma0, theta, kappa1, beta, volvol = (pars[k] for k in range(5))
        vartheta = jnp.sqrt(beta * beta + volvol * volvol)
        total = 0.0
        for i, tg in enumerate(grids):
            n = len(tg) - 1
            log_s, _, y = _log_spot_scan_fixed(
                nodes, wts, sigma0, theta, kappa1, kappa1 / theta, beta / vartheta, vartheta,
                jnp.asarray(Z0[:n]), jnp.asarray(Z1[:n]), h=float(tg[1] - tg[0]),
                n_nodes=len(p0.nodes), dtype=jnp.float64)
            total = total + _slice_resid(grid, weights, market, i, log_s, y)
        return total

    ref = jax.value_and_grad(jloss)(jnp.asarray(X0))
    ours = _port_objective(ct, p0, calibration_engine=svt.CalibrationEngine.ROUGH_MC,
                           nb_path=NB_PATH, nb_steps=NB_STEPS, randoms=(Z0, Z1))(X0)
    _close(ours, ref)


def test_varswap_fit_objective_and_gradient_match_jax():
    cj, ct = _two_slices()
    grid, weights, market = _jax_problem(cj)
    pricer = svj.LogSVPricer()
    vol_scaler = pricer.set_vol_scaler(option_chain=cj)
    varswap = jnp.asarray(cj.get_slice_varswap_strikes(floor_with_atm_vols=True).to_numpy())
    ttms_static = tuple(float(t) for t in cj.ttms)

    def jloss(pars):
        beta, volvol = pars[0], pars[1]
        etas = jpricer._backbone_etas_jnp(P0["sigma0"], P0["theta"], P0["kappa1"], P0["kappa2"],
                                          beta, volvol, ttms=np.asarray(cj.ttms),
                                          varswap_strikes=varswap)
        prices = jpricer.logsv_chain_price_grid(
            grid, sigma0=P0["sigma0"], theta=P0["theta"], kappa1=P0["kappa1"],
            kappa2=P0["kappa2"], beta=beta, volvol=volvol, vol_backbone_etas=etas,
            vol_scaler=vol_scaler, ttms_static=ttms_static)
        vols = jbsm.infer_bsm_ivols_from_model_chain_prices(
            ttms=grid.ttms, forwards=grid.forwards, discfactors=grid.discfactors,
            strikes_ttms=grid.strikes, optiontypes_ttms=grid.optioncodes, model_prices_ttms=prices)
        return _masked(vols, market, weights)

    x0 = np.array([P0["beta"], P0["volvol"]])
    ref = jax.value_and_grad(jloss)(jnp.asarray(x0))
    ours = _port_objective(ct, svt.LogSvParams(**P0), mct=MCT.PARAMS_WITH_VARSWAP_FIT)(x0)
    _close(ours, ref)


def test_qmc_engine_fit_recovers_smile():
    true = svt.LogSvParams(sigma0=0.85, theta=0.95, kappa1=4.0, kappa2=4.0, beta=0.2, volvol=1.6)
    ttms, strikes = np.array([0.25]), [np.linspace(0.8, 1.3, 6)]
    types = [np.array(['P', 'P', 'C', 'C', 'C', 'C'])]
    pricer = svt.LogSVPricer(device=CPU)
    chain0 = svt.OptionChain(ttms=ttms, forwards=np.ones(1), discfactors=np.ones(1),
                             strikes_ttms=strikes, optiontypes_ttms=types)
    _, ivols = pricer.compute_chain_prices_with_vols(chain0, true)
    chain = svt.OptionChain(ttms=ttms, forwards=np.ones(1), discfactors=np.ones(1),
                            strikes_ttms=strikes, optiontypes_ttms=types, bid_ivs=ivols,
                            ask_ivs=ivols)
    fit = pricer.calibrate_model_params_to_chain(
        chain, svt.LogSvParams(sigma0=0.8, theta=0.9, kappa1=4.0, kappa2=4.0, beta=0.1,
                               volvol=1.4),
        calibration_engine=svt.CalibrationEngine.MC, mc_engine="qmc", nb_path=4096, nb_steps=120)
    assert np.isfinite(fit.sigma0) and 0.5 < fit.sigma0 < 1.2
    _, fit_ivols = pricer.compute_chain_prices_with_vols(chain0, fit)
    assert np.nanmax(np.abs(fit_ivols[0] - ivols[0])) < 0.02


def test_varswap_fit_sets_backbone():
    cj, ct = _two_slices()
    pricer = svt.LogSVPricer(device=CPU)
    fit = pricer.calibrate_model_params_to_chain(
        ct, svt.LogSvParams(**P0), model_calibration_type=MCT.PARAMS_WITH_VARSWAP_FIT)
    assert pricer.calibration_result.nfev >= 1
    assert fit.vol_backbone is not None
    etas = fit.get_vol_backbone_etas(ct.ttms)
    assert np.all(np.isfinite(etas)) and np.all(etas > 0.0)
    # the backbone set is the one the fitted (beta, volvol) give
    expected = svt.fit_model_vol_backbone_to_varswaps(
        fit, ct.get_slice_varswap_strikes(floor_with_atm_vols=True))
    np.testing.assert_array_equal(etas, expected.to_numpy())
    assert (fit.sigma0, fit.theta, fit.kappa1, fit.kappa2) == (
        P0["sigma0"], P0["theta"], P0["kappa1"], P0["kappa2"])
