"""LogSV calibration by Levenberg-Marquardt against the JAX package.

* The ODE terms and the BTC chain prices from 0-dim float64 tensor
  parameters equal the float build bit for bit (so every earlier parity test
  of the float path still speaks for the tensor path).
* The LM residuals and their ``jacfwd`` Jacobian at ``bench.py``'s
  ``params0`` agree with JAX's ``jacfwd`` of the same residual function
  (the one ``_lm_run`` builds) to 1e-9 relative.
* The LM loop rejects a candidate whose cost is NaN; the constraint
  penalties; the pricer's ``method='lm'`` route and what raises.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from _torch_port import btc_chains

import stochvolmodels_torch as svt
from stochvolmodels_torch.models.logsv import affine as tafe
from stochvolmodels_torch.models.logsv import fast_calibration as tfc
from stochvolmodels_tpu.models.logsv import fast_calibration as jfc
from stochvolmodels_tpu.models.logsv.pricer import _pad_panel as jax_pad_panel
from stochvolmodels_tpu.models.logsv.pricer import logsv_chain_price_grid as jax_price_grid
from stochvolmodels_tpu.ops import bsm as jbsm

# bench.py's start point of the LM benchmark
PARAMS0 = dict(sigma0=0.8, theta=1.0, kappa1=2.21, kappa2=2.18, beta=0.15, volvol=1.85)
P0 = np.array([0.8, 1.0, 2.21, 0.15, 1.85])
RESIDUAL_YEAR_STEPS = 60


def f64(x):
    return torch.tensor(x, dtype=torch.float64)


@pytest.mark.parametrize("is_spot_measure", [True, False])
@pytest.mark.parametrize("order", [svt.ExpansionOrder.FIRST, svt.ExpansionOrder.SECOND])
def test_ode_terms_from_tensors_equal_the_float_build(is_spot_measure, order):
    kw = dict(theta=1.0413, kappa1=3.1844, kappa2=3.058, beta=-0.1514, volvol=1.8458)
    floats = tafe.func_a_ode_quadratic_terms(**kw, is_spot_measure=is_spot_measure,
                                             expansion_order=order, vol_backbone_eta=1.1)
    tensors = tafe.func_a_ode_quadratic_terms(**{k: f64(v) for k, v in kw.items()},
                                              is_spot_measure=is_spot_measure,
                                              expansion_order=order, vol_backbone_eta=1.1)
    for a, t in zip(floats, tensors):
        assert isinstance(a, np.ndarray) and t.dtype == torch.float64
        np.testing.assert_array_equal(t.numpy(), a)
    phi = svt.get_phi_grid(device="cpu", is_spot_measure=is_spot_measure, vol_scaler=0.17)
    for a, t in zip(tafe.build_grid_ode_terms(*floats, phi, torch.zeros_like(phi), is_spot_measure),
                    tafe.build_grid_ode_terms(*tensors, phi, torch.zeros_like(phi),
                                              is_spot_measure)):
        assert torch.equal(a, t)


@pytest.mark.parametrize("is_spot_measure", [True, False])
def test_chain_prices_from_tensor_params_equal_the_float_prices(is_spot_measure):
    _, ct = btc_chains()
    grid = ct.to_grid(device="cpu")
    p = svt.LOGSV_BTC_PARAMS.to_dict()
    names = ("sigma0", "theta", "kappa1", "kappa2", "beta", "volvol")
    vol_scaler = svt.set_vol_scaler(p["sigma0"], np.min(ct.ttms))
    kw = dict(ttms_static=tuple(float(t) for t in ct.ttms), year_steps=240,
              is_spot_measure=is_spot_measure, vol_backbone_etas=np.array([1.0, 1.1, 0.9, 1.0]))
    floats = svt.logsv_chain_price_grid(grid, **{k: float(p[k]) for k in names},
                                        vol_scaler=float(vol_scaler), **kw)
    tensors = svt.logsv_chain_price_grid(grid, **{k: f64(p[k]) for k in names},
                                         vol_scaler=f64(vol_scaler), **kw)
    assert torch.equal(floats, tensors)


@pytest.fixture(scope="module")
def residual_problem():
    """the LM residual function of both packages at the same chain targets."""
    cj, ct = btc_chains()
    vol_scaler = jfc.set_vol_scaler(sigma0=cj.get_chain_atm_vols()[0], ttm=cj.ttms[0])
    grid = cj.to_grid()
    mask = np.asarray(grid.mask)
    market = np.where(mask, jax_pad_panel(cj.get_mid_vols(), grid), 0.0)
    weights = np.where(mask, jax_pad_panel([v / np.sum(v) for v in cj.get_chain_vegas()], grid),
                       0.0)
    ttms = tuple(float(t) for t in cj.ttms)

    def jax_residuals(pars):   # _lm_run's residual function, unconstrained
        prices = jax_price_grid(grid, sigma0=pars[0], theta=pars[1], kappa1=pars[2],
                                kappa2=pars[2] / pars[1], beta=pars[3], volvol=pars[4],
                                vol_scaler=jnp.asarray(vol_scaler), ttms_static=ttms,
                                year_steps=RESIDUAL_YEAR_STEPS, unroll=4)
        vols = jbsm.infer_bsm_implied_vol_fast(
            forward=grid.forwards[:, None], ttm=grid.ttms[:, None], strike=grid.strikes,
            given_price=prices, discfactor=grid.discfactors[:, None], optiontype=grid.optioncodes)
        nan_mask = jnp.isnan(vols)
        clean = jnp.where(nan_mask, jnp.asarray(market), vols)
        return (jnp.sqrt(jnp.asarray(weights)) * (clean - jnp.asarray(market))).ravel()

    j_res = np.asarray(jax.jit(jax_residuals)(jnp.asarray(P0)))
    j_jac = np.asarray(jax.jit(jax.jacfwd(jax_residuals))(jnp.asarray(P0)))
    return ct, vol_scaler, market, weights, j_res, j_jac


def port_residual_fn(ct, constraints_type=svt.ConstraintsType.UNCONSTRAINT):
    vol_scaler, grid, market, weights = tfc._chain_targets(ct, True, "cpu")
    market, sqrtw = torch.as_tensor(market), torch.as_tensor(np.sqrt(weights))
    ttms = tuple(float(t) for t in ct.ttms)

    def residuals(pars):
        vols, constrained = tfc._model_vols(pars, grid, f64(vol_scaler), ttms,
                                            RESIDUAL_YEAR_STEPS)
        nan_mask = torch.isnan(vols)
        r = (sqrtw * (torch.where(nan_mask, market, vols) - market)).reshape(-1)
        pen = [math.sqrt(10.0) * g for g in tfc._constraint_gaps(constraints_type, *constrained)]
        return torch.cat([r, torch.stack(pen)]) if pen else r

    return residuals


def test_chain_targets_match_jax(residual_problem):
    ct, vol_scaler, market, weights, _, _ = residual_problem
    t_scaler, grid, t_market, t_weights = tfc._chain_targets(ct, True, "cpu")
    assert t_scaler == vol_scaler
    np.testing.assert_array_equal(t_market, market)
    np.testing.assert_allclose(t_weights, weights, rtol=1e-14, atol=0.0)
    assert grid.device == torch.device("cpu")


def test_lm_residuals_and_jacobian_match_jax(residual_problem):
    ct, _, _, _, j_res, j_jac = residual_problem
    residuals = port_residual_fn(ct)
    jac, res = jacfwd(lambda p: (lambda r: (r, r))(residuals(p)), has_aux=True)(f64(P0))
    # the quotes whose model vol is NaN at 60 steps/yr drop out on both sides
    np.testing.assert_array_equal(res.numpy() == 0.0, j_res == 0.0)
    np.testing.assert_allclose(res.numpy(), j_res, rtol=1e-9, atol=1e-9 * np.max(np.abs(j_res)))
    np.testing.assert_allclose(jac.numpy(), j_jac, rtol=1e-9, atol=1e-9 * np.max(np.abs(j_jac)))
    assert np.all(np.isfinite(jac.numpy()))


@pytest.mark.parametrize("year_steps,diverges", [(60, True), (180, False)])
def test_rk4_at_60_steps_diverges_near_the_first_lm_candidate(year_steps, diverges):
    """near the LM's first candidate from params0 (kappa1 ~4), 60 RK4 steps
    a year blow the third BTC slice's prices up (its quotes get NaN vols and
    drop out of the residuals); 180 steps a year, ``method='lm'``'s, do not."""
    _, ct = btc_chains()
    _, grid, _, _ = tfc._chain_targets(ct, True, "cpu")
    vol_scaler = f64(svt.LogSVPricer(device="cpu").set_vol_scaler(ct))
    pars = f64([0.85, 0.94, 4.04, 0.18, 2.19])
    vols, _ = tfc._model_vols(pars, grid, vol_scaler, tuple(float(t) for t in ct.ttms), year_steps)
    nan_per_slice = torch.isnan(vols).sum(1).numpy()
    expect = np.zeros(4, dtype=int)
    if diverges:
        expect[2] = int(grid.mask[2].sum())
    np.testing.assert_array_equal(nan_per_slice, expect)


def test_lm_rejects_a_candidate_whose_cost_is_nan():
    """a residual function that is NaN beyond x = 0.5 (a diverged
    candidate): every such step is rejected, and the best point stays
    finite."""
    target = torch.tensor([0.9, 0.3], dtype=torch.float64)

    def residuals(p):
        r = p - target
        return torch.where(p[0] > 0.5, torch.full_like(r, math.nan), r)

    best, cost = svt.lm_minimize(residuals, f64([0.2, 0.2]), f64([0.0, 0.0]), f64([2.0, 2.0]),
                                 nb_iters=6)
    assert torch.isfinite(cost) and torch.isfinite(best).all()
    assert float(best[0]) <= 0.5
    assert float(cost) < float(torch.sum((f64([0.2, 0.2]) - target) ** 2))


def test_lm_solves_a_box_bounded_least_squares_problem():
    """y = a exp(-b t) with a on its upper bound."""
    t = torch.linspace(0.0, 2.0, 12, dtype=torch.float64)
    y = 2.0 * torch.exp(-0.7 * t)
    best, cost = svt.lm_minimize(lambda p: p[0] * torch.exp(-p[1] * t) - y, f64([1.0, 0.1]),
                                 f64([0.0, 0.0]), f64([1.5, 5.0]), nb_iters=30)
    assert float(best[0]) == 1.5
    assert 0.0 < float(cost) < float(torch.sum(y ** 2))


@pytest.mark.parametrize("constraints_type", list(svt.ConstraintsType))
def test_penalty_residuals(constraints_type):
    """each constraint adds one sqrt(10)-scaled one-sided residual, zero
    where the constraint holds."""
    theta, kappa1, beta, volvol = 1.0, 0.5, 0.8, 1.0
    kappa2 = kappa1 / theta
    gaps = tfc._constraint_gaps(constraints_type, f64(theta), f64(kappa1), f64(kappa2),
                                f64(beta), f64(volvol))
    expect = {svt.ConstraintsType.UNCONSTRAINT: [],
              svt.ConstraintsType.MMA_MARTINGALE: [beta - kappa2],
              svt.ConstraintsType.INVERSE_MARTINGALE: [2 * beta - kappa2],
              svt.ConstraintsType.MMA_MARTINGALE_MOMENT4: [beta - kappa2, 1.5 * (beta ** 2 + volvol ** 2)
                                                           - (kappa1 + kappa2 * theta)],
              svt.ConstraintsType.INVERSE_MARTINGALE_MOMENT4: [2 * beta - kappa2,
                                                               1.5 * (beta ** 2 + volvol ** 2)
                                                               - (kappa1 + kappa2 * theta)]}
    np.testing.assert_allclose([float(g) for g in gaps],
                               [max(e, 0.0) for e in expect[constraints_type]], rtol=1e-15)


def test_pricer_lm_route_and_defaults(monkeypatch):
    calls = []

    def fake(**kw):
        calls.append(kw)
        return svt.LogSvParams(**PARAMS0), 0.0

    monkeypatch.setattr(tfc, "calibrate_logsv_lm_on_device", fake)
    _, ct = btc_chains()
    pricer = svt.LogSVPricer(device="cpu")
    pricer.calibrate_model_params_to_chain(ct, svt.LogSvParams(**PARAMS0), method="lm",
                                           constraints_type=svt.ConstraintsType.MMA_MARTINGALE)
    pricer.calibrate_model_params_to_chain(ct, svt.LogSvParams(**PARAMS0), method="lm",
                                           nb_iters=3, year_steps=60)
    assert [(c["nb_iters"], c["year_steps"]) for c in calls] == [(16, 180), (3, 60)]
    assert calls[0]["constraints_type"] == svt.ConstraintsType.MMA_MARTINGALE
    assert all(c["device"] == torch.device("cpu") for c in calls)
    np.testing.assert_array_equal(tfc._bounds_vector(calls[0]["params_min"], None), tfc.LOWER)
    np.testing.assert_array_equal(tfc._bounds_vector(calls[0]["params_max"], None), tfc.UPPER)


@pytest.mark.parametrize("kw,match", [
    (dict(calibration_engine=svt.CalibrationEngine.MC, mc_engine="sobol"), "mc_engine"),
    (dict(method="lm", calibration_engine=svt.CalibrationEngine.ROUGH_MC), "PARAMS5"),
    (dict(method="lm",
          model_calibration_type=svt.LogsvModelCalibrationType.PARAMS_WITH_VARSWAP_FIT),
     "PARAMS5"),
    (dict(method="lm", model_calibration_type=svt.LogsvModelCalibrationType.PARAMS4), "PARAMS5"),
])
def test_unported_calibrations_raise(kw, match):
    _, ct = btc_chains()
    with pytest.raises(NotImplementedError, match=match):
        svt.LogSVPricer(device="cpu").calibrate_model_params_to_chain(
            ct, svt.LogSvParams(**PARAMS0), **kw)


def test_unknown_method_raises():
    _, ct = btc_chains()
    with pytest.raises(ValueError):
        svt.LogSVPricer(device="cpu").calibrate_model_params_to_chain(
            ct, svt.LogSvParams(**PARAMS0), method="bfgs")
