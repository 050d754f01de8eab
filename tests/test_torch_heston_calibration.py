"""Heston calibration of the PyTorch port against the JAX package.

Both packages run on the CPU in float64 on the same numpy inputs.

* The chain prices from 0-dim float64 tensor parameters (and a tensor vol
  scaler) equal the float build bit for bit.
* The SLSQP objective (vega-weighted squared errors of the 200-step
  bisection ivols) and its ``torch.autograd`` gradient against
  ``_heston_calibration_objective`` and ``jax.value_and_grad`` at vol scaler
  0.28: value 1e-12 relative, gradient 1e-9 relative.
* The Feller constraint and its analytic Jacobian, as each package hands
  them to scipy.
* The LM residuals and their ``jacfwd`` Jacobian at the JAX test's
  ``params0``: 1e-9; two LM iterations against ``_heston_lm_run``: 1e-7.
* ``precision='fast'`` ivols go through the fast implied vol: equal to the
  JAX fused call with its closed form in float64 to 1e-10, to the JAX
  ``'fast'`` call (float32 closed form) to 1e-5, NaN patterns equal.
* A whole SLSQP fit capped at two iterations in both packages (each
  module's ``minimize`` wrapped to set ``maxiter``): 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import OptimizeResult
from torch.func import jacfwd

from _torch_port import assert_same_nan_pattern, btc_chains

import stochvolmodels_torch as svt
from stochvolmodels_torch.models import heston as th
from stochvolmodels_torch.ops import bsm as tbsm
from stochvolmodels_tpu.config import VariableType as JaxVariableType
from stochvolmodels_tpu.models import heston as jh
from stochvolmodels_tpu.ops import bsm as jbsm

# the JAX test's start point of its LM fit (tests/test_heston.py)
LM_PARAMS0 = dict(v0=0.8, theta=1.0, kappa=2.0, rho=0.1, volvol=1.5)
NAMES = ("v0", "theta", "kappa", "rho", "volvol")


def f64(x):
    return torch.tensor(x, dtype=torch.float64)


def seeded_points(n, seed=8):
    """BTC_HESTON_PARAMS with n - 1 seeded perturbations inside the bounds."""
    rng = np.random.default_rng(seed)
    base = svt.BTC_HESTON_PARAMS.to_array()
    scale = np.array([0.1, 0.1, 0.5, 0.2, 0.3])
    return [base] + [base + scale * rng.uniform(-1.0, 1.0, 5) for _ in range(n - 1)]


def jax_targets(cj, p0):
    """(grid, market, weights, vol scaler) as the JAX fit builds them."""
    grid = cj.to_grid()
    mask = np.asarray(grid.mask)
    market, _ = jh._pad_like(cj.get_mid_vols(), grid)
    weights, _ = jh._pad_like([v / np.sum(v) for v in cj.get_chain_vegas()], grid)
    vol_scaler = float(np.minimum(0.3, np.sqrt(p0[0] * cj.ttms[0])))
    return (grid, jnp.asarray(np.where(mask, market, 0.0)), jnp.asarray(np.where(mask, weights, 0.0)),
            vol_scaler)


def test_tensor_built_prices_equal_the_float_build():
    _, ct = btc_chains()
    grid = ct.to_grid(device="cpu")
    ttms = tuple(float(t) for t in ct.ttms)
    for point in seeded_points(3):
        kw = dict(zip(NAMES, point))
        floats = svt.heston_chain_price_grid(grid, **{k: float(v) for k, v in kw.items()},
                                             vol_scaler=0.27, ttms_static=ttms)
        tensors = svt.heston_chain_price_grid(grid, **{k: f64(v) for k, v in kw.items()},
                                              vol_scaler=f64(0.27), ttms_static=ttms)
        assert torch.equal(floats, tensors)
        # the maturities read from the grid give the same panel
        assert torch.equal(floats, svt.heston_chain_price_grid(
            grid, **{k: float(v) for k, v in kw.items()}, vol_scaler=0.27))


@pytest.mark.parametrize("point", range(3))
def test_slsqp_objective_and_gradient_match_jax(point):
    cj, ct = btc_chains()
    pars = seeded_points(3)[point]
    grid_j, market_j, weights_j, _ = jax_targets(cj, pars)
    value_j, grad_j = jax.jit(jax.value_and_grad(
        lambda p: jh._heston_calibration_objective(p, grid_j, market_j, weights_j, 0.28)))(
        jnp.asarray(pars))
    grid, market, weights, _ = th._calibration_targets(ct, pars, True, False, "cpu")
    tracked = f64(pars).requires_grad_(True)
    value = th._heston_calibration_objective(tracked, grid, market, weights, 0.28,
                                             tuple(float(t) for t in ct.ttms))
    (grad,) = torch.autograd.grad(value, tracked)
    assert float(value.detach()) > 0.0
    np.testing.assert_allclose(float(value.detach()), float(value_j), rtol=1e-12)
    np.testing.assert_allclose(grad.numpy(), np.asarray(grad_j), rtol=1e-9,
                               atol=1e-9 * np.max(np.abs(np.asarray(grad_j))))


def recording_minimize(records):
    """a stand-in for scipy's ``minimize`` that records its arguments and
    returns the start point."""
    def fake(fun, x0, **kw):
        records.append(dict(kw, fun=fun, x0=np.asarray(x0)))
        return OptimizeResult(x=np.asarray(x0), fun=0.0, nfev=0, nit=0)
    return fake


def test_feller_constraint_and_its_jacobian(monkeypatch):
    cj, ct = btc_chains()
    records = {}
    for module, pricer, chain in ((jh, jh.HestonPricer(), cj),
                                  (th, svt.HestonPricer(device="cpu"), ct)):
        records[module] = []
        monkeypatch.setattr(module, "minimize", recording_minimize(records[module]))
        pricer.calibrate_model_params_to_chain(chain, params0=None)
    (rec_j,), (rec_t,) = records[jh], records[th]
    np.testing.assert_array_equal(rec_t["x0"], rec_j["x0"])
    assert rec_t["bounds"] == rec_j["bounds"] and rec_t["options"] == rec_j["options"]
    cons_j, cons_t = rec_j["constraints"], rec_t["constraints"]
    assert cons_t["type"] == cons_j["type"] == "ineq"
    for point in seeded_points(4):
        assert cons_t["fun"](point) == cons_j["fun"](point)
        np.testing.assert_array_equal(cons_t["jac"](point), cons_j["jac"](point))
        h = 1e-6
        fd = [(cons_t["fun"](point + h * e) - cons_t["fun"](point - h * e)) / (2 * h)
              for e in np.eye(5)]
        np.testing.assert_allclose(cons_t["jac"](point), fd, rtol=1e-7, atol=1e-7)


@pytest.fixture(scope="module")
def lm_problem():
    """the LM residuals and Jacobian of the JAX package at the JAX test's
    params0 (the residual function ``_heston_lm_run`` builds)."""
    cj, ct = btc_chains()
    p0 = np.array([LM_PARAMS0[k] for k in NAMES])
    grid, market, weights, vol_scaler = jax_targets(cj, p0)
    sqrtw = jnp.sqrt(weights)

    def residuals(pars):
        prices = jh.heston_chain_price_grid(grid, v0=pars[0], theta=pars[1], kappa=pars[2],
                                            volvol=pars[4], rho=pars[3],
                                            vol_scaler=jnp.asarray(vol_scaler))
        vols = jbsm.infer_bsm_implied_vol_fast(
            forward=grid.forwards[:, None], ttm=grid.ttms[:, None], strike=grid.strikes,
            given_price=prices, discfactor=grid.discfactors[:, None], optiontype=grid.optioncodes)
        nan_mask = jnp.isnan(vols)
        r = (sqrtw * (jnp.where(nan_mask, market, vols) - market)).ravel()
        feller = jnp.maximum(pars[4] * pars[4] - 2.0 * pars[2] * pars[1], 0.0)
        return jnp.concatenate([r, jnp.sqrt(10.0) * feller[None]])

    j_res = np.asarray(jax.jit(residuals)(jnp.asarray(p0)))
    j_jac = np.asarray(jax.jit(jax.jacfwd(residuals))(jnp.asarray(p0)))
    return cj, ct, p0, j_res, j_jac


def test_lm_residuals_and_jacobian_match_jax(lm_problem):
    _, ct, p0, j_res, j_jac = lm_problem
    grid, market, weights, vol_scaler = th._calibration_targets(ct, p0, True, False, "cpu")
    residuals = th._heston_residuals(grid.ttms, grid.forwards, grid.discfactors, grid.strikes,
                                     grid.optioncodes, grid.mask, market, torch.sqrt(weights),
                                     f64(vol_scaler),
                                     ttms_static=tuple(float(t) for t in ct.ttms))
    jac, res = jacfwd(lambda p: (lambda r: (r, r))(residuals(p)), has_aux=True)(f64(p0))
    # volvol^2 = 2.25 > 2 kappa theta = 4: the Feller penalty is 0 at params0
    assert res[-1] == 0.0 and j_res[-1] == 0.0
    np.testing.assert_allclose(res.numpy(), j_res, rtol=1e-9, atol=1e-9 * np.max(np.abs(j_res)))
    np.testing.assert_allclose(jac.numpy(), j_jac, rtol=1e-9, atol=1e-9 * np.max(np.abs(j_jac)))
    assert np.all(np.isfinite(jac.numpy()))


def test_two_lm_iterations_match_jax(lm_problem):
    cj, ct, p0, _, _ = lm_problem
    grid, market, weights, vol_scaler = jax_targets(cj, p0)
    lower = jnp.asarray([b[0] for b in th.HESTON_BOUNDS])
    upper = jnp.asarray([b[1] for b in th.HESTON_BOUNDS])
    j_best, j_cost = jh._heston_lm_run(jnp.asarray(p0), grid, market, jnp.sqrt(weights), lower,
                                       upper, jnp.asarray(vol_scaler), nb_iters=2,
                                       use_float32=False)
    fit, cost = svt.calibrate_heston_lm(ct, svt.HestonParams(**LM_PARAMS0), nb_iters=2,
                                        device="cpu")
    start = float(jnp.sum(jnp.square(jnp.asarray(lm_problem[3]))))
    assert np.isfinite(cost) and cost < start
    np.testing.assert_allclose(cost, float(j_cost), rtol=1e-7)
    np.testing.assert_allclose(fit.to_array(), np.asarray(j_best), rtol=1e-7)
    # the pricer's method='lm' is the same fit, with its cost on the result
    pricer = svt.HestonPricer(device="cpu")
    via_pricer = pricer.calibrate_model_params_to_chain(ct, svt.HestonParams(**LM_PARAMS0),
                                                        method="lm", nb_iters=2)
    assert via_pricer == fit and pricer.calibration_result.fun == cost


def test_fast_precision_ivols_go_through_the_fast_iv(monkeypatch):
    cj, ct = btc_chains()
    H = svt.BTC_HESTON_PARAMS
    vol_scaler = float(np.minimum(0.3, np.sqrt(H.v0 * cj.ttms[0])))
    grid = cj.to_grid()
    args = (grid, H.v0, H.theta, H.kappa, H.volvol, H.rho, vol_scaler, JaxVariableType.LOG_RETURN)
    fused_f64 = cj.unpad_panel(jh._heston_chain_ivols_grid_jit(*args, False))
    fused_fast = jh.HestonPricer().compute_model_ivols_for_chain(cj, jh.BTC_HESTON_PARAMS,
                                                                 precision="fast")

    def no_bisection(*a, **k):
        raise AssertionError("precision='fast' ran the 200-step bisection")

    monkeypatch.setattr(tbsm, "_bisection", no_bisection)
    out = svt.HestonPricer(device="cpu").compute_model_ivols_for_chain(ct, H, precision="fast")
    for a, b, c in zip(out, fused_f64, fused_fast):
        assert_same_nan_pattern(a, b)
        assert_same_nan_pattern(a, c)
        np.testing.assert_allclose(a, np.asarray(b), rtol=0.0, atol=1e-10)
        np.testing.assert_allclose(a, np.asarray(c), rtol=0.0, atol=1e-5)
        assert np.all(np.isfinite(a))


def capped_minimize(module, maxiter, monkeypatch):
    real = module.minimize

    def capped(*args, **kw):
        kw["options"] = dict(kw.get("options") or {}, maxiter=maxiter)
        return real(*args, **kw)

    monkeypatch.setattr(module, "minimize", capped)


def test_slsqp_fit_capped_at_two_iterations_matches_jax(monkeypatch):
    cj, ct = btc_chains()
    for module in (jh, th):
        capped_minimize(module, 2, monkeypatch)
    j_fit = jh.HestonPricer().calibrate_model_params_to_chain(cj, jh.BTC_HESTON_PARAMS)
    pricer = svt.HestonPricer(device="cpu")
    fit = pricer.calibrate_model_params_to_chain(ct, svt.BTC_HESTON_PARAMS)
    assert pricer.calibration_result.nit == 2
    np.testing.assert_allclose(fit.to_array(), j_fit.to_array(), rtol=1e-6)
    assert not np.allclose(fit.to_array(), svt.BTC_HESTON_PARAMS.to_array())


def test_unknown_method_raises():
    _, ct = btc_chains()
    with pytest.raises(ValueError):
        svt.HestonPricer(device="cpu").calibrate_model_params_to_chain(ct, None, method="nope")


def test_v0_implied_matches_jax():
    for v0, volvol, ttm in ((0.8, 2.0, 0.04), (0.04, 0.4, 1.0)):
        assert svt.v0_implied(v0, volvol, ttm) == jh.v0_implied(v0, volvol, ttm)
