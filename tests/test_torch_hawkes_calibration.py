"""Hawkes JD calibration of the PyTorch port against the JAX package.

Both packages run on the CPU in float64 on the same numpy inputs, on the
first two BTC slices unless a test says otherwise.

* The Riccati RK4 and the chain price panel from 0-dim float64 tensor
  parameters equal the float build bit for bit.
* The PARAMS8 price panel against ``_hawkes_chain_price_panel``: 1e-12 x
  forward.
* The LM residuals and their ``jacfwd`` Jacobian at ``HawkesJDParams()``:
  1e-9, at 60 RK4 steps/yr (both slices take the 16-step floor there; no
  lane diverges in either package, and none at 720, the fit's default).
* The LM iteration: on a well-conditioned problem the two packages'
  iterations agree to 1e-12.  On the Hawkes chain they cannot agree to
  1e-7: at ``HawkesJDParams()`` the damped normal matrix has condition
  ~5e9, and the 11-step conjugate-gradient solve of both packages moves by
  O(1) in the beta components when the Jacobian moves by one rounding.
  The test shows that property of the reference; both fits start from the
  same cost (1e-9) and at least halve it in two iterations.
* The SLSQP objective and ``jump_cond`` at p0 and 3 seeded points: 1e-10.
* The risk-premia objective at p0 and 2 seeded points (on the 2-week slice
  of the forward-normalised chain): 1e-10 relative; the fit writes sigma and
  gamma into ``params0`` in both packages.
* The fits themselves, capped at one iteration: ``test_torch_hawkes_calibration_fit.py``.
* ``precision='fast'`` ivols and prices go through the fast implied vol at
  720 steps/yr: equal to the JAX fused call in float64 to 1e-10 (prices
  1e-12 x forward), to the JAX ``'fast'`` call (float32 Riccati) to 1e-5,
  NaN patterns equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import OptimizeResult
from torch.func import jacfwd

from _torch_port import assert_same_nan_pattern, btc_chains

import stochvolmodels_torch as svt
import stochvolmodels_tpu as svj
from stochvolmodels_torch.models import hawkes_jd as th
from stochvolmodels_torch.ops import bsm as tbsm
from stochvolmodels_tpu.models import hawkes_jd as jh
from stochvolmodels_tpu.models.logsv.pricer import _pad_panel as jax_pad_panel
from stochvolmodels_tpu.ops import lm as jlm

RESIDUAL_YEAR_STEPS = 60
GAMMA = 0.5


def f64(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


@functools.lru_cache(maxsize=None)
def two_slices():
    cj, ct = btc_chains()
    ids = list(cj.ids[:2])
    return (svj.OptionChain.get_slices_as_chain(cj, ids),
            svt.OptionChain.get_slices_as_chain(ct, ids))


def params8(P):
    """the LM's 8-parameter start vector of ``P``."""
    return np.array([P.sigma, P.mean_p, P.mean_m, P.theta_p, P.theta_m,
                     0.5 * (P.kappa_p + P.kappa_m), P.beta1_p, P.beta1_m])


def seeded_points(p0, n, scale, seed=5):
    rng = np.random.default_rng(seed)
    return [p0] + [p0 * (1.0 + scale * rng.uniform(-1.0, 1.0, p0.shape)) for _ in range(n - 1)]


def test_tensor_built_riccati_and_prices_equal_the_float_build():
    _, ct = two_slices()
    P = th.HawkesJDParams(**{**th.HawkesJDParams().to_dict(), "sigma": 0.52, "beta1_m": 91.3})
    p_float = th._ode_params(P)
    p_tensor = {k: f64(v) for k, v in p_float.items()}
    phi = svt.get_phi_grid(device="cpu", max_phi=th.MAX_PHI, vol_scaler=0.11)
    psi, a0 = torch.zeros_like(phi), torch.zeros((th.MAX_PHI, 3), dtype=torch.complex128)
    a_float = th._solve_a_ode_grid_p(phi, psi, a0, 37, 0.0021, p_float)
    assert torch.equal(a_float, th._solve_a_ode_grid_p(phi, psi, a0, 37, 0.0021, p_tensor))
    assert torch.equal(a_float, th.solve_a_ode_grid(phi, 37 * 0.0021, P, nb_steps=37))
    grid = ct.to_grid(device="cpu")
    kw = dict(ttms_static=tuple(float(t) for t in ct.ttms), year_steps=720)
    floats = th._hawkes_chain_price_panel(p_float, grid, lambda_p=P.lambda_p,
                                          lambda_m=P.lambda_m, vol_scaler=0.09, **kw)
    tensors = th._hawkes_chain_price_panel(p_tensor, grid, lambda_p=f64(P.lambda_p),
                                           lambda_m=f64(P.lambda_m), vol_scaler=f64(0.09), **kw)
    assert torch.equal(floats, tensors)
    # the pricer's path: the parameters as one tensor vector
    prices, gamma_forwards = th._price_panel(grid, P, 0.09, kw["ttms_static"], 720, True)
    assert torch.equal(floats, prices) and gamma_forwards is None


def test_params8_price_panel_matches_jax():
    cj, ct = two_slices()
    P = th.HawkesJDParams()
    pars = params8(P)
    vol_scaler = th.set_vol_scaler(P.sigma, np.min(ct.ttms))
    kw = dict(ttms_static=tuple(float(t) for t in ct.ttms), year_steps=720)
    ref = np.asarray(jh._hawkes_chain_price_panel(
        jh._pars8_to_dict(jnp.asarray(pars), P.shift_p, P.shift_m), cj.to_grid(),
        lambda_p=P.lambda_p, lambda_m=P.lambda_m, vol_scaler=vol_scaler, **kw))
    out = th._hawkes_chain_price_panel(
        th._pars8_to_dict(f64(pars), f64(P.shift_p), f64(P.shift_m)), ct.to_grid(device="cpu"),
        lambda_p=P.lambda_p, lambda_m=P.lambda_m, vol_scaler=vol_scaler, **kw).numpy()
    mask = np.asarray(cj.to_grid().mask)
    assert np.all(np.isfinite(out[mask])) and np.all(out[mask] > 0.0)
    gap = np.abs(out - ref) / ct.forwards[:, None]
    assert np.max(gap[mask]) <= 1e-12


@pytest.fixture(scope="module")
def lm_problem():
    """the LM residuals and Jacobian of the JAX package at HawkesJDParams()
    (the residual function ``_hawkes_lm_run`` builds)."""
    cj, ct = two_slices()
    P = jh.HawkesJDParams()
    p0 = params8(P)
    grid = cj.to_grid()
    mask = np.asarray(grid.mask)
    market = np.where(mask, jax_pad_panel(cj.get_mid_vols(), grid), 0.0)
    sqrtw = np.sqrt(np.where(mask, jax_pad_panel([v / np.sum(v) for v in cj.get_chain_vegas()],
                                                 grid), 0.0))
    consts = np.array([P.shift_p, P.shift_m, P.lambda_p, P.lambda_m,
                       jh.set_vol_scaler(P.sigma, np.min(cj.ttms))])
    ttms = tuple(float(t) for t in cj.ttms)

    def residuals(pars):
        c = jnp.asarray(consts)
        vols = jh._hawkes_chain_vols_panel(
            jh._pars8_to_dict(pars, c[0], c[1]), grid, ttms_static=ttms, lambda_p=c[2],
            lambda_m=c[3], vol_scaler=c[4], year_steps=RESIDUAL_YEAR_STEPS)
        nan_mask = jnp.isnan(vols)
        r = (jnp.asarray(sqrtw) * (jnp.where(nan_mask, market, vols) - market)).ravel()
        exp_jp, exp_jm = c[0] + pars[1], c[1] + pars[2]
        j1 = pars[5] - pars[6] * exp_jp + pars[6] * exp_jm
        j2 = pars[5] - pars[7] * exp_jp + pars[7] * exp_jm
        return jnp.concatenate([r, jnp.sqrt(10.0) * jnp.maximum(-(j1 + j2), 0.0)[None]])

    j_res = np.asarray(jax.jit(residuals)(jnp.asarray(p0)))
    j_jac = np.asarray(jax.jit(jax.jacfwd(residuals))(jnp.asarray(p0)))
    g = ct.to_grid(device="cpu")
    port = th._hawkes_lm_residuals(g.ttms, g.forwards, g.discfactors, g.strikes, g.optioncodes,
                                   g.mask, f64(market), f64(sqrtw), f64(consts), ttms_static=ttms,
                                   year_steps=RESIDUAL_YEAR_STEPS)
    return p0, j_res, j_jac, port, mask


def test_lm_residuals_and_jacobian_match_jax(lm_problem):
    p0, j_res, j_jac, residuals, mask = lm_problem
    jac, res = jacfwd(lambda p: (lambda r: (r, r))(residuals(p)), has_aux=True)(f64(p0))
    # no quote drops out (no NaN vol) at 60 steps/yr; the stationarity
    # penalty is 0 at the default parameters
    assert np.count_nonzero(res.numpy()[:-1]) == np.count_nonzero(mask) and res[-1] == 0.0
    np.testing.assert_allclose(res.numpy(), j_res, rtol=1e-9, atol=1e-9 * np.max(np.abs(j_res)))
    np.testing.assert_allclose(jac.numpy(), j_jac, rtol=1e-9, atol=1e-9 * np.max(np.abs(j_jac)))
    assert np.all(np.isfinite(jac.numpy()))


def test_lm_iterations_match_jax_on_a_well_conditioned_problem():
    """y = a exp(-b t) + c t: the two packages' LM iterations, one at a time."""
    t = np.linspace(0.0, 2.0, 12)
    y = 2.0 * np.exp(-0.7 * t) + 0.3 * t
    lower, upper, p0 = np.array([0.0, 0.0, -1.0]), np.array([1.8, 5.0, 1.0]), np.array([1.0, 0.1, 0.0])
    for nb_iters in (1, 2, 5):
        jb, jc = jlm.lm_minimize(lambda p: p[0] * jnp.exp(-p[1] * t) + p[2] * t - y,
                                 jnp.asarray(p0), jnp.asarray(lower), jnp.asarray(upper),
                                 nb_iters=nb_iters)
        tt, ty = f64(t), f64(y)
        tb, tc = svt.lm_minimize(lambda p: p[0] * torch.exp(-p[1] * tt) + p[2] * tt - ty,
                                 f64(p0), f64(lower), f64(upper), nb_iters=nb_iters)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(float(tc), float(jc), rtol=1e-12)


def jax_step(J, r, lam=1e-2):
    """the step of the JAX package's LM iteration from (J, r)."""
    JTJ = J.T @ J
    D = jnp.diag(jnp.maximum(jnp.diagonal(JTJ), 1e-10))
    n = J.shape[1]
    return jlm.cg_solve(JTJ + lam * D + 1e-12 * jnp.eye(n), -(J.T @ r), iters=n + 3)


def test_the_reference_lm_step_is_rounding_bound_at_the_default_params(lm_problem):
    """a relative change of 1e-15 in the Jacobian (below the two packages'
    3.7e-13 gap) moves the JAX package's own first step by more than 1e-3
    relative: no implementation can match its iterates to 1e-7 here."""
    _, j_res, j_jac, _, _ = lm_problem
    JTJ = j_jac.T @ j_jac
    assert np.linalg.cond(JTJ + 1e-2 * np.diag(np.diag(JTJ))) > 1e9
    rng = np.random.default_rng(3)
    step = np.asarray(jax_step(jnp.asarray(j_jac), jnp.asarray(j_res)))
    nudged = np.asarray(jax_step(jnp.asarray(j_jac * (1.0 + 1e-15 * rng.standard_normal(j_jac.shape))),
                                 jnp.asarray(j_res)))
    assert np.max(np.abs(nudged - step) / np.abs(step)) > 1e-3


def test_two_lm_iterations_both_lower_the_cost(lm_problem):
    cj, ct = two_slices()
    _, j_res, _, _, _ = lm_problem
    kw = dict(nb_iters=2, year_steps=RESIDUAL_YEAR_STEPS)
    j_fit, j_cost = jh.calibrate_hawkesjd_lm_on_device(cj, jh.HawkesJDParams(), use_float32=False,
                                                       **kw)
    fit, cost = svt.calibrate_hawkesjd_lm_on_device(ct, svt.HawkesJDParams(), device="cpu", **kw)
    _, cost0 = svt.calibrate_hawkesjd_lm_on_device(ct, svt.HawkesJDParams(), nb_iters=0,
                                                   year_steps=RESIDUAL_YEAR_STEPS, device="cpu")
    np.testing.assert_allclose(cost0, np.sum(j_res ** 2), rtol=1e-9)
    assert np.isfinite(cost) and cost < 0.5 * cost0 and float(j_cost) < 0.5 * cost0
    # both stay inside the box and keep the reduction of the 8-parameter fit
    for f in (fit, j_fit):
        assert f.kappa_p == f.kappa_m and f.beta2_p == -f.beta1_p and f.beta2_m == -f.beta1_m
        assert 0.1 <= f.sigma <= 2.0 and f.beta1_m <= 100.0
    # the pricer's method='lm' runs the same fit
    via_pricer = svt.HawkesJDPricer(device="cpu").calibrate_model_params_to_chain(
        ct, svt.HawkesJDParams(), method="lm", **kw)
    assert via_pricer == fit


@functools.lru_cache(maxsize=None)
def recorded_problems(kind):
    """the (objective, constraints, ...) each package hands to scipy for the
    8-parameter fit (``kind='slsqp'``, two slices) or the gamma fit (the
    2-week slice of the forward-normalised chain), and the ``params0`` each
    was called with."""
    cj, ct = two_slices()
    if kind == "gamma":
        cj = svj.OptionChain.to_forward_normalised_strikes(
            svj.OptionChain.get_slices_as_chain(cj, [cj.ids[0]]))
        ct = svt.OptionChain.to_forward_normalised_strikes(
            svt.OptionChain.get_slices_as_chain(ct, [ct.ids[0]]))
    out = {}
    for name, module, pricer, chain, params in (
            ("jax", jh, jh.HawkesJDPricer(), cj, jh.HawkesJDParams(risk_premia_gamma=GAMMA)),
            ("port", th, svt.HawkesJDPricer(device="cpu"), ct,
             svt.HawkesJDParams(risk_premia_gamma=GAMMA))):
        records = []

        def fake(fun, x0, **kw):
            records.append(dict(kw, fun=fun, x0=np.asarray(x0)))
            return OptimizeResult(x=np.asarray(x0), fun=0.0, nfev=0, nit=0)

        real, module.minimize = module.minimize, fake
        try:
            if kind == "gamma":
                returned = pricer.calibrate_risk_premia_gamma_to_chain(chain, params)
            else:
                returned = pricer.calibrate_model_params_to_chain(
                    chain, jh.HawkesJDParams() if name == "jax" else svt.HawkesJDParams())
        finally:
            module.minimize = real
        out[name] = (records[0], params, returned)
    return out


def test_slsqp_objective_and_jump_cond_match_jax():
    rec = recorded_problems("slsqp")
    (rj, _, _), (rt, _, _) = rec["jax"], rec["port"]
    np.testing.assert_array_equal(rt["x0"], rj["x0"])
    assert rt["bounds"] == rj["bounds"] and rt["options"] == rj["options"]
    assert rt["constraints"]["type"] == rj["constraints"]["type"] == "ineq"
    for x in seeded_points(rj["x0"], 4, 0.2):
        np.testing.assert_allclose(rt["fun"](x), rj["fun"](x), rtol=1e-10)
        np.testing.assert_allclose(rt["constraints"]["fun"](x), rj["constraints"]["fun"](x),
                                   rtol=1e-12)


def test_gamma_objective_matches_jax_and_writes_into_params0():
    rec = recorded_problems("gamma")
    (rj, pj, ret_j), (rt, pt, ret_t) = rec["jax"], rec["port"]
    np.testing.assert_array_equal(rt["x0"], rj["x0"])
    assert rt["bounds"] == rj["bounds"] and rt["options"] == rj["options"]
    assert rt["tol"] == rj["tol"] == 1e-16 and rt["options"]["eps"] == 0.025
    for x in seeded_points(rj["x0"], 3, 0.3):
        np.testing.assert_allclose(rt["fun"](x), rj["fun"](x), rtol=1e-10)
        # each evaluation writes (sigma, 8 x gamma/8) into params0, in both packages
        for params in (pj, pt):
            assert params.sigma == x[0] and params.risk_premia_gamma == 8.0 * x[1]
    # the fit returns params0 itself
    assert ret_j is pj and ret_t is pt


def test_fast_precision_goes_through_the_fast_iv(monkeypatch):
    cj, ct = btc_chains()
    P = jh.HawkesJDParams()
    d = dict(P.to_dict(), compensator_p=P.compensator_p, compensator_m=P.compensator_m)
    pvec = jnp.asarray([d[k] for k in jh._PKEYS])
    kw = dict(ttms_static=tuple(float(t) for t in cj.ttms), lambda_p=P.lambda_p,
              lambda_m=P.lambda_m, vol_scaler=jh.set_vol_scaler(P.sigma, np.min(cj.ttms)),
              year_steps=720, solve_f32=False)
    grid = cj.to_grid()

    @jax.jit
    def fused(pvec):
        p = dict(zip(jh._PKEYS, [pvec[i] for i in range(len(jh._PKEYS))]))
        return (jh._hawkes_chain_price_panel(p, grid, **kw),
                grid.masked(jh._hawkes_chain_vols_panel(p, grid, **kw)))

    prices_f64, vols_f64 = (cj.unpad_panel(np.asarray(a)) for a in fused(pvec))
    vols_fast = jh.HawkesJDPricer().compute_model_ivols_for_chain(cj, P, precision="fast")

    def no_bisection(*a, **k):
        raise AssertionError("precision='fast' ran the 200-step bisection")

    monkeypatch.setattr(tbsm, "_bisection", no_bisection)
    pricer = svt.HawkesJDPricer(device="cpu")
    vols = pricer.compute_model_ivols_for_chain(ct, svt.HawkesJDParams(), precision="fast")
    prices = pricer.price_chain(ct, svt.HawkesJDParams(), precision="fast")
    for v, vj, vf, p, pj, fwd in zip(vols, vols_f64, vols_fast, prices, prices_f64, ct.forwards):
        assert_same_nan_pattern(v, vj)
        assert_same_nan_pattern(v, vf)
        np.testing.assert_allclose(v, vj, rtol=0.0, atol=1e-10)
        np.testing.assert_allclose(v, np.asarray(vf), rtol=0.0, atol=1e-5)
        assert np.max(np.abs(p - pj)) <= 1e-12 * fwd
