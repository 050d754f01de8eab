"""The joint swaption-cube LM of the PyTorch port against the JAX package
(``engine='f64'``), on the CPU in float64: two slices x three strikes of
``tests/test_qa_traced.py``'s fixture at 24 RK4 steps/yr, the market normal
vols those of the traced cube at the fixture's parameters, the start point
the parameters with beta x 0.8 and volvol x 1.2, segment 0 free (four
parameters for six quotes: with segment 1 free too the normal system is
singular but for the damping, and the two packages' CG solves part by
rounding):

* the residuals and their Jacobian at the start point (the JAX module's
  residual function, rebuilt here from its public pieces): 1e-10 relative;
* the first two LM iterates (``nb_iters`` 1 and 2): the fitted beta and
  volvol and the cost, 1e-8 relative;
* the LM reduces the cost and leaves the other segments; a padded strike
  axis weighs nothing; repeated segments raise.

The fit with A free (``fit_A=True``) is held in
``test_torch_rates_calibration_fit_a.py``, the slice LM, the bootstrap,
the A prefit, the full fit and the pricer's entry point in
``test_torch_rates_calibration_fit.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_rates_traced import FWDS_FD, SLICES_FD, STRIKES_FD, params_pair

from stochvolmodels_tpu.models.factor_hjm import fast_calibration as jfc
from stochvolmodels_tpu.models.factor_hjm import rate_logsv_pricer as jrp
from stochvolmodels_tpu.ops.bachelier import infer_normal_implied_vol_fast as j_fast_iv
from stochvolmodels_torch.models.factor_hjm import fast_calibration as tfc
from stochvolmodels_torch.models.factor_hjm import rate_logsv_pricer as trp
from stochvolmodels_torch.ops.bachelier import infer_normal_implied_vol

YEAR_STEPS = 24


FD_CUBE = (SLICES_FD, FWDS_FD, STRIKES_FD)


def market_ivols(cube=FD_CUBE):
    """normal vols of the traced cube (slices, forwards, strikes) at the
    fixture's parameters (the port's, on the CPU): the target of the fits."""
    slices, fwds, strikes = cube
    _, pt = params_pair()
    fn, _ = trp.make_swaption_cube_fn_traced(pt, slices, fwds, strikes, year_steps=YEAR_STEPS,
                                             device="cpu")
    f64 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64))
    ivols = infer_normal_implied_vol(
        forward=f64(fwds)[:, None], ttm=f64([e for e, _ in slices])[:, None],
        strike=f64(np.stack(strikes)), given_price=fn(*fn.primals())).numpy()
    return list(ivols)


def start_pair(A_scale: float = 1.0):
    """the fixture's parameters in both packages with beta x 0.8, volvol x
    1.2 and A x ``A_scale`` on every segment."""
    pair = params_pair()
    for p in pair:
        for s in range(p.A.shape[0]):
            p.update_params(idx=s, beta_idx=p.beta.xs[s] * 0.8, volvol_idx=p.volvol.xs[s] * 1.2,
                            A_idx=p.A[s] * A_scale)
    return pair


def jax_residuals(pj, ivols, fit_A: bool, cube=FD_CUBE):
    """(residual function, p0) of the JAX module's cube LM, built from its
    public pieces in its order: the free vector [beta, volvol(, A)] of
    segment 0 placed by ``.at[].set``, the cube, the fast normal IV, NaN ->
    market."""
    slices, fwds, strikes = cube
    seg = jnp.asarray([0])
    build = jrp.make_swaption_cube_fn_traced if fit_A else jrp.make_swaption_cube_fn
    fn, _ = build(pj, slices, fwds, strikes, year_steps=YEAR_STEPS, engine="f64")
    beta0, volvol0, A0 = (jnp.asarray(pj.beta.xs), jnp.asarray(pj.volvol.xs), jnp.asarray(pj.A))
    K = len(strikes[0])
    fwd = jnp.asarray(np.repeat(np.array(fwds)[:, None], K, axis=1))
    ttm = jnp.asarray(np.repeat(np.array([e for e, _ in slices])[:, None], K, axis=1))
    strike, market = jnp.asarray(np.stack(strikes)), jnp.asarray(np.stack(ivols))

    def residuals(p):
        beta = beta0.at[seg].set(p[:3].reshape(1, 3))
        volvol = volvol0.at[seg].set(p[3:4])
        if fit_A:
            A = A0.at[seg].set(p[4:].reshape(1, 3))
            px = fn(jnp.asarray(pj.sigma0), A, beta, volvol, jnp.asarray(pj.kappa1),
                    jnp.asarray(pj.kappa2))
        else:
            px = fn(jnp.asarray(pj.sigma0), beta, volvol)
        iv = j_fast_iv(forward=fwd, ttm=ttm, strike=strike, given_price=px)
        return (jnp.where(jnp.isnan(iv), market, iv) - market).ravel()

    p0 = [beta0[seg].ravel(), volvol0[seg]] + ([A0[seg].ravel()] if fit_A else [])
    return residuals, jnp.concatenate(p0)


def port_residuals(pt, ivols, fit_A: bool, monkeypatch, cube=FD_CUBE):
    """(residual function, p0) of the port's cube LM, taken from the call
    that ``calibrate_rate_logsv_cube_lm_on_device`` makes of its LM loop."""
    seen = {}
    run = tfc._lm_run

    def spy(p0, lower, upper, problem, nb_iters, fit_A_, nb_free, d, key):
        seen["fn"] = tfc._residuals_fn(fit_A_, nb_free, d, problem)
        seen["p0"] = p0
        return run(p0, lower, upper, problem, nb_iters, fit_A_, nb_free, d, key)

    monkeypatch.setattr(tfc, "_lm_run", spy)
    tfc.calibrate_rate_logsv_cube_lm_on_device(pt, *cube, ivols, segments=[0], nb_iters=0,
                                               year_steps=YEAR_STEPS, fit_A=fit_A, device="cpu")
    return seen["fn"], seen["p0"]


def assert_residuals_and_jacobian_match(fit_A, A_scale, monkeypatch, cube=FD_CUBE):
    ivols = market_ivols(cube)
    pj, pt = start_pair(A_scale)
    res_j, p0_j = jax_residuals(pj, ivols, fit_A, cube)
    res_t, p0_t = port_residuals(pt, ivols, fit_A, monkeypatch, cube)
    np.testing.assert_array_equal(p0_t.numpy(), np.asarray(p0_j))
    r_j, J_j = np.asarray(res_j(p0_j)), np.asarray(jax.jacfwd(res_j)(p0_j))
    r_t = res_t(p0_t).numpy()
    J_t = torch.func.jacfwd(res_t)(p0_t).numpy()
    assert r_t.shape == (len(cube[0]) * len(cube[2][0]),) and J_t.shape == J_j.shape
    np.testing.assert_allclose(r_t, r_j, rtol=0, atol=1e-10 * np.max(np.abs(r_j)))
    np.testing.assert_allclose(J_t, J_j, rtol=0, atol=1e-10 * np.max(np.abs(J_j)))
    assert np.max(np.abs(r_j)) > 1e-5


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    import gc
    jax.clear_caches()
    gc.collect()


def test_residuals_and_jacobian_at_the_start_match(monkeypatch):
    assert_residuals_and_jacobian_match(False, 1.0, monkeypatch)


@pytest.fixture(scope="module")
def cube_fits():
    ivols = market_ivols()
    fits = {}
    for nb_iters in (1, 2):
        pj, pt = start_pair()
        fits[nb_iters] = (
            jfc.calibrate_rate_logsv_cube_lm_on_device(pj, *FD_CUBE, ivols, segments=[0],
                                                       nb_iters=nb_iters,
                                                       year_steps=YEAR_STEPS, engine="f64"),
            tfc.calibrate_rate_logsv_cube_lm_on_device(pt, *FD_CUBE, ivols, segments=[0],
                                                       nb_iters=nb_iters,
                                                       year_steps=YEAR_STEPS, device="cpu"))
    return ivols, fits


@pytest.mark.parametrize("nb_iters", [1, 2])
def test_first_two_iterates_match(cube_fits, nb_iters):
    _, fits = cube_fits
    (fj, cost_j), (ft, cost_t) = fits[nb_iters]
    for a, b in ((ft.beta.xs, fj.beta.xs), (ft.volvol.xs, fj.volvol.xs), (ft.A, fj.A)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-8 * np.max(np.abs(b)))
    assert abs(cost_t - cost_j) <= 1e-8 * cost_j


def test_the_lm_reduces_the_cost_and_keeps_the_rest(cube_fits):
    ivols, fits = cube_fits
    _, pt = start_pair()
    _, cost0 = tfc.calibrate_rate_logsv_cube_lm_on_device(pt, *FD_CUBE, ivols, segments=[0],
                                                          nb_iters=0, year_steps=YEAR_STEPS,
                                                          device="cpu")
    (_, c1), (_, c2) = fits[1][1], fits[2][1]
    assert c2 <= c1 < 0.05 * cost0
    fitted = fits[2][1][0]
    # the segments that are not free stay as they were
    np.testing.assert_array_equal(fitted.beta.xs[1:], pt.beta.xs[1:])
    np.testing.assert_array_equal(fitted.volvol.xs[1:], pt.volvol.xs[1:])
    # the input parameters are not written into
    np.testing.assert_array_equal(pt.beta.xs[0], params_pair()[1].beta.xs[0] * 0.8)


def test_padded_entries_weigh_nothing():
    """a cube whose slices hold 3 and 2 strikes: the padded quote has weight
    0, a priceable dummy, and the residual vector is (P, K_max) flat, as in
    the JAX module."""
    ivols = market_ivols()
    _, pt = start_pair()
    strikes = [STRIKES_FD[0], STRIKES_FD[1][:2]]
    cube, _ = trp.make_swaption_cube_fn(pt, SLICES_FD, FWDS_FD, strikes, year_steps=YEAR_STEPS,
                                        device="cpu")
    market, weights, fwd, strike, ttm = tfc._quote_panels(
        cube, FWDS_FD, strikes, [ivols[0], ivols[1][:2]], [e for e, _ in SLICES_FD])
    np.testing.assert_array_equal(weights, [[1.0, 1.0, 1.0], [1.0, 1.0, 0.0]])
    assert ttm[1, 2] == 1.0 and fwd[1, 2] == 0.0 and np.all(np.isfinite(market))
    fit, cost = tfc.calibrate_rate_logsv_cube_lm_on_device(
        pt, SLICES_FD, FWDS_FD, strikes, [ivols[0], ivols[1][:2]], nb_iters=1,
        year_steps=YEAR_STEPS, device="cpu")
    assert np.isfinite(cost) and np.all(np.isfinite(fit.beta.xs))


def test_repeated_segments_raise():
    ivols = market_ivols()
    _, pt = start_pair()
    with pytest.raises(AssertionError):
        tfc.calibrate_rate_logsv_cube_lm_on_device(pt, SLICES_FD, FWDS_FD, STRIKES_FD, ivols,
                                                   segments=[0, 0], nb_iters=0,
                                                   year_steps=YEAR_STEPS, device="cpu")

