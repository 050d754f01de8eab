"""The per-expiry slice LM and the term-structure bootstrap of the PyTorch
port against the JAX package, on the CPU in float64: the 1y expiry of
``tests/test_qa_traced.py``'s fixture with the 1y and 5y tenors x three
strikes (the frozen slice panels on a 31-point grid, 360 RK4 steps/yr),
the market normal vols those of the traced cube at the fixture's
parameters, the start point beta x 0.8 and volvol x 1.2:

* ``calibrate_rate_logsv_term_structure`` over the one expiry (one
  bootstrap step: the slice LM of segment 0 on the 31-point grid) at one
  iteration, and ``calibrate_rate_logsv_lm_on_device`` on the same grid at
  two: the first two iterates, fitted beta and volvol and the cost, 1e-8
  relative (the JAX package compiles each fit anew, ~11 s, so each iterate
  is one fit a side).
"""
import jax
import numpy as np
import pytest
from test_torch_rates_calibration import market_ivols, start_pair

from stochvolmodels_tpu.models.factor_hjm import fast_calibration as jfc
from stochvolmodels_torch.models.factor_hjm import fast_calibration as tfc
from stochvolmodels_torch.utils.rate_core import generate_ttms_grid

EXPIRY, TENORS = 1.0, [1.0, 5.0]
FWDS = [0.0435, 0.0421]
STRIKES = [fwd + np.array([-0.01, 0.0, 0.01]) for fwd in FWDS]
CUBE = ([(EXPIRY, t) for t in TENORS], FWDS, STRIKES)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    import gc
    jax.clear_caches()
    gc.collect()


def assert_fits_match(fit_j, fit_t):
    (fj, cost_j), (ft, cost_t) = fit_j, fit_t
    for a, b in ((ft.beta.xs, fj.beta.xs), (ft.volvol.xs, fj.volvol.xs), (ft.A, fj.A)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-8 * np.max(np.abs(b)))
    assert abs(np.asarray(cost_t) - np.asarray(cost_j)).max() <= 1e-8 * np.max(cost_j)


@pytest.fixture(scope="module")
def slice_fits():
    ivols = market_ivols(CUBE)
    t_grid = generate_ttms_grid(np.array([EXPIRY]), nb_pts=31)
    pj, pt = start_pair()
    args = (t_grid, EXPIRY, 0, TENORS, FWDS, STRIKES, ivols)
    second = (jfc.calibrate_rate_logsv_lm_on_device(pj, *args, nb_iters=2),
              tfc.calibrate_rate_logsv_lm_on_device(pt, *args, nb_iters=2, device="cpu"))
    pj, pt = start_pair()
    steps = dict(expiries=[EXPIRY], tenors=TENORS, forwards_expiries=[FWDS],
                 strikes_expiries=[STRIKES], market_ivols_expiries=[ivols], nb_iters=1)
    first = (jfc.calibrate_rate_logsv_term_structure(pj, **steps),
             tfc.calibrate_rate_logsv_term_structure(pt, **steps, device="cpu"))
    return first, second


def test_first_iterate_matches_through_one_bootstrap_step(slice_fits):
    (fit_j, fit_t), _ = slice_fits
    assert len(fit_t[1]) == 1
    assert_fits_match(fit_j, fit_t)


def test_second_iterate_matches(slice_fits):
    _, (fit_j, fit_t) = slice_fits
    assert_fits_match(fit_j, fit_t)


def test_slice_lm_reduces_the_cost_and_moves_segment_0_only(slice_fits):
    (_, (f1, c1)), (_, (f2, c2)) = slice_fits
    _, pt = start_pair()
    assert c2 <= c1[0] and np.isfinite(c2)
    assert not np.array_equal(f2.beta.xs[0], pt.beta.xs[0])
    np.testing.assert_array_equal(f2.beta.xs[1:], pt.beta.xs[1:])
    np.testing.assert_array_equal(f2.A, pt.A)
