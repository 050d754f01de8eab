"""The swaption-cube LM with the factor-vol levels A free (``fit_A=True``,
through the traced cube) of the PyTorch port against the JAX package
(``engine='f64'``), on the CPU in float64: four slices x five strikes of
``tests/test_qa_traced.py``'s fixture at 24 RK4 steps/yr, the market normal
vols those of the traced cube at the fixture's parameters, the start point
beta x 0.8, volvol x 1.2 and A x 1.03, segment 0 free (seven parameters for
twenty quotes):

* the residuals and their Jacobian at the start point: 1e-10 relative;
* the LM paths part by rounding (ROADMAP section 3: the A columns make the
  damped normal system ill-conditioned, and the two packages' CG solves
  take the 1e-14 gaps of the Jacobian to 6e-5 relative in the first
  iterate), so after two iterations the costs are held instead: each below
  5% of the start cost and within 1e-3 of each other, and the port's cost
  at the JAX package's fitted point equals the JAX package's, 1e-10
  relative.
"""
import jax
import numpy as np
import pytest
from test_torch_rates_calibration import (
    YEAR_STEPS,
    assert_residuals_and_jacobian_match,
    market_ivols,
    start_pair,
)
from test_torch_rates_core import as_numpy_dict
from test_torch_rates_traced import FWDS, SLICES, STRIKES

from stochvolmodels_tpu.models.factor_hjm import fast_calibration as jfc
from stochvolmodels_torch import interop
from stochvolmodels_torch.models.factor_hjm import fast_calibration as tfc

CUBE = (SLICES, FWDS, STRIKES)
A_SCALE = 1.03


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    import gc
    jax.clear_caches()
    gc.collect()


def test_residuals_and_jacobian_at_the_start_match(monkeypatch):
    assert_residuals_and_jacobian_match(True, A_SCALE, monkeypatch, CUBE)


def port_cost(params, ivols, nb_iters):
    return tfc.calibrate_rate_logsv_cube_lm_on_device(
        params, *CUBE, ivols, segments=[0], nb_iters=nb_iters, year_steps=YEAR_STEPS,
        fit_A=True, device="cpu")


def test_two_iterations_reach_the_same_cost():
    ivols = market_ivols(CUBE)
    pj, pt = start_pair(A_SCALE)
    _, cost0 = port_cost(pt, ivols, 0)
    fj, cost_j = jfc.calibrate_rate_logsv_cube_lm_on_device(
        pj, *CUBE, ivols, segments=[0], nb_iters=2, year_steps=YEAR_STEPS, fit_A=True,
        engine="f64")
    ft, cost_t = port_cost(pt, ivols, 2)
    assert max(cost_j, cost_t) < 0.05 * cost0
    assert abs(cost_t - cost_j) <= 1e-3 * cost_j
    # only segment 0 moved, A included
    assert not np.array_equal(ft.A[0], pt.A[0])
    np.testing.assert_array_equal(ft.A[1:], pt.A[1:])
    # the port's cost function at the JAX package's fitted point
    _, cost_at_j = port_cost(interop.rate_params_from_numpy(as_numpy_dict(fj)), ivols, 0)
    assert abs(cost_at_j - cost_j) <= 1e-10 * cost_j
