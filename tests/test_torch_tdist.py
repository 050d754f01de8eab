"""Student-t analytics of the PyTorch port against the JAX package.

* ``betainc`` (the port's continued fraction at a fixed term count) against
  ``scipy.special.betainc`` and the JAX package's ``betainc`` on a grid of a
  in [1.005, 10], b in {0.5, 1, 2.5}, x in (0, 1) with 1e-12 and 1 - 1e-12:
  1e-12 absolute (measured 2.6e-15 against scipy, 3.1e-14 against JAX,
  whose own gap to scipy is 3.2e-14);
* its forward-mode tangent and its reverse-mode gradient in (a, b, x)
  against JAX's ``jvp`` of its ``custom_jvp`` (the analytic x-derivative,
  central differences with eps = 1e-6 in a and b): 1e-7, the x-part where
  a < 8 (beyond, JAX's ``betaln`` is off by up to 1.3e-6, so the x-part is
  held to the analytic derivative with scipy's ``betaln`` to 1e-12);
* pdf, cdf and partial expectation: 1e-12; ``imply_drift_tdist``: 1e-12;
  prices: 1e-10 relative; ``infer_implied_vol_tdist``: 1e-9, with the
  reference's clamp of an unbracketed quote;
* the calibration loss's gradient: tests/test_torch_terminal_objectives.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch
import _torch_port  # noqa: F401

from stochvolmodels_tpu.ops import tdist as jtd
from stochvolmodels_torch.ops import tdist as ttd

T = lambda a: torch.tensor(np.asarray(a, dtype=np.float64))


def beta_grid():
    a = np.linspace(1.005, 10.0, 25)
    b = np.array([0.5, 1.0, 2.5])
    x = np.concatenate([np.linspace(1e-6, 1.0 - 1e-6, 97), [1e-12, 1.0 - 1e-12, 0.5]])
    return (g.ravel() for g in np.meshgrid(a, b, x, indexing="ij"))


def test_betainc_matches_scipy_and_jax():
    a, b, x = beta_grid()
    ours = ttd.betainc(T(a), T(b), T(x)).numpy()
    np.testing.assert_allclose(ours, scipy.special.betainc(a, b, x), rtol=0.0, atol=1e-12)
    np.testing.assert_allclose(ours, np.asarray(jtd.betainc(a, b, x)), rtol=0.0, atol=1e-12)


def test_betainc_edges():
    ours = ttd.betainc(T([2.0, 2.0, 2.0, 2.0]), T([0.5] * 4), T([0.0, 1.0, -0.1, np.nan])).numpy()
    np.testing.assert_array_equal(ours[:2], [0.0, 1.0])
    assert np.all(np.isnan(ours[2:]))


def test_betainc_tangent_and_gradient_match_the_jax_jvp():
    """the tangent in (a, b, x) and the gradient of sum(I) in each argument
    against JAX's jvp: the a- and b-parts everywhere, the x-part where a <
    8.  From a = 8 on, the JAX package's ``betaln`` (``jax.scipy.special``)
    is off by up to 1.3e-6 (scipy's ``betaln`` as the truth; below 8 it
    agrees to 1e-14), and so is its x-derivative: there the x-part is held
    to the analytic derivative with scipy's ``betaln``."""
    a, b, x = (v[::7] for v in beta_grid())
    x = np.clip(x, 1e-6, 1.0 - 1e-6)
    exact_jax = a < 8.0
    assert 0 < np.sum(exact_jax) < len(a)
    args = (jnp.asarray(a), jnp.asarray(b), jnp.asarray(x))
    rng = np.random.default_rng(11)
    da, db, dx = rng.normal(size=(3, len(a)))
    dx = np.where(exact_jax, dx, 0.0)
    _, ref = jax.jvp(jtd.betainc, args, (jnp.asarray(da), jnp.asarray(db), jnp.asarray(dx)))
    _, ours = torch.func.jvp(ttd.betainc, (T(a), T(b), T(x)), (T(da), T(db), T(dx)))
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-7, atol=1e-7 * np.max(np.abs(ref)))
    ta, tb, tx = (T(v).requires_grad_(True) for v in (a, b, x))
    ttd.betainc(ta, tb, tx).sum().backward()
    for tensor, unit in ((ta, 0), (tb, 1), (tx, 2)):
        tangents = [jnp.zeros_like(args[0])] * 3
        tangents[unit] = jnp.ones_like(args[0])
        ref = np.asarray(jax.jvp(jtd.betainc, args, tuple(tangents))[1])
        ours = tensor.grad.numpy()
        if unit == 2:
            exact = np.exp((a - 1.0) * np.log(x) + (b - 1.0) * np.log1p(-x)
                           - scipy.special.betaln(a, b))
            np.testing.assert_allclose(ours, exact, rtol=1e-12)
            ours, ref = ours[exact_jax], ref[exact_jax]
        np.testing.assert_allclose(ours, ref, rtol=1e-7, atol=1e-7 * np.max(np.abs(ref)))


def distribution_inputs(n=40, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.8, 0.8, n), rng.uniform(-0.2, 0.2, n), rng.uniform(0.2, 1.5, n),
            rng.uniform(2.02, 19.0, n), rng.uniform(0.02, 1.5, n))


@pytest.mark.parametrize("name", ["pdf_tdist", "cdf_tdist", "cum_mean_tdist"])
def test_distribution_functions_match(name):
    x, mu, vol, nu, ttm = distribution_inputs()
    ref = np.asarray(getattr(jtd, name)(x, mu, vol, nu, ttm))
    ours = getattr(ttd, name)(T(x), T(mu), T(vol), T(nu), T(ttm)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0.0, atol=1e-12 * max(1.0, np.max(np.abs(ref))))


def test_implied_drift_forward_and_default_probability_match():
    _, _, vol, nu, ttm = distribution_inputs(n=16)
    ref = np.asarray(jtd.imply_drift_tdist(0.02, vol, nu, ttm))
    ours = ttd.imply_drift_tdist(0.02, T(vol), T(nu), T(ttm)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0.0, atol=1e-12)
    np.testing.assert_allclose(ttd.compute_forward_tdist(1.0, T(ttm), T(vol), T(nu), 0.02).numpy(),
                               np.asarray(jtd.compute_forward_tdist(1.0, ttm, vol, nu, 0.02)),
                               rtol=1e-12)
    np.testing.assert_allclose(ttd.compute_default_prob_tdist(T(ttm), T(vol), T(nu)).numpy(),
                               np.asarray(jtd.compute_default_prob_tdist(ttm, vol, nu)),
                               rtol=0.0, atol=1e-12)


def slice_quotes():
    strikes = np.linspace(0.5, 1.6, 12)
    return strikes, np.where(strikes > 1.0, 'C', 'P')


@pytest.mark.parametrize("implied", [True, False])
def test_prices_match(implied):
    strikes, types = slice_quotes()
    ref = np.asarray(jtd.compute_vanilla_price_tdist(1.0, strikes, 0.25, 0.8, 4.5, types, 0.01,
                                                     is_compute_risk_neutral_mu=implied))
    ours = ttd.compute_vanilla_price_tdist(1.0, T(strikes), 0.25, 0.8, 4.5, types, 0.01,
                                           is_compute_risk_neutral_mu=implied).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-10)


def test_implied_vol_round_trip_matches():
    strikes, types = slice_quotes()
    prices = np.array(jtd.compute_vanilla_price_tdist(1.0, strikes, 0.25, 0.8, 4.5, types))
    # above the price at vol 10: unbracketed with f(0.05) < 0, which the
    # reference's clamp maps to the lower bound, 0.05
    prices[-1] = 10.0
    ref = np.asarray(jtd.infer_implied_vol_tdist(1.0, 0.25, strikes, prices, optiontype=types,
                                                 nu=4.5))
    ours = ttd.infer_implied_vol_tdist(1.0, 0.25, T(strikes), T(prices), optiontype=types,
                                       nu=4.5).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0.0, atol=1e-9)
    np.testing.assert_allclose(ours[:-1], 0.8, atol=1e-9)
    assert ours[-1] == 0.05
