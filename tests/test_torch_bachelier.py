"""Bachelier (normal) analytics of the PyTorch port against the JAX package.

The same numpy inputs (seeded) go through ``stochvolmodels_tpu.ops.bachelier``
and ``stochvolmodels_torch.ops.bachelier`` on the CPU in float64:

* prices, deltas, vegas (slice and chain panel), delta-to-strike and
  strikes-to-delta: 1e-12 relative;
* ``infer_normal_implied_vol`` (100-step bisection on [0.001, 0.1]): 1e-10
  on bracketed quotes, the same NaN pattern, and the same clamp at
  ``is_bounds_to_nan=False``; its gradient in the price (1/vega, 0 at NaN)
  against ``jax.grad``: 1e-10 relative;
* the fast implied normal vol and its ``jacfwd`` in (price, forward,
  strike, ttm) against JAX's ``jacfwd`` of its ``custom_jvp``: 1e-8;
* on a card (skipped here): the captured bisection equals its eager call
  bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import assert_same_nan_pattern, cuda_device  # noqa: F401

from stochvolmodels_tpu.ops import bachelier as jb
from stochvolmodels_torch.ops import bachelier as tb
from stochvolmodels_torch.ops import graphs

T = lambda a: torch.tensor(np.asarray(a, dtype=np.float64))


def inputs(n=64, seed=3):
    rng = np.random.default_rng(seed)
    forward = rng.uniform(0.5, 2.0, n)
    strike = forward * rng.uniform(0.8, 1.2, n)
    ttm = rng.uniform(0.05, 2.0, n)
    vol = rng.uniform(0.005, 0.09, n)
    types = np.where(rng.uniform(size=n) > 0.5, 'C', 'P')
    return forward, strike, ttm, vol, types


def assert_rel(a, b, rtol):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.max(np.abs(b)))


def test_prices_deltas_vegas_match():
    forward, strike, ttm, vol, types = inputs()
    for fn, kw in ((("compute_normal_price"), dict(forward=forward, strike=strike, ttm=ttm,
                                                    vol=vol, optiontype=types, discfactor=0.97)),
                   ("compute_normal_delta", dict(ttm=ttm, forward=forward, strike=strike, vol=vol,
                                                 optiontype=types, discfactor=0.97)),
                   ("compute_normal_slice_vegas", dict(ttm=ttm, forward=forward, strikes=strike,
                                                       vols=vol))):
        ref = getattr(jb, fn)(**kw)
        ours = getattr(tb, fn)(**{k: (v if k in ("optiontype",) else T(v)) for k, v in kw.items()})
        assert_rel(ours.numpy(), ref, 1e-12)


def test_slice_and_chain_panels_match():
    forward, strike, ttm, vol, types = inputs(n=12)
    ttms, forwards = ttm[:3], forward[:3]
    strikes = forwards[:, None] * np.linspace(0.9, 1.1, 4)[None, :]
    vols = vol[:12].reshape(3, 4)
    otypes = np.where(strikes > forwards[:, None], 'C', 'P')
    assert_rel(tb.compute_normal_vegas_ttms(T(ttms), T(forwards), T(strikes), T(vols)).numpy(),
               jb.compute_normal_vegas_ttms(ttms, forwards, strikes, vols), 1e-12)
    ours = tb.compute_normal_deltas_ttms(ttms, forwards, strikes, vols, otypes, device="cpu")
    for o, r in zip(ours, jb.compute_normal_deltas_ttms(ttms, forwards, strikes, vols, otypes)):
        assert_rel(o, r, 1e-12)
    prices = np.asarray(jb.compute_normal_price(forwards[:, None], strikes, ttms[:, None], vols,
                                                optiontype=otypes))
    ref = jb.infer_normal_ivols_from_chain_prices(ttms, forwards, np.ones(3), strikes, otypes,
                                                  prices)
    ours = tb.infer_normal_ivols_from_chain_prices(T(ttms), T(forwards), T(np.ones(3)),
                                                   T(strikes), otypes, T(prices))
    assert_same_nan_pattern(ours.numpy(), ref)
    assert_rel(np.nan_to_num(ours.numpy()), np.nan_to_num(np.asarray(ref)), 1e-10)


def test_delta_to_strike_and_strikes_to_delta_match():
    forward, strike, ttm, vol, _ = inputs()
    delta = np.random.default_rng(5).uniform(-0.95, 0.95, len(forward))
    assert_rel(tb.compute_normal_delta_to_strike(T(ttm), T(forward), T(delta), T(vol)).numpy(),
               jb.compute_normal_delta_to_strike(ttm, forward, delta, vol), 1e-12)
    assert_rel(tb.strikes_to_delta(T(strike), T(vol), T(forward), T(ttm)).numpy(),
               jb.strikes_to_delta(strike, vol, forward, ttm), 1e-12)


def quotes():
    """prices of quotes at vols in [0.005, 0.09], then two below the 0.001
    price (half the intrinsic value), two above the 0.1 price and a NaN."""
    forward, strike, ttm, vol, types = inputs()
    prices = np.array(jb.compute_normal_price(forward, strike, ttm, vol, optiontype=types))
    intrinsic = np.where(types == 'C', np.maximum(forward - strike, 0),
                         np.maximum(strike - forward, 0))
    prices[:2] = 0.5 * intrinsic[:2]
    prices[2:4] = prices[2:4] + 1.0
    prices[4] = np.nan
    return forward, strike, ttm, prices, types


@pytest.mark.parametrize("is_bounds_to_nan", [True, False])
def test_exact_implied_normal_vol_matches(is_bounds_to_nan):
    forward, strike, ttm, prices, types = quotes()
    ref = np.asarray(jb.infer_normal_implied_vol(forward, ttm, strike, prices, optiontype=types,
                                                 is_bounds_to_nan=is_bounds_to_nan))
    ours = tb.infer_normal_implied_vol(T(forward), T(ttm), T(strike), T(prices), optiontype=types,
                                       is_bounds_to_nan=is_bounds_to_nan).numpy()
    assert_same_nan_pattern(ours, ref)
    ok = ~np.isnan(ref)
    np.testing.assert_allclose(ours[ok], ref[ok], rtol=1e-10, atol=0.0)
    if not is_bounds_to_nan:
        np.testing.assert_array_equal(ours[:4], [0.001, 0.001, 0.1, 0.1])


def test_exact_implied_normal_vol_gradient_in_price_matches():
    forward, strike, ttm, prices, types = quotes()
    ref = np.asarray(jax.grad(lambda p: jnp.sum(jnp.nan_to_num(jb.infer_normal_implied_vol(
        forward, ttm, strike, p, optiontype=types))))(jnp.asarray(prices)))
    p = T(prices).requires_grad_(True)
    torch.nansum(tb.infer_normal_implied_vol(T(forward), T(ttm), T(strike), p,
                                             optiontype=types)).backward()
    ours = p.grad.numpy()
    assert np.all(ours[:5] == 0.0) and np.count_nonzero(ours) > 30
    np.testing.assert_allclose(ours, np.nan_to_num(ref), rtol=1e-10, atol=0.0)


def test_fast_implied_normal_vol_and_its_jacobian_match():
    forward, strike, ttm, prices, types = quotes()
    prices, forward, strike, ttm, types = (a[5:21] for a in (prices, forward, strike, ttm, types))
    ref = np.asarray(jb.infer_normal_implied_vol_fast(forward, ttm, strike, prices,
                                                      optiontype=types))
    ours = tb.infer_normal_implied_vol_fast(T(forward), T(ttm), T(strike), T(prices),
                                            optiontype=types).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-8, atol=0.0)

    def jfn(x):
        p, f, k, t = x
        return jb.infer_normal_implied_vol_fast(f, t, k, p, optiontype=types)

    def tfn(x):
        p, f, k, t = x.unbind()
        return tb.infer_normal_implied_vol_fast(f, t, k, p, optiontype=types)

    x = np.stack([prices, forward, strike, ttm])
    ref_jac = np.asarray(jax.jacfwd(jfn)(jnp.asarray(x)))
    our_jac = torch.func.jacfwd(tfn)(T(x)).numpy()
    assert np.all(np.isfinite(our_jac))
    np.testing.assert_allclose(our_jac, ref_jac, rtol=1e-8, atol=1e-8 * np.max(np.abs(ref_jac)))


@pytest.mark.gpu
def test_captured_normal_bisection_equals_eager_bit_for_bit(cuda_device):
    forward, strike, ttm, prices, types = quotes()
    args = [torch.as_tensor(a, device=cuda_device) for a in (forward, ttm, strike, prices)]
    captured = tb.infer_normal_implied_vol(*args, optiontype=types)
    with graphs.eager():
        eager = tb.infer_normal_implied_vol(*args, optiontype=types)
    assert torch.equal(torch.nan_to_num(captured), torch.nan_to_num(eager))
