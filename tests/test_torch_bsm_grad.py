"""The implied-vol gradients and the fast implied vol against the JAX package.

Both inversions are differentiable by the implicit function theorem: the
200-step bisection (``_implied_vol_core``, reverse mode) and the fast
bisection + Newton (``_fast_iv_core``, forward and reverse mode).  The same
numpy panel, made from a seed, holds bracketed quotes from deep in the money
to deep out of it, and quotes no vol in [0.01, 5] reaches: values agree to
1e-12 with the same NaN pattern, tangents and cotangents to 1e-9 relative.
Also: the LogSV ``precision='fast'`` ivols, the chain's vegas and ATM vols,
and the pricer's vol scaler.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, jvp, vjp

from _torch_port import assert_same_nan_pattern, btc_chains

import stochvolmodels_torch as svt
from stochvolmodels_torch.ops import bsm as tbsm
from stochvolmodels_tpu.models.logsv.pricer import LogSVPricer as JaxLogSVPricer
from stochvolmodels_tpu.models.logsv.params import LogSvParams as JaxLogSvParams
from stochvolmodels_tpu.ops import bsm as jbsm


def iv_panel(seed: int = 11, n: int = 96):
    """(price, forward, strike, ttm, discfactor, sgn) float64 numpy panels of
    out-of-the-money quotes: prices at vols in [0.05, 2.5], log-moneyness up
    to +-1.5 (deep OTM quotes of < 1e-6 x forward), and a tail of
    unbracketed quotes (negative, above the forward, NaN)."""
    rng = np.random.default_rng(seed)
    fwd = rng.uniform(0.5, 2.0, n)
    ttm = rng.uniform(0.02, 1.5, n)
    strike = fwd * np.exp(rng.uniform(-1.5, 1.5, n))
    vol = rng.uniform(0.05, 2.5, n)
    disc = rng.uniform(0.9, 1.0, n)
    # out-of-the-money quotes, as chains are quoted: the inversion of a deep
    # in-the-money price is ill-conditioned (vega / price ~ 0), and there an
    # ulp of price moves the vol by ~1e-8 in either package
    sgn = np.where(strike >= fwd, 1.0, -1.0)
    price = np.array(jbsm.compute_bsm_vanilla_price(
        forward=fwd, strike=strike, ttm=ttm, vol=vol,
        optiontype=np.where(sgn > 0, "C", "P"), discfactor=disc))
    price[-6:-4] = -0.01 * fwd[-6:-4]                # below any vol's price
    price[-4:-2] = 2.0 * fwd[-4:-2]                  # above any vol's price
    price[-2] = np.nan
    return price, fwd, strike, ttm, disc, sgn


def tangent_set(seed: int = 12, n: int = 96):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=n) for _ in range(5))


def jax_args(panel):
    return tuple(jnp.asarray(a) for a in panel)


def torch_args(panel):
    return tuple(torch.as_tensor(a) for a in panel)


def jax_fast(*a):
    return jbsm._fast_iv_core(*a, 24, 4)


def torch_fast(*a):
    return tbsm._FastIVCore.apply(*a, 24, 4)


def assert_rel(out, ref, rtol):
    out, ref = np.asarray(out), np.asarray(ref)
    assert_same_nan_pattern(out, ref)
    ok = ~np.isnan(ref)
    scale = np.maximum(np.abs(ref[ok]), 1e-300)
    rel = np.abs(out[ok] - ref[ok]) / scale
    assert rel.max() <= rtol, (rel.max(), np.argmax(rel))


@pytest.fixture(scope="module")
def panel():
    return iv_panel()


def test_panel_has_deep_otm_and_unbracketed_quotes(panel):
    price, fwd = panel[0], panel[1]
    vols = np.asarray(jbsm._fast_iv_core(*jax_args(panel), 24, 4))
    assert np.sum(np.isnan(vols)) >= 5
    assert np.nanmin(price / fwd) < 1e-6


@pytest.mark.parametrize("which", ["fast", "bisection"])
def test_values_match_jax(panel, which):
    if which == "fast":
        ref = jax_fast(*jax_args(panel))
        out = torch_fast(*torch_args(panel))
    else:
        ref = jbsm._implied_vol_core(*jax_args(panel))
        out = tbsm._ImpliedVolCore.apply(*torch_args(panel))
    out, ref = out.numpy(), np.asarray(ref)
    assert_same_nan_pattern(out, ref)
    ok = ~np.isnan(ref)
    np.testing.assert_allclose(out[ok], ref[ok], rtol=0.0, atol=1e-12)


def test_fast_core_jvp_matches_jax(panel):
    tangents = tangent_set()
    _, ref = jax.jvp(lambda *a: jax_fast(*a, jnp.asarray(panel[5])),
                     jax_args(panel[:5]), tuple(jnp.asarray(t) for t in tangents))
    _, out = jvp(lambda *a: torch_fast(*a, torch.as_tensor(panel[5])),
                 torch_args(panel[:5]), tuple(torch.as_tensor(t) for t in tangents))
    assert_rel(out.numpy(), ref, 1e-9)
    # NaN vols carry a zero tangent on both sides
    assert np.all(np.asarray(ref)[np.isnan(np.asarray(jax_fast(*jax_args(panel))))] == 0.0)


@pytest.mark.parametrize("which", ["fast", "bisection"])
def test_core_vjp_matches_jax(panel, which):
    cot = np.random.default_rng(13).normal(size=panel[0].shape)
    if which == "fast":
        jfn = lambda *a: jax_fast(*a, jnp.asarray(panel[5]))
        tfn = lambda *a: torch_fast(*a, torch.as_tensor(panel[5]))
    else:
        jfn = lambda *a: jbsm._implied_vol_core(*a, jnp.asarray(panel[5]))
        tfn = lambda *a: tbsm._ImpliedVolCore.apply(*a, torch.as_tensor(panel[5]))
    _, pull = jax.vjp(jfn, *jax_args(panel[:5]))
    refs = pull(jnp.asarray(cot))
    inputs = [t.requires_grad_(True) for t in torch_args(panel[:5])]
    outs = torch.autograd.grad(tfn(*inputs), inputs, grad_outputs=torch.as_tensor(cot))
    for out, ref in zip(outs, refs):
        ref = np.asarray(ref)
        np.testing.assert_array_equal(np.isnan(out.numpy()), np.isnan(ref))
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-9, atol=1e-9 * np.max(np.abs(ref)))
    if which == "fast":    # torch.func's vjp goes through the same backward
        _, pull_t = vjp(tfn, *torch_args(panel[:5]))
        np.testing.assert_array_equal(pull_t(torch.as_tensor(cot))[0].numpy(), outs[0].numpy())


def test_fast_core_jvp_matches_central_difference(panel):
    """d vol / d input against (vol(x + h) - vol(x - h)) / 2h, h = 1e-5 |x|,
    on quotes whose vol is inside (0.02, 4.5) and whose vega is not tiny."""
    args = torch_args(panel)
    vol = torch_fast(*args).numpy()
    vega = np.asarray(tbsm._price_partials(args[1], args[2], args[3], args[4],
                                           torch.as_tensor(np.nan_to_num(vol, nan=1.0)),
                                           args[5])[4])
    ok = (vol > 0.02) & (vol < 4.5) & (vega > 1e-3 * panel[1])
    assert ok.sum() > 40
    for k in range(5):
        x = panel[k]
        h = 1e-5 * np.abs(x)
        dx = np.zeros((5,) + x.shape)
        dx[k] = 1.0
        _, tangent = jvp(lambda *a: torch_fast(*a, args[5]), args[:5],
                         tuple(torch.as_tensor(d) for d in dx))
        up = [a.copy() for a in panel]
        down = [a.copy() for a in panel]
        up[k], down[k] = x + h, x - h
        fd = (torch_fast(*torch_args(up)).numpy() - torch_fast(*torch_args(down)).numpy()) / (2 * h)
        t = tangent.numpy()
        np.testing.assert_allclose(t[ok], fd[ok], rtol=1e-5, atol=1e-5 * np.max(np.abs(fd[ok])))


def test_jacfwd_and_vmap_go_through_the_fast_core(panel):
    args = torch_args(panel)
    small = tuple(a[:8] for a in args)
    J = jacfwd(lambda p: torch_fast(p, *small[1:]))(small[0])
    _, tangent = jvp(lambda p: torch_fast(p, *small[1:]), (small[0],), (torch.ones(8),))
    np.testing.assert_array_equal(J.sum(1).numpy(), tangent.numpy())
    assert np.count_nonzero(J.numpy() - np.diag(np.diag(J.numpy()))) == 0
    batched = torch.func.vmap(lambda p: torch_fast(p, *small[1:]))(torch.stack([small[0]] * 3))
    np.testing.assert_array_equal(batched[1].numpy(), torch_fast(*small).numpy())


def test_bisection_core_refuses_torch_func_transforms(panel):
    args = torch_args(panel)
    with pytest.raises(RuntimeError):
        jacfwd(lambda p: tbsm._ImpliedVolCore.apply(p, *args[1:]))(args[0])


def test_public_fast_iv_broadcasts_like_jax():
    fwd, ttm = np.array([1.0, 1.2]), np.array([0.1, 0.5])
    strikes = np.array([[0.8, 1.0, 1.3], [0.9, 1.2, 1.6]])
    types = np.array([["P", "C", "C"], ["P", "P", "C"]])
    prices = np.asarray(jbsm.compute_bsm_vanilla_price(fwd[:, None], strikes, ttm[:, None], 0.7,
                                                       types))
    ref = np.asarray(jbsm.infer_bsm_implied_vol_fast(fwd[:, None], ttm[:, None], strikes, prices,
                                                     optiontype=types))
    out = svt.infer_bsm_implied_vol_fast(torch.as_tensor(fwd)[:, None], torch.as_tensor(ttm)[:, None],
                                         torch.as_tensor(strikes), torch.as_tensor(prices),
                                         optiontype=types).numpy()
    np.testing.assert_allclose(out, ref, rtol=0.0, atol=1e-12)
    np.testing.assert_allclose(out, 0.7, atol=1e-12)


@pytest.mark.parametrize("params", [dict(sigma0=0.8376, theta=1.0413, kappa1=3.1844, kappa2=3.058,
                                         beta=0.1514, volvol=1.8458),
                                    dict(sigma0=0.88, theta=1.0, kappa1=2.21, kappa2=2.18,
                                         beta=0.15, volvol=1.85)])
def test_fast_precision_ivols_match_jax_fast(params):
    """the port's 'fast' ivols (float64 RK4 at 360 steps/yr, the fast IV)
    against the JAX package's (float32 RK4, float64 quadrature, the fast
    IV): within its ~1e-5 floor, with the same NaN pattern; and against the
    port's exact ivols."""
    cj, ct = btc_chains()
    ref = JaxLogSVPricer().compute_model_ivols_for_chain(cj, JaxLogSvParams(**params),
                                                         precision="fast")
    pricer = svt.LogSVPricer(device="cpu")
    out = pricer.compute_model_ivols_for_chain(ct, svt.LogSvParams(**params), precision="fast")
    exact = pricer.compute_model_ivols_for_chain(ct, svt.LogSvParams(**params))
    for o, r, e in zip(out, ref, exact):
        assert_same_nan_pattern(o, r)
        ok = ~np.isnan(np.asarray(r))
        np.testing.assert_allclose(o[ok], np.asarray(r)[ok], rtol=0.0, atol=1e-5)
        np.testing.assert_allclose(o, e, rtol=0.0, atol=1e-5)


def test_chain_vegas_atm_vols_and_vol_scaler_match_jax():
    cj, ct = btc_chains()
    for unit in (False, True):
        for o, r in zip(ct.get_chain_vegas(is_unit_ttm_vega=unit),
                        cj.get_chain_vegas(is_unit_ttm_vega=unit)):
            assert isinstance(o, np.ndarray)
            np.testing.assert_allclose(o, np.asarray(r), rtol=1e-14, atol=0.0)
    np.testing.assert_allclose(ct.get_chain_atm_vols(), cj.get_chain_atm_vols(), rtol=1e-14)
    for o, r in zip(ct.get_mid_vols(), cj.get_mid_vols()):
        np.testing.assert_array_equal(o, r)
    scaler = svt.LogSVPricer(device="cpu").set_vol_scaler(ct)
    np.testing.assert_allclose(scaler, JaxLogSVPricer().set_vol_scaler(cj), rtol=1e-14)
