"""Heston pricing of the PyTorch port against the JAX package.

* the closed-form log-MGF and the chained Riccati state (a, b) on the
  complex128 transform grid against ``compute_heston_mgf_grid`` on
  (re, im) pairs: elementwise |diff| <= 1e-12 |ref| (measured 8.5e-13, over
  three chained slices);
* BTC-chain prices within 1e-10 x forward (measured 7.1e-16) and implied
  vols within 1e-8 (measured 2.1e-14) with the same NaN pattern, for
  ``BTC_HESTON_PARAMS`` and the parameters of ``tests/test_heston.py``;
* put-call parity, and slices priced alone equal to the chained chain;
* the float64 ``'scan'`` engine's moments against the JAX scan (different
  random streams) within the tolerances of ``tests/test_pallas_mc.py``;
* ``engine='cuda'`` on the CPU (the kernel's plain version) against the JAX
  ``engine='pallas'`` (the Pallas kernel in interpret mode): both draw the
  same counter-hash stream, so they differ by float32 rounding only.  On
  the BTC chain's first three slices at 2^14 paths the largest gap is
  2.1e-6 standard errors and the stderrs agree to 6.8e-8 relative; the
  limits are 1e-5 standard errors and 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import assert_same_nan_pattern, btc_chains

import stochvolmodels_tpu as svj
import stochvolmodels_torch as svt
from stochvolmodels_tpu.models import heston as jh
from stochvolmodels_tpu.utils.cplx import Cplx

PARAM_SETS = {
    "btc": dict(v0=0.8, theta=1.0, kappa=2.0, rho=0.0, volvol=2.0),
    "test_heston": dict(v0=0.85 ** 2, theta=1.4 ** 2, kappa=3.0, volvol=2.0, rho=0.3),
}


def heston_pair(**kw):
    pj = jh.HestonParams(**kw)
    return pj, svt.heston_params_from_numpy(pj.to_dict())


def first_slices(chain, n):
    """the first ``n`` maturities of a port chain."""
    return svt.OptionChain(ttms=chain.ttms[:n], forwards=chain.forwards[:n],
                           strikes_ttms=chain.strikes_ttms[:n],
                           optiontypes_ttms=chain.optiontypes_ttms[:n],
                           discfactors=chain.discfactors[:n])


@pytest.mark.parametrize("name", sorted(PARAM_SETS))
def test_mgf_grid_and_chained_riccati_state_match(name):
    p = PARAM_SETS[name]
    phi = svt.get_phi_grid(device="cpu", vol_scaler=0.25)
    psi = torch.zeros_like(phi)
    to_cplx = lambda z: Cplx(jnp.asarray(z.real.numpy()), jnp.asarray(z.imag.numpy()))
    out, ref = [], []
    a_t = b_t = None
    aj = bj = None
    for dttm in (0.05, 0.15, 0.25):
        mgf_t, a_t, b_t = svt.compute_heston_mgf_grid(ttm=dttm, phi_grid=phi, psi_grid=psi,
                                                      a_t0=a_t, b_t0=b_t, **p)
        mgf_j, aj, bj = jh.compute_heston_mgf_grid(ttm=dttm, phi_grid=to_cplx(phi),
                                                   psi_grid=to_cplx(psi), a_t0=aj, b_t0=bj, **p)
        out += [mgf_t, a_t, b_t]
        ref += [mgf_j, aj, bj]
    for t, j in zip(out, ref):
        j = np.asarray(j.re) + 1j * np.asarray(j.im)
        assert np.all(np.abs(t.numpy() - j) <= 1e-12 * np.abs(j))


@pytest.mark.parametrize("name", sorted(PARAM_SETS))
def test_btc_chain_prices_and_ivols_match(name):
    cj, ct = btc_chains()
    pj, pt = heston_pair(**PARAM_SETS[name])
    prices_j = jh.HestonPricer().price_chain(cj, pj)
    prices_t = svt.HestonPricer(device="cpu").price_chain(ct, pt)
    for a, b, fwd in zip(prices_t, prices_j, cj.forwards):
        assert np.max(np.abs(a - np.asarray(b))) <= 1e-10 * fwd
    ivols_j = jh.HestonPricer().compute_model_ivols_for_chain(cj, pj)
    ivols_t = svt.HestonPricer(device="cpu").compute_model_ivols_for_chain(ct, pt)
    for a, b in zip(ivols_t, ivols_j):
        b = np.asarray(b)
        assert_same_nan_pattern(a, b)
        np.testing.assert_allclose(a, b, rtol=0.0, atol=1e-8)
        assert np.all((a > 0.3) & (a < 2.5))


@pytest.mark.parametrize("name", sorted(PARAM_SETS))
def test_fast_precision_and_vol_scaler(name):
    _, ct = btc_chains()
    _, pt = heston_pair(**PARAM_SETS[name])
    pricer = svt.HestonPricer(device="cpu")
    exact = pricer.price_chain(ct, pt)
    fast = pricer.price_chain(ct, pt, precision="fast")
    scaled = pricer.price_chain(ct, pt, vol_scaler=svt.models.heston.default_vol_scaler(
        pt.v0, ct.ttms[0]))
    for e, f, s in zip(exact, fast, scaled):
        np.testing.assert_array_equal(e, f)
        np.testing.assert_array_equal(e, s)
    with pytest.raises(NotImplementedError):
        pricer.price_chain(ct, pt, precision="bogus")


def test_put_call_parity():
    strikes = np.linspace(40000.0, 100000.0, 13)
    f, ttm, df = 67000.0, 0.25, 0.98
    _, pt = heston_pair(**PARAM_SETS["test_heston"])
    pricer = svt.HestonPricer(device="cpu")
    chain = lambda t: svt.OptionChain.slice_to_chain(ttm=ttm, forward=f, strikes=strikes,
                                                     optiontypes=np.full(13, t), discfactor=df)
    calls = pricer.price_chain(chain("C"), pt)[0]
    puts = pricer.price_chain(chain("P"), pt)[0]
    np.testing.assert_allclose(calls - puts, df * (f - strikes), rtol=1e-9, atol=1e-6 * f)


def test_slices_priced_alone_equal_the_chained_chain():
    _, ct = btc_chains()
    _, pt = heston_pair(**PARAM_SETS["test_heston"])
    pricer = svt.HestonPricer(device="cpu")
    full = pricer.price_chain(ct, pt)
    vol_scaler = svt.models.heston.default_vol_scaler(pt.v0, ct.ttms[0])
    for i in range(len(ct.ttms)):
        single = svt.OptionChain.slice_to_chain(
            ttm=ct.ttms[i], forward=ct.forwards[i], strikes=ct.strikes_ttms[i],
            optiontypes=ct.optiontypes_ttms[i], discfactor=ct.discfactors[i])
        alone = pricer.price_chain(single, pt, vol_scaler=vol_scaler)[0]
        np.testing.assert_allclose(full[i], alone, rtol=1e-9, atol=1e-9)


def test_scan_engine_moments_match_jax_scan():
    n = 1 << 15
    p = dict(theta=0.04, kappa=4.0, rho=-0.5, volvol=0.4)
    xt, vt, qt = (t.numpy() for t in svt.simulate_heston_terminal(
        gen=torch.Generator().manual_seed(3), x0=torch.zeros(n, dtype=torch.float64),
        var0=torch.full((n,), 0.04, dtype=torch.float64),
        qvar0=torch.zeros(n, dtype=torch.float64), ttm=1.0, **p))
    xj, vj, qj = map(np.asarray, jh.simulate_heston_terminal(
        key=jax.random.key(3), x0=jnp.zeros(n), var0=jnp.full(n, 0.04), qvar0=jnp.zeros(n),
        ttm=1.0, **p))
    tol = 0.005
    for x, v, q in ((xt, vt, qt), (xj, vj, qj)):
        assert np.all(np.isfinite(x))
        assert abs(v.mean() - 0.04) < tol
        assert abs(np.exp(x).mean() - 1.0) < 4.0 * tol
        assert abs(q.mean() - 0.04) < tol
    assert abs(vt.mean() - vj.mean()) < tol
    assert abs(qt.mean() - qj.mean()) < tol
    assert abs(np.exp(xt).mean() - np.exp(xj).mean()) < 4.0 * tol


def test_simulate_terminal_values_moments():
    params = svt.HestonParams(v0=0.04, theta=0.04, kappa=4.0, rho=-0.5, volvol=0.4)
    x, var, qvar = svt.HestonPricer(device="cpu").simulate_terminal_values(params=params, ttm=1.0,
                                                               nb_path=1 << 16, seed=3)
    assert x.dtype == np.float64 and x.shape == (1 << 16,)
    assert abs(np.mean(var) - params.theta) < 0.002
    assert abs(np.mean(np.exp(x)) - 1.0) < 0.01
    assert abs(np.mean(qvar) - params.theta) < 0.002


def test_cuda_engine_on_cpu_matches_pallas_interpret():
    cj, ct = btc_chains()
    pj, pt = heston_pair(**PARAM_SETS["btc"])
    n = 3
    kw = dict(nb_path=1 << 14, seed=24, engine="pallas")
    ref, ref_std = jh.heston_mc_chain_pricer(
        ttms=cj.ttms[:n], forwards=cj.forwards[:n], discfactors=cj.discfactors[:n],
        strikes_ttms=cj.strikes_ttms[:n], optiontypes_ttms=cj.optiontypes_ttms[:n],
        v0=pj.v0, theta=pj.theta, kappa=pj.kappa, rho=pj.rho, volvol=pj.volvol, **kw)
    out, out_std = svt.HestonPricer(device="cpu").model_mc_price_chain(
        first_slices(ct, n), pt, **dict(kw, engine="cuda"))
    for a, b, s, st in zip(out, ref, ref_std, out_std):
        assert np.all(np.abs(a - np.asarray(b)) <= 1e-5 * np.asarray(s))
        np.testing.assert_allclose(st, np.asarray(s), rtol=1e-6)


def test_pallas_is_an_alias_of_cuda():
    _, ct = btc_chains()
    _, pt = heston_pair(**PARAM_SETS["btc"])
    kw = dict(nb_path=1000, seed=3)
    a, _ = svt.HestonPricer(device="cpu").model_mc_price_chain(ct, pt, engine="cuda", **kw)
    b, _ = svt.HestonPricer(device="cpu").model_mc_price_chain(ct, pt, engine="pallas", **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("engine,nb_path", [("scan", 1 << 15), ("cuda", 1 << 16)])
def test_mc_engines_match_analytic_prices(engine, nb_path):
    """the rule of ``tests/test_heston.py``: 4 stderr + 0.5% of the price
    (the largest gap is 0.31 of that band for 'scan', 0.46 for 'cuda')."""
    _, ct = btc_chains()
    _, pt = heston_pair(**PARAM_SETS["btc"])
    pricer = svt.HestonPricer(device="cpu")
    analytic = pricer.price_chain(ct, pt)
    mc, std = pricer.model_mc_price_chain(ct, pt, engine=engine, nb_path=nb_path, seed=7)
    for a, m, s in zip(analytic, mc, std):
        assert np.all(np.isfinite(m)) and np.all(s > 0.0)
        assert np.all(np.abs(a - m) < 4.0 * s + 5e-3 * a)


def test_mc_chain_implied_vol_bands():
    _, ct = btc_chains()
    _, pt = heston_pair(**PARAM_SETS["btc"])
    pricer = svt.HestonPricer(device="cpu")
    prices, ups, downs, iv_mid, iv_up, iv_down, _ = pricer.compute_mc_chain_implied_vols(
        ct, pt, engine="cuda", nb_path=1 << 13, seed=24)
    for p, u, d, im, iu, idn in zip(prices, ups, downs, iv_mid, iv_up, iv_down):
        assert np.all(u >= p) and np.all(d <= p)
        live = ~np.isnan(idn)
        assert np.all(iu >= im) and np.all(im[live] >= idn[live])


def test_params_from_to_dict_and_to_array():
    pj = jh.HestonParams(v0=0.7, theta=0.9, kappa=2.5, rho=-0.2, volvol=1.1)
    a = svt.heston_params_from_numpy(pj.to_dict())
    b = svt.heston_params_from_numpy(pj.to_array())
    assert a == b == svt.HestonParams(v0=0.7, theta=0.9, kappa=2.5, rho=-0.2, volvol=1.1)
    np.testing.assert_array_equal(a.to_array(), pj.to_array())
    assert svt.BTC_HESTON_PARAMS == svt.heston_params_from_numpy(jh.BTC_HESTON_PARAMS.to_dict())
    assert svj.HestonPricer is jh.HestonPricer


def test_unported_options_raise():
    """the refusals of the JAX package's Heston MC: an unknown engine, and
    antithetic draws off the 'scan' engine (the kernel draws its own
    normals; Sobol points are stratified already)."""
    _, ct = btc_chains()
    _, pt = heston_pair(**PARAM_SETS["btc"])
    pricer = svt.HestonPricer(device="cpu")
    with pytest.raises(NotImplementedError):
        pricer.model_mc_price_chain(ct, pt, engine="mlmc", nb_path=256)
    with pytest.raises(NotImplementedError):
        pricer.model_mc_price_chain(ct, pt, nb_path=256, antithetic=True, engine="cuda")
    with pytest.raises(NotImplementedError):
        pricer.model_mc_price_chain(ct, pt, nb_path=256, antithetic=True, engine="qmc")
    with pytest.raises(NotImplementedError):
        pricer.price_chain(ct, pt, variable_type=svt.VariableType.SIGMA)
