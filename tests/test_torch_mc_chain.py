"""LogSV Monte-Carlo chain pricing of the PyTorch port.

* ``engine='cuda'`` on the CPU (the kernel's plain version) against the JAX
  package's ``engine='pallas'`` on the CPU (the Pallas kernel in interpret
  mode): the same seed draws the same random stream, so the prices agree to
  a small fraction of their standard error (limit 0.25 stderr; measured
  <= 0.014, the gap being the TPU kernel's approximate reciprocal);
* the port's ``'scan'`` and ``'cuda'`` engines against the port's analytic
  prices, within 4 sqrt(2) stderr + 5e-3, the rule of
  ``tests/test_pallas_mc.py``.  The terminal spot at the BTC parameters is
  heavy-tailed (volvol 1.85), so the sample stderr of one seed can
  understate the error: at 2^15 paths the counter-hash stream of seed 11
  lands 1.5x outside that band at the 3m slice (its mean S/F is 0.986),
  while 2^17 paths stay inside for seeds 11-15 and 24.  The float32
  ``'cuda'`` engine runs at 2^17 paths.
"""
import numpy as np
import pytest
import torch
from _torch_port import btc_chains, param_pair

import stochvolmodels_tpu as svj
import stochvolmodels_torch as svt

BTC_PARAMS = dict(sigma0=0.8376, theta=1.0413, kappa1=3.1844, kappa2=3.058,
                  beta=0.1514, volvol=1.8458)


def test_cuda_engine_on_cpu_matches_pallas_interpret():
    cj, ct = btc_chains()
    pj, pt = param_pair(**BTC_PARAMS)
    kw = dict(nb_path=1 << 15, nb_steps=60, seed=24)
    ref, ref_std = svj.LogSVPricer().model_mc_price_chain(cj, pj, engine="pallas", **kw)
    out, out_std = svt.LogSVPricer(device="cpu").model_mc_price_chain(ct, pt, engine="cuda", **kw)
    for a, b, s, st in zip(out, ref, ref_std, out_std):
        assert np.all(np.abs(a - np.asarray(b)) <= 0.25 * np.asarray(s))
        np.testing.assert_allclose(st, np.asarray(s), rtol=0.01)


def test_pallas_is_an_alias_of_cuda():
    _, ct = btc_chains()
    _, pt = param_pair(**BTC_PARAMS)
    kw = dict(nb_path=1 << 10, nb_steps=30, seed=3)
    a, _ = svt.LogSVPricer(device="cpu").model_mc_price_chain(ct, pt, engine="cuda", **kw)
    b, _ = svt.LogSVPricer(device="cpu").model_mc_price_chain(ct, pt, engine="pallas", **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("engine,nb_path", [("scan", 1 << 15), ("cuda", 1 << 17)])
def test_mc_engines_match_analytic_prices(engine, nb_path):
    _, ct = btc_chains()
    _, pt = param_pair(**BTC_PARAMS)
    pricer = svt.LogSVPricer(device="cpu")
    analytic = pricer.price_chain(ct, pt)
    mc, std = pricer.model_mc_price_chain(ct, pt, engine=engine, nb_path=nb_path, seed=11)
    for a, m, s in zip(analytic, mc, std):
        assert np.all(np.isfinite(m)) and np.all(s > 0.0)
        assert np.all(np.abs(a - m) < 4.0 * np.sqrt(2.0) * s + 5e-3)


def test_mc_chain_implied_vol_bands():
    _, ct = btc_chains()
    _, pt = param_pair(**BTC_PARAMS)
    pricer = svt.LogSVPricer(device="cpu")
    prices, ups, downs, iv_mid, iv_up, iv_down, std = pricer.compute_mc_chain_implied_vols(
        ct, pt, engine="cuda", nb_path=1 << 14, seed=24)
    for p, u, d, im, iu, idn in zip(prices, ups, downs, iv_mid, iv_up, iv_down):
        assert np.all(u >= p) and np.all(d <= p)
        live = ~np.isnan(idn)
        assert np.all(iu >= im) and np.all(im[live] >= idn[live])


def test_unknown_engine_and_estimators_raise():
    _, ct = btc_chains()
    _, pt = param_pair(**BTC_PARAMS)
    with pytest.raises(NotImplementedError):
        svt.LogSVPricer(device="cpu").model_mc_price_chain(ct, pt, engine="sobol", nb_path=256)
    # the kernel draws its normals on the card: no antithetic pairs there
    with pytest.raises(NotImplementedError):
        svt.LogSVPricer(device="cpu").model_mc_price_chain(ct, pt, nb_path=256, engine="cuda",
                                                           antithetic=True)
    # pairs and QMC replicates are two exclusive reductions
    with pytest.raises(NotImplementedError):
        svt.compute_mc_vars_payoff(x0=torch.zeros(4), sigma0=None, qvar0=torch.zeros(4),
                                   ttm=0.1, forward=1.0, strikes_ttm=[1.0],
                                   optiontypes_ttm=['C'], antithetic=True, nb_replicates=2)
