"""Rate futures in the PyTorch port against the JAX package, on the CPU: the
convexity adjustment of Theorems 3.3/3.5 and the adaptive tanh-sinh pricer
of options on rate futures.

* ``futures_conv_adj`` at the expiry (EURODOLLAR at ZERO and FIRST order,
  SOFR at ZERO order) and dense on a grid: 1e-11 of each output's scale
  (the h-system runs 1000 RK4 steps a year over panels whose short-tau
  terms cancel, where the two libraries' ``exp`` part by ~1e-14; the h
  outputs are ~1e-6 and part by ~3e-12 of that);
  ``calc_futures_rate`` on a few factor states: 1e-12 relative;
* ``logsv_chain_de_pricer`` on one FUTURES expiry (1y, three strikes about
  a 4.5% forward): prices 1e-12 absolute, normal ivols 1e-9;
  ``RateFutLogSVPricer.price_chain`` gives the same ivols.
"""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
from test_torch_rates_core import rate_param_pair

from stochvolmodels_tpu.models.factor_hjm import rate_logsv_pricer as jrp
from stochvolmodels_tpu.models.factor_hjm.rate_affine_expansion import UnderlyingType as JU
from stochvolmodels_tpu.models.logsv.affine import ExpansionOrder as JOrder
from stochvolmodels_tpu.utils.rate_core import generate_ttms_grid
from stochvolmodels_torch.models.factor_hjm import rate_logsv_pricer as trp
from stochvolmodels_torch.models.factor_hjm.rate_affine_expansion import UnderlyingType
from stochvolmodels_torch.models.logsv.affine import ExpansionOrder

BETA = np.tile([0.1, -0.05, 0.0], (3, 1))
VOLVOL = np.full(3, 0.3)


def close_scaled(a, b, rtol):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * max(np.max(np.abs(b)), 1e-300))


@pytest.fixture(scope="module")
def futures_row():
    pj, pt = rate_param_pair(beta_xs=BETA, volvol_xs=VOLVOL)
    kw = dict(t_grid=generate_ttms_grid(np.array([1.0]), nb_pts=21), ttms=np.array([1.0]),
              forwards=[np.array([0.045])], strikes_ttms=[[np.array([0.04, 0.045, 0.05])]],
              optiontypes_ttms=[np.repeat('C', 3)])
    ref = jrp.logsv_chain_de_pricer(pj, underlying_type=JU.FUTURES, **kw)
    ours = trp.logsv_chain_de_pricer(pt, underlying_type=UnderlyingType.FUTURES, device="cpu",
                                     **kw)
    chain = SimpleNamespace(ttms=kw["ttms"], forwards=kw["forwards"][0],
                            strikes_ttms=kw["strikes_ttms"][0],
                            optiontypes_ttms=kw["optiontypes_ttms"])
    pricer = trp.RateFutLogSVPricer(device="cpu").price_chain(chain, pt, t_grid=kw["t_grid"],
                                                              idxs=slice(0, 1))
    yield ref, ours, pricer
    import gc
    jax.clear_caches()
    gc.collect()


@pytest.mark.parametrize("order, settle", [("zero", "EURODOLLAR"), ("first", "EURODOLLAR"),
                                           ("zero", "SOFR")])
def test_conv_adj_at_expiry_and_dense(order, settle):
    pj, pt = rate_param_pair(beta_xs=BETA, volvol_xs=VOLVOL)
    jo, to = {"zero": (JOrder.ZERO, ExpansionOrder.ZERO),
              "first": (JOrder.FIRST, ExpansionOrder.FIRST)}[order]
    common = dict(t_start=1.0, basis_type="NELSON-SIEGEL", t0=0.0, Delta=0.25)
    ref = jrp.futures_conv_adj(params=pj, settlement_type=getattr(jrp.FutSettleType, settle),
                               expansion_order=jo, **common)
    ours = trp.futures_conv_adj(params=pt, settlement_type=getattr(trp.FutSettleType, settle),
                                expansion_order=to, device="cpu", **common)
    for a, b in zip(ours, ref):
        close_scaled(a, b, 1e-11)
    t_grid = generate_ttms_grid(np.array([1.0]), nb_pts=11)
    ref = jrp.futures_conv_adj(params=pj, settlement_type=getattr(jrp.FutSettleType, settle),
                               expansion_order=jo, dense_output=True, t_grid=t_grid, **common)
    ours = trp.futures_conv_adj(params=pt, settlement_type=getattr(trp.FutSettleType, settle),
                                expansion_order=to, dense_output=True, t_grid=t_grid,
                                device="cpu", **common)
    for a, b in zip(ours, ref):
        close_scaled(a, b, 1e-11)


def test_futures_rate_matches():
    pj, pt = rate_param_pair(beta_xs=BETA, volvol_xs=VOLVOL)
    rng = np.random.default_rng(5)
    x0, y0 = 0.005 * rng.normal(size=(4, 3)), 1e-5 * rng.normal(size=(4, 8))
    sigma0 = 1.0 + 0.1 * rng.normal(size=(4, 1))
    common = dict(ccy="USD", basis_type="NELSON-SIEGEL", x0=x0, y0=y0, sigma0=sigma0, t0=0.5,
                  t_start=1.0, t_end=1.25, Delta=0.25)
    ref = jrp.calc_futures_rate(params=pj, settlement_type=jrp.FutSettleType.EURODOLLAR,
                                expansion_order=JOrder.FIRST, **common)
    ours = trp.calc_futures_rate(params=pt, settlement_type=trp.FutSettleType.EURODOLLAR,
                                 expansion_order=ExpansionOrder.FIRST, device="cpu", **common)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, b, rtol=1e-12)


def test_futures_option_prices_match(futures_row):
    (ref_p, _), (ours_p, _), _ = futures_row
    np.testing.assert_allclose(ours_p[0][0], np.asarray(ref_p[0][0]), rtol=0, atol=1e-12)


def test_futures_option_ivols_match(futures_row):
    (_, ref_iv), (_, ours_iv), pricer = futures_row
    iv = ours_iv[0][0]
    assert np.all((iv > 0.001) & (iv < 0.05))
    np.testing.assert_allclose(iv, np.asarray(ref_iv[0][0]), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(pricer[0][0], iv)
