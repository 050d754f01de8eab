"""LogSV chain greeks of the PyTorch port (``models/greeks.py``) against the
JAX package's (CPU, float64), on the small chain and the parameters of
``tests/test_greeks.py`` at 240 RK4 steps/yr:

* price space: prices to 1e-12 x forward; delta, vega and every parameter
  greek to 1e-9 relative + 1e-12; gamma and ``theta_calendar`` to 1e-8
  relative + 1e-12;
* vol space (``in_vols=True``): ivols, delta, gamma, vega and a parameter
  greek to 1e-8 relative + 1e-12, and the port's gamma in vols against a
  central difference of its own delta in vols (the fast IV's derivatives
  are exact to second order);
* the pricer method equals the functional form, and an unknown greek raises
  as in the JAX package.

Each JAX program is built once per module.
"""
import numpy as np
import pytest
import torch

import stochvolmodels_torch as svt
from stochvolmodels_torch.models import greeks as tg
from stochvolmodels_tpu.data.option_chain import OptionChain as JChain
from stochvolmodels_tpu.models import greeks as jg
from stochvolmodels_tpu.models.logsv.params import LogSvParams as JParams

YEAR_STEPS = 240
LOGSV = dict(sigma0=0.85, theta=1.0, kappa1=4.0, kappa2=4.0, beta=0.15, volvol=1.8)
PRICE_GREEKS = ("delta", "gamma", "vega", "theta", "kappa1", "kappa2", "beta", "volvol",
                "theta_calendar")
VOL_GREEKS = ("delta", "gamma", "vega", "volvol")


def small_chain(cls, forward: float = 1.0):
    return cls(ttms=np.array([0.08, 0.25]), forwards=np.array([forward, forward * 1.002]),
               discfactors=np.array([0.999, 0.995]),
               strikes_ttms=[forward * np.array([0.85, 0.95, 1.0, 1.05, 1.2]),
                             forward * np.array([0.8, 1.0, 1.25])],
               optiontypes_ttms=[np.array(['P', 'P', 'C', 'C', 'C']),
                                 np.array(['P', 'C', 'C'])])


def _close(ours, ref, rtol, atol=1e-12):
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def price_space():
    ref = jg.logsv_chain_greeks(small_chain(JChain), JParams(**LOGSV), greeks=PRICE_GREEKS,
                                year_steps=YEAR_STEPS)
    ours = tg.logsv_chain_greeks(small_chain(svt.OptionChain), svt.LogSvParams(**LOGSV),
                                 greeks=PRICE_GREEKS, year_steps=YEAR_STEPS, device="cpu")
    return ours, ref


@pytest.fixture(scope="module")
def vol_space():
    ref = jg.logsv_chain_greeks(small_chain(JChain), JParams(**LOGSV), greeks=VOL_GREEKS,
                                year_steps=YEAR_STEPS, in_vols=True)
    ours = tg.logsv_chain_greeks(small_chain(svt.OptionChain), svt.LogSvParams(**LOGSV),
                                 greeks=VOL_GREEKS, year_steps=YEAR_STEPS, in_vols=True,
                                 device="cpu")
    return ours, ref


def test_prices_match_jax(price_space):
    ours, ref = price_space
    for a, b, f in zip(ours["price"], ref["price"], small_chain(svt.OptionChain).forwards):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-12 * f)


@pytest.mark.parametrize("greek", ["delta", "vega", "theta", "kappa1", "kappa2", "beta",
                                   "volvol"])
def test_first_order_greeks_match_jax(price_space, greek):
    ours, ref = price_space
    _close(ours[greek], ref[greek], rtol=1e-9)


@pytest.mark.parametrize("greek", ["gamma", "theta_calendar"])
def test_gamma_and_calendar_theta_match_jax(price_space, greek):
    ours, ref = price_space
    _close(ours[greek], ref[greek], rtol=1e-8)


@pytest.mark.parametrize("greek", ["ivol", "delta", "gamma", "vega", "volvol"])
def test_vol_space_greeks_match_jax(vol_space, greek):
    ours, ref = vol_space
    _close(ours[greek], ref[greek], rtol=1e-8)


def test_vol_space_gamma_is_the_derivative_of_the_vol_space_delta(vol_space):
    ours, _ = vol_space
    vs = svt.set_vol_scaler(sigma0=LOGSV["sigma0"], ttm=0.08)
    eps = 1e-4

    def delta_at(mult):
        c = small_chain(svt.OptionChain)
        c.forwards = c.forwards * mult
        return tg.logsv_chain_greeks(c, svt.LogSvParams(**LOGSV), greeks=("delta",),
                                     vol_scaler=vs, year_steps=YEAR_STEPS, in_vols=True,
                                     device="cpu")["delta"]

    at = tg.logsv_chain_greeks(small_chain(svt.OptionChain), svt.LogSvParams(**LOGSV),
                               greeks=("gamma",), vol_scaler=vs, year_steps=YEAR_STEPS,
                               in_vols=True, device="cpu")["gamma"]
    up, dn = delta_at(1.0 + eps), delta_at(1.0 - eps)
    for i, f in enumerate(small_chain(svt.OptionChain).forwards):
        np.testing.assert_allclose(at[i], (up[i] - dn[i]) / (2.0 * f * eps), rtol=2e-3, atol=2e-5)
    # the default vol scaler comes from the chain's (absent) vols: sigma0 here
    _close(at, ours["gamma"], rtol=1e-12)


def test_pricer_method_and_unknown_greek():
    chain = small_chain(svt.OptionChain)
    params = svt.LogSvParams(**LOGSV)
    out = svt.LogSVPricer(device="cpu").compute_chain_greeks(chain, params, greeks=("delta",),
                                                              year_steps=YEAR_STEPS)
    base = tg.logsv_chain_greeks(chain, params, greeks=("delta",), year_steps=YEAR_STEPS,
                                 device="cpu")
    for k in ("price", "delta"):
        _close(out[k], base[k], rtol=0, atol=0)
    with pytest.raises(ValueError):
        tg.logsv_chain_greeks(chain, params, greeks=("smile",), device="cpu")
    with pytest.raises(ValueError):
        jg.logsv_chain_greeks(small_chain(JChain), JParams(**LOGSV), greeks=("smile",))
