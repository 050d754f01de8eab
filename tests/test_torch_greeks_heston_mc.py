"""Heston chain greeks and the LogSV pathwise MC greeks of the PyTorch port
(``models/greeks.py``), against the JAX package (CPU, float64) on the small
chain of ``tests/test_greeks.py``:

* Heston price space: prices to 1e-12 x forward; delta, vega and every
  parameter greek to 1e-9 relative + 1e-12; gamma and ``theta_calendar`` to
  1e-8; vol space (``in_vols=True``) to 1e-8;
* the pathwise MC delta and vega (16,384 paths, 180 steps/yr, a fixed seed)
  against a central difference of the same fixed-seed MC (rtol 5e-3, atol
  5e-4, as ``tests/test_greeks.py``) and against the analytic greeks within
  0.03; MC gamma and unknown greeks raise as in the JAX package.
"""
import numpy as np
import pytest

import stochvolmodels_torch as svt
from stochvolmodels_torch.models import greeks as tg
from stochvolmodels_tpu.data.option_chain import OptionChain as JChain
from stochvolmodels_tpu.models import greeks as jg
from stochvolmodels_tpu.models.heston import HestonParams as JHeston
from test_torch_greeks import LOGSV, small_chain

HESTON = dict(v0=0.7, theta=0.9, kappa=3.0, rho=-0.4, volvol=1.5)
PRICE_GREEKS = ("delta", "gamma", "vega", "theta", "kappa", "rho", "volvol", "theta_calendar")
VOL_GREEKS = ("delta", "gamma", "vega", "rho")
NB_PATH = 16384
STEPS = 180


def _close(ours, ref, rtol, atol=1e-12):
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def heston_price_space():
    ref = jg.heston_chain_greeks(small_chain(JChain), JHeston(**HESTON), greeks=PRICE_GREEKS)
    ours = svt.HestonPricer(device="cpu").compute_chain_greeks(
        small_chain(svt.OptionChain), svt.HestonParams(**HESTON), greeks=PRICE_GREEKS)
    return ours, ref


def test_heston_prices_match_jax(heston_price_space):
    ours, ref = heston_price_space
    for a, b, f in zip(ours["price"], ref["price"], small_chain(svt.OptionChain).forwards):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-12 * f)


@pytest.mark.parametrize("greek", ["delta", "vega", "theta", "kappa", "rho", "volvol"])
def test_heston_first_order_greeks_match_jax(heston_price_space, greek):
    ours, ref = heston_price_space
    _close(ours[greek], ref[greek], rtol=1e-9)


@pytest.mark.parametrize("greek", ["gamma", "theta_calendar"])
def test_heston_gamma_and_calendar_theta_match_jax(heston_price_space, greek):
    ours, ref = heston_price_space
    _close(ours[greek], ref[greek], rtol=1e-8)


def test_heston_vol_space_greeks_match_jax():
    ref = jg.heston_chain_greeks(small_chain(JChain), JHeston(**HESTON), greeks=VOL_GREEKS,
                                 in_vols=True)
    ours = tg.heston_chain_greeks(small_chain(svt.OptionChain), svt.HestonParams(**HESTON),
                                  greeks=VOL_GREEKS, in_vols=True, device="cpu")
    for k in ("price", "ivol") + VOL_GREEKS:
        _close(ours[k], ref[k], rtol=1e-8)
    with pytest.raises(ValueError):
        tg.heston_chain_greeks(small_chain(svt.OptionChain), svt.HestonParams(**HESTON),
                               greeks=("smile",), device="cpu")


@pytest.fixture(scope="module")
def mc_greeks():
    return tg.logsv_mc_chain_greeks(small_chain(svt.OptionChain), svt.LogSvParams(**LOGSV),
                                    greeks=("delta", "vega"), nb_path=NB_PATH,
                                    nb_steps_per_year=STEPS, seed=7, device="cpu")


def _mc_prices(params, fmult=1.0):
    c = small_chain(svt.OptionChain)
    c.forwards = c.forwards * fmult
    return tg.logsv_mc_chain_greeks(c, params, greeks=(), nb_path=NB_PATH,
                                    nb_steps_per_year=STEPS, seed=7, device="cpu")["price"]


def test_mc_delta_vega_vs_fixed_seed_fd(mc_greeks):
    eps = 1e-4
    up = _mc_prices(svt.LogSvParams(**LOGSV), 1 + eps)
    dn = _mc_prices(svt.LogSvParams(**LOGSV), 1 - eps)
    vup = _mc_prices(svt.LogSvParams(**{**LOGSV, "sigma0": LOGSV["sigma0"] + eps}))
    vdn = _mc_prices(svt.LogSvParams(**{**LOGSV, "sigma0": LOGSV["sigma0"] - eps}))
    for i, f in enumerate(small_chain(svt.OptionChain).forwards):
        np.testing.assert_allclose(mc_greeks["delta"][i], (up[i] - dn[i]) / (2 * f * eps),
                                   rtol=5e-3, atol=5e-4)
        np.testing.assert_allclose(mc_greeks["vega"][i], (vup[i] - vdn[i]) / (2 * eps),
                                   rtol=5e-3, atol=5e-4)


def test_mc_greeks_match_analytic_within_mc_error(mc_greeks):
    an = tg.logsv_chain_greeks(small_chain(svt.OptionChain), svt.LogSvParams(**LOGSV),
                               greeks=("delta", "vega"), year_steps=360, device="cpu")
    for i in range(2):
        np.testing.assert_allclose(mc_greeks["delta"][i], an["delta"][i], atol=0.03)
        np.testing.assert_allclose(mc_greeks["vega"][i], an["vega"][i], atol=0.03)


def test_mc_gamma_and_unknown_greeks_raise():
    for greeks in (("gamma",), ("smile",)):
        with pytest.raises(ValueError):
            tg.logsv_mc_chain_greeks(small_chain(svt.OptionChain), svt.LogSvParams(**LOGSV),
                                     greeks=greeks, nb_path=64, device="cpu")
        with pytest.raises(ValueError):
            jg.logsv_mc_chain_greeks(small_chain(JChain), svt.LogSvParams(**LOGSV),
                                     greeks=greeks, nb_path=64)
