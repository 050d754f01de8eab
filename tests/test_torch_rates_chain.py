"""The swaption chain container of the PyTorch port against the JAX package.

``SwOptionChain`` on the USD cube of 18 Aug 2023
(``papers/sv_for_factor_hjm/calibration_fig_5_6_7.py``): the flat-curve
re-centring of ``create_swaption_chain_MF``, mid and ATM vols, normal
vegas (on host tensors in the port), the strike, expiry and tenor
reductions and the delta remaps, each equal to the JAX package's to 1e-14;
``remap_to_inc_delta`` takes the port's ``SeriesLike`` as well as a pandas
Series.  ``RateLogSVPricer.price_chain`` hands the adaptive pricer the
rows of the expiries it is given, on its device; ``populate_betas`` and
``make_mc_array`` as in the JAX package.
"""
import numpy as np
import pandas as pd
import pytest
from test_torch_rates_core import usd_cube_pair

from stochvolmodels_tpu.data.option_chain import SwOptionChain as JChain
from stochvolmodels_tpu.models.factor_hjm import rate_factor_basis as jbasis
from stochvolmodels_tpu.models.factor_hjm import rate_logsv_pricer as jrp
from stochvolmodels_torch.data.option_chain import SwOptionChain
from stochvolmodels_torch.models.factor_hjm import rate_factor_basis as tbasis
from stochvolmodels_torch.models.factor_hjm import rate_logsv_pricer as trp
from stochvolmodels_torch.utils.funcs import SeriesLike


@pytest.fixture(scope="module")
def chains():
    cj, _, ct, _ = usd_cube_pair()
    return cj, ct


def assert_nested(a, b, rtol=1e-14):
    if isinstance(b, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_nested(x, y, rtol)
    else:
        np.testing.assert_allclose(np.asarray(a, dtype=float), np.asarray(b, dtype=float),
                                   rtol=rtol, atol=0)


def test_create_swaption_chain_recentres_on_par_rates():
    rng = np.random.default_rng(6)
    tenors, ttms = np.array([2.0, 5.0]), np.array([1.0, 2.0, 3.0])
    fwds = [0.04 + 0.002 * rng.normal(size=3) for _ in tenors]
    strikes = [[f + np.linspace(-0.01, 0.01, 5) for f in fw] for fw in fwds]
    ivs = [[0.01 + 0.001 * rng.uniform(size=5) for _ in ttms] for _ in tenors]
    copy = lambda nested: [[np.array(x) for x in row] for row in nested]
    out = []
    for cls in (JChain, SwOptionChain):
        out.append(cls.create_swaption_chain_MF(
            ccy="USD", tenors=tenors, tenors_ids=["2y", "5y"], ttms=ttms,
            ttms_ids=["1y", "2y", "3y"], forwards=[np.array(f) for f in fwds],
            strikes_ttms=copy(strikes), ivs=copy(ivs), ticker="test"))
    cj, ct = out
    assert_nested(ct.forwards, cj.forwards)
    assert_nested(ct.strikes_ttms, cj.strikes_ttms)
    assert ct.optiontypes_ttms[0].tolist() == cj.optiontypes_ttms[0].tolist()


@pytest.mark.parametrize("method", ["get_mid_vols", "get_chain_atm_vols", "get_chain_vegas",
                                    "get_chain_vegas_unit"])
def test_chain_analytics_match(chains, method):
    cj, ct = chains
    if method == "get_chain_vegas_unit":
        assert_nested(ct.get_chain_vegas(is_unit_ttm_vega=True),
                      cj.get_chain_vegas(is_unit_ttm_vega=True), 1e-12)
    else:
        assert_nested(getattr(ct, method)(), getattr(cj, method)(),
                      1e-12 if method == "get_chain_vegas" else 1e-14)


@pytest.mark.parametrize("how", ["strikes", "ttms", "tenors"])
def test_reductions_match(chains, how):
    cj, ct = chains
    call = {"strikes": lambda c: c.reduce_strikes(2),
            "ttms": lambda c: c.reduce_ttms(["1y", "5y"]),
            "tenors": lambda c: c.reduce_tenors(["5y", "10y"])}[how]
    rj, rt = call(cj), call(ct)
    assert isinstance(rt, SwOptionChain)
    for name in ("ttms", "tenors", "forwards", "strikes_ttms", "bid_ivs", "ask_ivs"):
        assert_nested(getattr(rt, name), getattr(rj, name))
    assert list(rt.ttms_ids) == list(rj.ttms_ids) and list(rt.tenors_ids) == list(rj.tenors_ids)


def test_reductions_reject_what_is_not_there(chains):
    _, ct = chains
    with pytest.raises(ValueError):
        ct.reduce_strikes(9)
    with pytest.raises(ValueError):
        ct.reduce_ttms(["4y"])
    with pytest.raises(ValueError):
        ct.reduce_tenors(["30y"])


def test_delta_remaps():
    grid = np.linspace(-0.9, -0.1, 9)
    np.testing.assert_array_equal(SwOptionChain.remap_to_pc_delta(grid),
                                  JChain.remap_to_pc_delta(grid))
    values, index = np.linspace(0.01, 0.02, 5), np.array([0.1, 0.25, 0.5, 0.75, 0.9])
    ref = JChain.remap_to_inc_delta(pd.Series(values, index=index))
    ours = SwOptionChain.remap_to_inc_delta(SeriesLike(values=values, index=index))
    np.testing.assert_array_equal(ours.index, np.asarray(ref.index))
    np.testing.assert_array_equal(ours.to_numpy(), ref.to_numpy())
    as_series = SwOptionChain.remap_to_inc_delta(pd.Series(values, index=index))
    np.testing.assert_array_equal(np.asarray(as_series.index), np.asarray(ref.index))


def test_swaption_pricer_hands_the_expiry_rows_to_the_de_pricer(chains, monkeypatch):
    _, ct = chains
    _, _, _, pt = usd_cube_pair()
    seen = {}

    def fake(**kw):
        seen.update(kw)
        return "prices", "ivols"
    monkeypatch.setattr(trp, "logsv_chain_de_pricer", fake)
    out = trp.RateLogSVPricer(device="cpu").price_chain(ct, pt, t_grid=np.array([0.0, 1.0]),
                                                        idxs=slice(0, 1))
    assert out == "ivols" and seen["params"] is pt and str(seen["device"]) == "cpu"
    np.testing.assert_array_equal(seen["ttms"], [1.0])
    assert_nested(seen["forwards"], [f[:1] for f in ct.forwards])
    assert_nested(seen["strikes_ttms"], [s[:1] for s in ct.strikes_ttms])
    assert len(seen["optiontypes_ttms"]) == 1


def test_populate_betas_and_mc_array():
    for jb, tb in ((jbasis.NelsonSiegel(0.55, np.array([2., 5., 10.])),
                    tbasis.NelsonSiegel(0.55, np.array([2., 5., 10.]))),
                   (jbasis.Cheyette1D(0.3), tbasis.Cheyette1D(0.3))):
        np.testing.assert_array_equal(trp.RateFutLogSVPricer.populate_betas(0.3, tb),
                                      jrp.RateFutLogSVPricer.populate_betas(0.3, jb))
    np.testing.assert_array_equal(trp.make_mc_array(np.arange(3.0), 4),
                                  jrp.make_mc_array(np.arange(3.0), 4))
