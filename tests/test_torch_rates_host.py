"""The host rates modules of the PyTorch port against the JAX package, on
the CPU in float64:

* ``rate_logsv_ivols`` (SABR-style normal smiles with shift and beta, the
  ATM cubic for alpha, the parabolic pre-fit, the curve_fit smile fit,
  deltas at strikes and strikes at deltas): 1e-12 relative, the fits to
  1e-10;
* ``rate_evaluate`` (the one-factor curve: bonds, annuities, par rates and
  their first four state derivatives, LIBOR rates): 1e-12 relative;
* ``FutOptionChain``: ``filter_by_oi`` keeps the same strikes, vols and
  open interest, ``reduce_ttms`` the same expiries, ``get_chain_vegas`` the
  same vegas (1e-12).
"""
import numpy as np
import pytest

from stochvolmodels_tpu.data.option_chain import FutOptionChain as JFutOptionChain
from stochvolmodels_tpu.models.factor_hjm import rate_evaluate as jev
from stochvolmodels_tpu.models.factor_hjm import rate_logsv_ivols as jiv
from stochvolmodels_torch.data.option_chain import FutOptionChain
from stochvolmodels_torch.models.factor_hjm import rate_evaluate as tev
from stochvolmodels_torch.models.factor_hjm import rate_logsv_ivols as tiv

F0, TTM, SHIFT = 0.04, 1.5, 0.02
STRIKES = F0 + np.linspace(-0.015, 0.02, 9)
SMILE = dict(alpha=0.05, rho=-0.3, total_vol=0.6, beta=0.5, shift=SHIFT)


def close(a, b, rtol=1e-12):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.max(np.abs(b)))


@pytest.mark.parametrize("beta", [0.0, 0.5, 0.9995])
def test_smile_and_alpha_match(beta):
    kw = dict(SMILE, beta=beta)
    close(tiv.calc_logsv_ivols(STRIKES, F0, TTM, **kw), jiv.calc_logsv_ivols(STRIKES, F0, TTM, **kw))
    atm = dict(kw, alpha=0.009)
    close(tiv.calc_logsv_ivols(STRIKES, F0, TTM, is_alpha_atmvol=True, **atm),
          jiv.calc_logsv_ivols(STRIKES, F0, TTM, is_alpha_atmvol=True, **atm))
    args = dict(f0=F0, ttm=TTM, vol_atm=0.009, beta=beta, rho=-0.3, total_vol=0.6, shift=SHIFT)
    assert tiv.get_alpha(**args) == pytest.approx(jiv.get_alpha(**args), rel=1e-12)


def test_fits_match():
    vols = jiv.calc_logsv_ivols(STRIKES, F0, TTM, **SMILE) * (1.0 + 0.01 * np.sin(STRIKES * 300))
    parab_j = jiv.cals_logsv_parab_fit(STRIKES, vols, F0, beta=0.5, shift=SHIFT)
    parab_t = tiv.cals_logsv_parab_fit(STRIKES, vols, F0, beta=0.5, shift=SHIFT)
    for k in parab_j:
        close(parab_t[k], parab_j[k])
    fit_j = jiv.fit_logsv_ivols(STRIKES, vols, F0, beta=0.5, shift=SHIFT, ttm=TTM)
    fit_t = tiv.fit_logsv_ivols(STRIKES, vols, F0, beta=0.5, shift=SHIFT, ttm=TTM)
    for k in fit_j:
        close(fit_t[k], fit_j[k], rtol=1e-10)


def test_delta_maps_match():
    kw = dict(f0=F0, ttm=TTM, sigma0=0.05, rho=-0.3, total_vol=0.6, beta=0.5, shift=SHIFT)
    types = np.array(['P'] * 4 + ['C'] * 5)
    close(tiv.get_delta_at_strikes(STRIKES, optiontypes=types, **kw),
          jiv.get_delta_at_strikes(STRIKES, optiontypes=types, **kw))
    deltas = np.array([-0.25, -0.1, 0.1, 0.25, 0.5])
    ours, ref = tiv.infer_strikes_from_deltas(deltas, **kw), jiv.infer_strikes_from_deltas(deltas, **kw)
    np.testing.assert_array_equal(ours.index.to_numpy(), ref.index.to_numpy())
    close(ours.to_numpy(), ref.to_numpy())


def test_smile_refuses_a_negative_shifted_strike():
    with pytest.raises(ValueError):
        tiv.calc_logsv_ivols(np.array([-0.03]), F0, TTM, **SMILE)


@pytest.mark.parametrize("m", range(5))
def test_curve_evaluation_matches(m):
    ts_sw = np.arange(1.0, 6.5, 0.5)
    x, y = np.array([0.01, -0.02, 0.005]), np.array([0.001, 0.002, 0.0005])
    close(tev.bond(0.5, 3.0, x, y, m, False), jev.bond(0.5, 3.0, x, y, m, False))
    close(tev.annuity(0.5, ts_sw, x, y, m), jev.annuity(0.5, ts_sw, x, y, m))
    close(tev.swap_rate(0.5, ts_sw, x, y)[m], jev.swap_rate(0.5, ts_sw, x, y)[m])
    if m == 0:
        close(tev.libor_rate(0.5, 1.0, 1.25, x, y), jev.libor_rate(0.5, 1.0, 1.25, x, y))
        for ccy in ("USD", "JPY"):
            assert tev.Discount(ccy).df(2.0) == jev.Discount(ccy).df(2.0)


def fut_chain_rows(with_oi: bool = True):
    rng = np.random.default_rng(11)
    strikes = [0.05 + 0.0025 * np.arange(-4, 5) for _ in range(3)]
    rows = dict(ccy="USD", ttms=np.array([0.2, 0.45, 0.7]), forwards=np.array([0.05, 0.051, 0.052]),
                strikes_ttms=strikes, ttms_ids=np.array(["H", "M", "U"]),
                ivs_call_ttms=[rng.uniform(0.008, 0.012, 9) for _ in range(3)],
                ivs_put_ttms=[rng.uniform(0.008, 0.012, 9) for _ in range(3)], ticker="SR3")
    if with_oi:
        oi = [np.round(rng.uniform(10.0, 1000.0, 9)) for _ in range(6)]
        for o in oi:
            o[4] = 5000.0                       # the middle strike is the most liquid
        rows.update(call_oi=oi[:3], put_oi=oi[3:])
    return rows


def test_filter_by_oi_and_reduce_match():
    rows = fut_chain_rows()
    ours = FutOptionChain(**rows).filter_by_oi(max_strikes=5, include_atm=True)
    ref = JFutOptionChain(**rows).filter_by_oi(max_strikes=5, include_atm=True)
    for name in ("strikes_ttms", "ivs_call_ttms", "ivs_put_ttms", "call_oi", "put_oi"):
        for a, b in zip(getattr(ours, name), getattr(ref, name)):
            np.testing.assert_array_equal(a, b)
    assert [len(s) for s in ours.strikes_ttms] == [5, 5, 5]
    illiquid_atm = fut_chain_rows()
    illiquid_atm["call_oi"][0][4] = illiquid_atm["put_oi"][0][4] = 0.0
    with pytest.raises(ValueError):
        FutOptionChain(**illiquid_atm).filter_by_oi(max_strikes=2, include_atm=True)
    plain = fut_chain_rows(with_oi=False)
    red_t = FutOptionChain(**plain).reduce_ttms(np.array(["H", "U"]))
    red_j = JFutOptionChain(**plain).reduce_ttms(np.array(["H", "U"]))
    np.testing.assert_array_equal(red_t.ttms, red_j.ttms)
    np.testing.assert_array_equal(red_t.forwards, red_j.forwards)
    for a, b in zip(red_t.get_chain_vegas(device="cpu"), red_j.get_chain_vegas()):
        close(a, b)
    assert all(np.array_equal(a, b) for a, b in zip(red_t.get_mid_vols(), red_j.get_mid_vols()))
