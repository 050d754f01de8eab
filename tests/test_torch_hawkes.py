"""Hawkes jump-diffusion pricing of the PyTorch port against the JAX package.

* the batched Riccati RK4 on the complex128 grid against ``solve_a_ode_grid``
  on (re, im) pairs: elementwise |diff| <= 1e-12 |ref| (measured 2.0e-16 at
  ttm 0.25, the same over three chained slices); chained halves equal the
  direct solve to 1e-9, as in ``tests/test_hawkes.py``;
* BTC-chain prices within 1e-10 x forward (measured 6.2e-16) and implied
  vols within 1e-8 (measured 1.0e-13) with the same NaN pattern, for the
  BTC defaults and a calmer parameter set; put-call parity;
* the risk kernel's normalizers and gamma-forwards (measured equal to the
  last bit) and the gamma = 0.5 prices and ivols on the forward-normalised
  chain (measured 6.7e-16 and 3.6e-14; limits 1e-10 and 1e-8); gamma = 0
  against the standard pricer (measured 1.2e-15; limit 1e-12);
* the port's ``precision='fast'`` (float64 at 720 steps/yr) against the JAX
  package's mixed-precision ``'fast'``: prices rtol 1e-4 (measured 8.6e-6),
  ivols 1e-5 absolute (measured 6.4e-7);
* the new transform-engine pieces (``real_phi`` grid, complex weights, the
  complex payoff kernel, the gamma pricer) against ``ops/mgf.py``;
* Monte Carlo: the float64 ``'scan'`` engine against the analytic 2-week
  slice by the rule of ``tests/test_hawkes.py`` (4 stderr + 2% of the price
  + 2e-4 forward), the martingale test, and ``engine='cuda'`` on the CPU
  (the kernel's plain version) against the JAX ``engine='pallas'`` in
  interpret mode on the first two BTC slices at 2^15 paths.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import assert_same_nan_pattern, btc_chains

import stochvolmodels_tpu as svj
import stochvolmodels_torch as svt
from stochvolmodels_tpu.data.option_chain import OptionChain as JaxOptionChain
from stochvolmodels_tpu.models import hawkes_jd as jh
from stochvolmodels_tpu.ops import mgf as jmgf
from stochvolmodels_tpu.utils.cplx import Cplx
from stochvolmodels_torch.models import hawkes_jd as th
from stochvolmodels_torch.ops import mgf as tmgf

PARAM_SETS = {
    "btc": {},
    "calm": dict(sigma=0.6, shift_p=0.04, mean_p=0.05, shift_m=-0.04, mean_m=-0.05,
                 lambda_p=2.0, theta_p=2.0, kappa_p=10.0, beta1_p=20.0, beta2_p=-15.0,
                 lambda_m=3.0, theta_m=3.0, kappa_m=12.0, beta1_m=25.0, beta2_m=-20.0),
}
GAMMA = 0.5


def hawkes_pair(name="btc", gamma=None):
    pj = jh.HawkesJDParams(**PARAM_SETS[name], risk_premia_gamma=gamma)
    return pj, svt.hawkes_params_from_numpy(pj.to_dict())


def to_cplx(z: torch.Tensor) -> Cplx:
    return Cplx(jnp.asarray(z.real.numpy()), jnp.asarray(z.imag.numpy()))


def to_complex(z: Cplx) -> np.ndarray:
    return np.asarray(z.re) + 1j * np.asarray(z.im)


def normalised_chains():
    cj, ct = btc_chains()
    return (JaxOptionChain.to_forward_normalised_strikes(cj),
            svt.OptionChain.to_forward_normalised_strikes(ct))


@functools.lru_cache(maxsize=None)
def jax_prices_and_vols(name, gamma=None, precision="exact"):
    """the JAX package's chain prices and ivols (each call takes seconds)."""
    cj = normalised_chains()[0] if gamma is not None else btc_chains()[0]
    pj, _ = hawkes_pair(name, gamma)
    if precision == "fast":
        pricer = jh.HawkesJDPricer()
        return (pricer.price_chain(cj, pj, precision="fast"),
                pricer.compute_model_ivols_for_chain(cj, pj, precision="fast"))
    return jh.HawkesJDPricer().compute_chain_prices_with_vols(cj, pj)


@pytest.mark.parametrize("p_im", [0.0, 3.0, 20.0])
def test_riccati_rk4_matches_jax(p_im):
    pj, pt = hawkes_pair()
    phi = torch.tensor([-0.5 + 1j * p_im, -0.5 + 1j * (p_im + 7.0)], dtype=torch.complex128)
    out = th.solve_a_ode_grid(phi_grid=phi, ttm=0.25, model_params=pt).numpy()
    ref = to_complex(jh.solve_a_ode_grid(phi_grid=to_cplx(phi), ttm=0.25, model_params=pj))
    assert out.shape == (2, 3)
    assert np.all(np.abs(out - ref) <= 1e-12 * np.abs(ref))


def test_chained_state_and_log_mgf_match_jax():
    pj, pt = hawkes_pair("calm")
    phi = tmgf.get_phi_grid(device="cpu", max_phi=th.MAX_PHI, vol_scaler=0.1)
    a_t = aj = None
    for dttm in (0.05, 0.1, 0.2):
        a_t, lm_t = th.compute_hawkes_a_mgf_grid(ttm=dttm, phi_grid=phi, model_params=pt, a_t0=a_t)
        aj, lm_j = jh.compute_hawkes_a_mgf_grid(ttm=dttm, phi_grid=to_cplx(phi), model_params=pj,
                                                a_t0=aj)
        for t, j in ((a_t, aj), (lm_t, lm_j)):
            j = to_complex(j)
            assert np.all(np.abs(t.numpy() - j) <= 1e-12 * np.abs(j) + 1e-15)


def test_chained_equals_direct():
    _, pt = hawkes_pair()
    phi = torch.tensor([-0.5 + 5j], dtype=torch.complex128)
    a_mid = th.solve_a_ode_grid(phi_grid=phi, ttm=0.1, model_params=pt)
    a_chained = th.solve_a_ode_grid(phi_grid=phi, ttm=0.1, model_params=pt, a_t0=a_mid)
    a_direct = th.solve_a_ode_grid(phi_grid=phi, ttm=0.2, model_params=pt)
    np.testing.assert_allclose(a_chained.numpy(), a_direct.numpy(), rtol=0.0, atol=1e-9)


@pytest.mark.parametrize("name", sorted(PARAM_SETS))
def test_btc_chain_prices_match(name):
    cj, ct = btc_chains()
    _, pt = hawkes_pair(name)
    prices_j, _ = jax_prices_and_vols(name)
    prices_t = svt.HawkesJDPricer(device="cpu").price_chain(ct, pt)
    for a, b, fwd in zip(prices_t, prices_j, cj.forwards):
        assert a.shape == np.asarray(b).shape
        assert np.max(np.abs(a - np.asarray(b))) <= 1e-10 * fwd


@pytest.mark.parametrize("name", sorted(PARAM_SETS))
def test_btc_chain_ivols_match(name):
    _, ct = btc_chains()
    _, pt = hawkes_pair(name)
    _, ivols_j = jax_prices_and_vols(name)
    ivols_t = svt.HawkesJDPricer(device="cpu").compute_model_ivols_for_chain(ct, pt)
    for a, b in zip(ivols_t, ivols_j):
        b = np.asarray(b)
        assert_same_nan_pattern(a, b)
        np.testing.assert_allclose(a, b, rtol=0.0, atol=1e-8)
        assert np.all((a > 0.2) & (a < 2.0))


def test_put_call_parity():
    strikes = np.linspace(0.7, 1.4, 8) * 67000.0
    f, ttm, df = 67000.0, 0.25, 0.98
    _, pt = hawkes_pair()
    pricer = svt.HawkesJDPricer(device="cpu")
    chain = lambda t: svt.OptionChain.slice_to_chain(ttm=ttm, forward=f, strikes=strikes,
                                                     optiontypes=np.full(8, t), discfactor=df)
    calls = pricer.price_chain(chain("C"), pt)[0]
    puts = pricer.price_chain(chain("P"), pt)[0]
    assert np.all(calls > 0.0) and np.all(puts > 0.0)
    np.testing.assert_allclose(calls - puts, df * (f - strikes), rtol=1e-9, atol=1e-6 * f)


def test_forwards_under_risk_kernel_match():
    cj, ct = normalised_chains()
    pj, pt = hawkes_pair(gamma=GAMMA)
    nj, gj = jh.hawkesjd_forwards_under_risk_kernel(pj, GAMMA, cj.ttms, cj.forwards)
    nt, gt = th.hawkesjd_forwards_under_risk_kernel(pt, GAMMA, ct.ttms, ct.forwards,
                                                 device="cpu")
    np.testing.assert_allclose(nt, nj, rtol=1e-12)
    np.testing.assert_allclose(gt, gj, rtol=1e-12)
    assert np.all(nt > 0.0) and np.all(gt > 0.0)


def test_risk_premia_prices_and_ivols_match():
    _, ct = normalised_chains()
    _, pt = hawkes_pair(gamma=GAMMA)
    prices_j, ivols_j = jax_prices_and_vols("btc", GAMMA)
    prices_t, ivols_t = svt.HawkesJDPricer(device="cpu").compute_chain_prices_with_vols(ct, pt)
    for a, b, iv, ivj in zip(prices_t, prices_j, ivols_t, ivols_j):
        assert np.all(np.isfinite(a))
        assert np.max(np.abs(a - np.asarray(b))) <= 1e-10
        assert_same_nan_pattern(iv, ivj)
        np.testing.assert_allclose(iv, np.asarray(ivj), rtol=0.0, atol=1e-8)


def test_gamma_zero_reduces_to_standard_pricer():
    _, ct = normalised_chains()
    _, pt = hawkes_pair()
    _, pt0 = hawkes_pair(gamma=0.0)
    pricer = svt.HawkesJDPricer(device="cpu")
    for a, b in zip(pricer.price_chain(ct, pt0), pricer.price_chain(ct, pt)):
        np.testing.assert_allclose(a, b, rtol=0.0, atol=1e-12)


def test_fast_precision_matches_jax_fast():
    _, ct = btc_chains()
    _, pt = hawkes_pair()
    prices_j, ivols_j = jax_prices_and_vols("btc", precision="fast")
    pricer = svt.HawkesJDPricer(device="cpu")
    for a, b in zip(pricer.price_chain(ct, pt, precision="fast"), prices_j):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4)
    for a, b in zip(pricer.compute_model_ivols_for_chain(ct, pt, precision="fast"), ivols_j):
        b = np.asarray(b)
        assert_same_nan_pattern(a, b)
        np.testing.assert_allclose(a, b, rtol=0.0, atol=1e-5)
    with pytest.raises(NotImplementedError):
        pricer.price_chain(ct, pt, precision="bogus")


def test_phi_grid_with_real_phi_is_bit_exact():
    for real_phi in (None, -1.0, 0.25):
        t = tmgf.get_phi_grid(device="cpu", max_phi=th.MAX_PHI, vol_scaler=0.07, real_phi=real_phi)
        j = jmgf.get_phi_grid(max_phi=th.MAX_PHI, vol_scaler=0.07, real_phi=real_phi)
        np.testing.assert_array_equal(t.real.numpy(), np.asarray(j.re))
        np.testing.assert_array_equal(t.imag.numpy(), np.asarray(j.im))


def bsm_log_mgf(phi: torch.Tensor, vol: float, ttm: float) -> torch.Tensor:
    return 0.5 * vol * vol * ttm * phi * (phi + 1.0)


@pytest.mark.parametrize("real_phi", [-0.5, -0.8])
def test_slice_pricer_with_complex_kernel_matches_jax(real_phi):
    """the payoff kernel is picked from Re phi: real for -1/2, complex else.
    Both packages agree to 1e-13; at -1/2 the price is BSM's to 1e-6 (at
    -0.8 both sit 7.4e-5 above BSM: the JAX package's quadrature there)."""
    phi = tmgf.get_phi_grid(device="cpu", max_phi=th.MAX_PHI, vol_scaler=0.15, real_phi=real_phi)
    lm = bsm_log_mgf(phi, 0.6, 0.25)
    strikes = np.linspace(0.6, 1.6, 11)
    types = np.where(strikes >= 1.0, "C", "P")
    out = tmgf.vanilla_slice_pricer_with_mgf_grid(lm, phi, 1.0, strikes, types, 0.99).numpy()
    ref = np.asarray(jmgf.vanilla_slice_pricer_with_mgf_grid(to_cplx(lm), to_cplx(phi), 1.0,
                                                            strikes, types, 0.99))
    np.testing.assert_allclose(out, ref, rtol=0.0, atol=1e-13)
    if real_phi != -0.5:
        return
    bsm = svt.compute_bsm_vanilla_price(forward=torch.tensor(1.0, dtype=torch.float64),
                                        strike=torch.as_tensor(strikes), ttm=torch.tensor(0.25),
                                        vol=torch.tensor(0.6), optiontype=types,
                                        discfactor=torch.tensor(0.99)).numpy()
    np.testing.assert_allclose(out, bsm, rtol=0.0, atol=1e-6)


def test_gamma_slice_pricer_and_complex_weights_match_jax():
    phi = tmgf.get_phi_grid(device="cpu", max_phi=th.MAX_PHI, vol_scaler=0.15,
                            real_phi=-0.5 - GAMMA)
    lm = bsm_log_mgf(phi, 0.6, 0.25)
    strikes = np.linspace(0.6, 1.6, 11)
    types = np.where(strikes >= 1.0, "C", "P")
    kw = dict(risk_premia_gamma=GAMMA, ttm=0.25, forward=1.0, normalizer=0.97,
              gamma_forward=1.02, strikes=strikes, optiontypes=types)
    out = tmgf.slice_pricer_with_mgf_grid_with_gamma(log_mgf_grid=lm, phi_grid=phi, **kw).numpy()
    ref = np.asarray(jmgf.slice_pricer_with_mgf_grid_with_gamma(
        log_mgf_grid=to_cplx(lm), phi_grid=to_cplx(phi), **kw))
    np.testing.assert_allclose(out, ref, rtol=0.0, atol=1e-13)
    w = torch.complex(torch.linspace(-1.0, 2.0, 7, dtype=torch.float64),
                      torch.linspace(0.5, -3.0, 7, dtype=torch.float64))
    z = torch.complex(torch.linspace(-2.0, 1.0, 7, dtype=torch.float64),
                      torch.tensor([0.1, 3.0, float("nan"), -2.0, 8.0, 1e3, 0.0], dtype=torch.float64))
    out = float(tmgf._nansum_re(w, z))
    ref = float(jmgf._nansum_re(to_cplx(w), to_cplx(z)))
    assert out == pytest.approx(ref, rel=1e-15, abs=1e-15)
    with pytest.raises(NotImplementedError):
        tmgf.slice_pricer_with_mgf_grid_with_gamma(log_mgf_grid=lm, phi_grid=phi,
                                                   is_spot_measure=False, **kw)


def test_option_chain_helpers_match_jax():
    cj, ct = btc_chains()
    nj = JaxOptionChain.to_forward_normalised_strikes(cj)
    nt = svt.OptionChain.to_forward_normalised_strikes(ct)
    sj = JaxOptionChain.get_slices_as_chain(cj, ids=["1m", "2w"])
    st = svt.OptionChain.get_slices_as_chain(ct, ids=["1m", "2w"])
    for a, b in ((nt, nj), (st, sj)):
        np.testing.assert_array_equal(a.ttms, b.ttms)
        np.testing.assert_array_equal(a.forwards, b.forwards)
        np.testing.assert_array_equal(a.discfactors, b.discfactors)
        np.testing.assert_array_equal(np.asarray(a.ids), np.asarray(b.ids))
        for x, y in zip(a.strikes_ttms, b.strikes_ttms):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(a.optiontypes_ttms, b.optiontypes_ttms):
            np.testing.assert_array_equal(x.astype(str), np.asarray(y).astype(str))
        for x, y in zip(a.bid_ivs, b.bid_ivs):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(nt.forwards0, cj.forwards)


def test_scan_mc_matches_analytic_on_the_2w_slice():
    """the rule of ``tests/test_hawkes.py`` at 100000 paths, seed 11."""
    _, ct = btc_chains()
    _, pt = hawkes_pair()
    chain0 = svt.OptionChain.get_slices_as_chain(ct, ids=["2w"])
    pricer = svt.HawkesJDPricer(device="cpu")
    a = pricer.price_chain(chain0, pt)[0]
    m, s = pricer.model_mc_price_chain(chain0, pt, nb_path=100000, seed=11)
    tol = 4.0 * s[0] + 0.02 * a + 2e-4 * chain0.forwards[0]
    assert np.all(np.abs(a - m[0]) < tol)


def test_martingale():
    _, pt = hawkes_pair()
    x, lam_p, lam_m = svt.HawkesJDPricer(device="cpu").simulate_terminal_values(params=pt, ttm=0.25,
                                                                    nb_path=100000, seed=2)
    assert x.dtype == np.float64 and x.shape == (100000,)
    assert abs(np.mean(np.exp(x)) - 1.0) < 0.01
    assert np.all(lam_p >= 0) and np.all(lam_m >= 0)


def test_cuda_engine_on_cpu_matches_pallas_interpret():
    """both draw the same counter-hash stream; they differ by float32
    rounding (XLA's FMA contraction) only, which can flip a thinning test
    on a few paths.  Measured: largest gap 2.0e-6 standard errors (no path
    flipped), stderrs equal to 7.7e-8 relative; limits 1e-3 standard errors
    and 1e-5 relative."""
    cj, ct = btc_chains()
    pj, pt = hawkes_pair()
    n = 2
    kw = dict(nb_path=1 << 15, seed=24, engine="pallas")
    ref, ref_std = jh.hawkesjd_mc_chain_pricer(
        ttms=cj.ttms[:n], forwards=cj.forwards[:n], discfactors=cj.discfactors[:n],
        strikes_ttms=cj.strikes_ttms[:n], optiontypes_ttms=cj.optiontypes_ttms[:n],
        **kw, **pj.to_dict())
    out, out_std = svt.HawkesJDPricer(device="cpu").model_mc_price_chain(
        svt.OptionChain.get_slices_as_chain(ct, ids=ct.ids[:n]), pt, **dict(kw, engine="cuda"))
    for a, b, s, st in zip(out, ref, ref_std, out_std):
        assert np.all(np.abs(a - np.asarray(b)) <= 1e-3 * np.asarray(s))
        np.testing.assert_allclose(st, np.asarray(s), rtol=1e-5)


def test_pallas_is_an_alias_of_cuda():
    _, ct = btc_chains()
    _, pt = hawkes_pair()
    chain0 = svt.OptionChain.get_slices_as_chain(ct, ids=["2w"])
    kw = dict(nb_path=1000, seed=3)
    a, _ = svt.HawkesJDPricer(device="cpu").model_mc_price_chain(chain0, pt, engine="cuda", **kw)
    b, _ = svt.HawkesJDPricer(device="cpu").model_mc_price_chain(chain0, pt, engine="pallas", **kw)
    np.testing.assert_array_equal(a[0], b[0])


def test_params_from_to_dict():
    for gamma in (None, GAMMA):
        pj, pt = hawkes_pair("calm", gamma)
        assert pt == th.HawkesJDParams(**PARAM_SETS["calm"], risk_premia_gamma=gamma)
        assert pt.to_dict() == pj.to_dict()
        for name in ("compensator_p", "compensator_m", "jump1_cond", "jump2_cond",
                     "jumps_var_p", "jumps_var_m", "exp_jump_p", "exp_jump_m"):
            assert getattr(pt, name) == getattr(pj, name)
    assert th.set_vol_scaler(0.45, 0.04) == jh.set_vol_scaler(0.45, 0.04)
    assert svj.HawkesJDPricer is jh.HawkesJDPricer
    assert svt.HawkesJDParams() == svt.hawkes_params_from_numpy(jh.HawkesJDParams().to_dict())


def test_unported_options_raise():
    _, ct = btc_chains()
    _, pt = hawkes_pair()
    pricer = svt.HawkesJDPricer(device="cpu")
    with pytest.raises(NotImplementedError):
        pricer.model_mc_price_chain(ct, pt, engine="qmc", nb_path=256)
    with pytest.raises(NotImplementedError):
        pricer.price_chain(ct, pt, variable_type=svt.VariableType.Q_VAR)
    with pytest.raises(ValueError):
        pricer.calibrate_model_params_to_chain(ct, pt, method="bfgs")
