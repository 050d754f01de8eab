"""The Gaussian-mixture and Student-t terminal pricers of the PyTorch port
against the JAX package, on the bundled BTC chain, on the CPU.

* chain prices of both models at the same numpy parameters: 1e-12
  relative; the mixture's state densities: 1e-12;
* the per-slice SLSQP fits on the 2w slice against the JAX fits.  Student-t:
  parameters to 1e-5 and the objective at the fit to 1e-8 relative
  (measured: 1e-9 and 1.2e-13).  GMM: the 12-parameter SLSQP paths part by
  rounding over its 212 iterations (the objective and gradient agree to
  1e-10 at any one point, tests/test_torch_terminal_objectives.py): measured parameter gap 1.2e-4, and the port's
  fit lies 2.0e-7 relative below the JAX fit's objective; held to 5e-4 and
  to 1e-6 relative, the port's objective no higher than the JAX fit's by
  more than 1e-8 relative;
* the base ``ModelPricer.calibrate_model_params_to_chain`` raises, as the
  JAX package's does.
"""
import numpy as np
import pytest
from _torch_port import btc_chains, svj, svt

GMM = dict(gmm_weights=np.array([0.2, 0.5, 0.3]), gmm_mus=np.array([-0.8, 0.1, 0.4]),
           gmm_vols=np.array([1.1, 0.6, 0.8]), ttm=0.1)
TDIST = dict(drift=0.02, vol=0.85, nu=4.2, ttm=0.1)


def test_gmm_chain_prices_and_state_densities_match():
    cj, ct = btc_chains()
    pj = svj.GmmParams(**GMM)
    pt = svt.gmm_params_from_numpy(pj.to_dict())
    ref = svj.GmmPricer().price_chain(cj, pj)
    ours = svt.GmmPricer(device="cpu").price_chain(ct, pt)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o, r, rtol=1e-12)
    x = np.linspace(-1.5, 1.5, 31)
    for o, r in zip(pt.compute_state_pdfs(x), pj.compute_state_pdfs(x)):
        np.testing.assert_allclose(o, r, rtol=1e-12, atol=1e-300)
    assert pt.get_get_avg_vol() == pj.get_get_avg_vol()


def test_tdist_chain_prices_match():
    cj, ct = btc_chains()
    pj = svj.TdistParams(**TDIST)
    ref = svj.TdistPricer().price_chain(cj, pj)
    ours = svt.TdistPricer(device="cpu").price_chain(ct, svt.tdist_params_from_numpy(pj.to_dict()))
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o, r, rtol=1e-12)


def slice_pair(k=0):
    cj, ct = btc_chains()
    sid = cj.ids[k]
    return (svj.OptionChain.get_slices_as_chain(cj, ids=[sid]),
            svt.OptionChain.get_slices_as_chain(ct, ids=[sid]))


def fit_loss(pricer, chain, params) -> float:
    """the vega-weighted squared vol error of ``params`` on a one-slice chain,
    through the port (the objective both fits minimize)."""
    iv = chain.compute_model_ivols_from_chain_data(model_prices=pricer.price_chain(chain, params),
                                                   device="cpu")[0]
    mid = 0.5 * (chain.bid_ivs[0] + chain.ask_ivs[0])
    vegas = chain.get_chain_vegas()[0]
    ok = ~np.isnan(iv)
    return float(np.sum((vegas / np.sum(vegas))[ok] * (iv[ok] - mid[ok]) ** 2))


def test_tdist_slice_fit_matches_jax():
    cj, ct = slice_pair()
    pj = svj.TdistPricer().calibrate_model_params_to_chain_slice(cj)
    pricer = svt.TdistPricer(device="cpu")
    pt = pricer.calibrate_model_params_to_chain_slice(ct)
    np.testing.assert_allclose([pt.vol, pt.nu, pt.drift], [pj.vol, pj.nu, pj.drift],
                               rtol=0.0, atol=1e-5)
    ours = fit_loss(pricer, ct, pt)
    assert ours == pytest.approx(pricer.calibration_result.fun, rel=1e-12)
    assert ours == pytest.approx(fit_loss(pricer, ct, svt.tdist_params_from_numpy(pj.to_dict())),
                                 rel=1e-8)


def test_gmm_slice_fit_matches_jax_up_to_the_rounding_gap():
    cj, ct = slice_pair()
    pj = svj.GmmPricer().calibrate_model_params_to_chain_slice(cj)
    pricer = svt.GmmPricer(device="cpu")
    pt = pricer.calibrate_model_params_to_chain_slice(ct)
    flat = lambda p: np.concatenate([p.gmm_weights, p.gmm_mus, p.gmm_vols])
    np.testing.assert_allclose(flat(pt), flat(pj), rtol=0.0, atol=5e-4)
    np.testing.assert_allclose(np.sum(pt.gmm_weights), 1.0, atol=1e-10)
    assert np.all(np.diff(pt.gmm_mus) >= 0.0)
    ours = fit_loss(pricer, ct, pt)
    theirs = fit_loss(pricer, ct, svt.gmm_params_from_numpy(pj.to_dict()))
    assert ours == pytest.approx(theirs, rel=1e-6)
    assert ours <= theirs * (1.0 + 1e-8)


def test_base_pricer_calibration_raises():
    class Bare(svt.ModelPricer):
        def price_chain(self, option_chain, params, **kwargs):
            return []

    with pytest.raises(NotImplementedError):
        Bare(device="cpu").calibrate_model_params_to_chain(svt.get_btc_test_chain_data())
