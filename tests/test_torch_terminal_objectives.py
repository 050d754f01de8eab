"""The calibration objectives of the terminal models, the port's against
the JAX package's, on the bundled BTC chain, on the CPU: the value and the
gradient at one parameter point, the quantities each per-slice SLSQP step
reads.

* Gaussian mixture (mixture prices, BSM bisection, vega weights) on the 2w
  slice: value and gradient against ``jax.value_and_grad``, 1e-10
  relative;
* Student-t on the 1m slice (drift implied by 50 Newton iterations, the
  incomplete beta's a-derivative by central differences, BSM implied vols):
  value 1e-10, gradient in (vol, nu) 1e-6 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from _torch_port import btc_chains, svj

from stochvolmodels_tpu.models.gmm import compute_gmm_vanilla_price as j_gmm_price
from stochvolmodels_tpu.ops import bsm as jbsm
from stochvolmodels_tpu.ops import tdist as jtd
from stochvolmodels_torch.models.gmm import compute_gmm_vanilla_price as t_gmm_price
from stochvolmodels_torch.ops import bsm as tbsm
from stochvolmodels_torch.ops import tdist as ttd

T = lambda a: torch.tensor(np.asarray(a, dtype=np.float64))
GMM = dict(gmm_weights=np.array([0.2, 0.5, 0.3]), gmm_mus=np.array([-0.8, 0.1, 0.4]),
           gmm_vols=np.array([1.1, 0.6, 0.8]))


def first_slice():
    cj, _ = btc_chains()
    return svj.OptionChain.get_slices_as_chain(cj, ids=[cj.ids[0]])


def test_gmm_objective_and_gradient_match_jax():
    cj = first_slice()
    strikes, types = cj.strikes_ttms[0], cj.optiontypes_ttms[0]
    ttm, fwd, disc = float(cj.ttms[0]), float(cj.forwards[0]), float(cj.discfactors[0])
    market = 0.5 * (cj.bid_ivs[0] + cj.ask_ivs[0])
    vegas = cj.get_chain_vegas()[0]
    w = vegas / np.sum(vegas)

    def jloss(p):
        prices = j_gmm_price(p[:3], p[3:6], p[6:], ttm, fwd, strikes, types, disc)
        iv = jbsm.infer_bsm_implied_vol(fwd, ttm, strikes, prices, disc, types)
        return jnp.sum(jnp.where(jnp.isnan(iv), 0.0, w * (jnp.nan_to_num(iv) - market) ** 2))

    def tloss(p):
        prices = t_gmm_price(p[:3], p[3:6], p[6:], ttm, fwd, torch.tensor(strikes), types, disc)
        iv = tbsm.infer_bsm_implied_vol(fwd, ttm, torch.tensor(strikes), prices, disc, types)
        clean = torch.where(torch.isnan(iv), torch.tensor(market), iv)
        return torch.sum(torch.where(torch.isnan(iv), 0.0,
                                     torch.tensor(w) * (clean - torch.tensor(market)) ** 2))

    x0 = np.concatenate([GMM["gmm_weights"], GMM["gmm_mus"], GMM["gmm_vols"]])
    ref_v, ref_g = jax.value_and_grad(jloss)(jnp.asarray(x0))
    p = torch.tensor(x0, requires_grad=True)
    value = tloss(p)
    (grad,) = torch.autograd.grad(value, p)
    np.testing.assert_allclose(float(value), float(ref_v), rtol=1e-10)
    ref_g = np.asarray(ref_g)
    np.testing.assert_allclose(grad.numpy(), ref_g, rtol=1e-10, atol=1e-10 * np.max(np.abs(ref_g)))


def test_tdist_objective_and_gradient_in_vol_and_nu_match_jax():
    cj, _ = btc_chains()
    k = 1
    strikes, types = cj.strikes_ttms[k], cj.optiontypes_ttms[k]
    ttm, forward, disc = float(cj.ttms[k]), float(cj.forwards[k]), float(cj.discfactors[k])
    market = 0.5 * (cj.bid_ivs[k] + cj.ask_ivs[k])
    w = np.linspace(0.5, 1.5, len(strikes))

    def jloss(pars):
        vol, nu = pars[0], pars[1]
        drift = jtd.imply_drift_tdist(rf_rate=0.0, vol=vol, nu=nu, ttm=ttm)
        prices = jtd.compute_vanilla_price_tdist(forward * disc, strikes, ttm, vol, nu, types,
                                                 drift, is_compute_risk_neutral_mu=False)
        iv = jbsm.infer_bsm_implied_vol(forward, ttm, strikes, prices, disc, types)
        return jnp.sum(jnp.where(jnp.isnan(iv), 0.0, w * (jnp.nan_to_num(iv) - market) ** 2))

    def tloss(pars):
        vol, nu = pars[0], pars[1]
        drift = ttd.imply_drift_tdist(rf_rate=0.0, vol=vol, nu=nu, ttm=ttm)
        prices = ttd.compute_vanilla_price_tdist(T(forward * disc), T(strikes), ttm, vol, nu,
                                                 types, drift, is_compute_risk_neutral_mu=False)
        iv = tbsm.infer_bsm_implied_vol(forward, ttm, T(strikes), prices, disc, types)
        clean = torch.where(torch.isnan(iv), T(market), iv)
        return torch.sum(torch.where(torch.isnan(iv), 0.0, T(w) * (clean - T(market)) ** 2))

    x0 = np.array([0.9, 4.0])
    ref_v, ref_g = jax.value_and_grad(jloss)(jnp.asarray(x0))
    pars = T(x0).requires_grad_(True)
    value = tloss(pars)
    (grad,) = torch.autograd.grad(value, pars)
    np.testing.assert_allclose(float(value), float(ref_v), rtol=1e-10)
    assert np.all(np.abs(np.asarray(ref_g)) > 1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_g), rtol=1e-6)
