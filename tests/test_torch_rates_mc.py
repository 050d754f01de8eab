"""The factor-HJM Monte Carlo of the PyTorch port against the JAX package,
on the CPU in float64:

* ``simulate_logsv_MF`` at injected normals (the matched-randoms hook ``W``),
  64 paths to two maturities (two segments), under the risk-neutral,
  annuity and T-forward measures and in the DLN branch: every state path by
  path, 1e-12;
* ``_futures_scan`` at the JAX package's own threefry normals (rebuilt
  here by its fold-in and split): 1e-12;
* ``calc_mc_vols`` (``factor_hjm_pricer``) and ``calc_futures_mc_vols`` at
  20,000 paths: the two packages draw different normals from one seed, so
  their vols are held within 4 combined MC standard errors;
* the port alone: the DLN branch at b = 0 reproduces the standard branch on
  one stream, a seed fixes the paths, and a maturity off the time grid
  raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_rates_core import as_numpy_dict, rate_param_pair

from stochvolmodels_tpu.models.factor_hjm import factor_hjm_pricer as jfp
from stochvolmodels_tpu.models.factor_hjm import rate_logsv_pricer as jrp
from stochvolmodels_tpu.models.factor_hjm.rate_factor_basis import NelsonSiegel as JNelsonSiegel
from stochvolmodels_tpu.models.factor_hjm.rate_logsv_params import (
    MultiFactRateLogSvParams as JParams,
)
from stochvolmodels_tpu.models.factor_hjm.rate_logsv_params import TermStructure as JTS
from stochvolmodels_tpu.ops.random import key_from_seed
from stochvolmodels_tpu.utils.rate_core import get_default_swap_term_structure
from stochvolmodels_torch import interop
from stochvolmodels_torch.models.factor_hjm import factor_hjm_pricer as tfp
from stochvolmodels_torch.models.factor_hjm import rate_logsv_pricer as trp

NB_PATH = 64
# 181 / 360 years: 182 steps at 360 steps/yr, so that half of it is a grid point
TTMS = np.array([181.0 / 720.0, 181.0 / 360.0])
NB_STEPS = 182


def states(nb_path=NB_PATH):
    return dict(x0=np.zeros((nb_path, 3)), y0=np.zeros((nb_path, 8)), I0=np.zeros(nb_path),
                sigma0=np.ones((nb_path, 1)))


def mf_kwargs(p, **kw):
    return dict(theta=p.theta, kappa1=p.kappa1, kappa2=p.kappa2, ts=p.ts, A=p.A, R=p.R, C=p.C,
                Omega=p.Omega, betaxs=p.beta.xs, volvolxs=p.volvol.xs, basis=p.basis,
                ccy="USD", **kw)


MEASURES = {
    "risk-neutral": dict(ts_sw=None, T_fwd=None),
    "annuity": dict(ts_sw=get_default_swap_term_structure(TTMS[-1], 5.0), T_fwd=None),
    "forward": dict(ts_sw=None, T_fwd=2.0),
}


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    import gc
    jax.clear_caches()
    gc.collect()


def normals():
    rng = np.random.default_rng(3)
    return rng.standard_normal((NB_STEPS, NB_PATH, 3)), rng.standard_normal((NB_STEPS, NB_PATH))


def assert_paths_match(ref, ours):
    for r_list, o_list in zip(ref, ours):
        assert len(o_list) == len(TTMS)
        for r, o in zip(r_list, o_list):
            r = np.asarray(r)
            assert o.shape == r.shape
            np.testing.assert_allclose(o, r, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("measure", list(MEASURES))
def test_paths_at_injected_normals_match(measure):
    pj, pt = rate_param_pair(beta_xs=np.tile([0.2, -0.1, 0.0], (3, 1)), volvol_xs=np.full(3, 0.5))
    W = normals()
    m = ["risk-neutral", "annuity", "forward"].index(measure) + 1
    ref = jrp.simulate_logsv_MF(ttms=TTMS, measure_type=jrp.Measure(m), W=W, nb_path=NB_PATH,
                                **states(), **mf_kwargs(pj, **MEASURES[measure]))
    ours = trp.simulate_logsv_MF(ttms=TTMS, measure_type=trp.Measure(m), W=W, nb_path=NB_PATH,
                                 device="cpu", **states(), **mf_kwargs(pt, **MEASURES[measure]))
    assert_paths_match(ref, ours)
    assert np.std(ours[0][-1][:, 0]) > 1e-4


def dln_pair():
    return rate_param_pair(beta_xs=np.zeros((3, 3)), volvol_xs=np.zeros(3), kappa1=0.0,
                           kappa2=0.0)


def test_dln_paths_at_injected_normals_match():
    pj, pt = dln_pair()
    W = normals()
    kw = dict(ttms=TTMS, W=W, nb_path=NB_PATH, bxs=np.array([0.5, 0.2, -0.3]))
    ref = jrp.simulate_logsv_MF(**kw, **states(), **mf_kwargs(pj, ts_sw=None, T_fwd=None))
    ours = trp.simulate_logsv_MF(**kw, device="cpu", **states(),
                                 **mf_kwargs(pt, ts_sw=None, T_fwd=None))
    assert_paths_match(ref, ours)


def test_dln_preconditions_raise():
    _, pt = rate_param_pair()
    with pytest.raises(AssertionError):
        trp.simulate_logsv_MF(ttms=TTMS, nb_path=NB_PATH, bxs=np.zeros(3), device="cpu",
                              **states(), **mf_kwargs(pt, ts_sw=None, T_fwd=None))


def test_dln_at_zero_b_is_the_standard_branch_and_a_seed_fixes_the_paths():
    _, pt = dln_pair()
    common = dict(basis_type="NELSON-SIEGEL", ccy="USD", ttms=np.array([0.5]), params=pt,
                  nb_path=256, seed=7, device="cpu", **states(256))
    xs_std, ys_std, Is_std, _ = tfp.do_mc_simulation(**common)
    xs_dln, ys_dln, Is_dln, _ = tfp.do_mc_simulation(bxs=np.zeros(3), **common)
    for a, b in ((xs_dln, xs_std), (ys_dln, ys_std), (Is_dln, Is_std)):
        np.testing.assert_allclose(a[-1], b[-1], rtol=0, atol=1e-12)
    again = tfp.do_mc_simulation(**common)[0][-1]
    other = tfp.do_mc_simulation(**dict(common, seed=8))[0][-1]
    assert np.array_equal(again, xs_std[-1]) and not np.array_equal(other, xs_std[-1])


def test_a_maturity_off_the_grid_raises():
    _, pt = rate_param_pair()
    with pytest.raises(IndexError):
        trp.simulate_logsv_MF(ttms=np.array([0.25, 0.5]), nb_path=8, device="cpu", **states(8),
                              **mf_kwargs(pt, ts_sw=None, T_fwd=None))


def test_futures_scan_at_the_jax_normals_matches():
    S, P, d = 10, 16, 3
    rng = np.random.default_rng(0)
    a0, eta, beta = (rng.normal(0.0, s, (S, d)) for s in (0.01, 0.01, 0.2))
    a1, adj = rng.normal(0.0, 0.01, S), rng.normal(0.0, 0.1, S)
    volvol = np.abs(rng.normal(0.3, 0.05, S))
    vartheta2 = np.einsum('sd,sd->s', beta, beta) + volvol ** 2
    key, dt = key_from_seed(5), 0.25 / S
    static = dict(dt=dt, sdt=float(np.sqrt(dt)), nb_path=P, d=d)
    init = (np.full(P, np.log(0.05 + 4.0)), np.zeros(P))
    panels = (a0, a1, adj, eta, beta, volvol, vartheta2)
    ref = jrp._futures_scan(tuple(map(jnp.asarray, init)),
                            (jnp.arange(S),) + tuple(map(jnp.asarray, panels)), key,
                            jnp.asarray(1.0), jnp.asarray(0.5), jnp.asarray(1.0), **static)
    keys = [jax.random.split(jax.random.fold_in(key, i)) for i in range(S)]
    W0 = np.stack([np.asarray(jax.random.normal(k[0], (P, d))) for k in keys])
    W1 = np.stack([np.asarray(jax.random.normal(k[1], (P,))) for k in keys])
    t = lambda a: torch.tensor(np.asarray(a, dtype=np.float64))
    ours = trp._futures_scan(tuple(map(t, init)), (torch.arange(S),) + tuple(map(t, panels)),
                             (t(W0), t(W1)), t(1.0), t(0.5), t(1.0), **static)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-12, atol=1e-12)


def vol_stderr(vols, ups):
    """the vol's MC standard error from its +1.96-stderr price's vol."""
    return np.abs(np.asarray(ups) - np.asarray(vols)) / 1.96


def test_mc_vols_within_stderr_of_jax():
    pj, pt = rate_param_pair(beta_xs=np.tile([0.15, -0.075, 0.0], (3, 1)),
                             volvol_xs=np.full(3, 0.6), kappa1=2.0, kappa2=2.0)
    f0 = 0.043
    strikes = np.array([f0 - 0.008, f0, f0 + 0.008])
    kw = dict(basis_type="NELSON-SIEGEL", ttm=1.0, tenors=np.array([1.0]),
              forwards=[np.array([f0])], strikes_ttms=[[strikes]],
              optiontypes=np.repeat('C', 3), is_annuity_measure=False, nb_path=20000, seed=42)
    _, vols_j, ups_j, _ = jfp.calc_mc_vols(params=pj, **kw)
    prices_t, vols_t, ups_t, downs_t = tfp.calc_mc_vols(params=pt, device="cpu", **kw)
    assert len(vols_t) == 1 and vols_t[0].shape == (3,) and np.all(np.isfinite(vols_t[0]))
    assert np.all(downs_t[0] <= vols_t[0]) and np.all(vols_t[0] <= ups_t[0])
    se = np.hypot(vol_stderr(vols_j[0], ups_j[0]), vol_stderr(vols_t[0], ups_t[0]))
    assert np.all(np.abs(vols_t[0] - np.asarray(vols_j[0])) <= 4.0 * se), (vols_t, vols_j, se)


def futures_params():
    """the futures fixture of ``tests/test_factor_hjm.py::TestFuturesMC``."""
    ttm = 75.0 / 365.0
    times = np.array([0.0, ttm])
    pj = JParams(sigma0=1.0, theta=1.0, kappa1=0.5, kappa2=1.0,
                 beta=JTS.create_multi_fact_from_vec(times, 0.2 * np.ones(3)),
                 volvol=JTS.create_from_scalar(times, 0.35),
                 A=np.array([0.012, 0.011, 0.010])[None, :] * np.ones((1, 1)),
                 R=np.array([[1.0, 0.99, 0.97], [0.99, 1.0, 0.98], [0.97, 0.98, 1.0]]),
                 basis=JNelsonSiegel(meanrev=0.55, key_terms=np.array([2.0, 5.0, 10.0])),
                 ccy="USD_NS", vol_interpolation="BY_YIELD")
    pj.q = pj.theta
    return ttm, pj, interop.rate_params_from_numpy(as_numpy_dict(pj))


def test_futures_mc_vols_within_stderr_of_jax():
    ttm, pj, pt = futures_params()
    strikes = np.array([0.052, 0.057, 0.062])
    kw = dict(strikes=strikes, optiontypes=np.array(['C'] * 3), nb_path=20000, seed=42)
    f0_j, vols_j, se_j = jrp.calc_futures_mc_vols(pj, ttm, ttm, ttm + 0.25, **kw)
    f0_t, vols_t, se_t = trp.calc_futures_mc_vols(pt, ttm, ttm, ttm + 0.25, device="cpu", **kw)
    assert vols_t.shape == (3,) and np.all(np.isfinite(vols_t))
    # vol stderr = price stderr / Bachelier vega
    vega = np.sqrt(ttm) * np.exp(-0.5 * ((f0_t - strikes) / (vols_t * np.sqrt(ttm))) ** 2) \
        / np.sqrt(2.0 * np.pi)
    se = np.hypot(se_j, se_t) / vega
    assert np.all(np.abs(vols_t - vols_j) <= 4.0 * se), (vols_t, vols_j, se)
    assert abs(f0_t - f0_j) <= 4.0 * np.sqrt(2.0) * 0.012 * np.sqrt(ttm) / np.sqrt(20000)
