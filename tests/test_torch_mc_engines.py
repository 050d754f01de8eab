"""The Monte-Carlo engines of the PyTorch port beyond the plain 'scan' and
'cuda' paths, against the JAX package (CPU, float64):

* the payoff reducers (plain, Q_VAR, inverse, antithetic pairs, QMC
  replicates, with NaN paths) on the same paths: 1e-13; ``nanstd`` against
  ``jnp.nanstd`` at ddof 0 and 1: 1e-15 relative;
* Sobol direction numbers and gray codes: equal; Sobol words and uniforms
  given the same shift words: bit for bit;
* the QMC Euler core on the JAX package's own panels, plain and
  replicated: 1e-12;
* fixed-randoms chain prices, LogSV and rough, on the same numpy blocks:
  1e-12 x forward;
* streams that cannot match (the 'scan' generator, the QMC shifts, the vol
  paths) are held to the JAX tests' own oracles: the antithetic mirror and
  stderr reduction (``tests/test_antithetic.py``, at 100,000 paths: at its
  20,000 the call stderrs move by a few percent from stream to stream, more
  than the reduction), the QMC chain band
  against the Fourier price and the QMC fixed-randoms blocks against the QMC
  engine (``tests/test_qmc.py``), expected vol and QV against the analytic
  moments (``tests/test_logsv.py``);
* Q_VAR MC through the ``logsv_mc`` path (its plain version on the CPU)
  within 4 stderr + the Euler gap of the Fourier Q_VAR prices.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import README_PARAMS, param_pair

import stochvolmodels_torch as svt
import stochvolmodels_tpu as svj
from stochvolmodels_torch import interop
from stochvolmodels_tpu.config import VariableType as JVT
from stochvolmodels_tpu.models.logsv import pricer as jpricer
from stochvolmodels_tpu.ops import payoffs as jpay
from stochvolmodels_tpu.ops import qmc as jqmc
from stochvolmodels_tpu.ops.random import key_from_seed
from stochvolmodels_torch.config import VariableType as TVT
from stochvolmodels_torch.models.logsv import pricer as tpricer
from stochvolmodels_torch.models.logsv.vol_moments import (compute_analytic_qvar,
                                                           compute_expected_vol_t)
from stochvolmodels_torch.ops import payoffs as tpay
from stochvolmodels_torch.ops import qmc as tqmc
from stochvolmodels_torch.ops.random import antithetic_step_normals, generator_from_seed

CPU = torch.device("cpu")
TTMS = np.array([0.25])
FORWARDS = np.array([100.0])
DISCS = np.array([1.0])
STRIKES = [np.array([80.0, 90.0, 100.0, 110.0, 120.0])]
TYPES = [np.array(['P', 'P', 'C', 'C', 'C'])]
ANTI = dict(ttms=TTMS, forwards=FORWARDS, discfactors=DISCS, strikes_ttms=STRIKES,
            optiontypes_ttms=TYPES, v0=0.8, theta=0.9, kappa1=2.2, kappa2=2.2, beta=0.15,
            volvol=1.8, nb_path=100000, seed=42)


def _paths(n=4096, nan=True):
    rng = np.random.default_rng(5)
    x = rng.normal(-0.02, 0.2, n)
    qvar = rng.uniform(0.05, 0.4, n)
    if nan:
        x[[3, 700]] = np.nan
    return x, qvar


@pytest.mark.parametrize("ddof", [0, 1])
def test_nanstd_matches_jnp(ddof):
    a = np.random.default_rng(2).normal(size=(5, 301))
    a[0, :10] = np.nan
    a[2, :] = np.nan
    a[3, 1:] = np.nan
    ours = tpay.nanstd(torch.as_tensor(a), dim=1, ddof=ddof).numpy()
    ref = np.asarray(jnp.nanstd(a, axis=1, ddof=ddof))
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    np.testing.assert_allclose(ours, ref, rtol=1e-15)


@pytest.mark.parametrize("case", ["plain", "qvar", "inverse", "antithetic", "replicates"])
def test_payoff_reducers_match_jax(case):
    x, qvar = _paths()
    strikes = np.array([0.8, 0.95, 1.0, 1.05, 1.3]) * 100.0
    types = np.array(['P', 'P', 'C', 'C', 'C'])
    kw = dict(ttm=0.3, forward=100.0, strikes_ttm=strikes, optiontypes_ttm=types,
              discfactor=0.98)
    if case == "qvar":
        kw.update(variable_type=JVT.Q_VAR, strikes_ttm=np.array([0.1, 0.5, 0.9]),
                  optiontypes_ttm=np.array(['C', 'C', 'C']))
    if case == "inverse":
        kw.update(optiontypes_ttm=np.array(['IP', 'IP', 'IC', 'IC', 'IC']))
    if case == "antithetic":
        kw.update(antithetic=True)
    if case == "replicates":
        kw.update(nb_replicates=8)
    jp, js = jpay.compute_mc_vars_payoff(x0=x, sigma0=x, qvar0=qvar, **kw)
    if "variable_type" in kw:
        kw["variable_type"] = TVT.Q_VAR
    tp, ts = tpay.compute_mc_vars_payoff(x0=torch.as_tensor(x), sigma0=None,
                                         qvar0=torch.as_tensor(qvar), **kw)
    np.testing.assert_allclose(tp, np.asarray(jp), rtol=0, atol=1e-13)
    np.testing.assert_allclose(ts, np.asarray(js), rtol=0, atol=1e-13)


def test_sobol_tables_and_columns_bit_for_bit():
    np.testing.assert_array_equal(tqmc.sobol_direction_numbers(300),
                                  jqmc.sobol_direction_numbers(300))
    for reps in (0, 4):
        g = (jqmc.replicated_gray_codes(1024, reps) if reps else jqmc.gray_codes(1024))
        np.testing.assert_array_equal(tqmc.gray_codes(1024, reps, device=CPU).numpy(),
                                      np.asarray(g).astype(np.int64))
    gray_j = jqmc.gray_codes(2048)
    bits = tqmc.gray_bits(tqmc.gray_codes(2048, device=CPU))
    v = tqmc.sobol_direction_numbers(40)
    shifts = np.random.default_rng(9).integers(0, 1 << 32, 40, dtype=np.uint64).astype(np.uint32)
    for d in range(40):
        for dtype, jdtype in ((torch.float64, jnp.float64), (torch.float32, jnp.float32)):
            ours = tqmc.sobol_column(bits, torch.as_tensor(v[d].astype(np.int64)),
                                     int(shifts[d]), dtype).numpy()
            ref = np.asarray(jqmc.sobol_column(gray_j, jnp.asarray(v[d]), shifts[d], jdtype))
            np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("reps", [0, 4])
def test_qmc_core_on_jax_panels(reps):
    n, dt = 2048, 1.0 / 120.0
    panels = jqmc.qmc_scan_panels(key_from_seed(5), 12, per_step=2, dim_offset=26,
                                  nb_replicates=reps)
    x0, s0, q0 = np.zeros(n), np.full(n, 0.8), np.zeros(n)
    p = dict(theta=0.9, kappa1=2.0, kappa2=2.0, beta=0.2, volvol=1.5, vol_backbone_eta=1.1)
    ref = jpricer._simulate_logsv_terminal_qmc_core(
        *panels, jnp.asarray(x0), jnp.asarray(s0), jnp.asarray(q0), dt=dt, nb_replicates=reps,
        is_spot_measure=False, **p)
    ours = tpricer._simulate_logsv_terminal_qmc_core(
        *interop.qmc_panels_from_numpy(panels, device=CPU), torch.as_tensor(x0),
        torch.as_tensor(s0), torch.as_tensor(q0), dt=dt, nb_replicates=reps,
        is_spot_measure=False, **p)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12)


def test_fixed_randoms_logsv_and_rough_match_jax():
    cj = svj.get_btc_test_chain_data()
    ttms, fwds = cj.ttms[:2], cj.forwards[:2]
    chain_kw = dict(ttms=ttms, forwards=fwds, discfactors=cj.discfactors[:2],
                    strikes_ttms=cj.strikes_ttms[:2], optiontypes_ttms=cj.optiontypes_ttms[:2])
    W0s, W1s, dts = jpricer.get_randoms_for_chain_valuation(ttms, nb_path=4000, seed=3)
    tW0s, tW1s, tdts = tpricer.get_randoms_for_chain_valuation(ttms, nb_path=4000, seed=3)
    for a, b in zip(W0s + W1s, tW0s + tW1s):
        np.testing.assert_array_equal(a, b)
    assert dts == tdts
    p = dict(v0=0.8, theta=1.0, kappa1=3.0, kappa2=3.0, beta=0.2, volvol=1.8)
    etas = np.array([1.1, 0.95])
    jp, js = jpricer.logsv_mc_chain_pricer_fixed_randoms(
        W0s=W0s, W1s=W1s, dts=dts, vol_backbone_etas=etas, **chain_kw, **p)
    tp, ts = tpricer.logsv_mc_chain_pricer_fixed_randoms(
        W0s=W0s, W1s=W1s, dts=dts, vol_backbone_etas=etas, device=CPU, **chain_kw, **p)
    for a, b, c, d, f in zip(tp, jp, ts, js, fwds):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12 * f)
        np.testing.assert_allclose(c, d, rtol=0, atol=1e-12 * f)
    nodes, weights = svt.european_rule(0.1, 3, float(ttms[-1]))
    Z0, Z1, grids = jpricer.get_randoms_for_rough_vol_chain_valuation(ttms, nb_path=2000, seed=4)
    tZ0, tZ1, tgrids = tpricer.get_randoms_for_rough_vol_chain_valuation(ttms, nb_path=2000,
                                                                        seed=4)
    np.testing.assert_array_equal(Z0, tZ0)
    rough = dict(sigma0=0.8, theta=1.0, kappa1=3.0, kappa2=3.0, beta=0.2, orthog_vol=1.8,
                 weights=weights, nodes=nodes, timegrids=grids)
    jp, _ = jpricer.rough_logsv_mc_chain_pricer_fixed_randoms(Z0=Z0, Z1=Z1, **chain_kw, **rough)
    tp, _ = tpricer.rough_logsv_mc_chain_pricer_fixed_randoms(Z0=Z0, Z1=Z1, device=CPU,
                                                              **chain_kw, **rough)
    for a, b, f in zip(tp, jp, fwds):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12 * f)


def test_antithetic_mirror_and_stderr():
    w = antithetic_step_normals(generator_from_seed(1, device=CPU), (2, 10))
    np.testing.assert_array_equal(w[:, :5].numpy(), -w[:, 5:].numpy())
    with pytest.raises(ValueError):
        antithetic_step_normals(generator_from_seed(1, device=CPU), (2, 9))
    n = 64
    x, sigma, _ = tpricer.simulate_logsv_terminal(
        gen=generator_from_seed(7, device=CPU), x0=torch.zeros(n, dtype=torch.float64),
        sigma0=torch.full((n,), 0.5, dtype=torch.float64), qvar0=torch.zeros(n, dtype=torch.float64),
        ttm=0.25, theta=0.5, kappa1=2.0, kappa2=2.0, beta=0.0, volvol=0.0, antithetic=True)
    pair_sum = (x[:32] + x[32:]).numpy()
    np.testing.assert_allclose(pair_sum, pair_sum[0], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(sigma[:32].numpy(), sigma[32:].numpy())
    p_plain, s_plain = tpricer.logsv_mc_chain_pricer(device=CPU, **ANTI)
    p_anti, s_anti = tpricer.logsv_mc_chain_pricer(device=CPU, antithetic=True, **ANTI)
    assert np.sum(s_anti[0]) < np.sum(s_plain[0])
    assert np.all(np.abs(p_plain[0] - p_anti[0]) < 4.0 * np.hypot(s_plain[0], s_anti[0]))
    with pytest.raises(NotImplementedError):
        tpricer.logsv_mc_chain_pricer(device=CPU, engine="cuda", antithetic=True,
                                      **dict(ANTI, nb_path=1024))


def test_qmc_chain_band_and_fixed_blocks():
    """the JAX test's QMC band against the Fourier price (16k paths), and the
    materialized QMC blocks against the QMC engine on the same seed."""
    params = svt.LogSvParams(sigma0=0.9, theta=1.0, kappa1=4.0, kappa2=4.0, beta=0.15,
                             volvol=1.75)
    strikes = [np.linspace(0.7, 1.4, 8)]
    types = [np.array(['P', 'P', 'P', 'C', 'C', 'C', 'C', 'C'])]
    chain = svt.OptionChain(ttms=np.array([0.25]), forwards=np.ones(1), discfactors=np.ones(1),
                            strikes_ttms=strikes, optiontypes_ttms=types)
    analytic = svt.LogSVPricer(device=CPU).price_chain(chain, params)
    p_qmc, s_qmc = tpricer.logsv_mc_chain_pricer(
        ttms=chain.ttms, forwards=np.ones(1), discfactors=np.ones(1), strikes_ttms=strikes,
        optiontypes_ttms=types, v0=0.9, theta=1.0, kappa1=4.0, kappa2=4.0, beta=0.15,
        volvol=1.75, nb_path=16384, nb_steps_per_year=360, seed=24, engine="qmc", device=CPU)
    tol = np.maximum(3.0 * s_qmc[0], 2e-3)
    assert np.all(np.abs(p_qmc[0] - analytic[0]) < tol)
    ttms = np.array([0.1, 0.3])
    kw = dict(ttms=ttms, forwards=np.ones(2), discfactors=np.ones(2),
              strikes_ttms=[np.array([0.9, 1.0, 1.1])] * 2,
              optiontypes_ttms=[np.array(['P', 'C', 'C'])] * 2, theta=0.9, kappa1=3.0,
              kappa2=3.0, beta=0.2, volvol=1.5)
    W0s, W1s, dts = tpricer.get_qmc_randoms_for_chain_valuation(
        ttms=ttms, nb_path=2048, nb_steps_per_year=120, seed=7, device=CPU)
    p_fixed, _ = tpricer.logsv_mc_chain_pricer_fixed_randoms(W0s=W0s, W1s=W1s, dts=dts, v0=0.8,
                                                             device=CPU, **kw)
    p_qmc, _ = tpricer.logsv_mc_chain_pricer(v0=0.8, nb_path=2048, nb_steps_per_year=120,
                                             seed=7, engine="qmc", qmc_replicates=0,
                                             device=CPU, **kw)
    for a, b in zip(p_fixed, p_qmc):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12)


def test_vol_paths_and_terminal_qvar_vs_moments():
    params = svt.LogSvParams(sigma0=1.0, theta=1.0, kappa1=4.0, kappa2=4.0, beta=0.0,
                             volvol=1.75)
    pricer = svt.LogSVPricer(device=CPU)
    sigma_t, grid_t = pricer.simulate_vol_paths(params=params, ttm=1.0, nb_path=100000, seed=8)
    assert sigma_t.shape == (len(grid_t), 100000)
    np.testing.assert_allclose(np.mean(sigma_t[::60], axis=1),
                               compute_expected_vol_t(params=params, t=grid_t[::60]), atol=0.02)
    _, _, qvar = pricer.simulate_terminal_values(params=params, ttm=0.5, nb_path=100000, seed=3)
    assert abs(np.mean(qvar) - compute_analytic_qvar(params=params, ttm=0.5) * 0.5) < 0.01
    pdf = pricer.get_log_return_mc_pdf(ttm=0.1, params=params, x_grid=np.linspace(-1, 1, 21),
                                       nb_path=2000)
    assert abs(np.sum(pdf) - 1.0) < 1e-12 and np.all(pdf >= 0.0)


def test_qvar_mc_through_logsv_mc_path():
    """Q_VAR calls of the QV chain's 1w and 2w slices by the 'cuda' engine
    (its float32 plain version on the CPU): within 4 stderr + 1% of the
    Fourier price + 2e-4, the Euler gap at 360 steps/yr."""
    _, pt = param_pair(**README_PARAMS)
    chain = svt.OptionChain.get_slices_as_chain(svt.get_qv_options_test_chain_data(),
                                                ids=["1w", "2w"])
    pricer = svt.LogSVPricer(device=CPU)
    analytic = pricer.price_chain(chain, pt, variable_type=TVT.Q_VAR)
    mc, std = pricer.model_mc_price_chain(chain, pt, variable_type=TVT.Q_VAR, nb_path=1 << 14,
                                          engine="cuda", seed=3, nb_steps=360)
    for a, m, s in zip(analytic, mc, std):
        assert np.all(np.isfinite(m)) and np.all(s > 0.0)
        assert np.all(np.abs(m - a) < 4.0 * s + 0.01 * a + 2e-4), (m, a, s)
