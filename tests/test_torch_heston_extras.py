"""Heston beyond the plain 'scan' and 'cuda' MC, against the JAX package
(CPU, float64):

* the QMC Euler core on the JAX package's own Sobol panels (carried by
  ``interop.qmc_panels_from_numpy``), plain and replicated: path by path
  to 1e-12;
* the QMC chain against the Fourier prices within the band of
  ``tests/test_qmc.py::test_heston_qmc_chain_matches_analytic``
  (max(3 stderr, 2e-3)), and the padding of ``nb_path`` to the replicates;
* antithetic draws: the mirror pairs, and the paired stderr below the
  plain one at 100,000 paths (the LogSV test's size: the port's stream is
  not the JAX package's, so its call stderrs move by a few percent);
* analytic Q_VAR prices of the QV chain against the JAX package's,
  1e-10 x forward.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stochvolmodels_torch as svt
import stochvolmodels_tpu as svj
from stochvolmodels_torch import interop
from stochvolmodels_torch.models import heston as th
from stochvolmodels_tpu.models import heston as jh
from stochvolmodels_tpu.ops import qmc as jqmc
from stochvolmodels_tpu.ops.random import key_from_seed

CPU = torch.device("cpu")
QMC_PARAMS = dict(v0=0.04, theta=0.04, kappa=2.0, rho=-0.5, volvol=0.6)
ANTI = dict(ttms=np.array([0.25]), forwards=np.array([100.0]), discfactors=np.array([1.0]),
            strikes_ttms=[np.array([80.0, 90.0, 100.0, 110.0, 120.0])],
            optiontypes_ttms=[np.array(['P', 'P', 'C', 'C', 'C'])], v0=0.7, theta=0.9,
            kappa=2.5, rho=-0.3, volvol=1.2, nb_path=100000, seed=42)


@pytest.mark.parametrize("reps", [0, 4])
def test_qmc_core_on_jax_panels(reps):
    n, dt = 2048, 1.0 / 120.0
    panels = jqmc.qmc_scan_panels(key_from_seed(5), 12, per_step=2, dim_offset=26,
                                  nb_replicates=reps)
    x0, v0, q0 = np.zeros(n), np.full(n, 0.5), np.zeros(n)
    p = dict(theta=0.6, kappa=2.0, rho=-0.4, volvol=1.3)
    ref = jh._simulate_heston_terminal_qmc_core(
        *panels, jnp.asarray(x0), jnp.asarray(v0), jnp.asarray(q0), dt=dt,
        nb_replicates=reps, **p)
    ours = th._simulate_heston_terminal_qmc_core(
        *interop.qmc_panels_from_numpy(panels, device=CPU), torch.as_tensor(x0),
        torch.as_tensor(v0), torch.as_tensor(q0), dt=dt, nb_replicates=reps, **p)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12)


def test_qmc_chain_within_the_band_of_the_analytic_prices():
    ttms = np.array([0.5])
    strikes = [np.linspace(0.8, 1.2, 5)]
    types = [np.array(['P', 'P', 'C', 'C', 'C'])]
    chain = svt.OptionChain(ttms=ttms, forwards=np.ones(1), discfactors=np.ones(1),
                            strikes_ttms=strikes, optiontypes_ttms=types)
    analytic = svt.HestonPricer(device="cpu").price_chain(chain, svt.HestonParams(**QMC_PARAMS))
    p_qmc, s_qmc = th.heston_mc_chain_pricer(
        ttms=ttms, forwards=np.ones(1), discfactors=np.ones(1), strikes_ttms=strikes,
        optiontypes_ttms=types, nb_path=16384, seed=24, engine="qmc", device=CPU,
        **QMC_PARAMS)
    tol = np.maximum(3.0 * s_qmc[0], 2e-3)
    assert np.all(np.abs(p_qmc[0] - analytic[0]) < tol)
    # through the pricer, with nb_path padded up to a multiple of the replicates
    p_pad, s_pad = svt.HestonPricer(device="cpu").model_mc_price_chain(
        chain, svt.HestonParams(**QMC_PARAMS), nb_path=1001, engine="qmc", qmc_replicates=8)
    assert np.all(np.isfinite(p_pad[0])) and np.all(s_pad[0] > 0.0)


def test_antithetic_mirror_and_stderr():
    n = 64
    x, var, _ = th.simulate_heston_terminal(
        gen=svt.generator_from_seed(7, device=CPU), x0=torch.zeros(n, dtype=torch.float64),
        var0=torch.full((n,), 0.5, dtype=torch.float64), qvar0=torch.zeros(n, dtype=torch.float64),
        ttm=0.25, theta=0.5, kappa=2.0, rho=0.0, volvol=0.0, antithetic=True)
    # with no vol of vol the variance path is deterministic and x mirrors
    pair = (x[:32] + x[32:]).numpy()
    np.testing.assert_allclose(pair, pair[0], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(var[:32].numpy(), var[32:].numpy())
    p_plain, s_plain = th.heston_mc_chain_pricer(device=CPU, **ANTI)
    p_anti, s_anti = th.heston_mc_chain_pricer(device=CPU, antithetic=True, **ANTI)
    assert np.sum(s_anti[0]) < np.sum(s_plain[0])
    assert np.all(np.abs(p_plain[0] - p_anti[0]) < 4.0 * np.hypot(s_plain[0], s_anti[0]))


def test_qvar_prices_match_jax():
    cj = svj.get_qv_options_test_chain_data()
    ct = svt.get_qv_options_test_chain_data()
    params = dict(v0=0.6, theta=0.7, kappa=3.0, rho=-0.3, volvol=1.2)
    ref = svj.HestonPricer().price_chain(cj, svj.HestonParams(**params),
                                         variable_type=svj.VariableType.Q_VAR)
    ours = svt.HestonPricer(device="cpu").price_chain(ct, svt.HestonParams(**params),
                                                      variable_type=svt.VariableType.Q_VAR)
    for a, b, f in zip(ours, ref, ct.forwards):
        assert np.all(np.isfinite(a))
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-10 * f)
