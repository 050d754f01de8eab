"""The rough kernel's quadrature rules and the exact-linear drift of the
PyTorch port against the JAX package (CPU, float64):

* every rule (unbounded L2, L1, Abi Jaber-El Euch, Alfonsi-Kebaier,
  Gaussian, Harms, the ``quadrature_rule`` dispatcher), the error
  functionals, the kernel measure's moments, ``mittag_leffler``,
  ``kernel_frac`` and ``kernel_rheston``: the same host numpy and scipy
  code, held to 1e-12;
* ``drift_ode_expm`` and ``strang_step(drift_scheme='expm')`` against the
  JAX functions on the same panels and normals, path by path to 1e-12
  relative;
* the rough kernel's plain version at N = 2, 4 and 5 nodes (the counts the
  new rules give) against the interpret-mode Pallas kernel, path by path at
  2^16 paths, with the limits ``tests/test_torch_rough.py`` holds N = 3 to:
  medians 1e-6, maxima 1e-3 (log-spot, absolute), 1e-4 and 1e-4 (vol and
  variance, relative);
* an 'expm' scan chain against the 'rk4' one within 4 stderr at the JAX
  test's step-resolved lift, and the 'cuda' engine refusing the 'expm'
  drift.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stochvolmodels_torch as svt
from stochvolmodels_torch.models.rough import kernel as tk
from stochvolmodels_torch.models.rough import simulation as tsim
from stochvolmodels_torch.ops import cuda_mc
from stochvolmodels_tpu.models.rough import kernel as jk
from stochvolmodels_tpu.models.rough import simulation as jsim
from stochvolmodels_tpu.ops import pallas_mc

BTC = dict(sigma0=0.8376, theta=1.0413, kappa1=3.1844, kappa2=3.058, beta=0.1514, volvol=1.8458)
VARTHETA = float(np.hypot(BTC["beta"], BTC["volvol"]))
KERNEL_KW = dict(sigma0=BTC["sigma0"], theta=BTC["theta"], kappa1=BTC["kappa1"],
                 kappa2=BTC["kappa2"], rho=BTC["beta"] / VARTHETA, volvol=VARTHETA)
MODES = ("european", "ol2", "ol1", "aje", "ak", "gaussian", "harms")


def _same(a, b):
    np.testing.assert_allclose(np.asarray(a, dtype=float), np.asarray(b, dtype=float),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("mode", MODES)
def test_quadrature_rules_match(mode):
    for H, N, T in ((0.1, 2, 0.5), (0.3, 3, 1.0)):
        nt, wt = tk.quadrature_rule(H, N, T, mode=mode)
        nj, wj = jk.quadrature_rule(H, N, T, mode=mode)
        _same(nt, nj)
        _same(wt, wj)
        _same(tk.kernel_l2_relative_error(H, nt, wt, T), jk.kernel_l2_relative_error(H, nj, wj, T))
        _same(tk.kernel_l1_relative_error(H, nt, wt, T), jk.kernel_l1_relative_error(H, nj, wj, T))
    with pytest.raises(NotImplementedError):
        tk.quadrature_rule(0.1, 2, 0.5, mode="simpson")


def test_named_rules_and_measure_match():
    for name in ("optimized_l2_rule", "l1_rule", "abi_jaber_el_euch_rule", "ak_geometric_rule",
                 "gaussian_rule", "harms_rule"):
        for a, b in zip(getattr(tk, name)(0.2, 4, 0.75), getattr(jk, name)(0.2, 4, 0.75)):
            _same(a, b)
    _same(tk.gaussian_rule(0.1, 4, 0.5, m=2), jk.gaussian_rule(0.1, 4, 0.5, m=2))
    _same(tk._mu_norm(0.15), jk._mu_norm(0.15))
    _same(tk._mu_moments(0.15, 0.5, 3.0), jk._mu_moments(0.15, 0.5, 3.0))


def test_mittag_leffler_and_discrete_kernels_match():
    z = np.array([-120.0, -30.0, -2.5, 0.0, 1.5])
    _same(tk.mittag_leffler(z, 0.6, 0.6), jk.mittag_leffler(z, 0.6, 0.6))
    _same(tk.mittag_leffler(-3.0, 1.0), np.exp(-3.0))
    ft, fj = tk.kernel_frac(0.1, 1.2), jk.kernel_frac(0.1, 1.2)
    _same(ft.K_0(0.01), fj.K_0(0.01))
    _same(ft.K_diag(0.01, 5), fj.K_diag(0.01, 5))
    rt, rj = tk.kernel_rheston(0.3, 1.5, 0.4), jk.kernel_rheston(0.3, 1.5, 0.4)
    _same(rt.K_0(0.05), rj.K_0(0.05))
    _same(rt.K_diag(0.05, 2), rj.K_diag(0.05, 2))
    _same(rt.xi([0.1, 0.3], 0.04, 1.5, 0.09), rj.xi([0.1, 0.3], 0.04, 1.5, 0.09))


def _panels(n, p, seed=3):
    nodes, weights = svt.european_rule(0.1, n, 0.5) if n > 1 else (np.array([1e-3]),
                                                                    np.array([1.0]))
    rng = np.random.default_rng(seed)
    z0 = 0.8 + 0.2 * rng.standard_normal((n, p))
    return nodes, weights, z0


@pytest.mark.parametrize("n_nodes", [1, 3])
def test_drift_ode_expm_matches_path_by_path(n_nodes):
    nodes, weights, z0 = _panels(n_nodes, 256)
    p = z0.shape[1]
    v0 = np.full_like(z0, BTC["sigma0"] / weights.sum())
    tile = lambda a: np.tile(a[:, None], (1, p))
    args = (BTC["theta"], BTC["kappa1"], BTC["kappa2"])
    ref = np.asarray(jsim.drift_ode_expm(jnp.asarray(tile(nodes)), jnp.asarray(v0), *args,
                                         jnp.asarray(z0), jnp.asarray(tile(weights)), 1.0 / 720))
    ours = tsim.drift_ode_expm(torch.as_tensor(nodes)[:, None], torch.as_tensor(v0), *args,
                               torch.as_tensor(z0), torch.as_tensor(weights)[:, None],
                               1.0 / 720).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=0)
    # the 'expm' Strang step over 10 steps on shared normals
    z = np.random.default_rng(4).standard_normal((10, 2, p))
    kw = dict(theta=BTC["theta"], kappa1=BTC["kappa1"], kappa2=BTC["kappa2"],
              rho=KERNEL_KW["rho"], volvol=VARTHETA, h=1.0 / 360)
    vj, yj, lj = jnp.asarray(v0), jnp.zeros(p), jnp.zeros(p)
    vt, yt, lt = torch.as_tensor(v0), torch.zeros(p, dtype=torch.float64), \
        torch.zeros(p, dtype=torch.float64)
    for k in range(10):
        vj, yj, lj = jsim.strang_step(jnp.asarray(tile(nodes)), jnp.asarray(tile(weights)),
                                      jnp.asarray(v0), log_s=lj, v=vj, y=yj,
                                      z0=jnp.asarray(z[k, 0]), z1=jnp.asarray(z[k, 1]),
                                      drift_scheme="expm", **kw)
        vt, yt, lt = tsim.strang_step(torch.as_tensor(nodes)[:, None],
                                      torch.as_tensor(weights)[:, None], torch.as_tensor(v0),
                                      log_s=lt, v=vt, y=yt, z0=torch.as_tensor(z[k, 0]),
                                      z1=torch.as_tensor(z[k, 1]), drift_scheme="expm", **kw)
    for t, j in ((vt, vj), (yt, yj), (lt, lj)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("n_nodes", [2, 4, 5])
def test_plain_version_matches_interpret_kernel_at_new_node_counts(n_nodes):
    nodes, weights = tk.gaussian_rule(0.1, n_nodes, 0.5)
    assert len(nodes) == n_nodes and np.all(weights > 0.0)
    n = 1 << 16
    kw = dict(KERNEL_KW, ttm=0.25, nodes=nodes, weights=weights)
    xj, vj, yj = map(np.asarray, pallas_mc.simulate_rough_terminal_pallas(
        seed=7, nb_path=n, interpret=True, **kw))
    xt, vt, yt = (t.numpy() for t in cuda_mc.simulate_rough_terminal_torch(7, n, device="cpu",
                                                                           **kw))
    x_abs, v_rel, y_rel = np.abs(xt - xj), np.abs(vt - vj) / vj, np.abs(yt - yj) / yj
    for gap in (x_abs, v_rel, y_rel):
        assert np.median(gap) <= 1e-6
    assert np.max(x_abs) <= 1e-3
    assert np.max(v_rel) <= 1e-4
    assert np.max(y_rel) <= 1e-4


def test_expm_chain_within_mc_error_of_rk4_chain():
    """at tests/test_rough_logsv.py's step-resolved lift (H 0.3, 2 nodes on
    [0, 1], 720 steps/yr), where both drift schemes are converged."""
    nodes, weights = tk.european_rule(0.3, 2, 1.0)
    kw = dict(ttms=np.array([0.1, 0.25]), forwards=np.ones(2), discfactors=np.ones(2),
              strikes_ttms=[np.array([0.9, 1.0, 1.1])] * 2,
              optiontypes_ttms=[np.array(['P', 'C', 'C'])] * 2, nodes=nodes, weights=weights,
              nb_path=8192, nb_steps_per_year=720, seed=11, device="cpu", **BTC)
    p_rk4, s_rk4 = svt.rough_logsv_mc_chain_pricer(drift_scheme="rk4", **kw)
    p_expm, s_expm = svt.rough_logsv_mc_chain_pricer(drift_scheme="expm", **kw)
    for a, b, sa, sb in zip(p_rk4, p_expm, s_rk4, s_expm):
        assert np.all(np.abs(a - b) < 4.0 * np.hypot(sa, sb))
    with pytest.raises(NotImplementedError):
        svt.rough_logsv_mc_chain_pricer(drift_scheme="expm", engine="cuda", **kw)
    with pytest.raises(NotImplementedError):
        svt.rough_logsv_mc_chain_pricer(drift_scheme="euler", **kw)
