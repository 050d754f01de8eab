"""Rough LogSV (Markovian lift) of the PyTorch port against the JAX package.

* ``european_rule`` nodes and weights to 1e-12 (the same numpy and scipy
  code: measured equal bit for bit);
* ``LogSvParams.approximate_kernel`` picks 1, 2 and 3 nodes for H = 0.5,
  0.45 and 0.1, the JAX package's nodes;
* ``strang_step`` against the JAX ``strang_step`` on the same numpy normals,
  20 steps in float64: elementwise |diff| <= 1e-12 |ref| (measured 1.3e-13);
* the rough kernel's plain version path by path against
  ``simulate_rough_terminal_pallas(interpret=True)`` at 2^16 paths, ttm
  0.25, for 1, 2 and 3 nodes.  Both draw the same counter-hash stream; XLA
  contracts to FMA and evaluates exp with other ulps.  Measured: medians
  of the absolute gap in log-spot <= 1.7e-7 and of the relative gap in the
  weighted vol and the integrated variance <= 2.3e-7; maxima 1.6e-4
  (log-spot, absolute), 2.2e-5 (vol) and 6.6e-6 (variance).  Limits:
  medians 1e-6, maxima 1e-3, 1e-4 and 1e-4;
* ``rough_logsv_mc_chain_pricer(engine='cuda')`` on the CPU (the plain
  version) against the JAX ``engine='pallas'`` on the BTC chain's first
  three slices at 2^14 paths: measured gap 1.2e-5 standard errors (the
  stderrs agree to 2.1e-7 relative), limits 5e-5 and 1e-6;
* ``LogSVPricer.model_mc_price_chain(use_rough_mc=True)`` with the
  degenerate lift (H = 0.5) against the analytic LogSV prices, the rule of
  ``tests/test_rough_logsv.py``: 4 stderr + 2% of the price + 2e-4 forward
  (the largest gap is 0.42 of that band for 'scan', 0.32 for 'cuda').
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import btc_chains, cuda_device, param_pair  # noqa: F401

import stochvolmodels_torch as svt
from stochvolmodels_tpu.models.logsv.params import LogSvParams as JaxLogSvParams
from stochvolmodels_tpu.models.rough import kernel as jkernel
from stochvolmodels_tpu.models.rough import simulation as jsim
from stochvolmodels_tpu.ops import pallas_mc
from stochvolmodels_torch.ops import cuda_mc

BTC_PARAMS = dict(sigma0=0.8376, theta=1.0413, kappa1=3.1844, kappa2=3.058,
                  beta=0.1514, volvol=1.8458)
# the kernel's arguments at the BTC parameters: rho = beta / vartheta
VARTHETA = float(np.hypot(BTC_PARAMS["beta"], BTC_PARAMS["volvol"]))
KERNEL_KW = dict(sigma0=0.8376, theta=1.0413, kappa1=3.1844, kappa2=3.058,
                 rho=BTC_PARAMS["beta"] / VARTHETA, volvol=VARTHETA)


def lift(n_nodes, T=0.43):
    if n_nodes == 1:
        return np.array([1e-3]), np.array([1.0])
    return svt.european_rule(0.1 if n_nodes == 3 else 0.45, n_nodes, T)


def first_slices(chain, n):
    return dict(ttms=chain.ttms[:n], forwards=chain.forwards[:n],
                discfactors=chain.discfactors[:n], strikes_ttms=chain.strikes_ttms[:n],
                optiontypes_ttms=chain.optiontypes_ttms[:n])


@pytest.mark.parametrize("H,N,T", [(0.1, 3, 0.43), (0.45, 2, 0.5), (0.2, 3, 1.0), (0.3, 2, 0.25)])
def test_european_rule_matches(H, N, T):
    nodes, weights = svt.european_rule(H, N, T)
    nodes_j, weights_j = jkernel.european_rule(H, N, T)
    np.testing.assert_allclose(nodes, nodes_j, rtol=1e-12)
    np.testing.assert_allclose(weights, weights_j, rtol=1e-12)
    assert np.all(nodes > 0) and np.all(np.diff(nodes) > 0) and np.all(weights > 0)
    assert np.all(nodes <= svt.models.rough.kernel.MAX_NODE)


@pytest.mark.parametrize("H,n_nodes", [(0.5, 1), (0.45, 2), (0.1, 3)])
def test_approximate_kernel_dispatch(H, n_nodes):
    kw = dict(sigma0=0.8, theta=1.0, kappa1=3.0, kappa2=3.0, beta=0.15, volvol=1.85, H=H)
    pt, pj = svt.LogSvParams(**kw), JaxLogSvParams(**kw)
    pt.approximate_kernel(T=0.5)
    pj.approximate_kernel(T=0.5)
    assert len(pt.nodes) == len(pt.weights) == n_nodes
    np.testing.assert_allclose(pt.nodes, pj.nodes, rtol=1e-12)
    np.testing.assert_allclose(pt.weights, pj.weights, rtol=1e-12)


def test_params_from_numpy_carries_the_lift():
    pj = JaxLogSvParams(**BTC_PARAMS, H=0.1)
    pj.approximate_kernel(T=0.43)
    pt = svt.params_from_numpy(pj.to_dict())
    assert pt.H == 0.1
    np.testing.assert_array_equal(pt.nodes, pj.nodes)
    np.testing.assert_array_equal(pt.weights, pj.weights)


@pytest.mark.parametrize("n_nodes", [1, 3])
def test_strang_step_matches_over_20_steps(n_nodes):
    nodes, weights = lift(n_nodes)
    n, p, h = len(nodes), 512, 1.0 / 360.0
    rng = np.random.default_rng(4)
    z = rng.standard_normal((20, 2, p))
    kw = dict(theta=1.0413, kappa1=3.1844, kappa2=3.058, rho=KERNEL_KW["rho"], volvol=VARTHETA)
    v0 = np.full((n, p), 0.8376 / weights.sum())
    panel = lambda a: np.tile(a[:, None], (1, p))
    nodes_j, weights_j = jnp.asarray(panel(nodes)), jnp.asarray(panel(weights))
    nodes_t, weights_t = torch.as_tensor(nodes)[:, None], torch.as_tensor(weights)[:, None]
    vj, yj, lj = jnp.asarray(v0), jnp.zeros(p), jnp.zeros(p)
    vt, yt, lt = torch.as_tensor(v0), torch.zeros(p, dtype=torch.float64), \
        torch.zeros(p, dtype=torch.float64)
    for k in range(20):
        vj, yj, lj = jsim.strang_step(nodes_j, weights_j, jnp.asarray(v0), log_s=lj, v=vj, y=yj,
                                      h=h, z0=jnp.asarray(z[k, 0]), z1=jnp.asarray(z[k, 1]), **kw)
        vt, yt, lt = svt.strang_step(nodes_t, weights_t, torch.as_tensor(v0), log_s=lt, v=vt,
                                     y=yt, h=h, z0=torch.as_tensor(z[k, 0]),
                                     z1=torch.as_tensor(z[k, 1]), **kw)
    for t, j in ((vt, vj), (yt, yj), (lt, lj)):
        j = np.asarray(j)
        assert np.all(np.abs(t.numpy() - j) <= 1e-12 * np.abs(j))


def rough_path_gaps(n_nodes, n=1 << 16, ttm=0.25):
    """(log-spot abs, weighted vol rel, integrated var rel) gaps of the
    plain version against the interpret-mode Pallas kernel."""
    nodes, weights = lift(n_nodes)
    kw = dict(KERNEL_KW, ttm=ttm, nodes=nodes, weights=weights)
    xj, vj, yj = map(np.asarray, pallas_mc.simulate_rough_terminal_pallas(
        seed=7, nb_path=n, interpret=True, **kw))
    xt, vt, yt = (t.numpy() for t in cuda_mc.simulate_rough_terminal_torch(7, n, device="cpu",
                                                                           **kw))
    return np.abs(xt - xj), np.abs(vt - vj) / vj, np.abs(yt - yj) / yj


@pytest.mark.parametrize("n_nodes", [1, 2, 3])
def test_plain_version_matches_interpret_kernel_path_by_path(n_nodes):
    x_abs, v_rel, y_rel = rough_path_gaps(n_nodes)
    for gap in (x_abs, v_rel, y_rel):
        assert np.median(gap) <= 1e-6
    assert np.max(x_abs) <= 1e-3
    assert np.max(v_rel) <= 1e-4
    assert np.max(y_rel) <= 1e-4


def test_plain_version_moments_match_scan_engine():
    """different random streams: the moment check of ``tests/test_pallas_mc.py``."""
    n, ttm = 1 << 14, 0.25
    nodes, weights = svt.european_rule(0.125, 3, ttm)
    args = dict(sigma0=1.0, theta=1.0, kappa1=2.0, kappa2=2.0, volvol=1.5, rho=0.1,
                nodes=nodes, weights=weights, ttm=ttm, device="cpu")
    xt, vt, yt = (t.double().numpy() for t in cuda_mc.simulate_rough_terminal_torch(7, n, **args))
    args.pop("device")
    log_s, v, y = svt.log_spot_full_combined(nb_path=n, gen=torch.Generator().manual_seed(7),
                                             **args)
    vw = (torch.as_tensor(weights)[:, None] * v).sum(0).numpy()
    log_s, y = log_s.numpy(), y.numpy()
    tol = 0.03
    assert np.all(np.isfinite(xt))
    assert abs(xt.mean() - log_s.mean()) < tol
    assert abs(xt.std() - log_s.std()) < 2.0 * tol
    assert abs(vt.mean() - vw.mean()) < tol
    assert abs(yt.mean() - y.mean()) < tol


def test_cuda_engine_on_cpu_matches_pallas_interpret():
    cj, ct = btc_chains()
    nodes, weights = lift(3)
    kw = dict(sigma0=0.8376, theta=1.0413, kappa1=3.1844, kappa2=3.058, beta=0.1514,
              volvol=1.8458, weights=weights, nodes=nodes, nb_path=1 << 14, seed=10)
    ref, ref_std = jsim.rough_logsv_mc_chain_pricer(engine="pallas", **first_slices(cj, 3), **kw)
    out, out_std = svt.rough_logsv_mc_chain_pricer(engine="cuda", device="cpu",
                                                   **first_slices(ct, 3), **kw)
    for a, b, s, st in zip(out, ref, ref_std, out_std):
        assert np.all(np.abs(a - np.asarray(b)) <= 5e-5 * np.asarray(s))
        np.testing.assert_allclose(st, np.asarray(s), rtol=1e-6)


def test_cuda_engine_restarts_every_slice_on_the_base_seed():
    """the shared-stream contract: a slice priced alone equals the same
    slice inside the chain."""
    _, ct = btc_chains()
    nodes, weights = lift(2)
    kw = dict(sigma0=0.8376, theta=1.0413, kappa1=3.1844, kappa2=3.058, beta=0.1514,
              volvol=1.8458, weights=weights, nodes=nodes, nb_path=1000, seed=5,
              nb_steps_per_year=120, engine="cuda", device="cpu")
    full, _ = svt.rough_logsv_mc_chain_pricer(**first_slices(ct, 3), **kw)
    chain = first_slices(ct, 3)
    alone, _ = svt.rough_logsv_mc_chain_pricer(**{k: v[2:3] for k, v in chain.items()}, **kw)
    np.testing.assert_array_equal(full[2], alone[0])


@pytest.mark.parametrize("engine,nb_path", [("scan", 1 << 15), ("cuda", 1 << 16)])
def test_degenerate_lift_matches_analytic_prices(engine, nb_path):
    _, ct = btc_chains()
    _, pt = param_pair(**BTC_PARAMS)
    pt.H = 0.5
    pt.approximate_kernel(T=float(np.max(ct.ttms)))
    pricer = svt.LogSVPricer(device="cpu")
    analytic = pricer.price_chain(ct, pt)
    mc, std = pricer.model_mc_price_chain(ct, pt, nb_path=nb_path, use_rough_mc=True, seed=42,
                                          engine=engine)
    for a, m, s in zip(analytic, mc, std):
        assert np.all(np.isfinite(m)) and np.all(s > 0.0)
        assert np.all(np.abs(a - m) < 4.0 * s + 0.02 * a + 2e-4 * ct.forwards[0])


def test_rough_h01_ivols_sane():
    """the rule of ``tests/test_rough_logsv.py`` for H = 0.1."""
    _, ct = btc_chains()
    _, pt = param_pair(**BTC_PARAMS, H=0.1)
    pt.approximate_kernel(T=float(np.max(ct.ttms)))
    mc, _ = svt.LogSVPricer(device="cpu").model_mc_price_chain(
        ct, pt, nb_path=1 << 14, use_rough_mc=True, seed=10, engine="cuda")
    for iv in ct.compute_model_ivols_from_chain_data(model_prices=mc, device="cpu"):
        finite = np.isfinite(iv)
        assert np.mean(finite) > 0.8
        assert np.all((iv[finite] > 0.3) & (iv[finite] < 2.5))


def test_rough_mc_refusals():
    _, ct = btc_chains()
    _, pt = param_pair(**BTC_PARAMS, H=0.1)
    with pytest.raises(ValueError, match="approximate_kernel"):
        svt.LogSVPricer(device="cpu").model_mc_price_chain(ct, pt, nb_path=256,
                                                           use_rough_mc=True)
    pt.approximate_kernel(T=0.43)
    with pytest.raises(NotImplementedError):
        svt.LogSVPricer(device="cpu").model_mc_price_chain(ct, pt, nb_path=256,
                                                           use_rough_mc=True, engine="qmc")
    with pytest.raises(NotImplementedError):
        svt.LogSVPricer(device="cpu").model_mc_price_chain(ct, pt, nb_path=256,
                                                           use_rough_mc=True, antithetic=True)
    kw = dict(KERNEL_KW, ttm=0.1, device="cpu")
    with pytest.raises(ValueError, match="1..5 nodes"):
        cuda_mc.simulate_rough_terminal_torch(1, 256, nodes=np.ones(6), weights=np.ones(6), **kw)
    with pytest.raises(ValueError, match="multiple of 128"):
        cuda_mc.simulate_rough_terminal_kernel(1, 100, nodes=[1e-3], weights=[1.0], **kw)
    launches = cuda_mc.simulate_rough_terminal_cuda.launches
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_mc.simulate_rough_terminal_cuda(1, 256, nodes=[1e-3], weights=[1.0], **kw)
    out = cuda_mc.simulate_rough_terminal_kernel(1, 256, nodes=[1e-3], weights=[1.0], **kw)
    ref = cuda_mc.simulate_rough_terminal_torch(1, 256, nodes=[1e-3], weights=[1.0], **kw)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0.0, atol=0.0)
    assert cuda_mc.simulate_rough_terminal_cuda.launches == launches


def test_pallas_is_an_alias_of_cuda():
    _, ct = btc_chains()
    _, pt = param_pair(**BTC_PARAMS, H=0.45)
    pt.approximate_kernel(T=0.43)
    kw = dict(nb_path=512, nb_steps=60, seed=3, use_rough_mc=True)
    a, _ = svt.LogSVPricer(device="cpu").model_mc_price_chain(ct, pt, engine="cuda", **kw)
    b, _ = svt.LogSVPricer(device="cpu").model_mc_price_chain(ct, pt, engine="pallas", **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("nb_path", [1 << 18, (1 << 16) + 128])
@pytest.mark.parametrize("n_nodes", [1, 2, 3])
def test_cuda_kernel_matches_plain_version(cuda_device, n_nodes, nb_path):  # noqa: F811
    """the kernel's drift takes FMAs, the plain version one rounding per
    operation: measured by chip_smoke.py on an H100 at 2^20 x 91 (3 nodes), max gaps 4.0e-6
    in x, 2.1e-5 in vw and 2.5e-6 in y, 0.18 of rtol = atol = 1e-4; where
    the factors nearly cancel in w.v the relative gap in vw reaches 1.5e-4.
    (1 << 16) + 128 paths leave the last block of 256 half empty."""
    nodes, weights = lift(n_nodes)
    kw = dict(KERNEL_KW, ttm=0.25, nodes=nodes, weights=weights, device=cuda_device)
    launches = cuda_mc.simulate_rough_terminal_cuda.launches
    out = cuda_mc.simulate_rough_terminal_cuda(9, nb_path, **kw)
    torch.cuda.synchronize()
    assert cuda_mc.simulate_rough_terminal_cuda.launches == launches + 1
    ref = cuda_mc.simulate_rough_terminal_torch(9, nb_path, **kw)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
