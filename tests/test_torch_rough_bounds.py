"""``rough_mc``'s operation counts by node count, and the port's rough scan
chain against the JAX package's stored regression prices.

* ``cuda_mc.ROUGH_OPS_PER_STEP`` counts the float32 and integer operations
  a path-step of ``csrc/rough_mc.cu``'s ``template<int N>`` as a function of
  N; its N = 3 entry is the count the roofline bound always used, (317, 34),
  and ``OPS_PER_STEP["rough_mc"]`` stays that entry;
* ``tests/baselines/rough_logsv_btc.npz`` holds the JAX package's scan
  prices of the BTC chain (H = 0.1, 10,000 paths, seed 10).  The port's scan
  draws another stream, so its chain at the same settings is held to the
  baseline within 4 standard errors of the difference of two independent
  runs (sqrt(2) x the port's stderr), not path by path.
"""
from pathlib import Path

import numpy as np
import pytest

import stochvolmodels_torch as svt
from stochvolmodels_torch.ops import cuda_mc

BASELINE = Path(__file__).resolve().parent / "baselines" / "rough_logsv_btc.npz"


def test_rough_ops_at_three_nodes_are_the_counted_entry():
    assert cuda_mc.ROUGH_OPS_PER_STEP[3] == (317, 34)
    assert cuda_mc.OPS_PER_STEP["rough_mc"] == (317, 34)


@pytest.mark.parametrize("n", [1, 2, 4, 5])
def test_rough_ops_grow_by_one_nodes_work_per_node(n):
    """each node adds 71 float32 operations a path-step (two RK4 half steps'
    31 + 33, the diffusion's 3, the floor test's two dots' 4) and no
    integer one."""
    f32, i32 = cuda_mc.ROUGH_OPS_PER_STEP[n]
    assert (f32, i32) == (317 + 71 * (n - 3), 34)


def test_rough_scan_chain_within_mc_error_of_the_jax_baseline():
    chain = svt.get_btc_test_chain_data()
    params = svt.LogSvParams(sigma0=0.8376, theta=1.0413, kappa1=3.1844, kappa2=3.058,
                             beta=0.1514, volvol=1.8458, H=0.1)
    params.approximate_kernel(T=float(np.max(chain.ttms)))
    prices, stds = svt.LogSVPricer(device="cpu").model_mc_price_chain(
        chain, params, nb_path=10000, use_rough_mc=True, seed=10, engine="scan")
    with np.load(BASELINE) as z:
        baseline = [z[f"prices_{i}"] for i in range(len(chain.ttms))]
    for p, s, b in zip(prices, stds, baseline):
        assert p.shape == b.shape and np.all(s > 0.0)
        assert np.all(np.abs(p - b) < 4.0 * np.sqrt(2.0) * s), (p - b) / s
