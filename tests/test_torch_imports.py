"""Import hygiene of the PyTorch port.

``stochvolmodels_torch`` must import, and price, in a process where jax,
pandas, matplotlib and triton cannot be imported at all (the machine with
the card has none of jax, pandas and matplotlib; triton is imported only
inside the functions that launch a Triton kernel).  No module of the port
imports jax or the JAX package.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "stochvolmodels_torch"

_CHILD = r'''
import importlib.abc
import sys

BLOCKED = {"jax", "jaxlib", "pandas", "matplotlib", "triton", "stochvolmodels_tpu"}


class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"blocked import: {name}")
        return None


sys.meta_path.insert(0, _Block())
# as if not installed: an import raises, while importlib.util.find_spec (the
# probe torch makes when forward-mode AD first loads its compiler) says None
for name in BLOCKED:
    sys.modules[name] = None
import numpy as np
import stochvolmodels_torch as svt

chain = svt.get_btc_test_chain_data()
prices, ivols = svt.LogSVPricer(device="cpu").price_slice(
    params=svt.LOGSV_BTC_PARAMS, ttm=chain.ttms[0], forward=chain.forwards[0],
    strikes=chain.strikes_ttms[0], optiontypes=chain.optiontypes_ttms[0])
assert np.all(np.isfinite(prices)) and np.all((ivols > 0.5) & (ivols < 1.5)), ivols
heston = svt.HestonPricer(device="cpu").price_chain(chain, svt.BTC_HESTON_PARAMS)
assert all(np.all(np.isfinite(p)) for p in heston)
rough = svt.LogSvParams(**{**svt.LOGSV_BTC_PARAMS.to_dict(), "H": 0.1})
rough.approximate_kernel(T=float(chain.ttms[-1]))
mc, _ = svt.LogSVPricer(device="cpu").model_mc_price_chain(
    chain, rough, nb_path=256, nb_steps=60, use_rough_mc=True, engine="cuda")
assert all(np.all(np.isfinite(p)) for p in mc)
hawkes = svt.HawkesJDPricer(device="cpu")
hawkes_ivols = hawkes.compute_model_ivols_for_chain(chain, svt.HawkesJDParams())
assert all(np.all((iv > 0.2) & (iv < 2.0)) for iv in hawkes_ivols), hawkes_ivols
hawkes_mc, _ = hawkes.model_mc_price_chain(
    svt.OptionChain.get_slices_as_chain(chain, ids=["2w"]), svt.HawkesJDParams(), nb_path=256,
    engine="cuda")
assert np.all(np.isfinite(hawkes_mc[0]))
two = svt.OptionChain.get_slices_as_chain(chain, ids=["2w", "1m"])
_, heston_cost = svt.calibrate_heston_lm(two, svt.BTC_HESTON_PARAMS, nb_iters=1, device="cpu")
_, hawkes_cost = svt.calibrate_hawkesjd_lm_on_device(two, svt.HawkesJDParams(), nb_iters=1,
                                                     year_steps=60, device="cpu")
assert np.isfinite(heston_cost) and np.isfinite(hawkes_cost), (heston_cost, hawkes_cost)
logsv = svt.LogSVPricer(device="cpu")
qv = svt.OptionChain.get_slices_as_chain(svt.get_qv_options_test_chain_data(), ids=["1w"])
qv_prices = logsv.price_chain(qv, svt.LOGSV_BTC_PARAMS, variable_type=svt.VariableType.Q_VAR)
pdf = logsv.logsv_pdfs(svt.LOGSV_BTC_PARAMS, 0.1, svt.LOGSV_BTC_PARAMS.get_x_grid(0.1, n=20))
qmc, _ = logsv.model_mc_price_chain(two, svt.LOGSV_BTC_PARAMS, nb_path=256, engine="qmc")
backbone = svt.fit_model_vol_backbone_to_varswaps(svt.LOGSV_BTC_PARAMS,
                                                  chain.get_slice_varswap_strikes())
assert np.all(np.isfinite(qv_prices[0])) and np.isfinite(pdf).all() and np.isfinite(qmc[0]).all()
assert np.all(backbone.to_numpy() > 0.0), backbone
import torch
from stochvolmodels_torch.parallel.sweep import calibrate_heston_lm_sweep
ones = torch.ones(3, dtype=torch.float64)
normal = svt.infer_normal_implied_vol(ones, ones, ones, svt.compute_normal_price(ones, ones, ones,
                                                                                 0.05 * ones))
t_price = svt.compute_vanilla_price_tdist(1.0, ones, 0.25, 0.8)
gmm = svt.GmmPricer(device="cpu").price_chain(two, svt.GmmParams(
    np.array([0.5, 0.5]), np.zeros(2), np.array([0.5, 1.0]), 0.1))
tdist = svt.TdistPricer(device="cpu").price_chain(two, svt.TdistParams(0.0, 0.8, 4.0, 0.1))
(_, sweep_cost), = calibrate_heston_lm_sweep([two], svt.BTC_HESTON_PARAMS, nb_iters=1,
                                             device="cpu")
assert torch.allclose(normal, 0.05 * ones) and torch.isfinite(t_price).all(), (normal, t_price)
assert all(np.isfinite(p).all() for p in gmm + tdist) and np.isfinite(sweep_cost)
from stochvolmodels_torch.models.factor_hjm import logsv_chain_de_pricer, make_swaption_cube_fn
from stochvolmodels_torch.models.factor_hjm.fast_calibration import swaption_chain_to_cube
from stochvolmodels_torch.utils.funcs import SeriesLike
from stochvolmodels_torch.utils.rate_core import generate_ttms_grid
ts = np.array([0.0, 1.0, 2.0])
rates = svt.rate_params_from_numpy(dict(
    sigma0=1.0, theta=1.0, kappa1=1.0, kappa2=1.0, q=None, beta_ts=ts,
    beta_xs=np.array([[0.2, -0.1, 0.0]] * 2), volvol_ts=ts, volvol_xs=np.array([0.4, 0.3]),
    A=np.full(3, 0.01), R=np.eye(3), ccy="USD", basis="NELSON-SIEGEL", meanrev=0.25,
    key_terms=np.array([1.0, 5.0, 10.0])))
k = np.array([-0.01, 0.0, 0.01])
swaptions = svt.SwOptionChain(
    ccy="USD", ttms=np.array([1.0, 2.0]), tenors=np.array([1.0, 5.0]), ttms_ids=["1y", "2y"],
    tenors_ids=["1y", "5y"], forwards=[np.full(2, 0.04)] * 2, strikes_ttms=[[0.04 + k] * 2] * 2,
    bid_ivs=[[np.full(3, 0.01)] * 2] * 2, ask_ivs=[[np.full(3, 0.01)] * 2] * 2)
slices, fwds, strikes, _ = swaption_chain_to_cube(swaptions)
cube, mask = make_swaption_cube_fn(rates, slices, fwds, strikes, device="cpu")
panels, _ = svt.swaption_cube_greeks(rates, slices, fwds, strikes, greeks=("vega",),
                                     device="cpu")
_, de_ivols = logsv_chain_de_pricer(rates, generate_ttms_grid(np.array([1.0])), np.array([1.0]),
                                    [np.zeros(1)] * 3, [[k]] * 3, [np.repeat('C', 3)],
                                    device="cpu")
remapped = svt.SwOptionChain.remap_to_inc_delta(SeriesLike(values=k, index=np.array([0.25, 0.5, 0.75])))
assert torch.isfinite(cube(1.0, rates.beta.xs, rates.volvol.xs)).all() and mask.all()
assert np.all(panels["vega"] > 0.0) and np.all(np.isfinite(swaptions.get_chain_vegas()[0][0]))
assert all(np.all((iv[0] > 0.001) & (iv[0] < 0.05)) for iv in de_ivols), de_ivols
import stochvolmodels_torch.compat as compat
import stochvolmodels_torch.plotting.plots
import stochvolmodels_torch.plotting.pricer_plots
from stochvolmodels_torch.parallel.mesh import make_path_mesh, simulate_logsv_terminal_kernel_sharded
from stochvolmodels_torch.utils.profiling import annotate, wall_and_device_time
with wall_and_device_time() as wall, annotate("sharded_mc"):
    sharded = simulate_logsv_terminal_kernel_sharded(
        make_path_mesh(["cpu", "cpu"]), seed=1, nb_path=256, ttm=0.05, sigma0=0.8, theta=1.0,
        kappa1=2.0, kappa2=2.0, beta=0.2, volvol=1.5)
assert all(torch.isfinite(t).all() and t.shape == (256,) for t in sharded) and wall["wall_s"] > 0
assert compat.LogSVPricer is svt.LogSVPricer and "stochvolmodels" not in sys.modules
from stochvolmodels_torch.data import fetch_option_chain
try:
    fetch_option_chain.load_option_chain(options_data_dfs=object())
except ImportError as exc:
    assert "option-chain-analytics" in str(exc) and not fetch_option_chain.HAS_OCA, exc
loaded = sorted(m for m, mod in sys.modules.items() if m.split(".")[0] in BLOCKED and mod is not None)
assert not loaded, loaded
print("ok", len(prices))
'''


def test_port_imports_and_prices_without_jax_pandas_matplotlib_triton():
    """LogSV, Heston and Hawkes analytic prices, the rough and Hawkes MC's
    plain kernel versions, one Heston and one Hawkes LM iteration, the
    LogSV Q_VAR prices, a density, the QMC chain MC and the varswap
    backbone fit, a Bachelier price and implied vol, a Student-t price, the
    GMM and Student-t chain prices and one Heston LM sweep iteration, and
    the factor-HJM swaption cube, its vega, the adaptive tanh-sinh pricer on
    one expiry and the swaption chain's vegas and delta remap, and the
    mesh, profiling, plotting and compat modules (a path-sharded MC on a
    two-device CPU mesh inside a named region), and the chain-building
    module with its live fetch refused, in a process that cannot
    import jax, pandas, matplotlib or triton."""
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok 12"


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|stochvolmodels_tpu)\b", re.M)
    sources = sorted(PORT.rglob("*.py"))
    assert len(sources) >= 20
    offenders = [str(p.relative_to(REPO)) for p in sources if pattern.search(p.read_text())]
    assert not offenders, offenders


def test_chains_dir_lies_inside_the_port():
    """the port loads its chains from its own package data, never from the
    JAX package's directory."""
    from stochvolmodels_torch.data.sample_chains import CHAINS_DIR
    assert CHAINS_DIR.resolve().is_relative_to(PORT.resolve()), CHAINS_DIR
    assert sorted(p.name for p in CHAINS_DIR.glob("*.npz"))


def test_bundled_chains_equal_the_jax_packages_byte_for_byte():
    from stochvolmodels_torch.data.sample_chains import CHAINS_DIR
    jax_dir = REPO / "stochvolmodels_tpu" / "data" / "chains"
    ours = sorted(p.name for p in CHAINS_DIR.glob("*.npz"))
    assert ours == sorted(p.name for p in jax_dir.glob("*.npz"))
    for name in ours:
        assert (CHAINS_DIR / name).read_bytes() == (jax_dir / name).read_bytes(), name
