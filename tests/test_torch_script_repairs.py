"""Faults of the port's API that the example and paper scripts exposed,
each repaired in the port (``tests/test_torch_scripts_*.py`` run the
scripts themselves).

* ``OptionChain.get_slice_varswap_strikes``,
  ``fit_model_vol_backbone_to_varswaps`` and ``compute_histogram_data``
  returned the port's pandas-free ``SeriesLike``, which numpy's ufuncs and
  ``pd.concat`` refuse beside a pandas Series
  (``papers/forward_var/calibrate_forward_var.py`` takes
  ``np.maximum(varswaps, pd.Series(...))``;
  ``papers/logsv_model_with_quadratic_drift/article_figures.py`` concats
  histograms).  Where pandas is installed they now return a pandas Series,
  as the JAX package does, equal to its Series; without pandas (the card's
  machine) a ``SeriesLike``.
* The BSM analytics placed numpy inputs on a hard-coded CUDA device, so a
  caller could not ask for the CPU (``papers/inverse_options``).  The
  fallback is now ``_device_of``'s ``device`` default, CUDA, which a
  caller's CPU default reaches like every other ``device`` default.
* ``npdf``, ``ncdf``, ``erfcc`` and ``norm_ppf`` took tensors only
  (``papers/risk_premia_gmm/q_kernel.py`` passes numpy); they take
  array-likes as the JAX package's do.  ``strikes_to_delta`` of host
  inputs returned a tensor that pandas refuses as an index
  (``papers/sv_for_factor_hjm/calibration_fig_5_6_7.py``); it returns a
  numpy array for host inputs.
* ``LogSvParams`` printed its backbone as a (ttms, etas) pair and the
  backbone fit printed only its etas (``papers/forward_var``): the params
  hold the backbone as the Series they are given, and ``verbose=True``
  prints the market and model QV lines and the etas' Series, as the JAX
  package does.
"""
import inspect
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
from _torch_port import btc_chains, param_pair, svj, svt  # noqa: F401

from stochvolmodels_torch.ops import bsm
from stochvolmodels_torch.utils import funcs

REPO = Path(__file__).resolve().parents[1]


def test_varswap_strikes_are_a_series_that_numpy_takes_beside_a_series():
    cj, ct = btc_chains()
    ours, ref = ct.get_slice_varswap_strikes(), cj.get_slice_varswap_strikes()
    assert isinstance(ours, pd.Series)
    pd.testing.assert_index_equal(ours.index, ref.index)
    np.testing.assert_allclose(ours.to_numpy(), ref.to_numpy(), rtol=1e-12)
    # papers/forward_var/calibrate_forward_var.py:50-53
    floor_t = pd.Series(np.square(ct.get_chain_atm_vols()), index=ct.ttms)
    floor_j = pd.Series(np.square(cj.get_chain_atm_vols()), index=cj.ttms)
    both_t, both_j = np.maximum(ours, floor_t), np.maximum(ref, floor_j)
    assert isinstance(both_t, pd.Series)
    np.testing.assert_allclose(both_t.to_numpy(), both_j.to_numpy(), rtol=1e-12)


def test_backbone_fit_returns_a_series_the_params_take():
    cj, ct = btc_chains()
    pj, pt = param_pair(sigma0=0.88, theta=0.88, kappa1=2.2, kappa2=2.2, beta=0.0, volvol=0.92)
    ours = svt.fit_model_vol_backbone_to_varswaps(pt, ct.get_slice_varswap_strikes())
    ref = svj.fit_model_vol_backbone_to_varswaps(pj, cj.get_slice_varswap_strikes())
    assert isinstance(ours, pd.Series)
    np.testing.assert_allclose(ours.to_numpy(), ref.to_numpy(), rtol=1e-10)
    pt.set_vol_backbone(ours)
    np.testing.assert_allclose(pt.get_vol_backbone_etas(ct.ttms), ref.to_numpy(), rtol=1e-10)


def test_histograms_concat_as_pandas_series():
    data = np.random.default_rng(5).normal(size=2000)
    grid = np.linspace(-3.0, 3.0, 31)
    ours = [funcs.compute_histogram_data(data, grid, name=n) for n in ("a", "b")]
    assert all(isinstance(h, pd.Series) for h in ours)
    frame = pd.concat(ours, axis=1)
    assert list(frame.columns) == ["a", "b"] and frame.shape == (31, 2)


def test_without_pandas_the_series_are_series_like():
    child = (
        "import sys\n"
        "sys.modules['pandas'] = None\n"
        "import numpy as np\n"
        "from stochvolmodels_torch.utils import funcs\n"
        "s = funcs.to_series(np.arange(3.0), np.arange(3.0), name='x')\n"
        "assert isinstance(s, funcs.SeriesLike) and s.name == 'x', s\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", child], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_numpy_inputs_go_to_the_device_default():
    assert inspect.signature(bsm._device_of).parameters["device"].default == "cuda"
    assert bsm._device_of(np.ones(2)) == torch.device("cuda")
    assert bsm._device_of(np.ones(2), device="cpu") == torch.device("cpu")
    assert bsm._device_of(np.ones(2), torch.ones(1, dtype=torch.float64)) == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            bsm.compute_bsm_vanilla_price(np.ones(2), np.ones(2), np.ones(2), np.full(2, 0.5))


def test_a_cpu_default_reaches_the_numpy_bsm_calls(monkeypatch):
    """with ``_device_of``'s default set to the CPU, as a caller's CPU
    defaults set it, numpy inputs price on the CPU and equal the JAX
    package's prices."""
    monkeypatch.setattr(bsm._device_of, "__kwdefaults__", {"device": "cpu"})
    forwards = np.linspace(50000.0, 70000.0, 5)
    ours = bsm.compute_bsm_forward_grid_prices(0.1, forwards, 60000.0, 0.6, "C")
    ref = svj.compute_bsm_forward_grid_prices(0.1, forwards, 60000.0, 0.6, "C")
    assert ours.device == torch.device("cpu")
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-12)


def test_normal_helpers_take_numpy_as_the_jax_package_does(monkeypatch):
    from stochvolmodels_torch.ops import gauss

    monkeypatch.setattr(gauss._device_of, "__kwdefaults__", {"device": "cpu"})
    x = np.linspace(-4.0, 4.0, 9)
    for name in ("npdf", "ncdf", "erfcc"):
        ours, ref = getattr(gauss, name)(x), getattr(svj, name)(x)
        np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=1e-13, atol=1e-16)
    np.testing.assert_allclose(gauss.norm_ppf(np.array([0.1, 0.5, 0.9])).numpy(),
                               [-1.2815515655446004, 0.0, 1.2815515655446004], rtol=1e-12)


def test_strikes_to_delta_of_host_inputs_is_a_numpy_index(monkeypatch):
    from stochvolmodels_torch.ops import bachelier

    monkeypatch.setattr(bsm._device_of, "__kwdefaults__", {"device": "cpu"})
    strikes, ivols = np.array([0.03, 0.04, 0.05]), np.array([0.01, 0.011, 0.012])
    ours = bachelier.strikes_to_delta(strikes=strikes, ivols=ivols, f0=0.04, ttm=1.0)
    ref = svj.strikes_to_delta(strikes=strikes, ivols=ivols, f0=0.04, ttm=1.0)
    assert isinstance(ours, np.ndarray)
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=1e-13)
    assert list(pd.Series([1.0, 2.0, 3.0], index=ours).index) == list(ours)
    tensor = bachelier.strikes_to_delta(torch.as_tensor(strikes), torch.as_tensor(ivols), 0.04,
                                        torch.tensor(1.0, dtype=torch.float64))
    assert isinstance(tensor, torch.Tensor) and np.array_equal(tensor.numpy(), ours)


def test_params_print_their_backbone_as_the_jax_params_do(capsys):
    cj, ct = btc_chains()
    pj, pt = param_pair(sigma0=0.88, theta=0.88, kappa1=2.2, kappa2=2.2, beta=0.0, volvol=0.92)
    ours = svt.fit_model_vol_backbone_to_varswaps(pt, ct.get_slice_varswap_strikes(),
                                                  verbose=True)
    printed_t = capsys.readouterr().out
    ref = svj.fit_model_vol_backbone_to_varswaps(pj, cj.get_slice_varswap_strikes(),
                                                 verbose=True)
    printed_j = capsys.readouterr().out
    assert printed_t == printed_j and printed_t.startswith("market_qvar_dt=")
    pt.set_vol_backbone(ours)
    pj.set_vol_backbone(ref)
    assert pt.vol_backbone is ours
    assert str(pt.vol_backbone) == str(pj.vol_backbone)
    pair = svt.LogSvParams(vol_backbone=(ct.ttms, ours.to_numpy()))
    assert str(pair.vol_backbone) == str(pj.vol_backbone)
    np.testing.assert_array_equal(pair.get_vol_backbone_etas(ct.ttms),
                                  pt.get_vol_backbone_etas(ct.ttms))
