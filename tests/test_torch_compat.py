"""The port's ``stochvolmodels`` compat surface (``stochvolmodels_torch/compat.py``).

Held against the JAX package's shim (``stochvolmodels/__init__.py``), so
that no reference tree is needed:

* every public name of the shim exists in ``compat`` and comes from the
  port;
* each function's parameter list starts with the shim's, by
  ``tests/test_shim_signatures.py``'s rule (extra parameters have
  defaults); each class has at least the shim's public methods;
* in a child process that cannot import jax, the JAX package, matplotlib
  or pandas, ``install()`` resolves ``stochvolmodels`` and every
  submodule path of the shim to the port, binds each as an attribute of
  its parent (as ``test_submodules_are_attributes`` asks of the shim), and
  prices through ``stochvolmodels`` names;
* ``examples/run_lognormal_sv_pricer.py:87-105``'s prices and vols (one
  vanilla, one slice, the uniform 1m/3m chain) through the port's names
  equal the shim's to 1e-10;
* ``install()`` raises once the JAX package's shim is imported, and
  importing ``compat`` alone registers nothing under ``stochvolmodels``.
"""
import inspect
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from _torch_port import svt  # noqa: F401

import stochvolmodels as shim
import stochvolmodels_torch.compat as compat

REPO = Path(__file__).resolve().parents[1]
SHIM_MODULE = type(shim)


def public_names():
    return sorted(n for n in dir(shim) if not n.startswith("_")
                  and not isinstance(getattr(shim, n), SHIM_MODULE))


def plain_params(sig):
    return [p for p, v in sig.parameters.items()
            if v.kind not in (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)]


def test_compat_exports_every_name_of_the_shim_from_the_port():
    names = public_names()
    assert len(names) >= 115, len(names)
    missing = [n for n in names if not hasattr(compat, n)]
    assert not missing, missing
    for n in names:
        obj = getattr(compat, n)
        module = getattr(obj, "__module__", None)
        if module is not None and (callable(obj) or inspect.isclass(obj)):
            assert module.startswith("stochvolmodels_torch."), (n, module)
    assert compat.__version__ == "1.2.2+torch"


FUNCTIONS = [n for n in public_names() if callable(getattr(shim, n))
             and not inspect.isclass(getattr(shim, n))]


@pytest.mark.parametrize("name", FUNCTIONS)
def test_signature_starts_with_the_shims(name):
    try:
        theirs, ours = inspect.signature(getattr(shim, name)), inspect.signature(getattr(compat, name))
    except (TypeError, ValueError):
        pytest.skip(f"{name} has no signature")
    want, got = plain_params(theirs), plain_params(ours)
    assert got[:len(want)] == want, (name, want, got)
    for extra in got[len(want):]:
        assert ours.parameters[extra].default is not inspect.Parameter.empty, (name, extra)


CLASSES = [n for n in public_names() if inspect.isclass(getattr(shim, n))]


@pytest.mark.parametrize("name", CLASSES)
def test_class_has_the_shims_public_methods(name):
    pub = lambda c: {m for m in dir(c) if not m.startswith("_")}
    missing = pub(getattr(shim, name)) - pub(getattr(compat, name))
    assert not missing, (name, sorted(missing))


_CHILD = r'''
import importlib.abc
import sys

BLOCKED = {"jax", "jaxlib", "stochvolmodels_tpu", "matplotlib", "pandas"}


class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"blocked import: {name}")
        return None


sys.meta_path.insert(0, _Block())
for name in BLOCKED:
    sys.modules[name] = None
import numpy as np
import stochvolmodels_torch.compat as compat

assert not any(k == "stochvolmodels" or k.startswith("stochvolmodels.") for k in sys.modules)
assert compat.install() is compat and compat.install() is compat
import stochvolmodels as sv
from stochvolmodels.pricers.logsv_pricer import LogSVPricer
from stochvolmodels.pricers.factor_hjm.rate_logsv_pricer import make_swaption_cube_fn
from stochvolmodels.utils.plots import vol_slice_fit

assert sv is compat and sv.__version__ == "1.2.2+torch"
for path, target in compat._ALIASES.items():
    module = sys.modules["stochvolmodels." + path]
    if target is None:
        assert module.__name__ == "stochvolmodels." + path, path
    else:
        assert module.__name__ == "stochvolmodels_torch." + target, (path, module.__name__)
for top in ("data", "pricers", "utils"):
    assert hasattr(sv, top), top
assert sv.data.option_chain.OptionChain is sv.OptionChain
assert hasattr(sv.utils, "funcs") and hasattr(sv.pricers, "factor_hjm")
assert sv.pricers.factor_hjm.rate_logsv_pricer.make_swaption_cube_fn is make_swaption_cube_fn
assert sv.pricers.analytic.bsm.infer_bsm_implied_vol is sv.infer_bsm_implied_vol
assert LogSVPricer is sv.LogSVPricer and callable(vol_slice_fit)
chain = sv.OptionChain.get_uniform_chain(ttms=np.array([0.083, 0.25]), ids=np.array(["1m", "3m"]),
                                         strikes=np.linspace(0.9, 1.1, 3))
params = sv.LogSvParams(sigma0=1.0, theta=1.0, kappa1=5.0, kappa2=5.0, beta=0.2, volvol=2.0)
prices, vols = LogSVPricer(device="cpu").compute_chain_prices_with_vols(option_chain=chain,
                                                                        params=params)
assert all(np.all(np.isfinite(v)) and np.all((v > 0.5) & (v < 2.0)) for v in vols), vols
loaded = sorted(m for m, mod in sys.modules.items() if m.split(".")[0] in BLOCKED and mod is not None)
assert not loaded, loaded
print("ok", len(compat._ALIASES))
'''


def test_install_resolves_every_alias_to_the_port_without_jax_or_plotting_packages():
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok 38"


def test_aliases_cover_every_path_of_the_shim():
    shim_paths = {k[len("stochvolmodels."):] for k in sys.modules
                  if k.startswith("stochvolmodels.")}
    assert shim_paths <= set(compat._ALIASES), sorted(shim_paths - set(compat._ALIASES))
    assert len(compat._ALIASES) == 38


PARAMS = dict(sigma0=1.0, theta=1.0, kappa1=5.0, kappa2=5.0, beta=0.2, volvol=2.0)


def test_the_examples_uniform_chain_prices_as_through_the_shim():
    """examples/run_lognormal_sv_pricer.py:87-105 through both surfaces."""
    out = {}
    for name, sv, pricer in (("shim", shim, shim.LogSVPricer()),
                             ("compat", compat, compat.LogSVPricer(device="cpu"))):
        params = sv.LogSvParams(**PARAMS)
        price, vol = pricer.price_vanilla(params=params, ttm=0.25, forward=1.0, strike=1.0,
                                          optiontype='C')
        prices, vols = pricer.price_slice(params=params, ttm=0.25, forward=1.0,
                                          strikes=np.array([0.9, 1.0, 1.1]),
                                          optiontypes=np.array(['P', 'C', 'C']))
        chain = sv.OptionChain.get_uniform_chain(ttms=np.array([0.083, 0.25]),
                                                 ids=np.array(['1m', '3m']),
                                                 strikes=np.linspace(0.9, 1.1, 3))
        chain_prices, chain_vols = pricer.compute_chain_prices_with_vols(option_chain=chain,
                                                                         params=params)
        out[name] = [np.atleast_1d(np.asarray(x, dtype=float)) for x in
                     (price, vol, prices, vols, *chain_prices, *chain_vols)]
    assert len(out["compat"]) == len(out["shim"]) == 8
    for t, j in zip(out["compat"], out["shim"]):
        assert np.all(np.isfinite(t))
        np.testing.assert_allclose(t, j, rtol=1e-10, atol=1e-12)


def test_install_raises_beside_the_jax_shim():
    assert sys.modules["stochvolmodels"] is shim
    with pytest.raises(RuntimeError, match="already imported"):
        compat.install()
    assert sys.modules["stochvolmodels"] is shim
