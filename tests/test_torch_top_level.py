"""The port's top-level names against the JAX package's.

``stochvolmodels_tpu/__init__.py`` is parsed with ``ast`` (no JAX import):
every name it exports must exist on ``stochvolmodels_torch``, except the
names that exist only because of the TPU, listed below.
"""
import ast
import fnmatch
from pathlib import Path

import pytest

import stochvolmodels_torch as svt

JAX_INIT = Path(__file__).resolve().parents[1] / "stochvolmodels_tpu" / "__init__.py"

# names that exist only because of the TPU (ROADMAP north star): complex
# numbers as (re, im) pairs, the float32 solvers, threefry keys, jitted
# wrappers and the mixed-precision reduction; patterns
TPU_ONLY = ("cplx", "df32*", "*_jit", "key_from_seed", "_nansum_re_mixed")
# the factor-HJM names, all ported
FACTOR_HJM_PORTED = ("Cheyette1D", "CheyettePEND", "FutSettleType", "Measure",
                     "MultiFactRateLogSvParams", "NelsonSiegel", "RateFutLogSVPricer",
                     "RateLogSVPricer", "RateLogSvParams", "TermStructure", "UnderlyingType",
                     "SwOptionChain", "FutOptionChain", "swaption_cube_greeks")


def jax_top_level_names():
    """(name, module it comes from) of every name the JAX package's
    ``__init__`` imports or assigns."""
    names = []
    for node in ast.parse(JAX_INIT.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names += [(a.asname or a.name, node.module) for a in node.names]
        elif isinstance(node, ast.Assign):
            names += [(t.id, None) for t in node.targets if isinstance(t, ast.Name)]
    return names


def is_excepted(name: str) -> bool:
    return any(fnmatch.fnmatchcase(name, p) for p in TPU_ONLY)


def test_the_jax_init_exports_many_names():
    names = jax_top_level_names()
    assert len(names) > 120, len(names)
    assert ("compute_bsm_vanilla_slice_prices", "stochvolmodels_tpu.ops.bsm") in names


def test_port_exports_every_top_level_name_of_the_jax_package():
    missing = [(n, m) for n, m in jax_top_level_names() if not hasattr(svt, n)
               and not is_excepted(n)]
    assert not missing, missing


def test_only_tpu_names_are_excepted():
    excepted = [n for n, _ in jax_top_level_names() if is_excepted(n)]
    assert all(n.startswith(("cplx", "df32", "key_from_seed", "_nansum")) or n.endswith("_jit")
               for n in excepted), excepted


@pytest.mark.parametrize("name", ["compute_bsm_vanilla_price_vector",
                                  "compute_bsm_vanilla_slice_prices",
                                  "compute_bsm_vanilla_delta_vector",
                                  "compute_bsm_vanilla_slice_deltas",
                                  "compute_bsm_vanilla_grid_deltas",
                                  "compute_bsm_vanilla_slice_vegas", "compute_bsm_slice_vegas",
                                  "infer_bsm_ivols_from_model_slice_prices",
                                  "infer_bsm_ivols_from_slice_prices",
                                  "compute_var_swap_strike"])
def test_the_ten_names_once_missing_resolve_to_the_ports_functions(name):
    fn = getattr(svt, name)
    assert callable(fn) and fn.__module__.startswith("stochvolmodels_torch."), fn


@pytest.mark.parametrize("name", FACTOR_HJM_PORTED)
def test_each_factor_hjm_name_resolves_to_the_ports_object(name):
    assert name in dict(jax_top_level_names()), f"{name} is not a JAX top-level name"
    obj = getattr(svt, name)
    assert obj.__module__.startswith("stochvolmodels_torch."), obj
