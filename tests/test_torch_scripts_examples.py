"""The example scripts (``examples/``) run unchanged through the PyTorch
port and through the JAX package, on the CPU, by ``scripts/port_scripts.py``.

Every in-reach module of the group imports through the port's redirect of
``stochvolmodels_tpu``.  Every entry (each script's own switch) runs on
both sides; what it returned, printed and drew is held to the JAX run
within its kind's tolerance (``port_scripts.TOLERANCES``: float64
analytics 1e-8 relative, SLSQP fits 1e-5, Monte Carlo bands 4 combined
standard errors), and the port side loads no jax and no module of the JAX
package.
The tier-1 entries share one interpreter a side; the slow ones (both sides
past ~20 s on one core, ``port_scripts.SLOW``) run alone, marked slow.
"""
import pytest
from _torch_scripts import check_done, check_entry, check_import, group, run_both

MODULES, TIER1, SLOW = group(["examples/"])
ids = lambda name: name.replace("::", "-")


@pytest.fixture(scope="module")
def sides():
    return run_both(TIER1, MODULES)


@pytest.mark.parametrize("path", MODULES, ids=ids)
def test_module_imports_through_the_port(path, sides):
    check_import(path, sides)


@pytest.mark.parametrize("name", TIER1, ids=ids)
def test_entry_matches_the_jax_run(name, sides):
    check_entry(name, sides)


def test_the_port_side_ran_on_the_cpu_without_jax(sides):
    check_done(sides)


@pytest.mark.slow
@pytest.mark.parametrize("name", SLOW, ids=ids)
def test_slow_entry_matches_the_jax_run(name):
    check_entry(name, run_both([name]))
