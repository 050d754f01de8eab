"""The other paper scripts (``papers/`` outside the quadratic-drift LogSV
paper) run unchanged through the PyTorch port and through the JAX package,
on the CPU, by ``scripts/port_scripts.py``.

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
from _torch_scripts import check_done, check_entry, check_import, group, port_scripts, run_both

MODULES, TIER1, SLOW = group(["papers/forward_var/", "papers/il_hedging/",
                              "papers/inverse_options/", "papers/local_path.py",
                              "papers/risk_premia_gmm/", "papers/sv_for_factor_hjm/",
                              "papers/t_distribution/", "papers/volatility_models/"])
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


@pytest.mark.parametrize("vol_gap, objective_gap, ok", [(1.0, 1.0, True), (1.04, 1.08, True),
                                                        (3.0, 1.0, False), (1.0, 1.2, False),
                                                        (0.5, None, False)])
def test_a_parted_fit_is_held_to_the_jax_fit_error_and_objectives(vol_gap, objective_gap, ok):
    """a GMM fit that parts from the JAX one's (``FIT_QUALITY``, margins
    0.05 and 0.10) passes where its mean |model vol - mid| and each SLSQP
    objective stay within those margins of the JAX run's, and fails where
    its fit error is 3 times the JAX one's, an objective 1.2 times, or an
    optimizer call is missing."""
    name = "papers/risk_premia_gmm/run_gmm_fit.py::GMM_FIT"
    assert port_scripts.FIT_QUALITY[name] == (0.05, 0.10)
    xs, bid, ask = [0.9, 1.0, 1.1], [0.50, 0.45, 0.48], [0.54, 0.49, 0.52]
    pairs = lambda ys: [v for x, y in zip(xs, ys) for v in (x, y)]

    def record(gap, objectives):
        model = [(b + a) / 2.0 + gap for b, a in zip(bid, ask)]
        return dict(ok=True, returned=[], printed=[], objectives=objectives,
                    figures=[pairs(model), pairs(bid), pairs(ask)])

    ref = record(0.01, [1e-6, 2e-6])
    port = record(0.01 * vol_gap, [1e-6, 2e-6 * objective_gap] if objective_gap else [1e-6])
    verdict = port_scripts.judge(name, port, ref)
    assert verdict["jax_fit_error"] == pytest.approx(0.01)
    assert verdict["ok"] is ok, verdict
