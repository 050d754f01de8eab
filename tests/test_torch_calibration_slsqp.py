"""The port's SLSQP calibration (``LogSVPricer.calibrate_model_params_to_chain``)
against the JAX package's.

Both pricers hand scipy's ``minimize`` an objective with its gradient, a
start vector, bounds and inequality constraints.  A stand-in for
``minimize`` in each pricer module records what it is given, so the two
problems are held against each other without running the optimizer:

* for PARAMS4, 5 and 6 under every constraint type: the start vector and
  bounds are equal, and every constraint function agrees at two points;
* the vega-weighted PARAMS5 objective and its gradient (one backward
  through the RK4 and the bisection's implicit-function rule) at
  ``params0``, at the 720 steps/yr both run, to 1e-9 relative (the JAX side
  compiles for ~65 s on one core); the PARAMS4 and PARAMS6 objectives
  follow from it.
"""
import numpy as np
import pytest
from scipy.optimize import OptimizeResult

from _torch_port import btc_chains

import stochvolmodels_torch as svt
import stochvolmodels_torch.models.logsv.pricer as port_pricer
import stochvolmodels_tpu as svj
import stochvolmodels_tpu.models.logsv.pricer as jax_pricer

PARAMS0 = dict(sigma0=0.8, theta=1.0, kappa1=2.21, kappa2=2.18, beta=0.15, volvol=1.85)
TYPES = ("PARAMS4", "PARAMS5", "PARAMS6")


class Recorder:
    """a stand-in for scipy's ``minimize`` that records its arguments and
    returns the start vector."""

    def __init__(self):
        self.calls = []

    def __call__(self, fun, x0, jac=None, method=None, constraints=None, bounds=None,
                 options=None):
        self.calls.append(dict(fun=fun, x0=np.asarray(x0), method=method, bounds=bounds,
                               constraints=constraints, options=options))
        return OptimizeResult(x=np.asarray(x0), nfev=0, success=True)


def as_list(constraints):
    if constraints is None:
        return []
    return [constraints] if isinstance(constraints, dict) else list(constraints)


def recorded_problem(monkeypatch, mct: str, constraints: str):
    """(JAX call, port call) of the recorder for one calibration setting."""
    cj, ct = btc_chains()
    jax_rec, port_rec = Recorder(), Recorder()
    monkeypatch.setattr(jax_pricer, "minimize", jax_rec)
    monkeypatch.setattr(port_pricer, "minimize", port_rec)
    jax_pricer.LogSVPricer().calibrate_model_params_to_chain(
        cj, svj.LogSvParams(**PARAMS0),
        model_calibration_type=jax_pricer.LogsvModelCalibrationType[mct],
        constraints_type=jax_pricer.ConstraintsType[constraints])
    svt.LogSVPricer(device="cpu").calibrate_model_params_to_chain(
        ct, svt.LogSvParams(**PARAMS0),
        model_calibration_type=svt.LogsvModelCalibrationType[mct],
        constraints_type=svt.ConstraintsType[constraints])
    return jax_rec.calls[0], port_rec.calls[0]


@pytest.mark.parametrize("constraints", [c.name for c in svt.ConstraintsType])
@pytest.mark.parametrize("mct", TYPES)
def test_problem_matches_jax(monkeypatch, mct, constraints):
    j, t = recorded_problem(monkeypatch, mct, constraints)
    assert t["method"] == j["method"] == "SLSQP"
    np.testing.assert_array_equal(t["x0"], j["x0"])
    np.testing.assert_array_equal(np.asarray(t["bounds"]), np.asarray(j["bounds"]))
    assert t["options"] == j["options"]
    j_cons, t_cons = as_list(j["constraints"]), as_list(t["constraints"])
    assert len(t_cons) == len(j_cons) == {"UNCONSTRAINT": 0, "MMA_MARTINGALE": 1,
                                          "INVERSE_MARTINGALE": 1}.get(constraints, 2)
    other = j["x0"] * np.linspace(0.7, 1.4, j["x0"].size)
    for jc, tc in zip(j_cons, t_cons):
        assert tc["type"] == jc["type"] == "ineq"
        for x in (j["x0"], other):
            np.testing.assert_allclose(tc["fun"](x), jc["fun"](x), rtol=1e-15, atol=1e-15)


def test_objective_and_gradient_match_jax(monkeypatch):
    j, t = recorded_problem(monkeypatch, "PARAMS5", "UNCONSTRAINT")
    j_val, j_grad = j["fun"](j["x0"])
    t_val, t_grad = t["fun"](t["x0"])
    assert isinstance(t_val, float) and t_grad.dtype == np.float64
    np.testing.assert_allclose(t_val, j_val, rtol=1e-9)
    np.testing.assert_allclose(t_grad, j_grad, rtol=1e-9)


def test_params4_and_params6_objectives_follow_params5(monkeypatch):
    """the three layouts are one objective: PARAMS6 at kappa2 = kappa1 /
    theta is PARAMS5 (its gradient by the chain rule), and PARAMS4 is
    PARAMS6 with kappa1 and kappa2 held at params0's."""
    objective = {m: recorded_problem(monkeypatch, m, "UNCONSTRAINT")[1]["fun"] for m in TYPES}
    s0, th, k1, k2, b, vv = (PARAMS0[k] for k in ("sigma0", "theta", "kappa1", "kappa2",
                                                  "beta", "volvol"))
    v5, g5 = objective["PARAMS5"](np.array([s0, th, k1, b, vv]))
    v6, g6 = objective["PARAMS6"](np.array([s0, th, k1, k1 / th, b, vv]))
    np.testing.assert_allclose(v6, v5, rtol=1e-15)
    chain = np.array([g6[0], g6[1] - g6[3] * k1 / th ** 2, g6[2] + g6[3] / th, g6[4], g6[5]])
    np.testing.assert_allclose(g5, chain, rtol=1e-12)
    v4, g4 = objective["PARAMS4"](np.array([s0, th, b, vv]))
    v6, g6 = objective["PARAMS6"](np.array([s0, th, k1, k2, b, vv]))
    np.testing.assert_allclose(v4, v6, rtol=1e-15)
    np.testing.assert_allclose(g4, g6[[0, 1, 4, 5]], rtol=1e-12)
