"""The benchmark's plain reference of the Hawkes jump-diffusion MC
(``port_bench/reference/hawkes.py``) against the port, on the CPU.

(a) the port's MC chain with ``engine='cuda'`` (its kernel's plain version on
    the CPU) against the reference, on 5 parameter sets drawn around the BTC
    defaults with both stationarity margins positive, at 2^15 paths over the
    BTC chain's first two slices (184 steps at 1800 a year, the state
    carried): the widest price gap in reference standard errors, and the
    share of paths whose terminal x differs by more than 1e-3 (a thinning
    test decided otherwise moves a path by a whole jump, 0.03-0.2 in x);
(b) one reference step at 8 paths, worked by hand in float64 from the
    step's uniforms, with a jump forced on each side (and on both at once);
(c) under ``torch.profiler`` a Hawkes chain call (the first two slices) is
    one ``svt.mc_chain`` span that holds one ``svt.mc.path`` span a slice.
"""
import collections
import importlib
import importlib.util
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_port import svt  # noqa: F401

from stochvolmodels_torch.models import hawkes_jd
from stochvolmodels_torch.utils import profiling

BENCH_DIR = Path(__file__).resolve().parents[1] / "port_bench"


def _load(name: str, path: Path, package: bool = False):
    """the module (or package) at ``path`` under the private name ``name``,
    so that the benchmark's top-level names (``reference``, ``bench_lib``)
    never enter ``sys.path`` or shadow a module of another test."""
    if name not in sys.modules:
        where = dict(submodule_search_locations=[str(path)]) if package else {}
        spec = importlib.util.spec_from_file_location(
            name, path / "__init__.py" if package else path, **where)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


q = _load("_port_bench_quotes", BENCH_DIR / "bench_lib" / "quotes.py")
_load("_port_bench_reference", BENCH_DIR / "reference", package=True)
ref = importlib.import_module("_port_bench_reference.hawkes")
ref_mc = importlib.import_module("_port_bench_reference.mc")

CHAIN = BENCH_DIR / "data" / "btc_20211021.npz"
YEAR_STEPS = 1800
NB_PATH = 2 ** 15
# the published parameters that each draw moves by a factor in [0.85, 1.15]
MOVED = ("sigma", "shift_p", "mean_p", "shift_m", "mean_m", "lambda_p", "theta_p", "kappa_p",
         "beta1_p", "beta2_p", "lambda_m", "theta_m", "kappa_m", "beta1_m", "beta2_m")


def random_params(k: int) -> dict:
    """the BTC defaults, each moved by a seeded factor, redrawn until both
    stationarity margins are positive."""
    g = np.random.default_rng([21, k])
    base = hawkes_jd.HawkesJDParams()
    while True:
        fields = {n: float(getattr(base, n) * g.uniform(0.85, 1.15)) for n in MOVED}
        params = hawkes_jd.HawkesJDParams(mu=0.0, **fields)
        if params.jump1_cond > 0.0 and params.jump2_cond > 0.0:
            return {n: float(v) for n, v in params.to_dict().items() if v is not None}


def first_slices(n: int) -> dict:
    """the BTC chain's first ``n`` slices, as the benchmark loads the chain."""
    return {k: (v if k == "ticker" else v[:n]) for k, v in q.load(CHAIN).items()}


def terminal_states(monkeypatch, run, module, name):
    """run ``run()`` with ``module.name`` (a payoff of the terminal x) wrapped
    to keep each slice's terminal x; returns (run's result, the x's)."""
    kept, payoff = [], getattr(module, name)

    def keep(*args, **kwargs):
        x = kwargs["x0"] if "x0" in kwargs else args[0]
        kept.append(x.detach().clone())
        return payoff(*args, **kwargs)

    monkeypatch.setattr(module, name, keep)
    out = run()
    monkeypatch.undo()
    return out, kept


@pytest.mark.parametrize("k", range(5))
def test_port_chain_matches_the_reference(k, monkeypatch):
    params = random_params(k)
    quotes = first_slices(2)
    seed = 2 ** 31 + 97 * k
    (prices, _), xs = terminal_states(
        monkeypatch, lambda: hawkes_jd.HawkesJDPricer(device="cpu").model_mc_price_chain(
            q.option_chain(quotes), hawkes_jd.HawkesJDParams(**params), nb_path=NB_PATH,
            seed=seed, engine="cuda"), hawkes_jd, "compute_mc_vars_payoff")
    (rprices, rstds), rxs = terminal_states(
        monkeypatch, lambda: ref.mc_prices(quotes, params, NB_PATH, seed, YEAR_STEPS,
                                           device="cpu"), ref_mc, "payoffs")
    assert len(xs) == len(rxs) == 2
    # a path whose thinning test went the other way moves by a whole jump; the
    # plain version and the reference round the same float32 operations in
    # the same order, so none may
    for x, rx in zip(xs, rxs):
        flipped = torch.abs(x - rx[:NB_PATH]) > 1e-3
        assert float(flipped.double().mean()) == 0.0
    # the float64 payoffs reduce in another order (~1e-16 of a price); one
    # flipped path would move a price by ~1e-2 standard errors at 2^15 paths
    gap = max(float(np.max(np.abs(p - rp) / rs)) for p, rp, rs in zip(prices, rprices, rstds))
    assert gap <= 1e-8
    assert all(np.all(np.isfinite(p)) and np.all(p > 0.0) for p in prices)


def test_one_step_by_hand():
    params = {n: float(v) for n, v in hawkes_jd.HawkesJDParams().to_dict().items()
              if v is not None}
    n, seed, dt = 8, 2 ** 31 + 11, 1.0 / YEAR_STEPS
    a = ref.step_scalars(params, dt)
    u = [ref.Draws(seed, n, "cpu").uniform(0, s) for s in range(6)]
    un = [t.double().numpy() for t in u]
    inv_dt = 1.0 / dt
    threshold_p, threshold_m = -np.log(un[2]) * inv_dt, -np.log(un[3]) * inv_dt
    # forced: a jump up on paths 0 and 2, down on paths 1 and 2 (lambda at 1.5
    # times the threshold); paths 3-7 at the intensities' long-run levels
    lam_p = np.full(n, params["theta_p"])
    lam_m = np.full(n, params["theta_m"])
    lam_p[[0, 2]] = 1.5 * threshold_p[[0, 2]]
    lam_m[[1, 2]] = 1.5 * threshold_m[[1, 2]]
    x = np.linspace(-0.05, 0.05, n)
    state = tuple(torch.tensor(v, dtype=torch.float32) for v in (x, lam_p, lam_m))
    (x1, lp1, lm1), (fired_p, fired_m) = ref.euler_step(state, u, a, torch.float32)

    # by hand, in float64 from the float32 inputs
    x, lam_p, lam_m = (t.double().numpy() for t in state)
    hand_p, hand_m = lam_p > threshold_p, lam_m > threshold_m
    assert hand_p[[0, 2]].all() and hand_m[[1, 2]].all()
    np.testing.assert_array_equal(fired_p.numpy(), hand_p)
    np.testing.assert_array_equal(fired_m.numpy(), hand_m)
    z = np.sqrt(-2.0 * np.log(un[0])) * np.cos(math.pi * un[1])
    comp_p = math.exp(params["shift_p"]) / (1.0 - params["mean_p"]) - 1.0
    comp_m = math.exp(params["shift_m"]) / (1.0 - params["mean_m"]) - 1.0
    jump_p = np.where(hand_p, params["shift_p"] - np.log(un[4]) * params["mean_p"], 0.0)
    jump_m = np.where(hand_m, params["shift_m"] - np.log(un[5]) * params["mean_m"], 0.0)
    sigma = params["sigma"]
    x_hand = (x + (params["mu"] - 0.5 * sigma * sigma) * dt - comp_p * dt * lam_p
              - comp_m * dt * lam_m + sigma * math.sqrt(dt) * z + jump_p + jump_m)
    lp_hand = (lam_p + params["kappa_p"] * (params["theta_p"] - lam_p) * dt
               + params["beta1_p"] * jump_p + params["beta2_p"] * jump_m)
    lm_hand = (lam_m + params["kappa_m"] * (params["theta_m"] - lam_m) * dt
               + params["beta1_m"] * jump_p + params["beta2_m"] * jump_m)
    # float32 rounding of each operation and the polynomial ln (~3e-7
    # relative) against exact float64: 1e-5 of each term's scale
    scale = np.maximum(np.abs(lam_p), np.abs(lam_m))
    assert np.all(np.abs(x1.double().numpy() - x_hand) <= 1e-5)
    assert np.all(np.abs(lp1.double().numpy() - lp_hand) <= 1e-5 * scale)
    assert np.all(np.abs(lm1.double().numpy() - lm_hand) <= 1e-5 * scale)


def test_hawkes_chain_call_spans():
    pricer = hawkes_jd.HawkesJDPricer(device="cpu")
    chain = q.option_chain(first_slices(2))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        prices, _ = pricer.model_mc_price_chain(chain, hawkes_jd.HawkesJDParams(), nb_path=256,
                                                seed=5, engine="cuda")
    spans = sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name())
                   for ev in prof.profiler.kineto_results.events()
                   if ev.name().startswith("svt."))
    counts = collections.Counter(name for _, _, name in spans)
    assert counts[profiling.MC_CHAIN_SPAN] == 1
    # per slice: the path kernel, the payoff, strikes and codes up, prices and stderrs back
    assert counts[profiling.MC_PATH_SPAN] == len(chain.ttms) == 2
    assert counts[profiling.MC_PAYOFF_SPAN] == 2
    assert counts[profiling.UPLOAD_SPAN] == counts[profiling.FETCH_SPAN] == 4
    start, end, _ = next(s for s in spans if s[2] == profiling.MC_CHAIN_SPAN)
    assert all(start <= s and e <= end for s, e, _ in spans)
    assert len(prices) == 2
