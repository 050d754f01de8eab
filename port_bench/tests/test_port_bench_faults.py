"""
The check that decides ``correct`` fails what it must: each run here skips
the look for a card and drives the rest of a run at a size a CPU holds, with
the timed path broken underneath (a step that returns its state unchanged;
half of the batch left out, the mean taken over the rest; an answer altered
where it is produced), or with each control, the plain reference with one of
the configuration's precisions a step below, in the program's place.  A sound
run at the same size comes out correct.  (One chip: no exchange between
chips to leave out.)

    python -m pytest port_bench/tests -q
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
for _p in (ROOT, BENCH_DIR):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import json  # noqa: E402
import shutil  # noqa: E402

import run  # noqa: E402
import stochvolmodels_torch as svt  # noqa: E402
from stochvolmodels_torch.models import heston as heston_mod  # noqa: E402
from stochvolmodels_torch.models.logsv import fast_calibration, pricer as logsv_pricer  # noqa: E402
from bench_lib import cells  # noqa: E402
from bench_lib import quotes as q  # noqa: E402

SIZES = {"config": {"lm": {"nb_iters": 2, "year_steps": 30}},
         "traffic": {"nb_path": 4096, "checks": 1}}
MC_KERNEL = {"logsv": (logsv_pricer, "simulate_logsv_terminal_kernel"),
             "heston": (heston_mod, "simulate_heston_terminal_kernel")}
LM_MODULE = {"logsv": fast_calibration, "heston": heston_mod}
TARGETS = {"logsv": (fast_calibration, "_chain_targets"),
           "heston": (heston_mod, "_calibration_targets")}


# the Heston LM cell is left out of BENCHMARK.json (its runs spread too
# widely to bound); its entry, adapter and reference are held here, as a
# cell of a test root
EXTRA_CELLS = [{"name": "heston_btc.calib_lm", "config": "heston_btc", "traffic": "calib_lm",
                "chips": 1, "why": "a test cell"}]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = tmp_path_factory.mktemp("bench_root")
    shutil.copytree(BENCH_DIR, path / BENCH_DIR.name,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    known = {w["name"] for w in bench["workloads"]}
    bench["workloads"] += [c for c in EXTRA_CELLS if c["name"] not in known]
    (path / "BENCHMARK.json").write_text(json.dumps(bench))
    return path


def _run(cell: str, root: Path, seed: int = 2147483701) -> dict:
    return run.run(["--workload", cell, "--seed", str(seed), "--seconds", "0.3"],
                   device="cpu", overrides=SIZES, root=root)


def _model(cell: str) -> str:
    return cell.split("_")[0]


@pytest.mark.parametrize("cell", ["logsv_btc.mc_chain", "heston_btc.mc_chain",
                                  "logsv_btc.calib_lm", "heston_btc.calib_lm"])
def test_sound_run_is_correct(cell, root):
    result = _run(cell, root)
    assert result["correct"] is True, result["checks"]


@pytest.mark.parametrize("cell", ["logsv_btc.mc_chain", "heston_btc.mc_chain"])
def test_mc_state_unchanged_fails(cell, monkeypatch, root):
    module, name = MC_KERNEL[_model(cell)]
    monkeypatch.setattr(module, name, lambda seed, x0, qvar0, **kw:
                        (x0, kw.get("sigma0", kw.get("var0")), qvar0))
    assert _run(cell, root)["correct"] is False


@pytest.mark.parametrize("cell", ["logsv_btc.mc_chain", "heston_btc.mc_chain"])
def test_mc_half_the_paths_fails(cell, monkeypatch, root):
    module = MC_KERNEL[_model(cell)][0]
    payoff = module.compute_mc_vars_payoff

    def half(x0, sigma0, qvar0, **kw):
        n = x0.shape[0] // 2
        return payoff(x0=x0[:n], sigma0=sigma0[:n], qvar0=qvar0[:n], **kw)

    monkeypatch.setattr(module, "compute_mc_vars_payoff", half)
    assert _run(cell, root)["correct"] is False


@pytest.mark.parametrize("cell", ["logsv_btc.mc_chain", "heston_btc.mc_chain"])
def test_mc_altered_price_fails(cell, monkeypatch, root):
    module = MC_KERNEL[_model(cell)][0]
    payoff = module.compute_mc_vars_payoff

    def altered(**kw):
        prices, stds = payoff(**kw)
        prices = prices.copy()
        prices[0] *= 1.01
        return prices, stds

    monkeypatch.setattr(module, "compute_mc_vars_payoff", altered)
    assert _run(cell, root)["correct"] is False


@pytest.mark.parametrize("cell", ["logsv_btc.calib_lm", "heston_btc.calib_lm"])
def test_lm_state_unchanged_fails(cell, monkeypatch, root):
    module = LM_MODULE[_model(cell)]
    monkeypatch.setattr(module, "lm_minimize", lambda residuals, p0, lower, upper, nb_iters=16:
                        (p0, torch.sum(torch.square(residuals(p0)))))
    assert _run(cell, root)["correct"] is False


@pytest.mark.parametrize("cell", ["logsv_btc.calib_lm", "heston_btc.calib_lm"])
def test_lm_half_the_quotes_fails(cell, monkeypatch, root):
    module, name = TARGETS[_model(cell)]
    targets = getattr(module, name)

    def half(*args, **kw):
        out = list(targets(*args, **kw))
        w = out[3] if _model(cell) == "logsv" else out[2]   # the weight panel
        w = w.copy() if isinstance(w, np.ndarray) else w.clone()
        w[:, ::2] = 0.0
        if _model(cell) == "logsv":
            out[3] = w
        else:
            out[2] = w
        return tuple(out)

    monkeypatch.setattr(module, name, half)
    assert _run(cell, root)["correct"] is False


@pytest.mark.parametrize("cell", ["logsv_btc.calib_lm", "heston_btc.calib_lm"])
def test_lm_altered_answer_fails(cell, monkeypatch, root):
    name = "calibrate_logsv_lm_on_device" if _model(cell) == "logsv" else "calibrate_heston_lm"
    fit = getattr(svt, name)

    def altered(*args, **kw):
        params, cost = fit(*args, **kw)
        params.theta = params.theta * (1.0 + 1e-4)
        return params, cost

    monkeypatch.setattr(svt, name, altered)
    assert _run(cell, root)["correct"] is False


# (cell, control, paths): float32 payoffs fall short of float64 by an error
# that grows as the root of the paths in standard errors, so that control
# runs at 2^20 paths (on the card it reads 4.4e-4-8.1e-4 at the cells'
# 4,194,304; on the CPU 1.9e-4-3.2e-4 at 2^20)
CONTROL_CASES = [("logsv_btc.mc_chain", "bf16_state", 4096),
                 ("heston_btc.mc_chain", "bf16_state", 4096),
                 ("logsv_btc.mc_chain", "f32_payoffs", 2 ** 20),
                 ("heston_btc.mc_chain", "f32_payoffs", 2 ** 20),
                 ("logsv_btc.calib_lm", "float32", None),
                 ("heston_btc.calib_lm", "float32", None)]


@pytest.mark.parametrize("cell, control, nb_path", CONTROL_CASES)
def test_control_in_the_programs_place_fails(cell, control, nb_path, monkeypatch, root):
    """each control of the entry, the reference with one of the
    configuration's precisions a step below (MC: bfloat16 path state, or
    float32 payoffs; LM: float32), stands in for the program's call."""
    resolved = cells.resolve(cell, root=root)
    ref = resolved.reference()
    model = _model(cell)
    dtypes = resolved.entry().CONTROLS[control]

    def quotes_of(chain):
        return dict(ttms=chain.ttms, forwards=chain.forwards, discfactors=chain.discfactors,
                    strikes=chain.strikes_ttms, types=chain.optiontypes_ttms,
                    bid_ivs=chain.bid_ivs, ask_ivs=chain.ask_ivs)

    if cell.endswith("mc_chain"):
        def control_mc(self, chain, params, nb_path=0, seed=0, nb_steps=360, **kw):
            fields = {k: getattr(params, k) for k in resolved.config["params"]}
            return ref.mc_prices(quotes_of(chain), fields, nb_path, seed, nb_steps,
                                 dtype=dtypes[0], payoff_dtype=dtypes[1], device="cpu")

        cls = svt.LogSVPricer if model == "logsv" else svt.HestonPricer
        monkeypatch.setattr(cls, "model_mc_price_chain", control_mc)
    else:
        name = "calibrate_logsv_lm_on_device" if model == "logsv" else "calibrate_heston_lm"
        params_cls = svt.LogSvParams if model == "logsv" else svt.HestonParams
        keys = ("sigma0", "theta", "kappa1", "beta", "volvol") if model == "logsv" else \
            ("v0", "theta", "kappa", "rho", "volvol")

        def control_fit(chain, params0, nb_iters=16, year_steps=360, device="cpu", **kw):
            start = {k: getattr(params0, k) for k in resolved.config["lm"]["params0"]}
            best, cost = ref.fit(quotes_of(chain), start, nb_iters, year_steps,
                                 dtype=dtypes, device="cpu")
            fields = dict(zip(keys, (float(v) for v in best)))
            if model == "logsv":
                fields["kappa2"] = fields["kappa1"] / fields["theta"]
            return params_cls(**fields), cost

        monkeypatch.setattr(svt, name, control_fit)
    sizes = run._merge(SIZES, {"traffic": {"nb_path": nb_path}} if nb_path else {})
    result = run.run(["--workload", cell, "--seed", "2147483701", "--seconds", "0.3"],
                     device="cpu", overrides=sizes, root=root)
    assert result["correct"] is False


def test_request_inputs_follow_the_seed():
    cell = cells.resolve("logsv_btc.calib_lm")
    entry = cell.entry().Entry(cell, 2 ** 31 + 5, "cpu", cell.config, cell.traffic)
    again = cell.entry().Entry(cell, 2 ** 31 + 5, "cpu", cell.config, cell.traffic)
    (qa, pa), (qb, pb) = entry.make(3), again.make(3)
    assert pa == pb and all(np.array_equal(a, b) for a, b in zip(qa["bid_ivs"], qb["bid_ivs"]))
    (qc, pc) = entry.make(4)
    assert pc != pa and not np.array_equal(qc["bid_ivs"][0], qa["bid_ivs"][0])
    for b, a in zip(qa["bid_ivs"], qa["ask_ivs"]):
        assert np.all(a > b) and np.all(b > 0.3)
    assert q.request_seed(2 ** 31 + 5, 0, 3) == q.request_seed(2 ** 31 + 5, 0, 3)
