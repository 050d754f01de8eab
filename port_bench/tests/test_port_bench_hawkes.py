"""
CPU tests of the cell ``hawkes_btc.mc_chain``: it resolves to its files; a
sound run at a CPU size reads ``correct``; each fault reads ``correct``
false (a path loop that returns its state unchanged, half of the paths left
out of the payoffs, one price altered by 1 %), and so does each control of
the entry in the program's place; the adapter's frozen operation count is
the kernel's base count plus its branches at the measured shares, and the
yardstick counts the steps the launches take.

    python -m pytest port_bench/tests -q
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
for _p in (ROOT, BENCH_DIR):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import torch  # noqa: E402

import run  # noqa: E402
import stochvolmodels_torch as svt  # noqa: E402
from stochvolmodels_torch.models import hawkes_jd  # noqa: E402
from stochvolmodels_torch.ops import cuda_mc  # noqa: E402
from bench_lib import cells, yardstick  # noqa: E402
from bench_lib import quotes as q  # noqa: E402
from reference import mc as ref_mc  # noqa: E402

CELL = "hawkes_btc.mc_chain"
SIZES = {"traffic": {"nb_path": 4096, "checks": 1}}
SEED = 2147483701


def _run(sizes=SIZES) -> dict:
    return run.run(["--workload", CELL, "--seed", str(SEED), "--seconds", "0.3"], device="cpu",
                   overrides=sizes)


def test_cell_resolves_to_its_files():
    cell = cells.resolve(CELL)
    assert cell.config["model"] == "hawkes" and cell.traffic["entry"] == "mc_chain"
    assert cell.spec["chips"] == 1 and cell.config["reduced"] == [] and cell.config["assumed"]
    assert set(cell.config["params"]) == set(hawkes_jd.HawkesJDParams().to_dict()) - {
        "risk_premia_gamma"}
    adapter = cell.model()
    assert adapter.PATH_KERNEL == "hawkes_mc_kernel" and adapter.MC_YEAR_STEPS == 1800
    assert cell.config["mc"]["year_steps"] == hawkes_jd.MC_STEPS_PER_YEAR
    with pytest.raises(ValueError):
        adapter.Program("cpu").mc(None, cell.config["params"], 128, 1, 360)
    with pytest.raises(NotImplementedError):
        cell.reference().fit()
    assert set(cell.config["limits"]["mc_chain"]) == {"price_gap_se", "stderr_gap"}
    names = {m["name"] for m in cell.end_to_end + cell.per_layer}
    assert {"setup_s", "mc_chain_ms", "mc_chain_p95_ms", "mc_kernel_roofline", "mc_chain_mfu",
            "payoff_device_ms", "device_idle.mc_chain", "mc_host_copies",
            "mc_sync_idle_ms"} == names


def test_sound_run_is_correct():
    result = _run()
    assert result["correct"] is True, result["checks"]


def test_state_unchanged_fails(monkeypatch):
    monkeypatch.setattr(hawkes_jd, "simulate_hawkesjd_terminal_kernel",
                        lambda seed, x0, lambda_p0, lambda_m0, **kw: (x0, lambda_p0, lambda_m0))
    assert _run()["correct"] is False


def test_half_the_paths_fails(monkeypatch):
    payoff = hawkes_jd.compute_mc_vars_payoff

    def half(x0, sigma0, qvar0, **kw):
        n = x0.shape[0] // 2
        return payoff(x0=x0[:n], sigma0=sigma0[:n], qvar0=qvar0[:n], **kw)

    monkeypatch.setattr(hawkes_jd, "compute_mc_vars_payoff", half)
    assert _run()["correct"] is False


def test_altered_price_fails(monkeypatch):
    payoff = hawkes_jd.compute_mc_vars_payoff

    def altered(**kw):
        prices, stds = payoff(**kw)
        prices = prices.copy()
        prices[0] *= 1.01
        return prices, stds

    monkeypatch.setattr(hawkes_jd, "compute_mc_vars_payoff", altered)
    assert _run()["correct"] is False


@pytest.mark.parametrize("control", ["bf16_state", "f32_payoffs"])
def test_control_in_the_programs_place_fails(control, monkeypatch):
    """each control of the entry, the reference with one of the
    configuration's precisions a step below (bfloat16 path state, or float32
    payoffs), stands in for the program's call, and reads above each of the
    cell's limits.  float32 payoffs read 1.4e-5-8.4e-5 standard errors at
    4,096 paths on the CPU (four seeds, this run's 8.4e-5), 14-84 times the
    1e-6 limit, and 1.7e-6 in relative ``stderr_gap`` (this run), 1.7e5
    times the 1e-11 limit that the float64 payoffs' order of reduction stays
    under"""
    cell = cells.resolve(CELL)
    ref = cell.reference()
    dtypes = cell.entry().CONTROLS[control]

    def control_mc(self, chain, params, nb_path=0, seed=0, **kw):
        quotes = dict(ttms=chain.ttms, forwards=chain.forwards, discfactors=chain.discfactors,
                      strikes=chain.strikes_ttms, types=chain.optiontypes_ttms)
        fields = {k: getattr(params, k) for k in cell.config["params"]}
        return ref.mc_prices(quotes, fields, nb_path, seed, hawkes_jd.MC_STEPS_PER_YEAR,
                             dtype=dtypes[0], payoff_dtype=dtypes[1], device="cpu")

    monkeypatch.setattr(svt.HawkesJDPricer, "model_mc_price_chain", control_mc)
    result = _run()
    assert result["failed"] == 0 and result["correct"] is False
    assert all(c["value"] > c["limit"] for c in result["checks"].values()), result["checks"]


def test_frozen_op_count_is_the_branches_at_their_measured_shares():
    """the branch shares over the chain's four slices (the state carried, slice
    seeds base + 7919 i) at 8,192 paths: the frozen count was measured at
    131,072 paths (76.742 + 54.352 and 76.744 + 54.353 on two seeds) and
    rounded to 0.01; 8,192 paths read 76.744 + 54.353, and may stray from it
    by 0.02 more than the rounding's 0.005"""
    cell = cells.resolve(CELL)
    adapter = cell.model()
    params = svt.HawkesJDParams(**cell.config["params"])
    quotes = q.load(BENCH_DIR / cell.config["chain"])
    nb_path, seed = 8192, 1000003
    x = torch.zeros(nb_path)
    lam_p = torch.full((nb_path,), float(params.lambda_p))
    lam_m = torch.full((nb_path,), float(params.lambda_m))
    shares, steps, ttm0 = {}, 0, 0.0
    for i, ttm in enumerate(quotes["ttms"]):
        gap, seed_i = float(ttm - ttm0), seed + 7919 * i
        nb_steps = ref_mc.time_grid(gap, 1800)[0]
        got = cuda_mc.hawkes_branch_shares(seed_i, x, lam_p, lam_m, gap, 1800,
                                           **params.sim_params())
        for k, v in got.items():
            shares[k] = shares.get(k, 0.0) + v * nb_steps
        steps += nb_steps
        x, lam_p, lam_m = cuda_mc.simulate_hawkesjd_terminal_torch(
            seed_i, x, lam_p, lam_m, gap, **params.sim_params())
        ttm0 = float(ttm)
    # the kernel's count of what every path-step runs, and of each branch
    branch = cuda_mc.HAWKES_BRANCH_OPS
    measured = [base + sum(branch[b][j] * (shares[f"{b}_p"] + shares[f"{b}_m"])
                           for b in ("log", "jump")) / steps
                for j, base in enumerate(cuda_mc.OPS_PER_STEP["hawkes_mc"])]
    assert np.allclose(adapter.OPS_PER_STEP, measured, rtol=0.0, atol=0.005 + 0.02)
    assert adapter.OPS_PER_STEP == tuple(round(v, 2) for v in adapter.OPS_PER_STEP)


def test_yardstick_counts_the_launches_steps():
    """for each slice gap of the chain, the yardstick's step count is the
    launch's; the call's path-steps are the padded paths times their sum"""
    cell = cells.resolve(CELL)
    params = svt.HawkesJDParams(**cell.config["params"])
    quotes = q.load(BENCH_DIR / cell.config["chain"])
    gaps = np.diff(np.concatenate([[0.0], quotes["ttms"]]))
    launches = [cuda_mc._hawkes_args(float(g), nb_steps_per_year=1800, **params.sim_params())[0]
                for g in gaps]
    assert launches == [ref_mc.time_grid(float(g), 1800)[0] for g in gaps]
    assert sum(launches) == 780
    work = yardstick.mc_chain_work(cell.model().OPS_PER_STEP, quotes["ttms"],
                                   [len(k) for k in quotes["strikes"]], 4194304, 1800)
    assert work["path_steps"] == 4194304 * 780
    assert work["path_bytes"] == 24 * 4194304 * 4
