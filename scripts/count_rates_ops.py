#!/usr/bin/env python3
"""Count the leaf torch operations of one eager call of each factor-HJM
calibration and Monte-Carlo call of the PyTorch port, on the CPU.

    python3 scripts/count_rates_ops.py

The calls are those of ``chip_smoke.py``'s ``[rates-calib]`` and
``[rates-mc]`` phases on the USD cube of 18 Aug 2023 (12 slices x 9
strikes): the traced cube reprice, one traced greek's jvp, the cube LM's
initial state and one iteration (48 steps/yr), and one Monte-Carlo step
under each measure.  A leaf operation (views and allocations left out) is
close to one CUDA kernel, or one node of a captured graph, on the card; the
counts predict the card's kernel counts and, at ~2 us a captured kernel and
~15 us of host an eager one, its walls.  CPU walls are printed beside them
and say nothing of the card.
"""
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
import stochvolmodels_torch as svt  # noqa: E402
from stochvolmodels_torch.models.factor_hjm import fast_calibration as fc  # noqa: E402
from stochvolmodels_torch.models.factor_hjm import rate_logsv_pricer as rates  # noqa: E402
from stochvolmodels_torch.models.greeks import _cube_greek_panels  # noqa: E402
from stochvolmodels_torch.ops.lm import lm_init, lm_step  # noqa: E402

VIEWS = ("aten::view", "aten::as_strided", "aten::reshape", "aten::expand", "aten::_reshape",
         "aten::unsqueeze", "aten::squeeze", "aten::select", "aten::slice", "aten::t",
         "aten::transpose", "aten::permute", "aten::alias", "aten::empty", "aten::detach",
         "aten::lift", "aten::resolve", "aten::unbind", "aten::split", "aten::_unsafe_view",
         "aten::diagonal", "aten::real", "aten::imag", "aten::view_as", "aten::broadcast_to")


def leaf_ops(fn):
    """(leaf torch operations less views, CPU wall s) of one call of ``fn``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    return sum(1 for e in prof.events()
               if not e.cpu_children and not e.name.startswith(VIEWS)), wall


def main() -> None:
    torch.set_num_threads(2)
    chain, params = chip_smoke._usd_swaption_cube(svt)
    slices, fwds, strikes, market = fc.swaption_chain_to_cube(chain, max_expiry=5.0)
    cube, _ = rates.make_swaption_cube_fn_traced(params, slices, fwds, strikes, device="cpu")
    args = cube.primals()
    counts = {"traced cube reprice": leaf_ops(lambda: cube(*args)),
              "one traced greek (A_shift jvp)": leaf_ops(lambda: _cube_greek_panels(
                  "A_shift", *(args + cube.consts), traced=True))}
    seen = {}
    run = fc._lm_run

    def keep(p0, lower, upper, problem, nb_iters, fit_A, nb_free, d, key):
        seen.update(p0=p0, lower=lower, upper=upper, residuals=fc._residuals_fn(
            fit_A, nb_free, d, problem))
        return run(p0, lower, upper, problem, nb_iters, fit_A, nb_free, d, key)

    fc._lm_run = keep
    fc.calibrate_rate_logsv_cube_lm_on_device(chip_smoke._rates_start(params), slices, fwds,
                                              strikes, market, nb_iters=0, year_steps=48,
                                              device="cpu")
    fc._lm_run = run
    state = lm_init(seen["residuals"], seen["p0"])
    counts["cube LM initial state (48 steps/yr)"] = leaf_ops(
        lambda: lm_init(seen["residuals"], seen["p0"]))
    counts["cube LM iteration (48 steps/yr)"] = leaf_ops(
        lambda: lm_step(seen["residuals"], state, seen["lower"], seen["upper"]))
    n = 1000
    mf = dict(ttms=np.array([1.0]), x0=np.zeros((n, 3)), y0=np.zeros((n, 8)), I0=np.zeros(n),
              sigma0=np.ones((n, 1)), theta=params.theta, kappa1=params.kappa1,
              kappa2=params.kappa2, ts=params.ts, A=params.A, R=params.R, C=params.C,
              Omega=params.Omega, betaxs=params.beta.xs, volvolxs=params.volvol.xs,
              basis=params.basis, ccy=params.ccy, nb_path=n, device="cpu")
    for measure, kw in ((rates.Measure.RISK_NEUTRAL, dict(ts_sw=None, T_fwd=None)),
                        (rates.Measure.ANNUITY, dict(ts_sw=np.arange(1.0, 6.5, 0.5),
                                                     T_fwd=None)),
                        (rates.Measure.FORWARD, dict(ts_sw=None, T_fwd=3.0))):
        ops, wall = leaf_ops(lambda: rates.simulate_logsv_MF(measure_type=measure, **mf, **kw))
        counts[f"MC, 1y at 360 steps/yr, {measure.name}"] = (ops, wall)
    for name, (ops, wall) in counts.items():
        print(f"{name}: {ops} leaf operations (CPU {wall:.2f} s)")


if __name__ == "__main__":
    main()
