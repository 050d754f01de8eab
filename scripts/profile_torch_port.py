#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's serving path, on one CUDA GPU.

    python3 scripts/profile_torch_port.py [--model logsv|heston|hawkes|rough]
                                          [--nb-path 1048576] [--out DIR]
                                          [--calls NAME ...] [--eager]
                                          [--batch N ...]

For each warm call of a model's BTC-chain serving path (analytic
``price_chain``, ``compute_model_ivols_for_chain``, and the MC chain, bare
and with implied vols, through the CUDA kernel; for ``rough``, the LogSV
lift at H = 0.1 with 3 nodes, the bare MC chain alone) it prints one line: host
wall-clock (the median of 21 unprofiled calls, each also listed),
device busy time (sum of device
kernel time of one profiled call, from ``torch.profiler``), the device's idle share
(1 - busy / wall), the number of device kernels, and the three kernels that
take the most device time.  ``--calls`` keeps only the calls named;
``calibrate_lm`` (LogSV only: 12 LM iterations through the pricer from
``bench.py``'s start point, one captured CUDA graph; 3 unprofiled calls a
wall) runs only when named.  ``--eager`` runs every call without its CUDA
graphs (the bisection's and the LM fit's).  The full ``key_averages``
tables go to ``<out>/``.  Exits 1 without a CUDA device.

For ``hawkes`` the calls also hold one gamma = 0.5 risk-premia reprice with
its ivols on the forward-normalised chain
(``compute_chain_prices_with_vols_gamma``).  Whole fits, named in
``--calls`` only and timed without the profiler (one call each, after a
warm-up call for the captured LM fits, whose first call captures):
``heston``:
``calibrate_slsqp`` (from ``BTC_HESTON_PARAMS``), ``calibrate_lm`` (16
iterations from the JAX test's start point); ``hawkes``:
``calibrate_slsqp`` (8 parameters from ``HawkesJDParams()``),
``calibrate_gamma`` (from gamma 0.5 on the forward-normalised chain),
``calibrate_lm`` (16 iterations at 720 steps/yr).  Each fit's line adds
scipy's ``nfev`` and ``nit`` where there are, and the mean |model ivol - mid
vol| of the fit.

``--calls sweep`` (``logsv`` or ``heston``, named only) times the batched
LM sweep (``parallel/sweep.py``) of N perturbed BTC chains (bid and ask
ivols scaled on [0.90, 1.10]) for each N of ``--batch`` (default 64), from
``tests/test_parallel.py``'s start points at the JAX defaults: 16
iterations, LogSV at 360 RK4 steps/yr.  Each N prints one line: the first
call's wall (it captures the batched fit as one CUDA graph), the warm
call's wall and chains/s, the peak device memory of each
(``torch.cuda.max_memory_allocated``), and the device busy time, idle share
and kernel count of one profiled warm call; an N that does not fit in the
card's memory prints the error and the peak instead, and the next N runs.
"""
import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# unprofiled calls per wall: the MC chain walls (~8 ms) are host bound and
# spread by ~2 ms between runs, so a median of 3 cannot tell two trees apart
REPEATS = 21


def _profile(name, fn, out_dir: Path, repeats: int = REPEATS):
    fn()  # warm
    walls = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    wall_ms = statistics.median(walls)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    (out_dir / f"profile_{name}.txt").write_text(table)
    rec = {"call": name, "wall_ms": wall_ms, "walls_ms": walls, "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms, "kernel_launches": len(events),
           "top_kernels_ms": [[k[:60], v] for k, v in top]}
    print(json.dumps(rec), flush=True)
    return rec


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", choices=("logsv", "heston", "hawkes", "rough"),
                        default="logsv")
    parser.add_argument("--nb-path", type=int, default=1 << 20)
    parser.add_argument("--out", default="chiprun_out")
    parser.add_argument("--calls", nargs="+")
    parser.add_argument("--eager", action="store_true",
                        help="run without the CUDA graphs of the bisection and the LM fit")
    parser.add_argument("--batch", type=int, nargs="+", default=[64],
                        help="chains per sweep for --calls sweep")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_port: needs a CUDA device", file=sys.stderr)
        return 1
    import stochvolmodels_torch as svt
    from stochvolmodels_torch.ops import graphs

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    chain = svt.get_btc_test_chain_data()
    if args.model == "hawkes":
        params, pricer, mc_kw = svt.HawkesJDParams(), svt.HawkesJDPricer(device="cuda"), {}
    elif args.model == "heston":
        params, pricer, mc_kw = svt.BTC_HESTON_PARAMS, svt.HestonPricer(device="cuda"), {}
    elif args.model == "rough":
        params, pricer = svt.LogSvParams(**{**svt.LOGSV_BTC_PARAMS.to_dict(), "H": 0.1}), \
            svt.LogSVPricer(device="cuda")
        params.approximate_kernel(T=float(max(chain.ttms)))
        mc_kw = dict(use_rough_mc=True)
    else:
        params, pricer = svt.LOGSV_BTC_PARAMS, svt.LogSVPricer(device="cuda")
        mc_kw = dict(nb_steps=360)
    mc_kw.update(engine="cuda", nb_path=args.nb_path, seed=24)
    print(f"device: {torch.cuda.get_device_name(0)}; model {args.model}; "
          f"{'eager' if args.eager else 'captured'}", flush=True)
    tag = ("" if args.model == "logsv" else f"{args.model}_") + ("eager_" if args.eager else "")
    calls = {"model_mc_price_chain": lambda: pricer.model_mc_price_chain(chain, params, **mc_kw)}
    if args.model != "rough":  # the lift is priced by MC only: its bare chain call
        calls = {"price_chain": lambda: pricer.price_chain(chain, params),
                 "compute_model_ivols_for_chain":
                     lambda: pricer.compute_model_ivols_for_chain(chain, params),
                 **calls,
                 "compute_mc_chain_implied_vols":
                     lambda: pricer.compute_mc_chain_implied_vols(chain, params, **mc_kw)}
    repeats = {}
    if args.model == "logsv" and args.calls and "calibrate_lm" in args.calls:
        p0 = svt.LogSvParams(sigma0=0.8, theta=1.0, kappa1=2.21, kappa2=2.18, beta=0.15,
                             volvol=1.85)
        calls["calibrate_lm"] = lambda: pricer.calibrate_model_params_to_chain(
            chain, p0, method="lm", nb_iters=12)
        repeats["calibrate_lm"] = 3
    norm = svt.OptionChain.to_forward_normalised_strikes(chain)
    if args.model == "hawkes":
        gamma_params = svt.HawkesJDParams(risk_premia_gamma=0.5)
        calls["compute_chain_prices_with_vols_gamma"] = \
            lambda: pricer.compute_chain_prices_with_vols(norm, gamma_params)
    fits = {}
    if args.model == "heston":
        fits = {"calibrate_slsqp": (chain, lambda: pricer.calibrate_model_params_to_chain(
                    chain, svt.BTC_HESTON_PARAMS)),
                "calibrate_lm": (chain, lambda: pricer.calibrate_model_params_to_chain(
                    chain, svt.HestonParams(v0=0.8, theta=1.0, kappa=2.0, rho=0.1, volvol=1.5),
                    method="lm", nb_iters=16))}
    elif args.model == "hawkes":
        fits = {"calibrate_slsqp": (chain, lambda: pricer.calibrate_model_params_to_chain(
                    chain, svt.HawkesJDParams())),
                "calibrate_gamma": (norm, lambda: pricer.calibrate_risk_premia_gamma_to_chain(
                    norm, svt.HawkesJDParams(risk_premia_gamma=0.5))),
                "calibrate_lm": (chain, lambda: pricer.calibrate_model_params_to_chain(
                    chain, svt.HawkesJDParams(), method="lm", nb_iters=16, year_steps=720))}
    with graphs.eager() if args.eager else contextlib.nullcontext():
        recs = [_profile(f"{tag}{name}", fn, out_dir, repeats.get(name, REPEATS))
                for name, fn in calls.items() if not args.calls or name in args.calls]
        recs += [_time_fit(f"{tag}{name}", pricer, fit_chain, fn,
                           warm=name == "calibrate_lm" and not args.eager)
                 for name, (fit_chain, fn) in fits.items() if args.calls and name in args.calls]
        if args.calls and "sweep" in args.calls:
            recs += [_time_sweep(svt, args.model, chain, n) for n in args.batch]
    (out_dir / f"profile_{tag}summary.json").write_text(json.dumps(recs, indent=1))
    return 0


def _time_sweep(svt, model, chain, n):
    """the batched LM sweep of ``n`` perturbed chains: capture and warm
    walls, chains/s, peak memory, and one profiled warm call."""
    import dataclasses

    import numpy as np

    from stochvolmodels_torch.parallel import sweep

    chains = [dataclasses.replace(chain, bid_ivs=[s * iv for iv in chain.bid_ivs],
                                  ask_ivs=[s * iv for iv in chain.ask_ivs])
              for s in np.linspace(0.90, 1.10, n)]
    if model == "heston":
        fn = lambda: sweep.calibrate_heston_lm_sweep(
            chains, svt.HestonParams(v0=0.8 ** 2, theta=1.3 ** 2, kappa=4.0, volvol=1.5, rho=0.1))
    else:
        fn = lambda: sweep.calibrate_logsv_lm_sweep(
            chains, svt.LogSvParams(sigma0=0.8, theta=1.0, kappa1=2.21, kappa2=2.21, beta=0.15,
                                    volvol=1.85))
    rec = {"call": f"{model}_sweep", "chains": n, "nb_iters": 16,
           "year_steps": 360 if model == "logsv" else None}
    walls, peaks = [], []
    try:
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            fits = fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError as exc:
        rec.update(error=f"out of memory: {str(exc).splitlines()[0]}",
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30, walls_s=walls)
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
        return rec
    busy_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    costs = [c for _, c in fits]
    rec.update(capture_s=walls[0], warm_s=walls[1], chains_per_s=n / walls[1],
               peak_gib_capture=peaks[0], peak_gib_warm=peaks[1], device_busy_ms=busy_ms,
               device_idle_share=1.0 - busy_ms / (1e3 * walls[1]),
               kernel_launches=sum(1 for e in prof.events()
                                   if e.device_type == torch.autograd.DeviceType.CUDA),
               cost_median=statistics.median(costs), cost_max=max(costs),
               finite=bool(np.all(np.isfinite(costs))))
    print(json.dumps(rec), flush=True)
    return rec


def _time_fit(name, pricer, chain, fn, warm):
    """wall s of one fit (after a warm-up call if ``warm``: a captured LM
    fit's first call captures its graphs), scipy's counts, and the fit's
    mean |model ivol - mid vol|; no profiler."""
    if warm:
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ivols = pricer.compute_model_ivols_for_chain(chain, fit)
    err = statistics.mean(float(abs(iv - m).mean()) for iv, m in zip(ivols, chain.get_mid_vols()))
    res = getattr(pricer, "calibration_result", None)
    rec = {"call": name, "wall_s": wall, "fit_error": err, "fit": {k: float(v) for k, v in
                                                                 fit.to_dict().items()
                                                                 if v is not None},
           "nfev": int(getattr(res, "nfev", 0) or 0), "nit": int(getattr(res, "nit", 0) or 0)}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    sys.exit(main())
