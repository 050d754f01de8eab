"""The spread over seeds of an MC calibration's fit quality, on the port and
on the JAX package: what ``scripts/port_scripts.py``'s ``FIT_QUALITY``
margin of an MC fit rests on.

The entry ``examples/run_lognormal_sv_pricer.py::
CALIBRATE_MODEL_TO_BTC_OPTIONS_WITH_MC`` calibrates the rough LogSV model on
5,000 Monte Carlo paths at ``seed=7``.  The port's random stream is not
threefry, so its fit and the JAX one are two draws of the fit's MC noise.
This script reruns the entry as the runner runs it, one fresh interpreter a
(side, seed), with ``LogSVPricer.calibrate_model_params_to_chain`` given
each of ``--seeds`` instead of 7, and records the runner's two measures of
a fit: the mean |model vol - mid| of the figures (``_fit_error``) and the
final objective of the calibration's SLSQP call (the last of the entry's
``scipy.optimize.minimize`` calls).  It prints one JSON line a run, a table
of each side's mean, standard deviation and range, the relative margin
that 4 combined standard deviations of the two sides make of the JAX mean,
and the gap of the two means beside 4 combined standard errors of them.

    python scripts/fit_quality_spread.py --seeds 1 2 3 4 5 6 7 8 [--jobs 4]

CPU only; each run takes ~40 s on one core.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parent.parent
ENTRY = "examples/run_lognormal_sv_pricer.py::CALIBRATE_MODEL_TO_BTC_OPTIONS_WITH_MC"


def _runner():
    spec = importlib.util.spec_from_file_location("port_scripts",
                                                  ROOT / "scripts" / "port_scripts.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules.setdefault("port_scripts", module)
    spec.loader.exec_module(module)
    return module


def _child(side: str, seed: int) -> None:
    import matplotlib

    matplotlib.use("Agg")
    sys.path.insert(0, str(ROOT))
    ps = _runner()
    ps.record_objectives()
    if side == "port":
        import torch

        torch.set_num_threads(1)
        ps.install_port()
    else:
        import jax

        jax.config.update("jax_platforms", "cpu")
    from stochvolmodels_tpu.models.logsv import pricer   # the port's module on the port side

    plain = pricer.LogSVPricer.calibrate_model_params_to_chain

    def reseeded(self, *args, **kwargs):
        kwargs["seed"] = seed
        return plain(self, *args, **kwargs)

    pricer.LogSVPricer.calibrate_model_params_to_chain = reseeded
    entry = next(e for e in ps.entries() if e.name == ENTRY)
    with tempfile.TemporaryDirectory(prefix=f"spread_{side}_") as work:
        os.chdir(work)
        rec = ps.run_entry(entry)
        os.chdir(ROOT)
    figs = rec.get("figures", [])
    print(json.dumps(dict(side=side, seed=seed, ok=rec.get("ok"), error=rec.get("error"),
                          wall_s=rec["wall_s"],
                          fit_error=ps._fit_error(figs, ps._band_pairs(figs, figs)),
                          objective=(rec["objectives"] or [math.nan])[-1])), flush=True)


def _spawn(side: str, seed: int) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT), MPLBACKEND="Agg", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    if side == "jax":
        env.update(JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                                                  "intra_op_parallelism_threads=1")
    proc = subprocess.run([sys.executable, __file__, "--child", side, "--seed", str(seed)],
                          capture_output=True, text=True, env=env, cwd=str(ROOT))
    lines = [line for line in proc.stdout.splitlines() if line.startswith('{"side"')]
    rec = json.loads(lines[-1]) if lines else dict(side=side, seed=seed, ok=False,
                                                   error=proc.stderr[-2000:])
    print(json.dumps(rec), flush=True)
    return rec


def _stats(values):
    n = len(values)
    mean = sum(values) / n
    sd = math.sqrt(sum((v - mean) ** 2 for v in values) / (n - 1)) if n > 1 else math.nan
    return mean, sd, min(values), max(values)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, nargs="*", default=list(range(1, 9)))
    parser.add_argument("--jobs", type=int, default=4)
    parser.add_argument("--child", choices=("port", "jax"))
    parser.add_argument("--seed", type=int)
    args = parser.parse_args()
    if args.child:
        _child(args.child, args.seed)
        return 0
    runs = [(side, seed) for seed in args.seeds for side in ("port", "jax")]
    with ThreadPoolExecutor(max(1, args.jobs)) as pool:
        recs = list(pool.map(lambda r: _spawn(*r), runs))
    if not all(r.get("ok") for r in recs):
        print("some runs failed", file=sys.stderr)
        return 1
    summary = {}
    print("| side | measure | mean | sd | min | max |")
    print("|---|---|---|---|---|---|")
    for measure in ("fit_error", "objective"):
        for side in ("port", "jax"):
            stats = _stats([r[measure] for r in recs if r["side"] == side])
            summary[f"{side}_{measure}"] = stats
            print(f"| {side} | {measure} | " + " | ".join(f"{v:.6g}" for v in stats) + " |")
        port_sd, jax_sd = summary[f"port_{measure}"][1], summary[f"jax_{measure}"][1]
        summary[f"margin_{measure}"] = 4.0 * math.hypot(port_sd, jax_sd) / summary[f"jax_{measure}"][0]
        print(f"margin for {measure}: 4 combined sd / JAX mean = {summary[f'margin_{measure}']:.4f}")
        gap = summary[f"port_{measure}"][0] - summary[f"jax_{measure}"][0]
        sem = math.hypot(port_sd, jax_sd) / math.sqrt(len(args.seeds))
        summary[f"mean_gap_{measure}"] = (gap, 4.0 * sem)
        print(f"port mean - JAX mean for {measure}: {gap:.6g} "
              f"(4 combined standard errors of the means: {4.0 * sem:.6g})")
    print(json.dumps(dict(entry=ENTRY, seeds=args.seeds, **summary)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
