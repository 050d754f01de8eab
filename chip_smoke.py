#!/usr/bin/env python3
"""On-card smoke check of the PyTorch/CUDA port, ``stochvolmodels_torch``.

Run from the repository root on a machine with one NVIDIA GPU (built for
sm_90a, an H100) and the CUDA toolkit:

    python3 chip_smoke.py

It builds the hand-written Monte-Carlo kernels from ``csrc/`` (LogSV, Heston,
rough LogSV, Hawkes JD and the LogSV variant study, one nvcc each, started
together), holds each against its plain PyTorch version on the card (each of
the 14 variants of the study, at 1e-4 max(|plain|, 1), and the study's
poly-bm against logsv_mc at 1e-5), drives the port's serving paths on the
bundled BTC chain (LogSV analytic prices and implied vols, then MC through
its kernel; Heston analytic prices, implied vols and MC through its kernel;
the rough LogSV MC through its kernel; Hawkes JD analytic prices, implied
vols, one risk-premia reprice and MC through its kernel) and the variant
study of the LogSV path loop (each variant once, at 2^20 paths x 360 steps),
and measures each kernel's throughput against its plain version and its
roofline bound, with the card's SM clock sampled under each kernel's load,
the length of its SASS step loop (``scripts/sass_step_loops.py``) and the
issue floor those give.  The Hawkes kernel must equal its plain version bit
for bit; the LogSV, Heston and rough kernels, whose updates use FMA, are
held to 1e-4 in x and a stated tolerance in the other outputs (LogSV under
both measures).  The
four, and the study's poly-bm and one-prng, run once more at a path count
that leaves their last block half empty, bit for bit the first paths of the
full run.  Each
path runs with every launch count set to 0 just before it and read just
after.  Then the LogSV calibration on the BTC chain from ``bench.py``'s
start point: 12 Levenberg-Marquardt iterations through the pricer
(``method='lm'``) and through ``calibrate_logsv_lm_on_device``, each a
captured CUDA graph, held bit for bit against the eager fit, with the fit's
cost and error and ``calib_warm_s`` captured and eager; one SLSQP fit with
its wall time.  Then the 200-step bisection's graph: the ivols of the LogSV,
Heston and Hawkes chains and one MC band call, captured and uncaptured,
equal bit for bit, with their walls and the device kernels per inversion.
Then Heston calibration (one SLSQP fit; 16 LM iterations as one CUDA graph,
captured and eager, bit for bit), the Hawkes reprice as one CUDA graph
(prices, ivols and one risk-premia reprice, captured and eager, bit for
bit, with kernels and host launch calls per call) and Hawkes calibration
(16 LM iterations at 720 RK4 steps/yr, one graph an iteration, captured and
eager, bit for bit; one 8-parameter SLSQP fit and one risk-premia fit on
the first two BTC slices).  Then LogSV beyond log-return pricing: the Q_VAR
reprice of the QV chain (one CUDA graph, captured against eager bit for
bit, GPU against CPU, device busy time and idle share), the log-return, QV
and vol densities at the stiff paper parameters, Q_VAR chain MC through
the logsv_mc kernel (its launch count is the kernels line's ``launches``
for logsv_mc), the antithetic, QMC and fixed-randoms MC engines on BTC, and
the MC, QMC and varswap-backbone fits and one rough-MC objective on the
first two BTC slices.  Then the chain greeks of LogSV and Heston on BTC
(price and vol space, gamma and calendar theta, one CUDA graph a program,
captured against eager bit for bit, GPU against CPU) and the LogSV pathwise
MC greeks against a fixed-seed difference; the exponential-Euler affine
solve (one graph a slice) against the CPU and the RK4; Heston QMC,
antithetic and Q_VAR; and the rough chain through rough_mc with the
Gaussian rule's 2, 4 and 5 nodes (each instance held against its plain
version, with its ms, roofline bound, share of bound and SASS issue
floor), and one 'expm'-drift scan chain against the RK4's.  Then the
terminal models (Bachelier prices, deltas, vegas and implied vols, the
incomplete beta, Student-t prices and implied vols and GMM prices, each on
the card against the CPU; the normal bisection's graph against its eager
call; one GMM and one Student-t per-slice SLSQP fit of the first two
slices) and the LogSV and Heston LM sweeps of 64 perturbed BTC chains (two
CUDA graphs each, the initial state and one iteration, chains/s, peak memory, device busy; the first, middle and
last chain against their single-chain fits; captured against eager bit for
bit on 4 chains).  Then the factor-HJM swaption cube on the USD cube of 18
Aug 2023 at the paper's fitted parameters (12 slices x 9 strikes): the
reprice (one CUDA graph) captured against eager bit for bit, the card
against the CPU in price and normal ivol, the RMS gap to the market mids;
the three cube greeks (one graph each) captured against eager and the card
against the CPU; the adaptive tanh-sinh pricer's 1y row (its ff calls and
RK4 graphs, one batch's graph against its eager call, the card against the
CPU).  Then the rest of the factor-HJM suite on the same cube: the traced
reprice (one graph) captured, eager and against the CPU, the six traced
greeks, the A prefit through the traced graph, the 24-iteration cube LM from
a perturbed start (its iteration one graph, with its node count; two
iterations captured against eager bit for bit and the card against the CPU)
and the pricer's fit; then the rates Monte Carlo: calc_mc_vols on the 1y row
at 100,000 paths against the DE pricer, the annuity and T-forward paths at
injected normals card against CPU, and one futures expiry against the DE
futures pricer.  Then the device mesh (``parallel/mesh.py``): the
path-sharded LogSV MC at 2^20 paths x 361 steps on ``make_path_mesh()`` and
on two shards of one card, each shard equal bit for bit to a direct kernel
call at its seed and held to its plain version, the BTC chain from the
gathered paths within its MC band (the run's launches count in logsv_mc's);
the LM sweeps of 8 perturbed BTC chains and the USD cube's reprice and two
cube-LM iterations on the same meshes, against ``mesh=None``.  Then a
``device_trace`` with ``annotate`` regions around a LogSV MC chain call and
a captured Hawkes reprice, and the reference-style ``stochvolmodels`` names
after ``compat.install()`` in a fresh interpreter, equal bit for bit to the
port's call.  The greeks, the terminal models, the sweeps and the rates
cube run in a side process started after the kernel timings (the rough rules
and the sharded MC run before it), and the rates calibration, Monte Carlo and
mesh cube in a second one, beside the calibration and graph phases: all are
bound by host launch work; the walls of the phases that overlap include the
other processes' load on the card.  Each phase prints one line, and a ``[phase-walls]`` line their walls; any
failure raises and exits non-zero.
The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device
it exits 1 and prints no result.
"""
import contextlib
import importlib.util
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

DEVICE = "cuda"
NB_PATH = 1 << 20
# the half-empty last block of the redesigned kernels: a multiple of 128, not of 256
ODD_NB_PATH = NB_PATH - 128
# seconds of back-to-back launches of each kernel while nvidia-smi samples the SM clock
CLOCK_WINDOW_S = 1.5
# an H100 SM issues four warp-instructions a clock, one per scheduler
ISSUE_PER_SM_CLOCK = 4
MAIN_TTM = 0.25           # 91 Euler steps at 360 steps/yr
THROUGHPUT_TTM = 1.0      # 361 Euler steps at 360 steps/yr
# MC chain Euler grid, steps per year.  The pricer's default for the BTC
# chain (int(360 * 0.43) + 1 = 156) gives the 2-week slice 7 steps, whose
# Euler bias moves the far-OTM call ivols by up to 0.014 from the analytic
# ones; at 360 steps/yr the largest gap is 0.007 (plain version, 2^20 paths).
MC_STEPS_PER_YEAR = 360
PATH_KERNELS = ("logsv_mc", "heston_mc", "rough_mc", "hawkes_mc", "logsv_variants")
# the MC payoff reductions (csrc/mc_payoff.cu) beside the path loops
KERNELS = PATH_KERNELS + ("mc_payoff",)
# the payoff kernels against the plain panels: the benchmark's paths over the BTC slices,
# held at 1e-12 relative; their bound counts port_bench's float64 payoff work (4 operations a
# path, 6 a path and strike) at 34 TFLOP/s (H100 SXM float64 outside the tensor cores, 700 W)
PAYOFF_NB_PATH, PAYOFF_RTOL = 4_194_304, 1e-12
PAYOFF_OPS_PER_PATH, PAYOFF_OPS_PER_PATH_STRIKE, PEAK_F64_OPS_PER_S = 4, 6, 34e12
# the rough kernel-vs-plain and throughput phases: 3 nodes of the H = 0.1 lift
ROUGH_H, ROUGH_NODES, ROUGH_T = 0.1, 3, 0.43
# the Hawkes kernel runs at 1800 steps/yr: ttm 0.05 is 91 steps, 0.2 is 361
HAWKES_MAIN_TTM, HAWKES_THROUGHPUT_TTM, HAWKES_STEPS_PER_YEAR = 0.05, 0.2, 1800
HAWKES_GAMMA = 0.5
# warm repeats of the Hawkes calls: an analytic reprice is ~10^5 small launches
HAWKES_REPEATS = 1
# the variant study: dt = 1/360, 91 steps against the plain versions, 360 for the study
VARIANT_DT, VARIANT_CHECK_STEPS, VARIANT_STEPS = 1.0 / 360.0, 91, 360
# the bytes of state each path reads and writes once
STATE_BYTES = {"logsv_mc": 24, "heston_mc": 24, "rough_mc": 12, "hawkes_mc": 24,
               "logsv_variants": 8}
# H100 SXM at 700 W: float32 outside the tensor cores, and HBM3
PEAK_OPS_PER_S, PEAK_BYTES_PER_S = 67e12, 3.35e12
# calibration: bench.py's start point of the LM benchmark, 12 LM iterations,
# one warm call a side (the eager LM fits take 8-21 s each)
CALIB_PARAMS0 = dict(sigma0=0.8, theta=1.0, kappa1=2.21, kappa2=2.18, beta=0.15, volvol=1.85)
CALIB_LM_ITERS, CALIB_REPEATS = 12, 1
# warm repeats of each ivols call, captured and uncaptured
GRAPH_REPEATS = 3
# Heston calibration: the JAX test's LM start point (tests/test_heston.py), 16 LM iterations
HESTON_LM_PARAMS0 = dict(v0=0.8, theta=1.0, kappa=2.0, rho=0.1, volvol=1.5)
HESTON_LM_ITERS = 16
# Hawkes calibration: 16 LM iterations at 720 RK4 steps/yr from HawkesJDParams(), captured;
# captured against eager at HAWKES_LM_CHECK_ITERS (an eager iteration takes 5-11 s of host
# launches, and each iteration replays the same step graph); the SLSQP and gamma fits on the
# first HAWKES_FIT_SLICES BTC slices, the gamma fit at HAWKES_GAMMA_MAXITER iterations (its
# ftol of 1e-16 is never met, so it runs to maxiter)
HAWKES_LM_ITERS, HAWKES_LM_YEAR_STEPS, HAWKES_LM_CHECK_ITERS = 16, 720, 2
HAWKES_FIT_SLICES, HAWKES_GAMMA_MAXITER = 2, 10
# LogSV beyond LOG_RETURN: the README parameters on the QV chain; the stiff paper parameters of
# tests/test_logsv.py's density test; Q_VAR MC at 1440 steps/yr (its Euler gap at 360 steps/yr
# reaches 4-30% on the 1w slice, at 1440 about 1-2%), held to 4 stderr + 2% + 2e-4
README_PARAMS = dict(sigma0=0.8, theta=1.0, kappa1=5.0, kappa2=5.0, beta=0.15, volvol=2.0)
STIFF_PARAMS = dict(sigma0=0.8327, theta=1.0139, kappa1=4.8609, kappa2=4.7940, beta=0.1988,
                    volvol=2.3694)
PDF_TTM, PDF_POINTS = 0.25, 200
QVAR_MC_STEPS_PER_YEAR = 1440
# the MC engines on BTC (360 steps/yr), held to tests/test_logsv.py's band (4 stderr + 1.5% +
# 1e-4 forward); the fixed-randoms prices GPU against CPU on one numpy block
ENGINE_NB_PATH, QMC_NB_PATH, FIXED_NB_PATH, QMC_REPLICATES = 1 << 18, 1 << 17, 1 << 15, 8
# MC calibration on the first two BTC slices: 100k paths at 360 steps/yr; the rough objective
# (H = 0.1) GPU against CPU on one block of ROUGH_CALIB_NB_PATH paths
MC_CALIB_NB_PATH, MC_CALIB_SLICES, ROUGH_CALIB_NB_PATH = 100000, 2, 1 << 14
# the pathwise MC greeks at the JAX package's default 100,000 paths (360 steps/yr); the rough
# lifts of the ported rules (N = 2, 4, 5 nodes); the 'expm'-drift scan chain's paths
MC_GREEKS_NB_PATH, ROUGH_RULE_NODES, EXPM_NB_PATH = 100000, (2, 4, 5), 1 << 16
# the 'expm' against 'rk4' drift chains at tests/test_rough_logsv.py's step-resolved lift (H 0.3,
# 2 nodes on [0, 1], 720 steps/yr): at H = 0.1 the top node (~300/yr) leaves both schemes ~10%
# from the truth and from each other, so there they are not comparable
EXPM_LIFT, EXPM_STEPS_PER_YEAR = (0.3, 2, 1.0), 720
# the terminal models on the BTC layout: a normal-vol panel (forward 1, strikes 1 + (K / F - 1) /
# 20, the chain's ttms, normal vols 0.06 x mid vol / the largest mid vol, inside the [0.001, 0.1]
# bracket); Student-t prices and implied vols at vol 0.8, nu 4.5 on the first slice (each
# bisection step implies the drift by 50 Newton steps: ~200k eager kernels a slice); the GMM of
# tests/test_torch_terminal_models.py; the incomplete beta on the Student-t callers' domain
# (a = nu / 2 in [1.005, 10], b = 1/2, x up to 1 - 1e-12); the per-slice SLSQP fits on the
# first TERMINAL_FIT_SLICES slices, each warm-started from the one before
TDIST_VOL, TDIST_NU, TERMINAL_FIT_SLICES = 0.8, 4.5, 2
GMM_PARAMS = dict(gmm_weights=np.array([0.2, 0.5, 0.3]), gmm_mus=np.array([-0.8, 0.1, 0.4]),
                  gmm_vols=np.array([1.1, 0.6, 0.8]), ttm=0.1)
# the LM sweep: SWEEP_CHAINS perturbed BTC chains (bid and ask ivols x [0.90, 1.10]) from
# tests/test_parallel.py's start points at the JAX defaults (16 iterations, LogSV at 360 RK4
# steps/yr); the first, middle and last chain against their single-chain fits (1e-6 relative,
# the JAX test's rtol); captured against eager bit for bit at SWEEP_CHECK_CHAINS chains and
# SWEEP_CHECK_ITERS iterations (an eager LM iteration is seconds of host launches)
SWEEP_CHAINS, SWEEP_ITERS, SWEEP_YEAR_STEPS = 64, 16, 360
SWEEP_CHECK_CHAINS, SWEEP_CHECK_ITERS = 4, 2
# the device mesh: the path-sharded LogSV MC at 2^20 paths x 361 steps (BASELINE config 3's
# shape) on make_path_mesh() (every card of the host) and on two shards of one card,
# each shard held to a direct kernel call at its seed and to its plain version; the BTC chain
# from the gathered paths of make_path_mesh() within tests/test_logsv.py's band; the LM sweeps
# of MESH_SWEEP_CHAINS perturbed BTC chains (MESH_SWEEP_ITERS iterations, LogSV at
# MESH_SWEEP_YEAR_STEPS) and the USD cube's reprice and MESH_CUBE_ITERS cube-LM iterations on
# the same meshes against mesh=None
MESH_TWO_SHARDS = ("cuda:0", "cuda:0")
MESH_SEED = 11
MESH_SWEEP_CHAINS, MESH_SWEEP_ITERS, MESH_SWEEP_YEAR_STEPS = 8, 4, 180
MESH_CUBE_ITERS = 2
SWEEP_LOGSV_P0 = dict(sigma0=0.8, theta=1.0, kappa1=2.21, kappa2=2.21, beta=0.15, volvol=1.85)
SWEEP_HESTON_P0 = dict(v0=0.8 ** 2, theta=1.3 ** 2, kappa=4.0, volvol=1.5, rho=0.1)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def _smi_name_and_power() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class SmiSampler:
    """samples nvidia-smi's SM clock (MHz) and power draw (W) every 50 ms while
    the ``with`` block runs; the process it starts is stopped on exit."""

    def __enter__(self):
        self.samples = []
        self._proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
             "-lms", "50"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self._proc.terminate()
        try:
            out, _ = self._proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            out, _ = self._proc.communicate()
        for line in out.splitlines():
            m = re.fullmatch(r"\s*([\d.]+)\s*,\s*([\d.]+)\s*", line)
            if m:
                self.samples.append((float(m.group(1)), float(m.group(2))))
        return False

    def summary(self) -> str:
        if not self.samples:
            return "SM clock not measured (no nvidia-smi sample)"
        clocks, watts = zip(*self.samples)
        return (f"SM clock median {statistics.median(clocks):.0f} MHz (min {min(clocks):.0f}, "
                f"max {max(clocks):.0f}, {len(clocks)} samples), power draw median "
                f"{statistics.median(watts):.1f} W")

    def clock_mhz(self):
        return statistics.median(c for c, _ in self.samples) if self.samples else None


def _clock_under_load(name: str, run_k, k_ms: float):
    """the median SM clock (MHz, None if unsampled) over CLOCK_WINDOW_S of
    back-to-back launches of ``run_k``, printed with the power draw."""
    batch = max(1, int(100.0 / max(k_ms, 1e-3)))
    with SmiSampler() as smi:
        t_end = time.perf_counter() + CLOCK_WINDOW_S
        while time.perf_counter() < t_end:
            for _ in range(batch):
                run_k()
            torch.cuda.synchronize()
    print(f"[clock] {name} under {CLOCK_WINDOW_S} s of back-to-back launches: {smi.summary()}",
          flush=True)
    return smi.clock_mhz()


def _load_script(relpath: str):
    """a script of the checkout, imported by path."""
    path = Path(__file__).resolve().parent / relpath
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _warm_ms(fn, repeats: int = 5) -> float:
    """median wall-clock ms of ``fn`` after one warm-up call; ``fn`` ends in
    host data (numpy), so each call is complete when it returns."""
    fn()
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _event_ms(fn, repeats: int) -> float:
    """mean device ms of ``fn`` by CUDA events over ``repeats`` calls."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def _ptxas(log: str) -> str:
    """registers and spills of each kernel entry in an nvcc -Xptxas -v log;
    template instances are named by their arguments (the rough kernel's
    factor count; the variant study's variant), and more than six
    are summed up."""
    parts, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            n = re.findall(r"Li(\d+)E", m.group(1))
            entry = ",".join(n) if n else "kernel"
        elif "spill" in line and entry:
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            parts.append([entry, 0, int(spills.group(1)) + int(spills.group(2))])
        elif "Used" in line and "registers" in line and parts:
            parts[-1][1] = int(re.search(r"Used (\d+) registers", line).group(1))
    if len(parts) > 6:
        regs = [r for _, r, _ in parts]
        return (f"{len(parts)} instances, {min(regs)}-{max(regs)} registers, "
                f"{sum(s for _, _, s in parts)} B spilled in all")
    return "; ".join(f"{e}: {r} registers, {s} B spilled" for e, r, s in sorted(parts))


def _wrappers(cuda_mc, mc_variants) -> dict:
    return {"logsv_mc": cuda_mc.simulate_logsv_terminal_cuda,
            "heston_mc": cuda_mc.simulate_heston_terminal_cuda,
            "rough_mc": cuda_mc.simulate_rough_terminal_cuda,
            "hawkes_mc": cuda_mc.simulate_hawkesjd_terminal_cuda,
            "logsv_variants": mc_variants.run_variant_cuda}


def _reset_counts(cuda_mc, mc_variants) -> None:
    for fn in _wrappers(cuda_mc, mc_variants).values():
        fn.launches = 0


def _counts(cuda_mc, mc_variants) -> dict:
    return {name: fn.launches for name, fn in _wrappers(cuda_mc, mc_variants).items()}


def _bound_ms(name: str, ops_per_step, nb_path: int, nb_steps: int):
    """(the least time the card could take for this run's work, what bounds
    it): the larger of the operations over the float32 peak and the bytes
    of state over the memory rate."""
    ops_ms = 1e3 * sum(ops_per_step) * nb_path * nb_steps / PEAK_OPS_PER_S
    bytes_ms = 1e3 * STATE_BYTES[name] * nb_path / PEAK_BYTES_PER_S
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _vs_plain(name, nb_steps, kernel_out, plain_out, labels, exact=False, rtol=1e-4,
              atol=0.0) -> float:
    """print and check the kernel's outputs against the plain version's;
    returns the max absolute error.  ``exact``: equal bit for bit.  Else
    |kernel - plain| <= 1e-4 in log-returns x (they start at 0) and
    <= rtol |plain| + atol in the other outputs."""
    torch.cuda.synchronize()
    rels, max_abs = [], 0.0
    for label, k, p in zip(labels, kernel_out, plain_out):
        _check(bool(torch.isfinite(k).all()), f"{name} kernel output {label} not finite")
        diff = (k - p).abs()
        max_abs = max(max_abs, float(diff.max()))
        if exact:
            _check(bool(torch.equal(k, p)), f"{name} kernel differs from its plain version in "
                                            f"{label} by up to {float(diff.max())}")
            rels.append(f"{label} max abs {float(diff.max()):.3e}")
        elif label == "x":
            rels.append(f"x max abs {float(diff.max()):.3e}")
            _check(float(diff.max()) <= 1e-4, f"{name} kernel disagrees with its plain version "
                                              f"in x: {float(diff.max())}")
        else:
            rel = float((diff / p.abs()).max())
            rels.append(f"{label} max rel {rel:.3e}, max abs {float(diff.max()):.3e}")
            _check(bool((diff <= rtol * p.abs() + atol).all()),
                   f"{name} kernel disagrees with its plain version in {label}: rel {rel}")
    limits = ("equal bit for bit" if exact else
              f"limits 1e-4 in x, {rtol:g} relative" + (f" + {atol:g} absolute" if atol else ""))
    print(f"[kernel-vs-plain] {name} {kernel_out[0].shape[0]} paths x {nb_steps} steps: "
          f"{', '.join(rels)} ({limits}); max abs error {max_abs:.3e}", flush=True)
    return max_abs


def _throughput(name, run_k, run_p, nb_steps):
    """(kernel ms, plain ms, SM clock MHz under the kernel's load) at NB_PATH
    x nb_steps by CUDA events, in turns: plain, kernel, kernel, plain."""
    run_k(), run_p()
    plain_ms = [_event_ms(run_p, 1)]
    kernel_ms = [_event_ms(run_k, 10), _event_ms(run_k, 10)]
    plain_ms.append(_event_ms(run_p, 1))
    k_ms, p_ms = statistics.mean(kernel_ms), statistics.mean(plain_ms)
    path_steps = NB_PATH * nb_steps
    print(f"[throughput] {name} {NB_PATH} paths x {nb_steps} steps: kernel {k_ms:.3f} ms "
          f"({path_steps / k_ms * 1e3:.4e} path-steps/s), plain {p_ms:.3f} ms "
          f"({path_steps / p_ms * 1e3:.4e} path-steps/s); runs kernel {kernel_ms}, "
          f"plain {plain_ms}", flush=True)
    return k_ms, p_ms, _clock_under_load(name, run_k, k_ms)


def _gpu_vs_cpu(gpu, cpu, chain, params, prices, ivols, what, repeats=5):
    """the card's analytic ``prices`` and ``ivols`` against the CPU's; returns
    (price gap / forward, warm price ms, warm ivols ms)."""
    prices_cpu = cpu.price_chain(chain, params)
    ivols_cpu = cpu.compute_model_ivols_for_chain(chain, params)
    for pg, pc, ig, ic, fwd in zip(prices, prices_cpu, ivols, ivols_cpu, chain.forwards):
        _check(np.all(np.isfinite(pg)) and np.all(np.isfinite(ig)), f"{what} analytic output not finite")
        _check(np.max(np.abs(pg - pc)) <= 1e-10 * fwd, f"{what} GPU prices differ from CPU prices")
        _check(np.max(np.abs(ig - ic)) <= 1e-8, f"{what} GPU ivols differ from CPU ivols")
    gap = max(float(np.max(np.abs(pg - pc) / fwd))
              for pg, pc, fwd in zip(prices, prices_cpu, chain.forwards))
    price_ms = _warm_ms(lambda: gpu.price_chain(chain, params), repeats)
    ivol_ms = _warm_ms(lambda: gpu.compute_model_ivols_for_chain(chain, params), repeats)
    return gap, price_ms, ivol_ms


def _same(a, b) -> bool:
    """equal bit for bit: two ragged lists of arrays (NaN where NaN), or two
    fits ((params, cost) by their repr)."""
    if isinstance(a, (list, tuple)) and isinstance(a[0], np.ndarray):
        return len(a) == len(b) and all(np.array_equal(x, y, equal_nan=True)
                                        for x, y in zip(a, b))
    return repr(a) == repr(b)


def _fit_error(pricer, chain, params) -> float:
    """mean over slices of the mean |model ivol - mid vol| (tests/test_logsv.py's rule)."""
    ivols = pricer.compute_model_ivols_for_chain(chain, params)
    return float(np.nanmean([np.nanmean(np.abs(iv - m))
                             for iv, m in zip(ivols, chain.get_mid_vols())]))


def _captured_and_eager(graphs, fn, repeats=CALIB_REPEATS):
    """(first result, capture s, median warm s captured, median warm s eager):
    the first call captures the graph; then captured and eager calls in
    turns (captured, eager, eager, captured, ...), each of which must return
    the first result bit for bit."""
    t0 = time.perf_counter()
    first = fn()
    capture_s = time.perf_counter() - t0
    walls = {"captured": [], "eager": []}
    for i in range(repeats):
        for mode in (("captured", "eager") if i % 2 == 0 else ("eager", "captured")):
            with (graphs.eager() if mode == "eager" else contextlib.nullcontext()):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                walls[mode].append(time.perf_counter() - t0)
            _check(_same(out, first), f"a {mode} call differs from the first captured call: "
                                      f"{out} vs {first}")
    return (first, capture_s, statistics.median(walls["captured"]),
            statistics.median(walls["eager"]))


def _calibration_phase(svt, gpu, chain) -> None:
    """LogSV calibration on the BTC chain from bench.py's params0: the LM fit
    (one CUDA graph) through the pricer and directly, captured and eager, and
    one SLSQP fit."""
    from stochvolmodels_torch.ops import graphs

    smi = _smi_name_and_power()
    p0 = svt.LogSvParams(**CALIB_PARAMS0)
    err0 = _fit_error(gpu, chain, p0)
    fits = {
        "pricer method='lm' (180 steps/yr)": lambda: (gpu.calibrate_model_params_to_chain(
            chain, p0, method="lm", nb_iters=CALIB_LM_ITERS), None),
        "calibrate_logsv_lm_on_device (360 steps/yr)": lambda: svt.calibrate_logsv_lm_on_device(
            chain, p0, nb_iters=CALIB_LM_ITERS)}
    for name, fit_fn in fits.items():
        graphs.REPLAYS.clear()
        (fit, cost), capture_s, captured_s, eager_s = _captured_and_eager(graphs, fit_fn)
        replays = graphs.REPLAYS["lm"]
        _check(replays == 1 + CALIB_REPEATS, f"{name}: {replays} LM graph replays")
        err = _fit_error(gpu, chain, fit)
        _check(err < 0.02 and err < err0, f"{name}: fit error {err} (start {err0})")
        if cost is not None:
            _check(np.isfinite(cost) and cost < 0.01, f"{name}: LM cost {cost}")
        print(f"[calibration] {name}, {CALIB_LM_ITERS} LM iterations from bench.py's params0: "
              f"cost {cost}, mean |ivol - mid| {err:.5f} (start {err0:.5f}); captured fit equal "
              f"bit for bit to the eager fit; capture (first call) {capture_s:.3f} s; "
              f"calib_warm_s captured {captured_s:.4f}, eager {eager_s:.4f} (median of "
              f"{CALIB_REPEATS} warm calls; {replays} graph replays) | {smi}; fit "
              f"{ {k: round(float(v), 6) for k, v in fit.to_dict().items() if k in CALIB_PARAMS0} }",
              flush=True)
    t0 = time.perf_counter()
    fit = gpu.calibrate_model_params_to_chain(chain, p0)
    slsqp_s = time.perf_counter() - t0
    err = _fit_error(gpu, chain, fit)
    _check(err < 0.03, f"SLSQP PARAMS5 fit error {err}")
    print(f"[calibration] SLSQP PARAMS5 from bench.py's params0 (RK4 at 720 steps/yr, "
          f"objective and gradient by torch.autograd): {slsqp_s:.3f} s, nfev "
          f"{gpu.calibration_result.nfev}, nit {gpu.calibration_result.nit}, objective "
          f"{gpu.calibration_result.fun:.6e}, mean |ivol - mid| {err:.5f} | {smi}", flush=True)


def _device_busy(fn):
    """(device kernels, host launch calls, device busy ms, profiled wall ms)
    of one warm call of ``fn`` (:func:`_profiled` after one warm-up call)."""
    fn()
    return _profiled(fn)[1]


def _profiled(fn):
    """(output, (device kernels, host launch calls, device busy ms, profiled
    wall ms)) of one call of ``fn`` by torch.profiler: busy is the sum of the
    kernels' durations, the wall the host time around the call and its
    synchronise.  It records the CUDA activity only (the kernels and the
    runtime's launch calls): on calls of 10^5 kernels the host-op events of
    a full profile take minutes to collect."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = 1e-3 * sum(e.time_range.elapsed_us() for e in kernels)
    launches = sum(1 for e in events if e.name.startswith(("cudaLaunchKernel", "cudaGraphLaunch")))
    return out, (len(kernels), launches, busy_ms, wall_ms)


def _captured_then_eager(graphs, fn, profile_captured=True, profile_eager=True):
    """(output, capture s, warm captured s, captured profile, eager profile)
    of a call through CUDA graphs: the first call captures; one warm captured
    call is timed and (``profile_captured``; else the profile is None) one
    more profiled, then one eager call, profiled or (with ``profile_eager``
    False: its profile is then (None, None, None, wall)) timed; each must
    return the first output bit for bit."""
    t0 = time.perf_counter()
    first = fn()
    capture_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    captured_s = time.perf_counter() - t0
    _check(_same(out, first), "a captured call differs from the first call")
    captured = None
    if profile_captured:
        out, captured = _profiled(fn)
        _check(_same(out, first), "a profiled captured call differs from the first call")
    with graphs.eager():
        if profile_eager:
            out, eager = _profiled(fn)
        else:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            eager = (None, None, None, 1e3 * (time.perf_counter() - t0))
    _check(_same(out, first), "the eager call differs from the captured call")
    return first, capture_s, captured_s, captured, eager


def _busy_line(counts) -> str:
    kernels, launches, busy, wall = counts
    return (f"{kernels} device kernels, {launches} host launch calls, device busy {busy:.2f} ms "
            f"of {wall:.2f} ms profiled wall (idle share {1.0 - busy / wall:.1%})")


def _profile_counts(fn):
    """(device kernels, host launch calls) of one warm call of ``fn``."""
    return _device_busy(fn)[:2]


def _launches_per_inversion(svt, graphs, chain, prices) -> dict:
    """(device kernels, host launch calls, wall ms, CUDA-event ms) of one
    chain inversion, captured and eager."""
    grid = chain.to_grid(device=DEVICE)
    panel = torch.as_tensor(svt.npad(prices, pad_value=np.nan)[0], device=DEVICE)
    invert = lambda: svt.infer_bsm_ivols_from_model_chain_prices(
        ttms=grid.ttms, forwards=grid.forwards, discfactors=grid.discfactors,
        strikes_ttms=grid.strikes, optiontypes_ttms=grid.optioncodes, model_prices_ttms=panel)
    counts = {}
    for mode in ("captured", "eager"):
        with (graphs.eager() if mode == "eager" else contextlib.nullcontext()):
            kernels, launches = _profile_counts(invert)
            wall_ms = _warm_ms(lambda: invert().cpu(), repeats=11)
            device_ms = _event_ms(invert, 11)
        counts[mode] = (kernels, launches, wall_ms, device_ms)
    return counts


def _graph_phase(svt, chain, gpu, hgpu, kgpu, P, H, HP) -> None:
    """the 200-step bisection as one CUDA graph per panel shape: the ivols of
    the LogSV, Heston and Hawkes chains and one MC band call, captured and
    uncaptured, equal bit for bit, with their walls."""
    from stochvolmodels_torch.ops import graphs

    smi = _smi_name_and_power()
    mc_kw = dict(engine="cuda", nb_path=NB_PATH, seed=24, nb_steps=MC_STEPS_PER_YEAR)
    # (call, inversions a call)
    calls = {
        "LogSV compute_model_ivols_for_chain":
            (lambda: gpu.compute_model_ivols_for_chain(chain, P), 1),
        "Heston compute_model_ivols_for_chain":
            (lambda: hgpu.compute_model_ivols_for_chain(chain, H), 1),
        "Hawkes compute_model_ivols_for_chain":
            (lambda: kgpu.compute_model_ivols_for_chain(chain, HP), 1),
        "LogSV compute_mc_chain_implied_vols (3 inversions)":
            (lambda: [iv for band in gpu.compute_mc_chain_implied_vols(chain, P, **mc_kw)[3:6]
                      for iv in band], 3)}
    for name, (fn, inversions) in calls.items():
        graphs.REPLAYS.clear()
        out, _, captured_s, eager_s = _captured_and_eager(graphs, fn, repeats=GRAPH_REPEATS)
        _check(graphs.REPLAYS["bisection"] == inversions * (1 + GRAPH_REPEATS),
               f"{name}: {graphs.REPLAYS['bisection']} bisection graph replays")
        for iv in out:
            _check(np.mean(np.isfinite(iv)) > 0.8, f"{name}: ivols not finite: {iv}")
        print(f"[graphs] {name}: captured equal bit for bit to uncaptured; wall captured "
              f"{1e3 * captured_s:.1f} ms, uncaptured {1e3 * eager_s:.1f} ms (median of "
              f"{GRAPH_REPEATS}); {graphs.REPLAYS['bisection']} bisection graph replays | {smi}",
              flush=True)
    counts = _launches_per_inversion(svt, graphs, chain, gpu.price_chain(chain, P))
    _check(counts["captured"][1] < 20 and counts["eager"][1] > 10000,
           f"host launch calls per inversion {counts}")
    cap, unc = counts["captured"], counts["eager"]
    print(f"[graphs] one chain inversion: device kernels captured {cap[0]}, uncaptured "
          f"{unc[0]}; host launch calls captured {cap[1]}, uncaptured {unc[1]} "
          f"(torch.profiler); wall captured {cap[2]:.2f} ms, uncaptured {unc[2]:.2f} ms "
          f"(median of 11, to the panel on the host); CUDA-event time back to back "
          f"captured {cap[3]:.2f} ms, uncaptured {unc[3]:.2f} ms (mean of 11) | {smi}",
          flush=True)


def _heston_calibration_phase(svt, hgpu, chain) -> None:
    """Heston on the BTC chain: one SLSQP fit from BTC_HESTON_PARAMS, and 16
    LM iterations (one CUDA graph) from the JAX test's start point, captured
    and eager in turns, equal bit for bit."""
    from stochvolmodels_torch.ops import graphs

    smi = _smi_name_and_power()
    H = svt.BTC_HESTON_PARAMS
    err0 = _fit_error(hgpu, chain, H)
    t0 = time.perf_counter()
    fit = hgpu.calibrate_model_params_to_chain(chain, H)
    slsqp_s = time.perf_counter() - t0
    res = hgpu.calibration_result
    err = _fit_error(hgpu, chain, fit)
    _check(np.isfinite(res.fun) and err < err0, f"Heston SLSQP fit error {err} (start {err0})")
    feller = 2.0 * fit.kappa * fit.theta - fit.volvol ** 2
    _check(feller > -1e-6, f"Heston SLSQP fit breaks the Feller condition: {feller}")
    print(f"[heston-calibration] SLSQP from BTC_HESTON_PARAMS (Feller constraint, gradient by "
          f"torch.autograd): {slsqp_s:.3f} s, nfev {res.nfev}, nit {res.nit}, objective "
          f"{res.fun:.6e}, mean |ivol - mid| {err:.5f} (start {err0:.5f}), Feller gap "
          f"2 kappa theta - volvol^2 = {feller:.4f} | {smi}", flush=True)
    p0 = svt.HestonParams(**HESTON_LM_PARAMS0)
    err0 = _fit_error(hgpu, chain, p0)
    graphs.REPLAYS.clear()
    (fit, cost), capture_s, captured_s, eager_s = _captured_and_eager(
        graphs, lambda: svt.calibrate_heston_lm(chain, p0, nb_iters=HESTON_LM_ITERS, device=DEVICE),
        repeats=CALIB_REPEATS)
    replays = graphs.REPLAYS["heston_lm"]
    _check(replays == 1 + CALIB_REPEATS, f"Heston LM: {replays} graph replays")
    err = _fit_error(hgpu, chain, fit)
    _check(np.isfinite(cost) and err < min(err0, 0.05), f"Heston LM fit error {err} (start {err0})")
    feller = 2.0 * fit.kappa * fit.theta - fit.volvol ** 2
    _check(feller > -0.5, f"Heston LM fit far outside the Feller condition: {feller}")
    print(f"[heston-calibration] LM, {HESTON_LM_ITERS} iterations from {HESTON_LM_PARAMS0}: cost "
          f"{cost:.6e}, mean |ivol - mid| {err:.5f} (start {err0:.5f}), Feller gap {feller:.4f}; "
          f"captured fit equal bit for bit to the eager fit; capture (first call) {capture_s:.3f} "
          f"s; warm captured {captured_s:.4f} s, eager {eager_s:.4f} s (median of "
          f"{CALIB_REPEATS}, in turns; {replays} graph replays) | {smi}", flush=True)


def _hawkes_graph_phase(svt, kgpu, chain) -> None:
    """the Hawkes reprice as one CUDA graph: price_chain, the ivols and one
    gamma = 0.5 risk-premia reprice, captured and eager in turns, equal bit
    for bit, with device kernels and host launch calls per call."""
    from stochvolmodels_torch.ops import graphs

    smi = _smi_name_and_power()
    HP = svt.HawkesJDParams()
    norm_chain = svt.OptionChain.to_forward_normalised_strikes(chain)
    HG = svt.HawkesJDParams(risk_premia_gamma=HAWKES_GAMMA)
    calls = {
        "price_chain": (lambda: kgpu.price_chain(chain, HP), True),
        "compute_model_ivols_for_chain": (lambda: kgpu.compute_model_ivols_for_chain(chain, HP),
                                          True),
        f"risk-premia compute_chain_prices_with_vols (gamma {HAWKES_GAMMA}, forward-normalised)":
            (lambda: [a for half in kgpu.compute_chain_prices_with_vols(norm_chain, HG)
                      for a in half], False)}
    for name, (fn, count) in calls.items():
        graphs.REPLAYS.clear()
        out, _, captured_s, eager_s = _captured_and_eager(graphs, fn, repeats=HAWKES_REPEATS)
        _check(graphs.REPLAYS["hawkes_price"] == 1 + HAWKES_REPEATS,
               f"Hawkes {name}: {graphs.REPLAYS['hawkes_price']} reprice graph replays")
        _check(all(np.all(np.isfinite(a)) for a in out), f"Hawkes {name}: output not finite")
        counts = ""
        if count:
            cap = _profile_counts(fn)
            with graphs.eager():
                unc = _profile_counts(fn)
            counts = (f"; device kernels captured {cap[0]}, eager {unc[0]}; host launch calls "
                      f"captured {cap[1]}, eager {unc[1]} (torch.profiler, one call)")
        print(f"[hawkes-graph] {name}: captured equal bit for bit to eager (the graph was "
              f"captured in the Hawkes path above); warm captured {1e3 * captured_s:.1f} ms, eager "
              f"{1e3 * eager_s:.1f} ms (median of {HAWKES_REPEATS}, in turns){counts} | {smi}",
              flush=True)


def _hawkes_calibration_phase(svt, kgpu, chain) -> None:
    """Hawkes on the BTC chain: 16 LM iterations (one CUDA graph an
    iteration) captured, and captured against eager at
    HAWKES_LM_CHECK_ITERS iterations, equal bit for bit; one 8-parameter
    SLSQP fit and one (sigma, gamma) fit on the first HAWKES_FIT_SLICES
    slices."""
    from stochvolmodels_torch.ops import graphs

    smi = _smi_name_and_power()
    p0 = svt.HawkesJDParams()
    lm = lambda n: svt.calibrate_hawkesjd_lm_on_device(chain, p0, nb_iters=n,
                                                       year_steps=HAWKES_LM_YEAR_STEPS, device=DEVICE)
    err0 = _fit_error(kgpu, chain, p0)
    graphs.REPLAYS.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit, cost = lm(HAWKES_LM_ITERS)
    capture_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = lm(HAWKES_LM_ITERS)
    torch.cuda.synchronize()
    captured_s = time.perf_counter() - t0
    _check(_same(again, (fit, cost)), f"Hawkes LM: a warm captured fit differs: {again}")
    _, _, check_captured_s, check_eager_s = _captured_and_eager(
        graphs, lambda: lm(HAWKES_LM_CHECK_ITERS), repeats=1)
    steps = graphs.REPLAYS["hawkes_lm_step"]
    _check(steps == 2 * HAWKES_LM_ITERS + 2 * HAWKES_LM_CHECK_ITERS,
           f"Hawkes LM: {steps} step replays")
    _, cost0 = lm(0)
    init_nodes = _profile_counts(lambda: lm(0))[0]
    step_nodes = _profile_counts(lambda: lm(1))[0] - init_nodes
    err = _fit_error(kgpu, chain, fit)
    gap = fit.jump1_cond + fit.jump2_cond
    _check(np.isfinite(cost) and cost < cost0 and err < err0,
           f"Hawkes LM: cost {cost} (start {cost0}), fit error {err} (start {err0})")
    _check(gap > -1.0, f"Hawkes LM fit far from stationary: jump1 + jump2 = {gap}")
    print(f"[hawkes-calibration] LM, {HAWKES_LM_ITERS} iterations at {HAWKES_LM_YEAR_STEPS} RK4 "
          f"steps/yr from HawkesJDParams(): cost {cost:.6e} (start {cost0:.6e}), mean |ivol - "
          f"mid| {err:.5f} (start {err0:.5f}), stationarity jump1 + jump2 = {gap:.4f}; capture "
          f"(first call: the initial state's graph and the step's) {capture_s:.3f} s; graph nodes "
          f"(device kernels of one replay) initial state {init_nodes}, step {step_nodes}; warm "
          f"captured {captured_s:.4f} s; {HAWKES_LM_CHECK_ITERS}-iteration fits captured "
          f"{check_captured_s:.4f} s and eager {check_eager_s:.4f} s, equal bit for bit (one "
          f"step graph, replayed per iteration; {steps} step replays) | {smi}", flush=True)
    part = svt.OptionChain.get_slices_as_chain(chain, ids=chain.ids[:HAWKES_FIT_SLICES])
    where = f"the first {HAWKES_FIT_SLICES} BTC slices ({', '.join(part.ids)})"
    err0 = _fit_error(kgpu, part, p0)
    t0 = time.perf_counter()
    fit = kgpu.calibrate_model_params_to_chain(part, svt.HawkesJDParams())
    slsqp_s = time.perf_counter() - t0
    res = kgpu.calibration_result
    err = _fit_error(kgpu, part, fit)
    _check(np.isfinite(res.fun) and err < err0, f"Hawkes SLSQP fit error {err} (start {err0})")
    print(f"[hawkes-calibration] 8-parameter SLSQP on {where} (finite differences, reprice and "
          f"bisection two graphs an evaluation): {slsqp_s:.3f} s, nfev {res.nfev}, nit "
          f"{res.nit}, objective {res.fun:.6e}, mean |ivol - mid| {err:.5f} (start {err0:.5f}), "
          f"stationarity {fit.jump1_cond + fit.jump2_cond:.4f} | {smi}", flush=True)
    norm = svt.OptionChain.to_forward_normalised_strikes(part)
    err0 = _fit_error(kgpu, norm, svt.HawkesJDParams(risk_premia_gamma=HAWKES_GAMMA))
    params0 = svt.HawkesJDParams(risk_premia_gamma=HAWKES_GAMMA)
    t0 = time.perf_counter()
    fit = kgpu.calibrate_risk_premia_gamma_to_chain(norm, params0, maxiter=HAWKES_GAMMA_MAXITER)
    gamma_s = time.perf_counter() - t0
    res = kgpu.calibration_result
    err = _fit_error(kgpu, norm, fit)
    _check(fit is params0 and np.isfinite(res.fun) and err <= err0,
           f"Hawkes gamma fit error {err} (start {err0})")
    print(f"[hawkes-calibration] (sigma, gamma) risk-premia fit on {where}, forward-normalised, "
          f"from gamma {HAWKES_GAMMA}, maxiter {HAWKES_GAMMA_MAXITER}: {gamma_s:.3f} s, nfev {res.nfev}, nit {res.nit}, objective "
          f"{res.fun:.6e}, sigma {fit.sigma:.5f}, gamma {fit.risk_premia_gamma:.5f}, mean |ivol - "
          f"mid| {err:.5f} (start {err0:.5f}) | {smi}", flush=True)


def _qvar_phase(svt, graphs) -> None:
    """the Q_VAR reprice of the QV chain at the README parameters: one CUDA
    graph, captured against eager bit for bit, GPU against CPU, and the
    Fourier call struck near 0 against the analytic expected QV."""
    smi = _smi_name_and_power()
    chain = svt.get_qv_options_test_chain_data()
    P = svt.LogSvParams(**README_PARAMS)
    gpu, cpu = svt.LogSVPricer(device=DEVICE), svt.LogSVPricer(device="cpu")
    qvar = svt.VariableType.Q_VAR
    reprice = lambda: gpu.price_chain(chain, P, variable_type=qvar)
    graphs.REPLAYS.clear()
    prices, capture_s, captured_s, eager_s = _captured_and_eager(graphs, reprice, repeats=3)
    _check(graphs.REPLAYS["logsv_qvar_price"] == 4,
           f"Q_VAR reprice: {graphs.REPLAYS['logsv_qvar_price']} graph replays")
    t0 = time.perf_counter()
    prices_cpu = cpu.price_chain(chain, P, variable_type=qvar)
    cpu_s = time.perf_counter() - t0
    gap = 0.0
    for pg, pc, fwd in zip(prices, prices_cpu, chain.forwards):
        _check(np.all(np.isfinite(pg)) and np.all((pg > 0.0) & (pg < 1.0)),
               f"Q_VAR prices not sane: {pg}")
        _check(np.max(np.abs(pg - pc)) <= 1e-10 * fwd, "Q_VAR GPU prices differ from CPU prices")
        gap = max(gap, float(np.max(np.abs(pg - pc)) / fwd))
    captured = _device_busy(reprice)
    with graphs.eager():
        eager = _device_busy(reprice)
    ttm = 0.5
    fwd = svt.compute_analytic_qvar(params=P, ttm=ttm)
    near0 = svt.OptionChain.slice_to_chain(ttm=ttm, forward=fwd, strikes=np.array([1e-8, 0.5 * fwd]),
                                           optiontypes=np.array(['C', 'C']))
    fp = gpu.price_chain(near0, P, variable_type=qvar)[0]
    rel = [abs(fp[0] - fwd) / fwd, abs(fp[1] - 0.5 * fwd) / fwd]
    _check(max(rel) < 0.02, f"Q_VAR call near 0 {fp} vs analytic QV {fwd}")
    print(f"[qvar] QV chain ({len(chain.ttms)} x {len(chain.strikes_ttms[0])} calls, 40000-point "
          f"Psi grid, RK4 at 720 steps/yr): GPU vs CPU max |dprice|/fwd {gap:.2e} (CPU {cpu_s:.2f} "
          f"s); captured equal bit for bit to eager; capture (first call) {capture_s:.3f} s; warm "
          f"captured {1e3 * captured_s:.1f} ms, eager {1e3 * eager_s:.1f} ms (median of 3, in "
          f"turns); captured: {_busy_line(captured)}; eager: {_busy_line(eager)}; 0.5y call "
          f"struck at 1e-8 {fp[0]:.6f} and at QV/2 {fp[1]:.6f} vs analytic QV {fwd:.6f} (rel "
          f"{rel[0]:.2e}, {rel[1]:.2e}) | {smi}", flush=True)


def _pdfs_phase(svt, graphs) -> None:
    """the log-return, QV and vol densities at the stiff paper parameters:
    mass and mean, GPU against CPU, walls and kernels captured and eager."""
    smi = _smi_name_and_power()
    P = svt.LogSvParams(**STIFF_PARAMS)
    for name in ("LOG_RETURN", "Q_VAR", "SIGMA"):
        vt = svt.VariableType[name]
        grid = P.get_variable_space_grid(variable_type=vt, ttm=PDF_TTM, n=PDF_POINTS, n_stdevs=4.5)
        run = lambda: [svt.logsv_pdfs(P, PDF_TTM, grid, variable_type=vt, device=DEVICE)]
        graphs.REPLAYS.clear()
        (pdf,), capture_s, captured_s, eager_s = _captured_and_eager(graphs, run, repeats=1)
        _check(graphs.REPLAYS["logsv_pdf"] == 2, f"{name} density: {graphs.REPLAYS['logsv_pdf']} replays")
        mass = float(np.nansum(pdf))
        mean = float(np.nansum(pdf * grid) / mass)
        _check(np.all(np.isfinite(pdf)) and 0.95 < mass < 1.05, f"{name} density mass {mass}")
        if name != "LOG_RETURN":
            _check(0.5 < mean < 1.5, f"{name} density mean {mean}")
        t0 = time.perf_counter()
        pdf_cpu = svt.logsv_pdfs(P, PDF_TTM, grid, variable_type=vt, device="cpu")
        cpu_s = time.perf_counter() - t0
        dev = float(np.max(np.abs(pdf - pdf_cpu)))
        _check(dev <= 1e-10, f"{name} density GPU vs CPU {dev}")
        captured = _device_busy(run)
        with graphs.eager():
            eager = _device_busy(run)
        print(f"[pdfs] {name} at ttm {PDF_TTM}, {PDF_POINTS} points: mass {mass:.6f}, mean "
              f"{mean:.6f}; GPU vs CPU max |dpdf| {dev:.2e} (CPU {cpu_s:.2f} s); "
              f"captured equal bit for bit to eager; capture {capture_s:.3f} s; warm captured "
              f"{1e3 * captured_s:.1f} ms, eager {1e3 * eager_s:.1f} ms; captured: "
              f"{_busy_line(captured)}; eager: {_busy_line(eager)} | {smi}", flush=True)


def _qvar_mc_phase(svt, cuda_mc, mc_variants) -> float:
    """Q_VAR chain prices through the logsv_mc kernel at NB_PATH paths
    against the analytic Q_VAR prices, and the kernel against its plain
    version on the chain's last slice at this path's steps; returns that
    check's max absolute error."""
    from stochvolmodels_torch.utils.funcs import set_time_grid

    smi = _smi_name_and_power()
    chain = svt.get_qv_options_test_chain_data()
    P = svt.LogSvParams(**README_PARAMS)
    gpu = svt.LogSVPricer(device=DEVICE)
    qvar = svt.VariableType.Q_VAR
    analytic = gpu.price_chain(chain, P, variable_type=qvar)
    kw = dict(variable_type=qvar, nb_path=NB_PATH, engine="cuda", seed=24,
              nb_steps=QVAR_MC_STEPS_PER_YEAR)
    _reset_counts(cuda_mc, mc_variants)
    mc, std = gpu.model_mc_price_chain(chain, P, **kw)
    launches = _counts(cuda_mc, mc_variants)["logsv_mc"]
    _check(launches == len(chain.ttms), f"Q_VAR MC path launched {launches} logsv_mc kernels")
    worst = 0.0
    for a, m, s in zip(analytic, mc, std):
        _check(np.all(np.isfinite(m)), f"Q_VAR MC prices not finite: {m}")
        ratio = np.abs(m - a) / (4.0 * s + 0.02 * a + 2e-4)
        _check(np.all(ratio < 1.0), f"Q_VAR MC {m} outside 4 stderr + 2% + 2e-4 of {a}")
        worst = max(worst, float(np.max(ratio)))
    ms = _warm_ms(lambda: gpu.model_mc_price_chain(chain, P, **kw), repeats=3)
    # the chain pricer's slices again (seed 24 + 7919 i), then the last slice
    # (6m to 12m) by the kernel and by its plain version from the same state
    state = (torch.zeros(NB_PATH, dtype=torch.float32, device=DEVICE),
             torch.full((NB_PATH,), P.sigma0, dtype=torch.float32, device=DEVICE),
             torch.zeros(NB_PATH, dtype=torch.float32, device=DEVICE))
    ttms = np.concatenate([[0.0], chain.ttms])
    step_kw = dict(theta=P.theta, kappa1=P.kappa1, kappa2=P.kappa2, beta=P.beta,
                   volvol=P.volvol, nb_steps_per_year=QVAR_MC_STEPS_PER_YEAR)
    for i in range(len(chain.ttms) - 1):
        state = cuda_mc.simulate_logsv_terminal_cuda(24 + 7919 * i, *state,
                                                     ttm=float(ttms[i + 1] - ttms[i]), **step_kw)
    i = len(chain.ttms) - 1
    step_kw.update(ttm=float(ttms[i + 1] - ttms[i]))
    err = _vs_plain(f"logsv_mc (Q_VAR chain, {chain.ids[i]} slice)",
                    set_time_grid(step_kw["ttm"], QVAR_MC_STEPS_PER_YEAR)[0],
                    cuda_mc.simulate_logsv_terminal_cuda(24 + 7919 * i, *state, **step_kw),
                    cuda_mc.simulate_logsv_terminal_torch(24 + 7919 * i, *state, **step_kw),
                    ("x", "sigma", "qvar"), atol=1e-4)
    print(f"[qvar-mc] QV chain through logsv_mc, {NB_PATH} paths at {QVAR_MC_STEPS_PER_YEAR} "
          f"steps/yr: {launches} kernel launches for {len(chain.ttms)} maturities (counted on "
          f"this path alone; the kernels line keeps the LOG_RETURN path's count); max |MC - "
          f"analytic| / (4 stderr + 2% + 2e-4) {worst:.3f}; warm model_mc_price_chain {ms:.1f} ms "
          f"| {smi}", flush=True)
    return err


def _mc_band(chain, analytic, mc, std, what) -> float:
    worst = 0.0
    for a, m, s, fwd in zip(analytic, mc, std, chain.forwards):
        _check(np.all(np.isfinite(m)), f"{what} prices not finite: {m}")
        ratio = np.abs(a - m) / (4.0 * s + 0.015 * a + 1e-4 * fwd)   # tests/test_logsv.py's band
        _check(np.all(ratio < 1.0), f"{what} {m} outside 4 stderr + 1.5% + 1e-4 fwd of {a}")
        worst = max(worst, float(np.max(ratio)))
    return worst


def _mc_engines_phase(svt, graphs, chain) -> None:
    """the antithetic scan, QMC with replicates and fixed-randoms chain MC on
    BTC, each within its band of the analytic prices, with stderrs beside the
    plain scan's, QMC's launches per slice, and the fixed-randoms prices GPU
    against CPU."""
    from stochvolmodels_torch.models.logsv import pricer as lp

    smi = _smi_name_and_power()
    P = svt.LOGSV_BTC_PARAMS
    gpu = svt.LogSVPricer(device=DEVICE)
    analytic = gpu.price_chain(chain, P)
    base = dict(nb_steps=MC_STEPS_PER_YEAR, seed=24)
    runs = {"scan": dict(base, engine="scan", nb_path=ENGINE_NB_PATH),
            "antithetic scan": dict(base, engine="scan", nb_path=ENGINE_NB_PATH, antithetic=True),
            f"qmc ({QMC_REPLICATES} replicates)": dict(base, engine="qmc", nb_path=QMC_NB_PATH,
                                                       qmc_replicates=QMC_REPLICATES)}
    stderr = {}
    for name, kw in runs.items():
        t0 = time.perf_counter()
        mc, std = gpu.model_mc_price_chain(chain, P, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        worst = _mc_band(chain, analytic, mc, std, name)
        stderr[name] = float(np.mean([np.mean(s / f) for s, f in zip(std, chain.forwards)]))
        print(f"[mc-engines] {name}, {kw['nb_path']} paths: max |MC - analytic| / band "
              f"{worst:.3f}; mean stderr / fwd {stderr[name]:.3e} (plain scan "
              f"{stderr['scan']:.3e}); first call {wall:.3f} s | {smi}", flush=True)
    qmc_kw = runs[f"qmc ({QMC_REPLICATES} replicates)"]
    qmc_call = lambda: gpu.model_mc_price_chain(chain, P, **qmc_kw)
    captured = _device_busy(qmc_call)
    with graphs.eager():
        eager = _device_busy(qmc_call)
    n = len(chain.ttms)
    print(f"[mc-engines] QMC chain call, per slice ({n} slices): host launch calls captured "
          f"{captured[1] / n:.0f}, eager {eager[1] / n:.0f}; device kernels captured "
          f"{captured[0] / n:.0f}, eager {eager[0] / n:.0f}; captured: {_busy_line(captured)}; "
          f"eager: {_busy_line(eager)} | {smi}", flush=True)
    W0s, W1s, dts = lp.get_randoms_for_chain_valuation(chain.ttms, nb_path=FIXED_NB_PATH,
                                                       nb_steps_per_year=MC_STEPS_PER_YEAR, seed=10)
    fixed_kw = dict(ttms=chain.ttms, forwards=chain.forwards, discfactors=chain.discfactors,
                    strikes_ttms=chain.strikes_ttms, optiontypes_ttms=chain.optiontypes_ttms,
                    W0s=W0s, W1s=W1s, dts=dts, v0=P.sigma0, theta=P.theta, kappa1=P.kappa1,
                    kappa2=P.kappa2, beta=P.beta, volvol=P.volvol)
    t0 = time.perf_counter()
    fg, fs = lp.logsv_mc_chain_pricer_fixed_randoms(device=DEVICE, **fixed_kw)
    gpu_s = time.perf_counter() - t0
    fc, _ = lp.logsv_mc_chain_pricer_fixed_randoms(device="cpu", **fixed_kw)
    gap = max(float(np.max(np.abs(g - c)) / f) for g, c, f in zip(fg, fc, chain.forwards))
    _check(gap <= 1e-10, f"fixed-randoms GPU prices differ from CPU: {gap}")
    worst = _mc_band(chain, analytic, fg, fs, "fixed randoms")
    print(f"[mc-engines] fixed randoms, {FIXED_NB_PATH} paths of numpy blocks: GPU vs CPU max "
          f"|dprice|/fwd {gap:.2e}; max |MC - analytic| / band {worst:.3f}; GPU call "
          f"{gpu_s:.3f} s (blocks to the card included) | {smi}", flush=True)


def _mc_calibration_phase(svt, chain) -> None:
    """fits on the first two BTC slices: MC SLSQP with the 'scan' and 'qmc'
    engines, the varswap-backbone fit, and one rough-MC objective and
    gradient GPU against CPU."""
    from stochvolmodels_torch.models.logsv import pricer as lp

    smi = _smi_name_and_power()
    part = svt.OptionChain.get_slices_as_chain(chain, ids=chain.ids[:MC_CALIB_SLICES])
    where = f"the first {MC_CALIB_SLICES} BTC slices ({', '.join(part.ids)})"
    gpu = svt.LogSVPricer(device=DEVICE)
    p0 = svt.LogSvParams(**CALIB_PARAMS0)
    err0 = _fit_error(gpu, part, p0)
    fits = {"MC scan": dict(calibration_engine=svt.CalibrationEngine.MC, mc_engine="scan",
                            nb_path=MC_CALIB_NB_PATH),
            "MC qmc": dict(calibration_engine=svt.CalibrationEngine.MC, mc_engine="qmc",
                           nb_path=MC_CALIB_NB_PATH),
            "PARAMS_WITH_VARSWAP_FIT (analytic)": dict(
                model_calibration_type=svt.LogsvModelCalibrationType.PARAMS_WITH_VARSWAP_FIT)}
    for name, kw in fits.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit = gpu.calibrate_model_params_to_chain(part, p0, **kw)
        wall = time.perf_counter() - t0
        res = gpu.calibration_result
        err = _fit_error(gpu, part, fit)
        _check(np.isfinite(res.fun) and np.isfinite(err) and err < max(err0, 0.05),
               f"{name} fit error {err} (start {err0})")
        extra = ""
        if fit.vol_backbone is not None:
            etas = fit.get_vol_backbone_etas(part.ttms)
            _check(np.all(np.isfinite(etas) & (etas > 0.0)), f"{name}: backbone {etas}")
            extra = f", backbone etas {np.round(etas, 5).tolist()}"
        print(f"[mc-calibration] {name} SLSQP on {where} from bench.py's params0: {wall:.3f} s, "
              f"nfev {res.nfev}, nit {res.nit}, objective {res.fun:.6e}, mean |ivol - mid| "
              f"{err:.5f} (start {err0:.5f}){extra} | {smi}", flush=True)
    rough = svt.LogSvParams(**CALIB_PARAMS0, H=0.1)
    rough.approximate_kernel(T=float(part.ttms[-1]))
    Z0, Z1, _ = lp.get_randoms_for_rough_vol_chain_valuation(
        part.ttms, nb_path=ROUGH_CALIB_NB_PATH, nb_steps_per_year=MC_STEPS_PER_YEAR, seed=12)
    x0 = np.array([rough.sigma0, rough.theta, rough.kappa1, rough.beta, rough.volvol])
    out = {}
    for dev in (DEVICE, "cpu"):
        pricer = svt.LogSVPricer(device=dev)
        objective, *_ = pricer._slsqp_problem(
            part, rough, svt.LogSvParams(sigma0=0.1, theta=0.1, kappa1=0.25, kappa2=0.25,
                                         beta=-3.0, volvol=0.2),
            svt.LogSvParams(sigma0=1.5, theta=1.5, kappa1=10.0, kappa2=10.0, beta=3.0, volvol=3.0),
            True, False, svt.LogsvModelCalibrationType.PARAMS5, svt.ConstraintsType.UNCONSTRAINT,
            calibration_engine=svt.CalibrationEngine.ROUGH_MC, nb_steps=MC_STEPS_PER_YEAR,
            randoms=(Z0, Z1))
        t0 = time.perf_counter()
        out[dev] = objective(x0)
        out[dev + "_s"] = time.perf_counter() - t0
    (lg, gg), (lc, gc) = out[DEVICE], out["cpu"]
    _check(np.isfinite(lg) and np.all(np.isfinite(gg)), f"rough objective {lg}, {gg}")
    _check(abs(lg - lc) <= 1e-9 * abs(lc) and np.all(np.abs(gg - gc) <= 1e-9 * np.abs(gc).max()),
           f"rough objective GPU {lg}, {gg} vs CPU {lc}, {gc}")
    print(f"[mc-calibration] ROUGH_MC objective and gradient at H = 0.1 ({len(rough.nodes)} "
          f"nodes, {ROUGH_CALIB_NB_PATH} paths) on {where}: GPU {lg:.9e} vs CPU {lc:.9e}, max "
          f"|dgrad| {float(np.max(np.abs(gg - gc))):.2e} (limit 1e-9 relative); GPU "
          f"{out[DEVICE + '_s']:.3f} s, CPU {out['cpu_s']:.3f} s | {smi}", flush=True)


def _greeks_close(gpu_out, cpu_out, chain, what) -> tuple:
    """GPU against CPU: prices to 1e-10 x forward, every greek panel to 1e-8
    relative (+ 1e-12 of the panel's largest entry); returns the largest
    price gap / forward and the largest relative greek gap."""
    price_gap, greek_gap = 0.0, 0.0
    for key in gpu_out:
        for g, c, fwd in zip(gpu_out[key], cpu_out[key], chain.forwards):
            _check(np.all(np.isfinite(g)), f"{what} {key} not finite: {g}")
            if key == "price":
                _check(np.max(np.abs(g - c)) <= 1e-10 * fwd, f"{what} GPU prices differ from CPU")
                price_gap = max(price_gap, float(np.max(np.abs(g - c)) / fwd))
                continue
            scale = 1e-12 * float(np.max(np.abs(c)))
            _check(bool(np.all(np.abs(g - c) <= 1e-8 * np.abs(c) + scale)),
                   f"{what} GPU {key} differs from CPU: {g} vs {c}")
            greek_gap = max(greek_gap, float(np.max(np.abs(g - c) / (np.abs(c) + scale + 1e-300))))
    return price_gap, greek_gap


def _greeks_phase(svt, graphs, chain) -> None:
    """LogSV and Heston chain greeks on the BTC chain at full width (1000-point
    Phi grid, 240 RK4 steps/yr for LogSV): delta, gamma, vega, calendar theta
    and every parameter greek, in price and in vol space; each program one
    CUDA graph, captured against eager bit for bit, the GPU against the CPU;
    then the pathwise MC delta and vega at 100,000 paths and 360 steps/yr
    against a fixed-seed central difference on the card."""
    smi = _smi_name_and_power()
    models = {
        "LogSV": (svt.LogSVPricer, svt.LOGSV_BTC_PARAMS,
                  ("delta", "gamma", "vega", "theta_calendar", "theta", "kappa1", "kappa2",
                   "beta", "volvol")),
        "Heston": (svt.HestonPricer, svt.BTC_HESTON_PARAMS,
                   ("delta", "gamma", "vega", "theta_calendar", "theta", "kappa", "rho",
                    "volvol"))}
    for model, (cls, params, names) in models.items():
        gpu, cpu = cls(device=DEVICE), cls(device="cpu")
        for in_vols in (False, True):
            flat = lambda d: [a for k in sorted(d) for a in d[k]]
            holder = {}

            def call():
                holder["out"] = gpu.compute_chain_greeks(chain, params, greeks=names,
                                                         in_vols=in_vols)
                return flat(holder["out"])

            # a profile of 10^5 kernels costs ~0.1 ms an event to collect: the captured
            # calls are profiled in price space only, the eager ones for Heston's (~7k kernels)
            profile_eager = model == "Heston" and not in_vols
            before = graphs.REPLAYS["greeks"]
            _, capture_s, captured_s, captured, eager = _captured_then_eager(
                graphs, call, profile_captured=not in_vols, profile_eager=profile_eager)
            out = holder["out"]
            replays = graphs.REPLAYS["greeks"] - before
            calls = 3 if not in_vols else 2
            _check(replays == 3 * calls, f"{model} greeks: {replays} graph replays (3 programs, "
                                         f"{calls} captured calls)")
            t0 = time.perf_counter()
            ref = cpu.compute_chain_greeks(chain, params, greeks=names, in_vols=in_vols)
            cpu_s = time.perf_counter() - t0
            price_gap, greek_gap = _greeks_close(out, ref, chain, f"{model} greeks")
            space = "vol" if in_vols else "price"
            print(f"[greeks] {model} {space} space, {len(names)} greeks on the BTC chain "
                  f"({len(chain.ttms)} slices, 1000-point Phi grid): GPU vs CPU max |dprice|/fwd "
                  f"{price_gap:.2e}, greeks max rel {greek_gap:.2e} (CPU {cpu_s:.2f} s); "
                  f"captured equal bit for bit to eager ({replays} graph replays, 3 programs: "
                  f"the greeks and calendar theta's two shifted maturities); capture (first "
                  f"call) {capture_s:.3f} s; warm captured {1e3 * captured_s:.1f} ms, eager "
                  f"{eager[3]:.1f} ms{' (profiled)' if profile_eager else ''}; captured: "
                  f"{_busy_line(captured) if captured else 'not profiled'}; eager: "
                  f"{_busy_line(eager) if profile_eager else 'not profiled'} | {smi}", flush=True)
    # pathwise MC greeks on the forward-normalised chain (the units of tests/test_greeks.py)
    norm = svt.OptionChain.to_forward_normalised_strikes(chain)
    P = svt.LOGSV_BTC_PARAMS
    mc_kw = dict(nb_path=MC_GREEKS_NB_PATH, nb_steps_per_year=MC_STEPS_PER_YEAR, seed=7,
                 device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mc = svt.logsv_mc_chain_greeks(norm, P, greeks=("delta", "vega"), **mc_kw)
    mc_s = time.perf_counter() - t0
    eps = 1e-4

    def prices(params, mult=1.0):
        c = svt.OptionChain.to_forward_normalised_strikes(chain)
        c.forwards = c.forwards * mult
        return svt.logsv_mc_chain_greeks(c, params, greeks=(), **mc_kw)["price"]

    up, dn = prices(P, 1 + eps), prices(P, 1 - eps)
    bump = lambda d: svt.LogSvParams(**{**P.to_dict(), "sigma0": P.sigma0 + d})
    vup, vdn = prices(bump(eps)), prices(bump(-eps))
    worst = 0.0
    for i in range(len(chain.ttms)):
        for key, fd in (("delta", (up[i] - dn[i]) / (2 * eps)), ("vega", (vup[i] - vdn[i]) / (2 * eps))):
            _check(np.all(np.isfinite(mc[key][i])), f"MC {key} not finite")
            ratio = np.abs(mc[key][i] - fd) / (5e-3 * np.abs(fd) + 5e-4)
            _check(bool(np.all(ratio < 1.0)), f"MC pathwise {key} {mc[key][i]} vs fixed-seed FD {fd}")
            worst = max(worst, float(np.max(ratio)))
    print(f"[greeks] LogSV pathwise MC delta and vega, {MC_GREEKS_NB_PATH} paths at "
          f"{MC_STEPS_PER_YEAR} steps/yr (eager float64 Euler, forward-normalised chain): max "
          f"|pathwise - fixed-seed central FD| / (5e-3 |FD| + 5e-4) {worst:.3f}; wall "
          f"{mc_s:.3f} s (both greeks, one call) | {smi}", flush=True)


def _analytic_ode_phase(svt, graphs, chain) -> None:
    """the exponential-Euler affine solve on the BTC chain's full Phi grid:
    the first slice GPU against CPU, the solve chained over the chain's
    maturities against the RK4's, steps, kernels, captured and eager walls."""
    from stochvolmodels_torch.models.logsv import affine as afe
    from stochvolmodels_torch.ops import mgf

    smi = _smi_name_and_power()
    P = svt.LOGSV_BTC_PARAMS
    vs = svt.set_vol_scaler(sigma0=P.sigma0, ttm=np.min(chain.ttms))
    ode = dict(theta=P.theta, kappa1=P.kappa1, kappa2=P.kappa2, beta=P.beta, volvol=P.volvol)

    def first_slice(device, analytic=True):
        phi = mgf.get_phi_grid(vol_scaler=vs, device=device)
        zero = torch.zeros_like(phi)
        return afe.compute_logsv_a_mgf_grid(ttm=float(chain.ttms[0]), phi_grid=phi,
                                            psi_grid=zero, theta_grid=zero, sigma0=P.sigma0,
                                            is_analytic=analytic, vol_scaler=vs, **ode)[1]

    gpu = first_slice(DEVICE).cpu().numpy()
    cpu = first_slice("cpu").numpy()
    gap = float(np.max(np.abs(gpu - cpu) / np.maximum(1.0, np.abs(cpu))))
    _check(np.all(np.isfinite(gpu)) and gap <= 1e-10, f"analytic ODE GPU vs CPU {gap}")

    def chained(analytic):
        phi = mgf.get_phi_grid(vol_scaler=vs, device=DEVICE)
        zero = torch.zeros_like(phi)
        a_t, ttm0, out = None, 0.0, []
        for ttm in chain.ttms:
            a_t, log_mgf = afe.compute_logsv_a_mgf_grid(
                ttm=float(ttm) - ttm0, phi_grid=phi, psi_grid=zero, theta_grid=zero,
                sigma0=P.sigma0, a_t0=a_t, is_analytic=analytic, vol_scaler=vs, **ode)
            out.append(log_mgf.cpu().numpy())
            ttm0 = float(ttm)
        return out

    graphs.REPLAYS.clear()
    ana, capture_s, captured_s, eager_s = _captured_and_eager(graphs, lambda: chained(True),
                                                              repeats=3)
    replays = graphs.REPLAYS["logsv_analytic_ode"]
    _check(replays == 4 * len(chain.ttms), f"analytic ODE: {replays} graph replays")
    rk4 = chained(False)
    # the scheme's O(dt^2) error grows with |phi|: held relative to max(1, |log MGF|) (the
    # JAX test's 2e-4 is absolute on |Im phi| <= 40 at one ttm 0.25, where |log MGF| <= ~10)
    chain_gap = max(float(np.max(np.abs(a - r) / np.maximum(1.0, np.abs(r))))
                    for a, r in zip(ana, rk4))
    mgf_gap = max(float(np.max(np.abs(np.exp(a) - np.exp(r)))) for a, r in zip(ana, rk4))
    _check(chain_gap <= 2e-4, f"chained analytic MGF vs RK4 {chain_gap}")
    p_max = afe.phi_grid_p_max(vs)
    steps, ttm0 = [], 0.0
    for ttm in chain.ttms:
        steps.append(afe.analytic_nb_steps(float(ttm) - ttm0, p_max))
        ttm0 = float(ttm)
    captured = _profiled(lambda: chained(True))[1]
    with graphs.eager():
        eager = _profiled(lambda: chained(True))[1]
    print(f"[analytic-ode] exponential-Euler solve on the 1000-point Phi grid (p_max {p_max:.4f} "
          f"from the grid's constants, 10 fixed-point iterations a step): first "
          f"slice GPU vs CPU max rel {gap:.2e} (limit 1e-10); chained over {len(chain.ttms)} "
          f"slices, max |log MGF - RK4's| / max(1, |log MGF|) {chain_gap:.2e} (limit 2e-4), max |MGF - "
          f"RK4's| {mgf_gap:.2e}; steps per slice {steps}; "
          f"captured equal bit for bit to eager (one graph a slice, {replays} replays); capture "
          f"(first call) {capture_s:.3f} s; warm captured {1e3 * captured_s:.1f} ms, eager "
          f"{1e3 * eager_s:.1f} ms (median of 3); captured: {_busy_line(captured)}; eager: "
          f"{_busy_line(eager)} | {smi}", flush=True)


def _heston_extras_phase(svt, graphs, chain) -> None:
    """Heston QMC (2^17 paths, 8 replicates) and antithetic chains on BTC within
    the band of the analytic prices, with stderrs, QMC's launches per slice;
    analytic Q_VAR on the QV chain, GPU against CPU."""
    smi = _smi_name_and_power()
    H = svt.BTC_HESTON_PARAMS
    gpu, cpu = svt.HestonPricer(device=DEVICE), svt.HestonPricer(device="cpu")
    analytic = gpu.price_chain(chain, H)
    runs = {"scan": dict(engine="scan", nb_path=ENGINE_NB_PATH),
            "antithetic scan": dict(engine="scan", nb_path=ENGINE_NB_PATH, antithetic=True),
            f"qmc ({QMC_REPLICATES} replicates)": dict(engine="qmc", nb_path=QMC_NB_PATH,
                                                       qmc_replicates=QMC_REPLICATES)}
    stderr = {}
    for name, kw in runs.items():
        graphs.REPLAYS.clear()
        t0 = time.perf_counter()
        mc, std = gpu.model_mc_price_chain(chain, H, seed=24, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        worst = _mc_band(chain, analytic, mc, std, f"Heston {name}")
        stderr[name] = float(np.mean([np.mean(s / f) for s, f in zip(std, chain.forwards)]))
        if kw["engine"] == "qmc":
            _check(graphs.REPLAYS["heston_qmc"] == len(chain.ttms),
                   f"Heston QMC: {graphs.REPLAYS['heston_qmc']} graph replays")
        print(f"[heston-extras] {name}, {kw['nb_path']} paths at 360 steps/yr: max |MC - "
              f"analytic| / band {worst:.3f}; mean stderr / fwd {stderr[name]:.3e} (plain scan "
              f"{stderr['scan']:.3e}); first call {wall:.3f} s | {smi}", flush=True)
    qmc_call = lambda: gpu.model_mc_price_chain(chain, H, seed=24, **runs[
        f"qmc ({QMC_REPLICATES} replicates)"])
    captured = _profiled(qmc_call)[1]
    with graphs.eager():
        eager = _profiled(qmc_call)[1]
    n = len(chain.ttms)
    print(f"[heston-extras] QMC chain call, per slice ({n} slices): host launch calls captured "
          f"{captured[1] / n:.0f}, eager {eager[1] / n:.0f}; captured: {_busy_line(captured)}; "
          f"eager: {_busy_line(eager)} | {smi}", flush=True)
    qv = svt.get_qv_options_test_chain_data()
    qvar = svt.VariableType.Q_VAR
    prices = gpu.price_chain(qv, H, variable_type=qvar)
    prices_cpu = cpu.price_chain(qv, H, variable_type=qvar)
    gap = 0.0
    for pg, pc, fwd in zip(prices, prices_cpu, qv.forwards):
        _check(np.all(np.isfinite(pg)) and np.all(pg > 0.0), f"Heston Q_VAR prices not sane: {pg}")
        _check(np.max(np.abs(pg - pc)) <= 1e-10 * fwd, "Heston Q_VAR GPU prices differ from CPU")
        gap = max(gap, float(np.max(np.abs(pg - pc)) / fwd))
    q_ms = _warm_ms(lambda: gpu.price_chain(qv, H, variable_type=qvar), repeats=3)
    print(f"[heston-extras] Q_VAR on the QV chain ({len(qv.ttms)} x {len(qv.strikes_ttms[0])} "
          f"calls, 40000-point Psi grid, closed form): GPU vs CPU max |dprice|/fwd {gap:.2e}; "
          f"warm price_chain {q_ms:.1f} ms | {smi}", flush=True)


def _rough_rules_phase(svt, cuda_mc, mc_variants, chain) -> dict:
    """the rough chain through rough_mc with Gaussian-rule lifts of N = 2, 4
    and 5 nodes (the counts the ported rules give): each chain driven with
    the launch counts set to 0 just before it and read just after, each
    instance held against its plain version at 2^20 x 91, its ms and the
    plain version's at 2^20 x 361; then one 'expm'-drift scan chain against
    the 'rk4' one.  Returns {N: (kernel ms, plain ms, max abs err)}."""
    from stochvolmodels_torch.ops import _build
    from stochvolmodels_torch.utils.funcs import set_time_grid

    smi = _smi_name_and_power()
    P = svt.LOGSV_BTC_PARAMS
    gpu = svt.LogSVPricer(device=DEVICE)
    max_ttm = float(np.max(chain.ttms))
    vartheta = float(np.hypot(P.beta, P.volvol))
    main_steps = set_time_grid(MAIN_TTM, MC_STEPS_PER_YEAR)[0]
    tp_steps = set_time_grid(THROUGHPUT_TTM, MC_STEPS_PER_YEAR)[0]
    out, launched, roof = {}, {}, {}
    sass = _load_script("scripts/sass_step_loops.py")
    loops = sass.loop_lengths(sass.disassemble(_build._lib_path("rough_mc")))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n in ROUGH_RULE_NODES:
        nodes, weights = svt.gaussian_rule(ROUGH_H, n, max_ttm)
        _check(len(nodes) == n and np.all(weights > 0.0), f"gaussian_rule gave {nodes}, {weights}")
        params = svt.LogSvParams(**{**P.to_dict(), "H": ROUGH_H, "nodes": nodes, "weights": weights})
        _reset_counts(cuda_mc, mc_variants)
        prices, _ = gpu.model_mc_price_chain(chain, params, nb_path=NB_PATH, use_rough_mc=True,
                                             engine="cuda", seed=24)
        launched[n] = _counts(cuda_mc, mc_variants)["rough_mc"]
        _check(launched[n] == len(chain.ttms), f"rough chain N={n}: {launched[n]} launches")
        ivols = chain.compute_model_ivols_from_chain_data(model_prices=prices, device=DEVICE)
        for iv in ivols:
            ok = np.isfinite(iv)
            _check(np.mean(ok) > 0.8 and np.all((iv[ok] > 0.3) & (iv[ok] < 2.5)),
                   f"rough N={n} ivols not sane: {iv}")
        kw = dict(ttm=MAIN_TTM, sigma0=P.sigma0, theta=P.theta, kappa1=P.kappa1, kappa2=P.kappa2,
                  rho=P.beta / vartheta, volvol=vartheta, nodes=nodes, weights=weights, device=DEVICE)
        err = _vs_plain(f"rough_mc (N={n}, Gaussian rule)", main_steps,
                        cuda_mc.simulate_rough_terminal_cuda(7, NB_PATH, **kw),
                        cuda_mc.simulate_rough_terminal_torch(7, NB_PATH, **kw),
                        ("x", "vw", "y"), atol=1e-4)
        tp = dict(kw, ttm=THROUGHPUT_TTM)
        run_k = lambda: cuda_mc.simulate_rough_terminal_cuda(7, NB_PATH, **tp)
        run_p = lambda: cuda_mc.simulate_rough_terminal_torch(7, NB_PATH, **tp)
        run_k()
        k_ms = statistics.mean([_event_ms(run_k, 10), _event_ms(run_k, 10)])
        p_ms = _event_ms(run_p, 1)
        clock = _clock_under_load(f"rough_mc (N={n})", run_k, k_ms)
        bound, _ = _bound_ms("rough_mc", cuda_mc.ROUGH_OPS_PER_STEP[n], NB_PATH, tp_steps)
        _, common, _ = loops[str(n)]
        floor = (float("nan") if clock is None else 1e3 * common * (NB_PATH // 32) * tp_steps
                 / (sms * ISSUE_PER_SM_CLOCK * clock * 1e6))
        out[n] = (k_ms, p_ms, err)
        roof[n] = (sum(cuda_mc.ROUGH_OPS_PER_STEP[n]), bound, common, floor, clock)
    _reset_counts(cuda_mc, mc_variants)
    print(f"[rough-rules] rough chain through rough_mc at N = {list(ROUGH_RULE_NODES)} "
          f"(gaussian_rule, H = {ROUGH_H}), {NB_PATH} paths: launches per chain call "
          f"{launched}; kernel / plain ms at {NB_PATH} x {tp_steps} steps "
          + ", ".join(f"N={n} {k:.3f} / {p:.1f} ({NB_PATH * tp_steps / k * 1e3:.4e} path-steps/s)"
                      for n, (k, p, _) in out.items())
          + "; roofline (ops a path-step, bound ms, share of bound, SASS common path, issue "
          "floor ms and its share of the kernel time, SM clock MHz) "
          + ", ".join(f"N={n} {ops} ops, bound {b:.4f} ms, {b / out[n][0]:.1%}, SASS {c}, "
                      f"floor {f:.4f} ms ({f / out[n][0]:.1%}) at {mhz}"
                      for n, (ops, b, c, f, mhz) in roof.items()) + f" | {smi}", flush=True)
    nodes, weights = svt.european_rule(*EXPM_LIFT)
    scan_kw = dict(ttms=chain.ttms, forwards=chain.forwards, discfactors=chain.discfactors,
                   strikes_ttms=chain.strikes_ttms, optiontypes_ttms=chain.optiontypes_ttms,
                   sigma0=P.sigma0, theta=P.theta, kappa1=P.kappa1, kappa2=P.kappa2, beta=P.beta,
                   volvol=P.volvol, nodes=nodes, weights=weights, nb_path=EXPM_NB_PATH, seed=11,
                   nb_steps_per_year=EXPM_STEPS_PER_YEAR, device=DEVICE)
    walls, res = {}, {}
    for scheme in ("rk4", "expm"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[scheme] = svt.rough_logsv_mc_chain_pricer(drift_scheme=scheme, **scan_kw)
        walls[scheme] = time.perf_counter() - t0
    worst = 0.0
    for a, b, sa, sb in zip(res["rk4"][0], res["expm"][0], res["rk4"][1], res["expm"][1]):
        _check(np.all(np.isfinite(b)), "expm chain not finite")
        ratio = np.abs(a - b) / (4.0 * np.hypot(sa, sb))
        _check(bool(np.all(ratio < 1.0)), f"expm chain {b} vs rk4 chain {a}")
        worst = max(worst, float(np.max(ratio)))
    print(f"[rough-rules] 'expm' against 'rk4' drift, scan engine (float64 eager), "
          f"european_rule{EXPM_LIFT} at {EXPM_STEPS_PER_YEAR} steps/yr, {EXPM_NB_PATH} paths, "
          f"same seed: max |dprice| / (4 stderr) {worst:.3f}; walls rk4 "
          f"{walls['rk4']:.2f} s, expm {walls['expm']:.2f} s | {smi}", flush=True)
    return out


def _rel_gap(gpu, cpu) -> float:
    """max |card - CPU| / max |CPU| over the finite entries (NaN where NaN)."""
    gpu, cpu = (np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x, dtype=float)
                for x in (gpu, cpu))
    _check(np.array_equal(np.isnan(gpu), np.isnan(cpu)), "card and CPU NaN patterns differ")
    ok = ~np.isnan(cpu)
    return float(np.max(np.abs(gpu[ok] - cpu[ok])) / max(np.max(np.abs(cpu[ok])), 1e-300))


def _timed_s(fn):
    """(output, wall s) of one call that ends on the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _terminal_models_phase(svt, graphs, chain) -> None:
    """Bachelier, the incomplete beta, Student-t and GMM on the BTC chain,
    each on the card against the CPU; the Bachelier bisection's graph
    against its eager call; one GMM and one Student-t per-slice SLSQP fit of
    the first two slices."""
    from stochvolmodels_torch.ops import bachelier, tdist

    smi = _smi_name_and_power()
    devices = {"card": torch.device(DEVICE), "cpu": torch.device("cpu")}
    strikes, mask = svt.npad([1.0 + (k / f - 1.0) / 20.0
                              for k, f in zip(chain.strikes_ttms, chain.forwards)], pad_value=1.0)
    mids, _ = svt.npad(chain.get_mid_vols(), pad_value=0.5)
    types, _ = svt.npad([svt.encode_optiontypes(t) for t in chain.optiontypes_ttms], pad_value=1)
    normal_vols = 0.06 * mids / np.max(mids)
    ttms = chain.ttms[:, None]
    gaps, out = {}, {}
    for label, dev in devices.items():
        f64 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)
        one, k, t, v = f64(np.ones_like(strikes)), f64(strikes), f64(ttms), f64(normal_vols)
        codes = torch.as_tensor(types.astype(np.int8), device=dev)
        price = bachelier.compute_normal_price(one, k, t, v, optiontype=codes)
        out[label] = dict(
            price=price, delta=bachelier.compute_normal_delta(t, one, k, v, codes),
            vega=bachelier.compute_normal_slice_vegas(t, one, k, v),
            iv=bachelier.infer_normal_implied_vol(one, t, k, price, optiontype=codes),
            iv_fast=bachelier.infer_normal_implied_vol_fast(one, t, k, price, optiontype=codes))
    for name in out["cpu"]:
        gaps[f"normal {name}"] = _rel_gap(out["card"][name], out["cpu"][name])
    # the round trip where the price moves with the vol: |F - K| < 3 sdev (further out the
    # price sits at the intrinsic value to rounding)
    live = mask & (np.abs(1.0 - strikes) < 3.0 * normal_vols * np.sqrt(ttms))
    iv = out["card"]["iv"].cpu().numpy()
    solved = ~np.isnan(iv) & live
    _check(np.sum(live) >= 0.5 * np.sum(mask) and np.mean(solved[live]) > 0.9,
           f"normal iv: {np.sum(solved)} of {np.sum(live)} solved")
    exact_err = float(np.max(np.abs(iv[solved] - normal_vols[solved])))
    fast = out["card"]["iv_fast"].cpu().numpy()
    fast_err = float(np.max(np.abs(fast[live] - normal_vols[live])))
    _check(exact_err < 1e-8 and fast_err < 1e-8, f"normal iv round trips {exact_err}, {fast_err}")
    f64 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), device=DEVICE)
    args = (f64(np.ones_like(strikes)), f64(ttms), f64(strikes), out["card"]["price"])
    codes = torch.as_tensor(types.astype(np.int8), device=DEVICE)
    replays = graphs.REPLAYS["normal_bisection"]
    captured, captured_s = _timed_s(lambda: bachelier.infer_normal_implied_vol(
        *args, optiontype=codes))
    _check(graphs.REPLAYS["normal_bisection"] == replays + 1, "the normal bisection's graph "
                                                              "did not replay")
    with graphs.eager():
        eager, eager_s = _timed_s(lambda: bachelier.infer_normal_implied_vol(
            *args, optiontype=codes))
    _check(torch.equal(torch.nan_to_num(captured), torch.nan_to_num(eager)),
           "the captured normal bisection differs from the eager one")
    # the incomplete beta on the Student-t callers' domain, card against CPU
    a, x = np.meshgrid(np.linspace(1.005, 10.0, 25),
                       np.concatenate([np.linspace(1e-6, 1.0 - 1e-6, 97), [1.0 - 1e-12]]))
    beta = {label: tdist.betainc(*(torch.as_tensor(g.ravel(), device=dev)
                                   for g in (a, np.full_like(a, 0.5), x)))
            for label, dev in devices.items()}
    beta_gap = float(torch.max(torch.abs(beta["card"].cpu() - beta["cpu"])))
    _check(beta_gap < 1e-13, f"betainc card vs CPU {beta_gap}")
    # Student-t prices and the implied vol round trip on the first slice
    n = 1
    t_out, t_walls = {}, {}
    for label, dev in devices.items():
        f64 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)
        spot = f64((chain.forwards * chain.discfactors)[:n, None])
        k, t = f64(svt.npad(chain.strikes_ttms, pad_value=np.nan)[0][:n]), f64(ttms[:n])
        k = torch.where(torch.isnan(k), spot, k)
        codes = torch.as_tensor(types[:n].astype(np.int8), device=dev)
        price = tdist.compute_vanilla_price_tdist(spot, k, t, TDIST_VOL, TDIST_NU, codes)
        iv, t_walls[label] = _timed_s(lambda: tdist.infer_implied_vol_tdist(
            spot, t, k, price, optiontype=codes, nu=TDIST_NU))
        t_out[label] = dict(price=price, iv=iv)
    for name in t_out["cpu"]:
        gaps[f"student-t {name}"] = _rel_gap(t_out["card"][name], t_out["cpu"][name])
    t_iv_err = float(torch.max(torch.abs(t_out["card"]["iv"] - TDIST_VOL)))
    _check(t_iv_err < 1e-8, f"student-t iv round trip {t_iv_err}")
    gmm = {label: svt.GmmPricer(device=dev).price_chain(chain, svt.GmmParams(**GMM_PARAMS))
           for label, dev in devices.items()}
    gaps["gmm prices"] = max(_rel_gap(g, c) for g, c in zip(gmm["card"], gmm["cpu"]))
    _check(max(gaps.values()) < 1e-10, f"card against CPU: {gaps}")
    print(f"[terminal-models] BTC layout ({chain.ttms.size} x {strikes.shape[1]} panel), card "
          f"against CPU, max relative gap: "
          + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items())
          + f"; betainc (a in [1.005, 10], b 0.5, x to 1 - 1e-12) max abs gap {beta_gap:.2e}; "
          f"normal iv round trip within 3 sdev of the money exact {exact_err:.2e} ({np.sum(solved)} "
          f"of {np.sum(live)} quotes), fast {fast_err:.2e}; normal bisection captured {1e3 * captured_s:.2f} ms "
          f"equal bit for bit to eager {1e3 * eager_s:.2f} ms; Student-t iv round trip "
          f"{t_iv_err:.2e}, wall card {t_walls['card']:.2f} s, CPU {t_walls['cpu']:.2f} s "
          f"| {smi}", flush=True)
    ids = list(chain.ids[:TERMINAL_FIT_SLICES])
    # the largest mean |ivol - mid| of a fit: the mixture fits the BTC smiles to ~0.001; the
    # Student-t law, one vol and one nu a slice, to 0.06-0.08, as the JAX package's fit does
    for name, pricer, max_err in (("GMM", svt.GmmPricer(device=DEVICE), 0.01),
                                  ("Student-t", svt.TdistPricer(device=DEVICE), 0.1)):
        params0, parts = None, []
        for sid in ids:
            one = svt.OptionChain.get_slices_as_chain(chain, ids=[sid])
            params0, wall = _timed_s(lambda: pricer.calibrate_model_params_to_chain_slice(
                one, params0=params0))
            res = pricer.calibration_result
            err = _fit_error(pricer, one, params0)
            _check(np.isfinite(res.fun) and err < max_err, f"{name} fit of {sid}: error {err}")
            parts.append(f"{sid} {wall:.2f} s, nfev {res.nfev}, nit {res.nit}, objective "
                         f"{res.fun:.4e}, mean |ivol - mid| {err:.5f}")
        print(f"[terminal-models] {name} per-slice SLSQP (scipy on the host, torch.autograd "
              f"gradient), warm-started: " + "; ".join(parts) + f" | {smi}", flush=True)


def _mesh_phase(svt, cuda_mc, mc_variants, chain, analytic) -> tuple:
    """the path-sharded LogSV MC (``parallel/mesh.py``) at 2^20 paths x 361
    steps on ``make_path_mesh()`` and on two shards of one card, then the
    BTC chain from the gathered paths of ``make_path_mesh()``, slice by
    slice: every launch of that run counted.  Each shard equals a direct
    kernel call at its offset seed bit for bit (so the gathered tensors are
    their concatenation), and is held to its plain version (1e-4 in x, 1e-4
    |plain| + 1e-4 in sigma and qvar); the chain's MC prices lie in
    tests/test_logsv.py's band of ``analytic``.  Returns (the run's logsv_mc
    launches, the largest error against the plain versions)."""
    from stochvolmodels_torch.parallel import mesh
    from stochvolmodels_torch.utils.funcs import set_time_grid

    smi = _smi_name_and_power()
    P = svt.LOGSV_BTC_PARAMS
    kw = dict(ttm=THROUGHPUT_TTM, theta=P.theta, kappa1=P.kappa1, kappa2=P.kappa2, beta=P.beta,
              volvol=P.volvol, nb_steps_per_year=MC_STEPS_PER_YEAR)
    nb_steps = set_time_grid(THROUGHPUT_TTM, MC_STEPS_PER_YEAR)[0]
    meshes = {"make_path_mesh()": mesh.make_path_mesh(),
              "two shards of cuda:0": mesh.make_path_mesh(MESH_TWO_SHARDS)}
    sharded = lambda m, **extra: mesh.simulate_logsv_terminal_kernel_sharded(
        m, MESH_SEED, NB_PATH, sigma0=P.sigma0, **dict(kw, **extra))

    # the mesh path, counted
    _reset_counts(cuda_mc, mc_variants)
    outs = {name: sharded(m) for name, m in meshes.items()}
    chain_paths = [sharded(meshes["make_path_mesh()"], ttm=float(t)) for t in chain.ttms]
    torch.cuda.synchronize()
    counts = _counts(cuda_mc, mc_variants)
    launches = counts["logsv_mc"]
    want = sum(m.size for m in meshes.values()) + len(chain.ttms) * meshes["make_path_mesh()"].size
    _check(launches == want and sum(counts.values()) == launches,
           f"the mesh path launched {counts}, expected {want} logsv_mc launches")

    err = 0.0
    for name, m in meshes.items():
        local = NB_PATH // m.size
        direct, shard_ms = [], []
        for i, dev in enumerate(m.devices):
            state = (torch.zeros(local, dtype=torch.float32, device=dev),
                     torch.full((local,), P.sigma0, dtype=torch.float32, device=dev),
                     torch.zeros(local, dtype=torch.float32, device=dev))
            seed = MESH_SEED + mesh.SEED_STRIDE * i
            run = lambda: cuda_mc.simulate_logsv_terminal_kernel(seed, *state, **kw)
            direct.append(run())
            err = max(err, _vs_plain(f"logsv_mc shard {i} of {name}", nb_steps, direct[-1],
                                     cuda_mc.simulate_logsv_terminal_torch(seed, *state, **kw),
                                     ("x", "sigma", "qvar"), atol=1e-4))
            run()
            shard_ms.append(_event_ms(run, 10))
        for k, label in enumerate(("x", "sigma", "qvar")):
            _check(torch.equal(outs[name][k], torch.cat([d[k].to(m.devices[0]) for d in direct])),
                   f"{name}: the gathered {label} differs from the shards' direct calls")
        wall_ms = _warm_ms(lambda: [t.cpu() for t in sharded(m)], repeats=5)
        print(f"[mesh] simulate_logsv_terminal_kernel_sharded on {name} ({m.size} shard(s) of "
              f"{local} paths x {nb_steps} steps): each shard equal bit for bit to a direct "
              f"kernel call at seed {MESH_SEED} + 1,000,003 i, so the gathered tensors are their "
              f"concatenation; shard kernel ms {[round(t, 4) for t in shard_ms]} (CUDA events, "
              f"mean of 10); warm wall {wall_ms:.3f} ms with the read back (median of 5) | {smi}",
              flush=True)

    mc, std = [], []
    for i, (x, sig, qvar) in enumerate(chain_paths):
        p, s = svt.compute_mc_vars_payoff(x, sig, qvar, ttm=chain.ttms[i],
                                          forward=chain.forwards[i],
                                          strikes_ttm=chain.strikes_ttms[i],
                                          optiontypes_ttm=chain.optiontypes_ttms[i],
                                          discfactor=chain.discfactors[i])
        mc.append(p)
        std.append(s)
    worst = _mc_band(chain, analytic, mc, std, "sharded MC chain")
    print(f"[mesh] BTC chain from the gathered paths of make_path_mesh() ({NB_PATH} paths, "
          f"{MC_STEPS_PER_YEAR} steps/yr, one sharded call a slice): max |MC - analytic| / (4 "
          f"stderr + 1.5% + 1e-4 fwd) {worst:.3f}; the mesh path launched logsv_mc {launches} "
          f"times (the kernels line counts them) | {smi}", flush=True)
    return launches, err


def _mesh_sweep_phase(svt, graphs, chain) -> None:
    """the LogSV and Heston LM sweeps of MESH_SWEEP_CHAINS perturbed BTC
    chains with ``mesh=make_path_mesh()`` (bit for bit the ``mesh=None``
    sweep) and on two shards of one card (1e-12 relative), with walls."""
    import dataclasses

    from stochvolmodels_torch.parallel import sweep
    from stochvolmodels_torch.parallel.mesh import make_path_mesh

    smi = _smi_name_and_power()
    scales = np.linspace(0.90, 1.10, MESH_SWEEP_CHAINS)
    chains = [dataclasses.replace(chain, bid_ivs=[s * iv for iv in chain.bid_ivs],
                                  ask_ivs=[s * iv for iv in chain.ask_ivs]) for s in scales]
    logsv_p0, heston_p0 = svt.LogSvParams(**SWEEP_LOGSV_P0), svt.HestonParams(**SWEEP_HESTON_P0)
    models = {
        "LogSV": (lambda mesh: sweep.calibrate_logsv_lm_sweep(
                      chains, logsv_p0, nb_iters=MESH_SWEEP_ITERS,
                      year_steps=MESH_SWEEP_YEAR_STEPS, mesh=mesh, device=DEVICE),
                  lambda p, c: [p.sigma0, p.theta, p.kappa1, p.beta, p.volvol, c]),
        "Heston": (lambda mesh: sweep.calibrate_heston_lm_sweep(
                       chains, heston_p0, nb_iters=MESH_SWEEP_ITERS, mesh=mesh, device=DEVICE),
                   lambda p, c: [p.v0, p.theta, p.kappa, p.rho, p.volvol, c])}
    meshes = {"mesh=None": None, "make_path_mesh()": make_path_mesh(),
              "two shards of cuda:0": make_path_mesh(MESH_TWO_SHARDS)}
    for name, (run, vector) in models.items():
        fits, walls = {}, {}
        for label, mesh in meshes.items():
            run(mesh)   # the first call captures
            fits[label], walls[label] = _timed_s(lambda: run(mesh))
        base = np.array([vector(p, c) for p, c in fits["mesh=None"]])
        _check(bool(np.all(np.isfinite(base))), f"{name} mesh sweep: {base}")
        _check(_same(fits["make_path_mesh()"], fits["mesh=None"]),
               f"{name} sweep on make_path_mesh() differs from mesh=None")
        two = np.array([vector(p, c) for p, c in fits["two shards of cuda:0"]])
        gap = float(np.max(np.abs(two - base) / np.abs(base)))
        _check(gap <= 1e-12, f"{name} sweep on two shards against mesh=None: relative gap {gap}")
        print(f"[mesh-sweep] {name} LM sweep of {MESH_SWEEP_CHAINS} perturbed BTC chains, "
              f"{MESH_SWEEP_ITERS} iterations"
              + (f" at {MESH_SWEEP_YEAR_STEPS} steps/yr" if name == "LogSV" else "")
              + f": make_path_mesh() ({meshes['make_path_mesh()'].size} card) equal bit for bit "
              f"to mesh=None; two shards of cuda:0 (graphs of {MESH_SWEEP_CHAINS // 2} chains, "
              f"replayed per shard) against mesh=None max relative gap {gap:.2e}; warm walls "
              + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items()) + f" | {smi}", flush=True)


def _profiling_phase(svt, chain, gpu, kgpu) -> None:
    """``device_trace`` around one warm LogSV MC chain call through logsv_mc
    and one warm captured Hawkes reprice (one CUDA graph), each in an
    ``annotate`` region: the trace holds both region names and a logsv_mc
    kernel event; its size, the traced wall and the untraced wall."""
    import os
    import shutil
    import tempfile

    from stochvolmodels_torch.utils.profiling import (
        TRACE_FILE,
        annotate,
        device_trace,
        wall_and_device_time,
    )

    smi = _smi_name_and_power()
    P, HP = svt.LOGSV_BTC_PARAMS, svt.HawkesJDParams()
    mc_call = lambda: gpu.model_mc_price_chain(chain, P, engine="cuda", nb_path=NB_PATH, seed=24,
                                               nb_steps=MC_STEPS_PER_YEAR)
    reprice = lambda: kgpu.price_chain(chain, HP)

    def both():
        with annotate("logsv_mc_chain"):
            mc_call()
        with annotate("hawkes_captured_reprice"):
            reprice()

    both()   # warm: the reprice's graph is captured (or replayed)
    with wall_and_device_time() as untraced:
        both()
    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        t0 = time.perf_counter()
        with device_trace(trace_dir) as d:
            with wall_and_device_time() as traced:
                both()
        trace_s = time.perf_counter() - t0
        path = os.path.join(d, TRACE_FILE)
        size = os.path.getsize(path)
        events = json.load(open(path))["traceEvents"]
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    names = {e.get("name", "") for e in events}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    mc_kernels = [e for e in kernels if "logsv_mc" in e.get("name", "")]
    _check({"logsv_mc_chain", "hawkes_captured_reprice"} <= names,
           "the trace lacks an annotate region")
    # the chain call launches one logsv_mc a slice; the profiler may drop a kernel record
    # under load, so the gate asks for one
    _check(len(mc_kernels) >= 1, "the trace holds no logsv_mc kernel event")
    print(f"[profiling] device_trace around one LogSV MC chain call ({NB_PATH} paths) and one "
          f"captured Hawkes reprice, each in an annotate region: trace {size / 2 ** 20:.1f} MiB, "
          f"{len(events)} events, {len(kernels)} kernel events ({len(mc_kernels)} logsv_mc of "
          f"{len(chain.ttms)} launched); both "
          f"regions present; wall_and_device_time of the two calls: traced {traced['wall_s']:.3f} "
          f"s, untraced {untraced['wall_s']:.3f} s; the whole device_trace block (its start, "
          f"stop and export included) {trace_s:.3f} s | {smi}", flush=True)


# run by _compat_phase in a fresh interpreter: the examples' uniform chain through the
# stochvolmodels names, its prices and vols printed as float hex
_COMPAT_CHILD = r'''
import json
import numpy as np
import stochvolmodels_torch.compat as compat
compat.install()
import stochvolmodels as sv
from stochvolmodels import LogSvParams, LogSVPricer, OptionChain
assert sv is compat
chain = OptionChain.get_uniform_chain(ttms=np.array([0.083, 0.25]), ids=np.array(["1m", "3m"]),
                                      strikes=np.linspace(0.9, 1.1, 3))
params = LogSvParams(sigma0=1.0, theta=1.0, kappa1=5.0, kappa2=5.0, beta=0.2, volvol=2.0)
prices, vols = LogSVPricer().compute_chain_prices_with_vols(option_chain=chain, params=params)
print(json.dumps([[float(v).hex() for v in a] for a in list(prices) + list(vols)]))
'''


def _start_compat_phase():
    """the compat child, started (it runs beside the main process's phases)."""
    return subprocess.Popen([sys.executable, "-c", _COMPAT_CHILD], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            cwd=str(Path(__file__).resolve().parent))


def _compat_phase(svt, child) -> None:
    """the examples' uniform chain (examples/run_lognormal_sv_pricer.py:87-105)
    priced through ``stochvolmodels`` names after ``compat.install()`` in a
    fresh interpreter, equal bit for bit to the same call on
    ``stochvolmodels_torch`` here."""
    smi = _smi_name_and_power()
    try:
        out, err = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    _check(child.returncode == 0, f"the compat child failed: {err[-2000:]}")
    theirs = [np.array([float.fromhex(v) for v in a]) for a in
              json.loads(out.strip().splitlines()[-1])]
    chain = svt.OptionChain.get_uniform_chain(ttms=np.array([0.083, 0.25]),
                                              ids=np.array(["1m", "3m"]),
                                              strikes=np.linspace(0.9, 1.1, 3))
    params = svt.LogSvParams(sigma0=1.0, theta=1.0, kappa1=5.0, kappa2=5.0, beta=0.2, volvol=2.0)
    prices, vols = svt.LogSVPricer(device=DEVICE).compute_chain_prices_with_vols(chain, params)
    ours = [np.asarray(a, dtype=float) for a in list(prices) + list(vols)]
    _check(len(ours) == len(theirs) and all(np.array_equal(a, b) for a, b in zip(ours, theirs)),
           f"compat prices {theirs} differ from the port's {ours}")
    _check(all(np.all(np.isfinite(a)) for a in ours), "compat prices not finite")
    print(f"[compat] compat.install() in a fresh interpreter, then the examples' uniform chain "
          f"(1m, 3m x 3 strikes) through stochvolmodels.LogSVPricer: prices and vols equal bit "
          f"for bit to stochvolmodels_torch's; vols {np.round(np.concatenate(ours[2:]), 4).tolist()}"
          f" | {smi}", flush=True)


def _sweep_phase(svt, graphs, chain) -> None:
    """the LogSV and Heston LM sweeps of SWEEP_CHAINS perturbed BTC chains,
    each one CUDA graph: capture and warm walls, chains/s, peak memory,
    device busy and idle share; the first, middle and last chain against
    their single-chain fits; captured against eager bit for bit on a small
    sweep."""
    import dataclasses

    from stochvolmodels_torch.parallel import sweep

    smi = _smi_name_and_power()
    scales = np.linspace(0.90, 1.10, SWEEP_CHAINS)
    chains = [dataclasses.replace(chain, bid_ivs=[s * iv for iv in chain.bid_ivs],
                                  ask_ivs=[s * iv for iv in chain.ask_ivs]) for s in scales]
    logsv_p0, heston_p0 = svt.LogSvParams(**SWEEP_LOGSV_P0), svt.HestonParams(**SWEEP_HESTON_P0)
    models = {
        "LogSV": (lambda cs, iters=SWEEP_ITERS: sweep.calibrate_logsv_lm_sweep(
                      cs, logsv_p0, nb_iters=iters, year_steps=SWEEP_YEAR_STEPS, device=DEVICE),
                  lambda c: svt.calibrate_logsv_lm_on_device(
                      c, logsv_p0, nb_iters=SWEEP_ITERS, year_steps=SWEEP_YEAR_STEPS,
                      device=DEVICE),
                  lambda p: [p.sigma0, p.theta, p.kappa1, p.beta, p.volvol], "logsv_lm_sweep"),
        "Heston": (lambda cs, iters=SWEEP_ITERS: sweep.calibrate_heston_lm_sweep(
                       cs, heston_p0, nb_iters=iters, device=DEVICE),
                   lambda c: svt.calibrate_heston_lm(c, heston_p0, nb_iters=SWEEP_ITERS,
                                                   device=DEVICE),
                   lambda p: [p.v0, p.theta, p.kappa, p.rho, p.volvol], "heston_lm_sweep")}
    for name, (run, single, vector, graph) in models.items():
        replays, steps = graphs.REPLAYS[graph + "_init"], graphs.REPLAYS[graph + "_step"]
        torch.cuda.reset_peak_memory_stats()
        fits, capture_s = _timed_s(lambda: run(chains))
        peak_capture = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        again, warm_s = _timed_s(lambda: run(chains))
        peak_warm = torch.cuda.max_memory_allocated() / 2 ** 30
        _check(_same(again, fits), f"{name} sweep: a warm call differs from the first")
        _check(graphs.REPLAYS[graph + "_init"] == replays + 2
               and graphs.REPLAYS[graph + "_step"] == steps + 2 * SWEEP_ITERS,
               f"{name} sweep: the graphs did not replay")
        again, counts = _profiled(lambda: run(chains))
        _check(_same(again, fits), f"{name} sweep: the profiled call differs from the first")
        costs = np.array([c for _, c in fits])
        _check(bool(np.all(np.isfinite(costs))) and len(fits) == SWEEP_CHAINS,
               f"{name} sweep costs {costs}")
        gap = 0.0
        for i in (0, SWEEP_CHAINS // 2, SWEEP_CHAINS - 1):
            fit_i, cost_i = single(chains[i])
            want, got = np.array(vector(fit_i) + [cost_i]), np.array(vector(fits[i][0]) + [costs[i]])
            gap = max(gap, float(np.max(np.abs(got - want) / np.abs(want))))
        _check(gap < 1e-6, f"{name} sweep against single-chain fits: relative gap {gap}")
        small = chains[::SWEEP_CHAINS // SWEEP_CHECK_CHAINS][:SWEEP_CHECK_CHAINS]
        captured = run(small, SWEEP_CHECK_ITERS)
        with graphs.eager():
            eager, eager_s = _timed_s(lambda: run(small, SWEEP_CHECK_ITERS))
        _check(_same(captured, eager), f"{name} sweep: captured differs from eager")
        print(f"[sweep] {name} LM sweep of {SWEEP_CHAINS} perturbed BTC chains (ivols x "
              f"[0.90, 1.10]), {SWEEP_ITERS} iterations"
              + (f" at {SWEEP_YEAR_STEPS} steps/yr" if name == "LogSV" else "")
              + f", two CUDA graphs (the initial state, and one iteration replayed "
              f"{SWEEP_ITERS} times): capture (first call) {capture_s:.2f} s, warm "
              f"{warm_s:.3f} s, {SWEEP_CHAINS / warm_s:.2f} chains/s; peak memory "
              f"{peak_capture:.2f} GiB capturing, {peak_warm:.2f} GiB warm; profiled: "
              f"{_busy_line(counts)}; cost median {np.median(costs):.3e}, max "
              f"{np.max(costs):.3e}; chains 0, {SWEEP_CHAINS // 2}, {SWEEP_CHAINS - 1} against "
              f"their single-chain fits: max relative gap {gap:.2e}; captured equal bit for bit "
              f"to eager at {SWEEP_CHECK_CHAINS} chains x {SWEEP_CHECK_ITERS} iterations (eager "
              f"{eager_s:.2f} s) | {smi}", flush=True)


# the USD swaption normal-vol cube of 18 August 2023 (6 expiries x 3 tenors x 9 strikes) and the
# paper's fitted 3-factor Nelson-Siegel parameters, copied from
# papers/sv_for_factor_hjm/calibration_fig_5_6_7.py:36-120 (that module imports JAX); the cube
# reprices at the parameters' 5y term structure (P = 12 slices), the DE pricer's row is 1y
USD_TTMS, USD_TENORS = np.array([1.0, 2.0, 3.0, 5.0, 7.0, 10.0]), np.array([2.0, 5.0, 10.0])
USD_FORWARDS = [np.array([4.0750, 4.0350, 4.0550, 4.1150, 4.1550, 4.1000]) * 0.01,
                np.array([4.0750, 4.0350, 4.0500, 4.1150, 4.1550, 4.1000]) * 0.01,
                np.array([4.0750, 4.0300, 4.0500, 4.1150, 4.1500, 4.1000]) * 0.01]
USD_IVS = [[[164.82, 159.85, 156.28, 153.48, 151.6, 150.76, 151, 152.28, 154.51],
            [137.84, 137.23, 137.64, 139.12, 141.67, 145.16, 149.44, 154.33, 159.7],
            [123.88, 123.76, 124.84, 127.2, 130.75, 135.3, 140.61, 146.47, 152.7],
            [109.39, 108.57, 109.15, 111.27, 114.8, 119.48, 124.97, 130.99, 137.34],
            [99.54, 98.4, 98.57, 100.24, 103.34, 107.59, 112.66, 118.27, 124.2],
            [90.59, 88.27, 87.23, 87.26, 90.24, 94.11, 99.04, 104.62, 110.57]],
           [[139.42, 136.82, 135.02, 134.17, 134.47, 135.62, 137.86, 140.94, 144.72],
            [123.91, 122.97, 123.11, 124.43, 126.89, 130.35, 134.64, 139.55, 144.91],
            [112.89, 112.6, 113.52, 115.7, 119.04, 123.33, 128.34, 133.86, 139.71],
            [102.3, 101.56, 102.1, 104.02, 107.22, 111.46, 116.44, 121.92, 127.71],
            [93.71, 92.57, 92.67, 94.16, 96.98, 100.9, 105.6, 110.81, 116.34],
            [84.25, 82.31, 81.6, 82.41, 84.79, 88.48, 93.08, 98.26, 103.77]],
           [[116.41, 115.51, 115.54, 116.59, 118.62, 121.54, 125.2, 129.44, 134.11],
            [108.04, 107.74, 108.47, 110.25, 113.03, 116.65, 120.93, 125.68, 130.78],
            [101.43, 101.38, 102.35, 104.34, 107.29, 111.01, 115.32, 120.05, 125.07],
            [91.69, 91.41, 92.33, 94.48, 97.72, 101.83, 106.54, 111.65, 117],
            [84.28, 83.64, 84.33, 86.47, 89.89, 94.28, 99.32, 104.76, 110.4],
            [74.54, 73.66, 74.14, 76.14, 79.51, 83.87, 88.87, 94.22, 99.75]]]
USD_STRIKES = [[[2.56, 2.93875, 3.3175, 3.69625, 4.075, 4.45375, 4.8325, 5.21125, 5.59],
                [2.03, 2.53125, 3.0325, 3.53375, 4.035, 4.53625, 5.0375, 5.53875, 6.04],
                [1.79, 2.35625, 2.9225, 3.48875, 4.055, 4.62125, 5.1875, 5.75375, 6.32],
                [1.55, 2.19125, 2.8325, 3.47375, 4.115, 4.75625, 5.3975, 6.03875, 6.68],
                [1.42, 2.10375, 2.7875, 3.47125, 4.155, 4.83875, 5.5225, 6.20625, 6.89],
                [1.25, 1.9625, 2.675, 3.3875, 4.1, 4.8125, 5.525, 6.2375, 6.95]],
               [[2.73, 3.06625, 3.4025, 3.73875, 4.075, 4.41125, 4.7475, 5.08375, 5.42],
                [2.24, 2.68875, 3.1375, 3.58625, 4.035, 4.48375, 4.9325, 5.38125, 5.83],
                [1.99, 2.505, 3.02, 3.535, 4.05, 4.565, 5.08, 5.595, 6.11],
                [1.72, 2.31875, 2.9175, 3.51625, 4.115, 4.71375, 5.3125, 5.91125, 6.51],
                [1.59, 2.23125, 2.8725, 3.51375, 4.155, 4.79625, 5.4375, 6.07875, 6.72],
                [1.42, 2.09, 2.76, 3.43, 4.1, 4.77, 5.44, 6.11, 6.78]],
               [[2.89, 3.18625, 3.4825, 3.77875, 4.075, 4.37125, 4.6675, 4.96375, 5.26],
                [2.43, 2.83, 3.23, 3.63, 4.03, 4.43, 4.83, 5.23, 5.63],
                [2.19, 2.655, 3.12, 3.585, 4.05, 4.515, 4.98, 5.445, 5.91],
                [1.93, 2.47625, 3.0225, 3.56875, 4.115, 4.66125, 5.2075, 5.75375, 6.3],
                [1.77, 2.365, 2.96, 3.555, 4.15, 4.745, 5.34, 5.935, 6.53],
                [1.59, 2.2175, 2.845, 3.4725, 4.1, 4.7275, 5.355, 5.9825, 6.61]]]
USD_PARAM_TS = np.array([0.0, 1.0, 2.0, 3.0, 5.0])
USD_A = [[0.0145520600966057, 0.0129872854900715, 0.0113053431415981],
         [0.0134748570248017, 0.0128907769293694, 0.0112651548589306],
         [0.011573352659394, 0.0122196017111508, 0.010764379038105],
         [0.0070554411390967, 0.0097915826853067, 0.0086699569420959]]
USD_BETA = [[1.5175197006627835e-02, 1.0634920321914283e-01, 6.6674118846722419e-01],
            [4.8368206184131085e-01, 1.7547946297795609e-02, -2.8323520431018540e-01],
            [6.5149765993861006e-02, -8.1944955908784672e-02, -1.2933054838433659e-04],
            [4.0771895182424006e-01, -7.2998068741307848e-02, -4.0049869808018973e-01]]
USD_VOLVOL = [0.0972782445446557, 0.1071198215096482, 0.0744932897602731, 0.03]
USD_R = [[1.0, 0.99, 0.97], [0.99, 1.0, 0.98], [0.97, 0.98, 1.0]]
RATES_MAX_EXPIRY, RATES_REPEATS = 5.0, 5


def _usd_swaption_cube(svt):
    """(the USD SwOptionChain, re-centred on the flat-curve par rates as the
    paper builds it, and its fitted MultiFactRateLogSvParams)."""
    strikes = [[np.array(k) * 0.01 for k in row] for row in USD_STRIKES]
    ivs = [[np.array(v) * 1e-4 for v in row] for row in USD_IVS]
    chain = svt.SwOptionChain.create_swaption_chain_MF(
        ccy="USD", tenors=USD_TENORS, tenors_ids=["2y", "5y", "10y"], ttms=USD_TTMS,
        ttms_ids=["1y", "2y", "3y", "5y", "7y", "10y"], forwards=[f.copy() for f in USD_FORWARDS],
        strikes_ttms=strikes, ivs=ivs, ticker="USD_aug_23")
    params = svt.MultiFactRateLogSvParams(
        sigma0=1.0, theta=1.0, kappa1=0.25, kappa2=0.25,
        beta=svt.TermStructure(ts=USD_PARAM_TS, xs=np.array(USD_BETA)),
        volvol=svt.TermStructure(ts=USD_PARAM_TS, xs=np.array(USD_VOLVOL)),
        A=np.array(USD_A), R=np.array(USD_R),
        basis=svt.NelsonSiegel(meanrev=0.55, key_terms=np.array([2.0, 5.0, 10.0])),
        ccy="USD", vol_interpolation="BY_YIELD")
    return chain, params


def _rates_cube_phase(svt, graphs, chain) -> None:
    """the factor-HJM swaption cube on the USD cube at full width: the 12-slice reprice
    (one CUDA graph) captured and eager, the card against the CPU, normal ivols and their
    gap to the market; the three cube greeks (one graph each); the adaptive tanh-sinh
    pricer on the 1y row (one graph of the RK4 a padded node batch)."""
    del chain
    from stochvolmodels_torch.models.factor_hjm import rate_logsv_pricer as rates
    from stochvolmodels_torch.models.factor_hjm.fast_calibration import swaption_chain_to_cube
    from stochvolmodels_torch.ops import bachelier
    from stochvolmodels_torch.utils.rate_core import generate_ttms_grid

    smi = _smi_name_and_power()
    sw_chain, params = _usd_swaption_cube(svt)
    slices, fwds, strikes, market = swaption_chain_to_cube(sw_chain, max_expiry=RATES_MAX_EXPIRY)
    _check(len(slices) == 12 and all(s.size == 9 for s in strikes), f"cube rows {slices}")
    args = (params.sigma0, params.beta.xs, params.volvol.xs)
    build, build_s = _timed_s(lambda: rates.make_swaption_cube_fn(params, slices, fwds, strikes,
                                                                  device=DEVICE))
    cube, mask = build
    cpu_cube, _ = rates.make_swaption_cube_fn(params, slices, fwds, strikes, device="cpu")
    replays = graphs.REPLAYS["rates_cube"]
    first, capture_s, _, captured, eager = _captured_then_eager(
        graphs, lambda: [cube(*args).cpu().numpy()])
    _check(graphs.REPLAYS["rates_cube"] >= replays + 3, "the cube's graph did not replay")
    captured_ms = _warm_ms(lambda: cube(*args).cpu().numpy(), RATES_REPEATS)
    with graphs.eager():
        eager_ms = _warm_ms(lambda: cube(*args).cpu().numpy(), 2)
    prices = first[0]
    cpu_prices = cpu_cube(*args).numpy()
    fwd = np.asarray(fwds)[:, None]
    _check(bool(np.all(np.isfinite(prices))) and bool(mask.all()), "cube prices not finite")
    price_gap = float(np.max(np.abs(prices - cpu_prices) / fwd))
    _check(price_gap <= 1e-12, f"cube prices card against CPU: {price_gap} x forward")
    ttms = np.array([e for e, _ in slices])[:, None]
    k = np.stack(strikes)
    ivols = {}
    for label, dev, px in (("card", DEVICE, prices), ("cpu", "cpu", cpu_prices)):
        f64 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)
        ivols[label] = bachelier.infer_normal_implied_vol(
            f64(fwd), f64(ttms), f64(k), f64(px), optiontype='C').cpu().numpy()
    iv_gap = float(np.max(np.abs(ivols["card"] - ivols["cpu"])))
    _check(bool(np.all(np.isfinite(ivols["card"]))) and iv_gap <= 1e-10,
           f"cube normal ivols card against CPU: {iv_gap}")
    rms_bp = 1e4 * float(np.sqrt(np.mean((ivols["card"] - np.stack(market)) ** 2)))
    print(f"[rates-cube] USD swaption cube 18 Aug 2023, {len(slices)} slices x 9 strikes "
          f"(S = {cube.key[4]} RK4 steps, {cube.key[5]} tanh-sinh nodes), the paper's fitted "
          f"parameters: host panels {build_s:.3f} s; capture (first call) {capture_s:.3f} s; "
          f"warm reprice captured {captured_ms:.2f} ms (median of {RATES_REPEATS}), eager "
          f"{eager_ms:.2f} ms; captured profile: {_busy_line(captured)}; eager profile: "
          f"{_busy_line(eager)}; captured equal bit for bit to eager; card against CPU max "
          f"|dprice| / forward {price_gap:.2e}, normal ivols {iv_gap:.2e}; RMS gap of the model "
          f"normal ivols to the market mids {rms_bp:.2f} bp | {smi}", flush=True)

    greeks = ("vega", "beta_shift", "volvol_shift")
    call = lambda: svt.swaption_cube_greeks(params, slices, fwds, strikes, device=DEVICE)[0]
    replays = graphs.REPLAYS["rates_cube_greeks"]
    gpu_greeks, greeks_capture_s = _timed_s(call)
    again, greeks_warm_s = _timed_s(call)
    _check(graphs.REPLAYS["rates_cube_greeks"] == replays + 2 * len(greeks),
           "the greeks' graphs did not replay")
    with graphs.eager():
        eager_greeks, greeks_eager_s = _timed_s(call)
    for g in ("price",) + greeks:
        _check(np.array_equal(again[g], gpu_greeks[g]) and np.array_equal(eager_greeks[g],
                                                                          gpu_greeks[g]),
               f"cube greek {g}: a warm or eager call differs from the captured one")
    cpu_greeks, greeks_cpu_s = _timed_s(lambda: svt.swaption_cube_greeks(
        params, slices, fwds, strikes, device="cpu")[0])
    greek_gap = 0.0
    for g in greeks:
        c, d = cpu_greeks[g], np.abs(gpu_greeks[g] - cpu_greeks[g])
        _check(bool(np.all((d <= 1e-10 * np.abs(c)) | (d <= 1e-14))),
               f"cube greek {g} card against CPU: {np.max(d)}")
        greek_gap = max(greek_gap, float(np.max(d / np.maximum(np.abs(c), 1e-14))))
    print(f"[rates-cube] swaption_cube_greeks {', '.join(greeks)} on the same cube (one jvp a "
          f"greek, one CUDA graph each; each call freezes the host panels anew): first call "
          f"(captures) {greeks_capture_s:.3f} s, warm {greeks_warm_s:.3f} s, eager "
          f"{greeks_eager_s:.3f} s, CPU {greeks_cpu_s:.3f} s; captured equal bit for bit to "
          f"eager; card against CPU max relative gap {greek_gap:.2e} (floor 1e-14) | {smi}",
          flush=True)

    calls = {"ff": 0}
    solve = rates.compute_logsv_a_mgf_grid

    def counted(*a, **kw):
        calls["ff"] += 1
        return solve(*a, **kw)
    t_grid = generate_ttms_grid(sw_chain.ttms[:4])
    row = dict(t_grid=t_grid, idxs=slice(0, 1))
    captures = graphs.CAPTURES["rates_ode"]
    rates.compute_logsv_a_mgf_grid = counted
    try:
        de_ivols, de_s = _timed_s(lambda: rates.RateLogSVPricer(device=DEVICE).price_chain(
            sw_chain, params, **row))
        ff_calls, de_graphs = calls["ff"], graphs.CAPTURES["rates_ode"] - captures
        _, de_warm_s = _timed_s(lambda: rates.RateLogSVPricer(device=DEVICE).price_chain(
            sw_chain, params, **row))
    finally:
        rates.compute_logsv_a_mgf_grid = solve
    cpu_ivols, de_cpu_s = _timed_s(lambda: rates.RateLogSVPricer(device="cpu").price_chain(
        sw_chain, params, **row))
    # one ff batch of the row (1y x 2y, 16 nodes): the RK4's graph against its eager call
    a, k0, k1, k2, beta, volvol, _ = params.transform_QA_params(expiry=1.0, tenor=2.0,
                                                                 t_grid=t_grid)
    p_nodes = torch.as_tensor(np.geomspace(1e-2, 1e3, 16), device=DEVICE)
    ff_kw = dict(ttm=1.0, phi_grid=torch.complex(torch.full_like(p_nodes, -0.5), p_nodes),
                 sigma0=params.sigma0, q=params.theta, times=t_grid[:k0.size], a0=a,
                 a1=np.zeros_like(k0), kappa0=k0, kappa1=k1, kappa2=k2, beta=beta,
                 volvol=volvol, b=np.zeros_like(k0))
    replays = graphs.REPLAYS["rates_ode"]
    ff_captured = rates.compute_logsv_a_mgf_grid(**ff_kw)[1]
    with graphs.eager():
        ff_eager = rates.compute_logsv_a_mgf_grid(**ff_kw)[1]
    _check(graphs.REPLAYS["rates_ode"] == replays + 1 and torch.equal(ff_captured, ff_eager),
           "the rates RK4's graph differs from its eager call")
    de_gap = max(float(np.max(np.abs(g[0] - c[0]))) for g, c in zip(de_ivols, cpu_ivols))
    _check(all(np.all(np.isfinite(g[0])) for g in de_ivols) and de_gap <= 1e-9,
           f"DE row ivols card against CPU: {de_gap}")
    print(f"[rates-cube] RateLogSVPricer.price_chain (adaptive tanh-sinh, 360 RK4 steps/yr) on "
          f"the 1y row, 3 tenors x 9 strikes: {ff_calls} ff calls, {de_graphs} RK4 graphs "
          f"captured; first call {de_s:.3f} s, warm {de_warm_s:.3f} s (graphs replayed), CPU "
          f"{de_cpu_s:.3f} s; card against CPU max |d normal ivol| {de_gap:.2e}; one 16-node "
          f"batch's RK4 graph equal bit for bit to its eager call | {smi}",
          flush=True)


RATES_CALIB_ITERS, RATES_CALIB_YEAR_STEPS, RATES_PREFIT_OUTER = 24, 48, 4
# calibrate_model_params_to_chain's default is 360 steps/yr; its warm wall there was predicted
# over 30 s (PERF.md section 6), so the smoke runs it at the cube LM's 48
RATES_PRICER_YEAR_STEPS = 48
RATES_MC_PATHS, RATES_MC_CHECK_PATHS = 100_000, 4096
TRACED_GREEKS = ("vega", "A_shift", "beta_shift", "volvol_shift", "kappa1", "kappa2")


def _rates_start(params):
    """the calibration's start point: the fitted parameters with beta x 0.5
    and volvol x 1.3 on every segment."""
    import copy

    start = copy.deepcopy(params)
    for seg in range(start.A.shape[0]):
        start.update_params(idx=seg, beta_idx=params.beta.xs[seg] * 0.5,
                            volvol_idx=float(params.volvol.xs[seg]) * 1.3)
    return start


def _rates_calib_phase(svt, graphs, chain) -> None:
    """the factor-HJM cube calibration on the USD cube (12 slices x 9
    strikes): the traced reprice (one graph) captured, eager and on the CPU;
    the six traced greeks (one graph each); the A prefit through the traced
    graph; the cube LM (the initial state and the iteration one graph each)
    with its graph's nodes, captured against eager and the card against the
    CPU over two iterations; the pricer's entry point."""
    del chain
    from stochvolmodels_torch.models.factor_hjm import fast_calibration as fc
    from stochvolmodels_torch.models.factor_hjm import rate_logsv_pricer as rates

    smi = _smi_name_and_power()
    sw_chain, params = _usd_swaption_cube(svt)
    slices, fwds, strikes, market = fc.swaption_chain_to_cube(sw_chain,
                                                              max_expiry=RATES_MAX_EXPIRY)
    fwd = np.asarray(fwds)[:, None]
    cube_rows = (slices, fwds, strikes)

    # the traced reprice at the fitted parameters
    cube, _ = rates.make_swaption_cube_fn_traced(params, *cube_rows, device=DEVICE)
    args = cube.primals()
    replays = graphs.REPLAYS["rates_cube_traced"]
    first, capture_s, captured_s, captured, eager = _captured_then_eager(
        graphs, lambda: [cube(*args).cpu().numpy()])
    _check(graphs.REPLAYS["rates_cube_traced"] >= replays + 3, "the traced cube did not replay")
    prices = first[0]
    cpu_cube, _ = rates.make_swaption_cube_fn_traced(params, *cube_rows, device="cpu")
    cpu_prices, cpu_s = _timed_s(lambda: cpu_cube(*cpu_cube.primals()).numpy())
    price_gap = float(np.max(np.abs(prices - cpu_prices) / fwd))
    _check(bool(np.all(np.isfinite(prices))) and price_gap <= 1e-12,
           f"traced cube card against CPU: {price_gap} x forward")
    frozen, _ = rates.make_swaption_cube_fn(params, *cube_rows, device=DEVICE)
    frozen_gap = float(np.max(np.abs(prices - frozen(params.sigma0, params.beta.xs,
                                                       params.volvol.xs).cpu().numpy()) / fwd))
    print(f"[rates-calib] traced cube reprice, USD cube {len(slices)} x 9 (S = {cube.nb_steps} "
          f"RK4 steps, {cube.key[2]} mean-state RK4 steps), the paper's fitted parameters: "
          f"capture (first call) {capture_s:.3f} s; warm captured {1e3 * captured_s:.2f} ms; "
          f"captured profile: {_busy_line(captured)}; eager profile: {_busy_line(eager)}; "
          f"captured equal bit for bit to eager; card against CPU max |dprice| / forward "
          f"{price_gap:.2e} (CPU {cpu_s:.2f} s); traced against frozen (scipy rtol 1e-3 panels) "
          f"max |dprice| / forward {frozen_gap:.2e} | {smi}", flush=True)

    # the six traced greeks
    call = lambda: svt.swaption_cube_greeks(params, *cube_rows, greeks=TRACED_GREEKS,
                                            traced=True, device=DEVICE)[0]
    replays = graphs.REPLAYS["rates_cube_greeks_traced"]
    gpu_greeks, greeks_first_s = _timed_s(call)
    again, greeks_warm_s = _timed_s(call)
    _check(graphs.REPLAYS["rates_cube_greeks_traced"] == replays + 2 * len(TRACED_GREEKS),
           "the traced greeks' graphs did not replay")
    with graphs.eager():
        eager_greeks, greeks_eager_s = _timed_s(call)
    for g in ("price",) + TRACED_GREEKS:
        _check(np.array_equal(again[g], gpu_greeks[g]) and np.array_equal(eager_greeks[g],
                                                                          gpu_greeks[g]),
               f"traced greek {g}: a warm or eager call differs from the captured one")
    cpu_greeks, greeks_cpu_s = _timed_s(lambda: svt.swaption_cube_greeks(
        params, *cube_rows, greeks=TRACED_GREEKS, traced=True, device="cpu")[0])
    greek_gap = 0.0
    for g in TRACED_GREEKS:
        c, d = cpu_greeks[g], np.abs(gpu_greeks[g] - cpu_greeks[g])
        _check(bool(np.all((d <= 1e-10 * np.abs(c)) | (d <= 1e-14))),
               f"traced greek {g} card against CPU: {np.max(d)}")
        greek_gap = max(greek_gap, float(np.max(d / np.maximum(np.abs(c), 1e-14))))
    print(f"[rates-calib] swaption_cube_greeks(traced=True), {', '.join(TRACED_GREEKS)} (one "
          f"jvp a greek, one CUDA graph each): first call (captures) {greeks_first_s:.3f} s, "
          f"warm {greeks_warm_s:.3f} s, eager {greeks_eager_s:.3f} s, CPU {greeks_cpu_s:.2f} s; "
          f"captured equal bit for bit to eager; card against CPU max relative gap "
          f"{greek_gap:.2e} (floor 1e-14) | {smi}", flush=True)

    # the A prefit through the traced graph, from the start point
    start = _rates_start(params)
    replays = graphs.REPLAYS["rates_cube_traced"]
    (prefit, atm_bp), prefit_s = _timed_s(lambda: fc.prefit_A_to_atm(
        start, *cube_rows, market, nb_outer=RATES_PREFIT_OUTER, traced=True, device=DEVICE))
    prefit_replays = graphs.REPLAYS["rates_cube_traced"] - replays
    _check(prefit_replays == RATES_PREFIT_OUTER and np.isfinite(atm_bp),
           f"prefit: {prefit_replays} traced-cube replays, ATM error {atm_bp} bp")
    print(f"[rates-calib] prefit_A_to_atm(traced=True), {RATES_PREFIT_OUTER} outer iterations "
          f"from the start point (beta x 0.5, volvol x 1.3): {prefit_s:.3f} s (one traced-cube "
          f"graph, {prefit_replays} replays, a batched ATM bisection an iteration); max ATM "
          f"error {atm_bp:.3f} bp; A moved by up to "
          f"{float(np.max(np.abs(prefit.A / start.A - 1.0))):.3%} | {smi}", flush=True)

    # the cube LM (frozen panels) from the start point, every segment the expiries reach free
    n_quotes = sum(len(k) for k in strikes)
    n_free = min(max(int(np.searchsorted(params.ts, e)) - 1 for e, _ in slices),
                 params.A.shape[0] - 1) + 1
    lm = lambda p, n, device=DEVICE: fc.calibrate_rate_logsv_cube_lm_on_device(
        p, *cube_rows, market, nb_iters=n, year_steps=RATES_CALIB_YEAR_STEPS, device=device)
    (_, cost0), _ = _timed_s(lambda: lm(start, 0))
    captures = graphs.CAPTURES["rates_lm_step"]
    (fit, cost), first_s = _timed_s(lambda: lm(start, RATES_CALIB_ITERS))
    _check(graphs.CAPTURES["rates_lm_step"] == captures + 1, "the LM step was not captured")
    replays = graphs.REPLAYS["rates_lm_step"]
    (fit_w, cost_w), warm_s = _timed_s(lambda: lm(start, RATES_CALIB_ITERS))
    _check(graphs.REPLAYS["rates_lm_step"] == replays + RATES_CALIB_ITERS,
           "the LM step did not replay once an iteration")
    _check(cost_w == cost and np.array_equal(fit_w.beta.xs, fit.beta.xs),
           "a warm LM fit differs from the first")
    rms0, rms = (1e4 * float(np.sqrt(c / n_quotes)) for c in (cost0, cost))
    _check(np.isfinite(cost) and rms < rms0, f"cube LM: RMS gap {rms0} -> {rms} bp")
    _, (k0, _, busy0, _) = _profiled(lambda: lm(start, 0))
    _, (k1, launch1, busy1, wall1) = _profiled(lambda: lm(start, 1))
    two = lm(start, 2)
    with graphs.eager():
        two_eager, eager2_s = _timed_s(lambda: lm(start, 2))
    _check(two[1] == two_eager[1] and np.array_equal(two[0].beta.xs, two_eager[0].beta.xs)
           and np.array_equal(two[0].volvol.xs, two_eager[0].volvol.xs),
           "the captured LM differs from the eager LM")
    two_cpu, cpu2_s = _timed_s(lambda: lm(start, 2, device="cpu"))
    iter_gap = max(_rel_gap(two[0].beta.xs, two_cpu[0].beta.xs),
                   _rel_gap(two[0].volvol.xs, two_cpu[0].volvol.xs),
                   abs(two[1] - two_cpu[1]) / two_cpu[1])
    _check(iter_gap <= 1e-9, f"cube LM iterates card against CPU: {iter_gap}")
    print(f"[rates-calib] cube LM (fit_A=False, segments 0-{n_free - 1}, "
          f"{n_free * (params.A.shape[1] + 1)} parameters, {n_quotes} "
          f"quotes, {RATES_CALIB_ITERS} iterations at {RATES_CALIB_YEAR_STEPS} steps/yr) from the "
          f"start point: RMS normal-vol gap {rms0:.2f} -> {rms:.2f} bp (cost {cost0:.4e} -> "
          f"{cost:.4e}); first call {first_s:.3f} s (captures the initial state and the "
          f"iteration), warm {warm_s:.3f} s (capture ~{first_s - warm_s:.3f} s); the iteration's "
          f"graph {k1 - k0} kernel nodes (one replay, {busy1 - busy0:.2f} ms busy; one-iteration "
          f"fit {launch1} host launch calls, {wall1:.1f} ms wall); two iterations captured equal "
          f"bit for bit to eager ({eager2_s:.2f} s eager), card against CPU max relative gap "
          f"{iter_gap:.2e} (CPU {cpu2_s:.2f} s) | {smi}", flush=True)

    replays = graphs.REPLAYS["rates_lm_step"]
    (pfit, pcost), pricer_s = _timed_s(lambda: rates.RateLogSVPricer(
        device=DEVICE).calibrate_model_params_to_chain(sw_chain, start, max_expiry=RATES_MAX_EXPIRY,
                                                       nb_iters=RATES_CALIB_ITERS,
                                                       year_steps=RATES_PRICER_YEAR_STEPS))
    _check(np.isfinite(pcost) and pcost <= cost0
           and graphs.REPLAYS["rates_lm_step"] == replays + RATES_CALIB_ITERS,
           f"pricer calibration: cost {pcost}")
    print(f"[rates-calib] RateLogSVPricer.calibrate_model_params_to_chain, {RATES_CALIB_ITERS} "
          f"iterations at {RATES_PRICER_YEAR_STEPS} steps/yr (its default 360 cut, PERF.md): "
          f"warm {pricer_s:.3f} s, cost {pcost:.4e}, RMS gap "
          f"{1e4 * float(np.sqrt(pcost / n_quotes)):.2f} bp | {smi}", flush=True)


def _mesh_cube_phase(svt, graphs, chain) -> None:
    """the USD cube's frozen reprice and MESH_CUBE_ITERS cube-LM iterations
    (48 steps/yr, from the calibration's start point) with
    ``mesh=make_path_mesh()`` (bit for bit the ``mesh=None`` call) and on
    two shards of one card (1e-12 relative), each shard through its own
    graphs; walls beside mesh=None's."""
    del chain
    from stochvolmodels_torch.models.factor_hjm import fast_calibration as fc
    from stochvolmodels_torch.models.factor_hjm import rate_logsv_pricer as rates
    from stochvolmodels_torch.parallel.mesh import make_path_mesh

    smi = _smi_name_and_power()
    sw_chain, params = _usd_swaption_cube(svt)
    slices, fwds, strikes, market = fc.swaption_chain_to_cube(sw_chain,
                                                              max_expiry=RATES_MAX_EXPIRY)
    cube_rows = (slices, fwds, strikes)
    start = _rates_start(params)
    meshes = {"mesh=None": None, "make_path_mesh()": make_path_mesh(),
              "two shards of cuda:0": make_path_mesh(MESH_TWO_SHARDS)}
    prices, fits, walls, parts = {}, {}, {}, []
    for label, mesh in meshes.items():
        cube, _ = rates.make_swaption_cube_fn(params, *cube_rows, mesh=mesh, device=DEVICE)
        parts = [p.mask.shape[0] for p in getattr(cube, "parts", [])] or parts
        args = cube.primals()
        cube(*args)   # the first call captures
        prices[label], reprice_s = _timed_s(lambda: cube(*args).cpu().numpy())
        lm = lambda: fc.calibrate_rate_logsv_cube_lm_on_device(
            start, *cube_rows, market, nb_iters=MESH_CUBE_ITERS,
            year_steps=RATES_CALIB_YEAR_STEPS, mesh=mesh, device=DEVICE)
        lm()
        fits[label], lm_s = _timed_s(lm)
        walls[label] = (1e3 * reprice_s, lm_s)
    base_fit, base_cost = fits["mesh=None"]
    vector = lambda f, c: np.concatenate([f.beta.xs.ravel(), f.volvol.xs, [c]])
    one_fit, one_cost = fits["make_path_mesh()"]
    _check(np.array_equal(prices["make_path_mesh()"], prices["mesh=None"])
           and np.array_equal(vector(one_fit, one_cost), vector(base_fit, base_cost)),
           "the cube on make_path_mesh() differs from mesh=None")
    price_gap = float(np.max(np.abs(prices["two shards of cuda:0"] - prices["mesh=None"]))
                      / np.max(np.abs(prices["mesh=None"])))
    two = vector(*fits["two shards of cuda:0"])
    base = vector(base_fit, base_cost)
    nz = base != 0.0
    fit_gap = float(np.max(np.abs(two - base)[nz] / np.abs(base[nz])))
    _check(bool(np.all(np.isfinite(prices["mesh=None"]))) and price_gap <= 1e-12
           and fit_gap <= 1e-12 and np.array_equal(two[~nz], base[~nz]),
           f"the cube on two shards against mesh=None: prices {price_gap}, LM {fit_gap}")
    print(f"[mesh-cube] USD cube {len(slices)} x 9: make_path_mesh() equal bit for bit to "
          f"mesh=None (reprice and {MESH_CUBE_ITERS} LM iterations at {RATES_CALIB_YEAR_STEPS} "
          f"steps/yr); two shards of cuda:0 ({parts} slices, one reprice graph and one jac "
          f"and one residual graph a shard) against mesh=None: prices "
          f"{price_gap:.2e} of the largest price, LM parameters and cost max relative gap "
          f"{fit_gap:.2e} (cost {base_cost:.6e}); warm reprice ms / LM s: "
          + ", ".join(f"{k} {v[0]:.2f} / {v[1]:.3f}" for k, v in walls.items())
          + f" | {smi}", flush=True)


def _mc_band_gate(mc, ups, downs, analytic, what) -> float:
    """the largest |MC vol - analytic vol| over the wider of 10% of the
    analytic vol and the MC vol's 1.96-stderr band; fails above 1."""
    mc, ups, downs, analytic = (np.asarray(a, dtype=float) for a in (mc, ups, downs, analytic))
    band = np.maximum(0.1 * np.abs(analytic), np.maximum(ups - mc, mc - downs))
    ratio = float(np.max(np.abs(mc - analytic) / band))
    _check(bool(np.all(np.isfinite(mc))) and ratio <= 1.0,
           f"{what}: MC vols {mc} outside the band of {analytic}")
    return ratio


def _futures_params(svt):
    """the futures fixture of tests/test_factor_hjm.py::TestFuturesMC: a 75-day
    expiry on a 3-month rate, the paper's USD basis and correlations."""
    ttm = 75.0 / 365.0
    times = np.array([0.0, ttm])
    params = svt.MultiFactRateLogSvParams(
        sigma0=1.0, theta=1.0, kappa1=0.5, kappa2=1.0,
        beta=svt.TermStructure.create_multi_fact_from_vec(times, 0.2 * np.ones(3)),
        volvol=svt.TermStructure.create_from_scalar(times, 0.35),
        A=np.array([[0.012, 0.011, 0.010]]), R=np.array(USD_R),
        basis=svt.NelsonSiegel(meanrev=0.55, key_terms=np.array([2.0, 5.0, 10.0])),
        ccy="USD_NS", vol_interpolation="BY_YIELD")
    params.q = params.theta
    return ttm, params


def _rates_mc_phase(svt, graphs, chain) -> None:
    """the factor-HJM Monte Carlo: calc_mc_vols on the USD cube's 1y row at
    100,000 paths (one graph) against the DE pricer; simulate_logsv_MF under
    the annuity and T-forward measures at injected normals, card against
    CPU path by path; calc_futures_mc_vols on one futures expiry against the
    DE futures pricer."""
    del chain
    from stochvolmodels_torch.models.factor_hjm import factor_hjm_pricer as fhjm
    from stochvolmodels_torch.models.factor_hjm import rate_logsv_pricer as rates
    from stochvolmodels_torch.models.factor_hjm.rate_affine_expansion import UnderlyingType
    from stochvolmodels_torch.utils.funcs import set_time_grid
    from stochvolmodels_torch.utils.rate_core import (
        generate_ttms_grid,
        get_default_swap_term_structure,
    )

    smi = _smi_name_and_power()
    sw_chain, params = _usd_swaption_cube(svt)
    tenors = np.asarray(sw_chain.tenors, dtype=float)
    row = dict(forwards=[np.array([sw_chain.forwards[i][0]]) for i in range(tenors.size)],
               strikes_ttms=[[np.asarray(sw_chain.strikes_ttms[i][0])] for i in range(tenors.size)])
    call = lambda: fhjm.calc_mc_vols("NELSON-SIEGEL", params, 1.0, tenors,
                                     optiontypes=np.repeat('C', 9), is_annuity_measure=False,
                                     nb_path=RATES_MC_PATHS, seed=7, device=DEVICE, **row)
    captures = graphs.CAPTURES["rates_mc"]
    _, first_s = _timed_s(call)
    (prices, vols, ups, downs), warm_s = _timed_s(call)
    _check(graphs.CAPTURES["rates_mc"] == captures + 1, "the MC segment was not captured once")
    _, counts = _profiled(call)
    de_vols, de_s = _timed_s(lambda: rates.RateLogSVPricer(device=DEVICE).price_chain(
        sw_chain, params, t_grid=generate_ttms_grid(sw_chain.ttms[:4]), idxs=slice(0, 1)))
    ratio = max(_mc_band_gate(vols[i], ups[i], downs[i], de_vols[i][0], f"1y x {tenors[i]}y")
                for i in range(tenors.size))
    nb_steps = set_time_grid(1.0, 360)[0]
    print(f"[rates-mc] calc_mc_vols, USD cube 1y row (3 tenors x 9 strikes), {RATES_MC_PATHS} "
          f"paths x {nb_steps} steps (360/yr, one CUDA graph; normals drawn before it): first "
          f"call {first_s:.3f} s, warm {warm_s:.3f} s; profile: {_busy_line(counts)}; MC against "
          f"the DE pricer's normal vols ({de_s:.2f} s): max |gap| / band {ratio:.3f} (band: 10% "
          f"or the 1.96-stderr band, the wider); 1y x 2y MC vols (bp) "
          f"{np.round(1e4 * vols[0], 2).tolist()} | {smi}", flush=True)

    # the annuity and T-forward measures at injected normals, card against CPU
    rng = np.random.default_rng(11)
    W = (rng.standard_normal((nb_steps, RATES_MC_CHECK_PATHS, 3)),
         rng.standard_normal((nb_steps, RATES_MC_CHECK_PATHS)))
    n = RATES_MC_CHECK_PATHS
    mf = dict(ttms=np.array([1.0]), x0=np.zeros((n, 3)), y0=np.zeros((n, 8)), I0=np.zeros(n),
              sigma0=np.ones((n, 1)), theta=params.theta, kappa1=params.kappa1,
              kappa2=params.kappa2, ts=params.ts, A=params.A, R=params.R, C=params.C,
              Omega=params.Omega, betaxs=params.beta.xs, volvolxs=params.volvol.xs,
              basis=params.basis, ccy=params.ccy, nb_path=n, W=W)
    gaps = {}
    for measure, kw in ((rates.Measure.ANNUITY,
                         dict(ts_sw=get_default_swap_term_structure(1.0, 5.0), T_fwd=None)),
                        (rates.Measure.FORWARD, dict(ts_sw=None, T_fwd=3.0))):
        run = lambda device: rates.simulate_logsv_MF(measure_type=measure, device=device,
                                                     **mf, **kw)
        card = run(DEVICE)
        with graphs.eager():
            eager = run(DEVICE)
        cpu = run("cpu")
        _check(all(np.array_equal(a[-1], b[-1]) for a, b in zip(card, eager)),
               f"{measure.name}: the captured MC differs from the eager MC")
        gap = max(float(np.max(np.abs(a[-1] - b[-1]) / np.maximum(np.abs(b[-1]), 1.0)))
                  for a, b in zip(card, cpu))
        _check(gap <= 1e-12, f"{measure.name} MC card against CPU: {gap}")
        gaps[measure.name] = gap
    print(f"[rates-mc] simulate_logsv_MF at injected normals ({n} paths x {nb_steps} steps, USD "
          f"parameters): ANNUITY (1y x 5y) and FORWARD (T = 3) captured equal bit for bit to "
          f"eager; card against CPU path by path max gap "
          + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items()) + f" (floor 1) | {smi}",
          flush=True)

    # one futures expiry against the DE futures pricer
    ttm, fparams = _futures_params(svt)
    fstrikes = np.array([0.052, 0.057, 0.062])
    fut = lambda: rates.calc_futures_mc_vols(fparams, ttm, ttm, ttm + 0.25, strikes=fstrikes,
                                             optiontypes=np.array(['C'] * 3),
                                             nb_path=RATES_MC_PATHS, seed=42, device=DEVICE)
    _, fut_first_s = _timed_s(fut)
    (f0, fvols, fse), fut_s = _timed_s(fut)
    _, de_f = rates.logsv_chain_de_pricer(
        params=fparams, t_grid=generate_ttms_grid(np.array([ttm])), ttms=np.array([ttm]),
        forwards=[np.array([f0])], strikes_ttms=[[fstrikes]], optiontypes_ttms=[np.repeat('C', 3)],
        underlying_type=UnderlyingType.FUTURES, settlement_type=rates.FutSettleType.EURODOLLAR,
        device=DEVICE)
    vega = np.sqrt(ttm) * np.exp(-0.5 * ((f0 - fstrikes) / (fvols * np.sqrt(ttm))) ** 2) \
        / np.sqrt(2.0 * np.pi)
    band = 1.96 * fse / vega
    fratio = _mc_band_gate(fvols, fvols + band, fvols - band, np.asarray(de_f[0][0]).ravel(),
                           "futures")
    print(f"[rates-mc] calc_futures_mc_vols, 75-day expiry on a 3m rate, {RATES_MC_PATHS} "
          f"paths x {set_time_grid(ttm, 720)[0]} steps (720/yr, one CUDA graph): first call "
          f"{fut_first_s:.3f} s, warm {fut_s:.3f} s; f0 {f0:.6f}; MC against the DE futures "
          f"pricer: max |gap| / band {fratio:.3f}; MC vols (bp) "
          f"{np.round(1e4 * fvols, 2).tolist()} | {smi}", flush=True)


# the phases that run in the side process, in order: none launches a hand-written kernel
SIDE_PHASES = ("greeks", "terminal-models", "sweep", "mesh-sweep", "rates-cube")


# the factor-HJM calibration and Monte Carlo, in a second side process: host bound too, and
# their CPU references take minutes of host time
RATES_SIDE_PHASES = ("rates-calib", "rates-mc", "mesh-cube")


def _side_phases(conn, names) -> None:
    """a side process: each of ``names`` on the BTC chain, its walls (or the
    traceback of its failure) sent back through ``conn``."""
    import traceback

    try:
        import stochvolmodels_torch as svt
        from stochvolmodels_torch.ops import graphs

        chain = svt.get_btc_test_chain_data()
        phases = {"greeks": _greeks_phase, "terminal-models": _terminal_models_phase,
                  "sweep": _sweep_phase, "mesh-sweep": _mesh_sweep_phase,
                  "rates-cube": _rates_cube_phase, "rates-calib": _rates_calib_phase,
                  "rates-mc": _rates_mc_phase, "mesh-cube": _mesh_cube_phase}
        if names == RATES_SIDE_PHASES:
            # the CPU references of these phases share the host with two more processes
            torch.set_num_threads(2)
        walls = {}
        for name in names:
            t0 = time.perf_counter()
            phases[name](svt, graphs, chain)
            walls[name] = time.perf_counter() - t0
        conn.send(("ok", walls))
    except BaseException:
        conn.send(("failed", traceback.format_exc()))
        raise
    finally:
        conn.close()


def _start_side_phases(names=SIDE_PHASES):
    """(a side process running ``names``, the end of the pipe it reports on),
    started."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    receiver, sender = ctx.Pipe(duplex=False)
    process = ctx.Process(target=_side_phases, args=(sender, names),
                          name=f"chip_smoke side phases {names[0]}")
    process.start()
    sender.close()
    return process, receiver


def _join_side_phases(process, receiver) -> dict:
    """the side phases' walls, after the process ends; raises if it failed."""
    try:
        status, payload = receiver.recv()
    except EOFError:
        status, payload = "failed", "the side process ended without a report"
    process.join()
    _check(status == "ok" and process.exitcode == 0,
           f"side phases (exit code {process.exitcode}): {payload}")
    return payload


def _scaled_gap(label: str, out: torch.Tensor, ref: torch.Tensor, limit: float) -> float:
    """max |out - ref| / max(|ref|, 1) of two float32 outputs, printed and held
    to ``limit``, with the kernel's output finite; returns the max abs gap."""
    torch.cuda.synchronize()
    _check(bool(torch.isfinite(out).all()), f"{label} output not finite")
    diff = (out - ref).abs()
    max_abs = float(diff.max())
    scaled = float((diff / ref.abs().clamp(min=1.0)).max())
    print(f"[kernel-vs-plain] {label}: max abs error {max_abs:.3e}, max error / max(|ref|, 1) "
          f"{scaled:.3e} (limit {limit:g})", flush=True)
    _check(scaled <= limit, f"{label} exceeds its limit")
    return max_abs


def _payoff_gap(out, ref) -> float:
    """the widest relative gap of (prices, stds) lists; inf where the NaN
    patterns differ."""
    gap = 0.0
    for o, r in zip(out, ref):
        for a, b in zip(o, r):
            a, b = a.cpu().numpy(), b.cpu().numpy()
            if not np.array_equal(np.isnan(a), np.isnan(b)):
                return float("inf")
            ok = ~np.isnan(b)
            rel = np.abs(a[ok] - b[ok]) / np.maximum(np.abs(b[ok]), np.finfo(np.float64).tiny)
            gap = max(gap, float(np.max(rel, initial=0.0)))
    return gap


def _mc_payoff_phase(svt, chain) -> tuple:
    """the payoff kernels (mc_vars_payoff_cuda) against the plain panels
    (mc_vars_payoff) on float32 terminal states of PAYOFF_NB_PATH paths, one
    a BTC slice: held at PAYOFF_RTOL, then timed over the four slices by
    CUDA events in turns (plain, kernel, kernel, plain) beside the float64
    bound.  Returns (kernel ms, plain ms, bound ms, widest gap) of a chain's
    four slices."""
    from stochvolmodels_torch.ops import payoffs
    from stochvolmodels_torch.ops.bsm import as_option_codes

    dev = torch.device(DEVICE)
    slices = []
    for i, ttm in enumerate(chain.ttms):
        g = torch.Generator(device=dev).manual_seed(100 + i)
        x = (torch.randn(PAYOFF_NB_PATH, generator=g, device=dev, dtype=torch.float64)
             * (0.9 * np.sqrt(ttm)) - 0.405 * ttm).to(torch.float32)
        strikes = torch.as_tensor(np.asarray(chain.strikes_ttms[i], dtype=np.float64), device=dev)
        slices.append((x, torch.zeros_like(x), float(ttm), float(chain.forwards[i]), strikes,
                       as_option_codes(chain.optiontypes_ttms[i], dev),
                       float(chain.discfactors[i])))

    def run(fn):
        return [fn(x, q, ttm, fwd, k, c, discfactor=d) for x, q, ttm, fwd, k, c, d in slices]

    kernel, plain = (lambda: run(payoffs.mc_vars_payoff_cuda)), (lambda: run(payoffs.mc_vars_payoff))
    before = payoffs.mc_vars_payoff_cuda.launches
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    _check(payoffs.mc_vars_payoff_cuda.launches == before + len(slices),
           "the payoff kernels did not run once a slice")
    gap = _payoff_gap(out, ref)
    _check(gap <= PAYOFF_RTOL, f"the payoff kernels differ from the plain panels by {gap:.3e}")
    again = kernel()
    torch.cuda.synchronize()
    _check(all(torch.equal(a, b) for o, r in zip(out, again) for a, b in zip(o, r)),
           "two payoff kernel runs on one input differ")
    plain_ms = [_event_ms(plain, 3)]
    kernel_ms = [_event_ms(kernel, 20), _event_ms(kernel, 20)]
    plain_ms.append(_event_ms(plain, 3))
    k_ms, p_ms = statistics.mean(kernel_ms), statistics.mean(plain_ms)
    ops = sum(PAYOFF_NB_PATH * (PAYOFF_OPS_PER_PATH + PAYOFF_OPS_PER_PATH_STRIKE * len(k))
              for k in chain.strikes_ttms)
    bound_ms = 1e3 * ops / PEAK_F64_OPS_PER_S
    print(f"[mc-payoff] {PAYOFF_NB_PATH} float32 paths x {len(slices)} BTC slices "
          f"({[len(k) for k in chain.strikes_ttms]} strikes): kernels {k_ms:.4f} ms, plain panels "
          f"{p_ms:.3f} ms a chain ({p_ms / k_ms:.1f}x); bound {bound_ms:.4f} ms ({ops:.4e} float64 "
          f"ops at {PEAK_F64_OPS_PER_S:.0e}/s): {bound_ms / k_ms:.1%} of the bound; widest "
          f"relative gap {gap:.3e} (gate {PAYOFF_RTOL:.0e}), two runs equal bit for bit; runs "
          f"kernel {kernel_ms}, plain {plain_ms}", flush=True)
    return k_ms, p_ms, bound_ms, gap


def _variants_vs_plain(cuda_mc, mc_variants, x0: torch.Tensor) -> float:
    """each variant of the study against its plain version at NB_PATH x
    VARIANT_CHECK_STEPS (1e-4 max(|plain|, 1): the kernel's multiply-adds and
    approximate 1/sigma); poly-bm against logsv_mc at the study's parameters
    (eta 1, spot measure), path by path, within 1e-5 max(|out|, 1), the
    limit tests/test_torch_mc_variants.py holds the two plain versions to;
    poly-bm and one-prng (the two key rings) at ODD_NB_PATH, a half-empty
    last block, bit for bit the first paths of the full run.  Returns the
    largest gap to a plain version."""
    err, full = 0.0, {}
    for variant in mc_variants.VARIANTS:
        full[variant] = mc_variants.run_variant_cuda(7, x0, VARIANT_CHECK_STEPS, VARIANT_DT,
                                                     variant)
        plain_out = mc_variants.run_variant_torch(7, x0, VARIANT_CHECK_STEPS, VARIANT_DT, variant)
        err = max(err, _scaled_gap(f"logsv_variants {variant} {NB_PATH} paths x "
                                   f"{VARIANT_CHECK_STEPS} steps", full[variant], plain_out, 1e-4))
    from stochvolmodels_torch.utils.funcs import set_time_grid
    study = dict(theta=1.04, kappa1=3.18, kappa2=3.06, beta=0.15, volvol=1.85)
    # 91 steps at 359 a year over 91/360: dt rounds to the study's float32 1/360
    ttm = VARIANT_CHECK_STEPS / 360.0
    nb_steps, dt, _ = set_time_grid(ttm, 359)
    _check(nb_steps == VARIANT_CHECK_STEPS and np.float32(dt) == np.float32(VARIANT_DT),
           "the production grid no longer gives the study's steps")
    x, sigma, qvar = cuda_mc.simulate_logsv_terminal_cuda(
        7, x0, torch.full_like(x0, float(mc_variants.SIGMA0)), torch.zeros_like(x0), ttm=ttm,
        nb_steps_per_year=359, **study)
    _scaled_gap(f"logsv_variants poly-bm against logsv_mc {NB_PATH} paths x "
                f"{VARIANT_CHECK_STEPS} steps", full["poly-bm"], x + sigma + qvar, 1e-5)
    for variant in ("poly-bm", "one-prng"):
        odd = mc_variants.run_variant_cuda(7, x0[:ODD_NB_PATH], VARIANT_CHECK_STEPS, VARIANT_DT,
                                           variant)
        _check(torch.equal(odd, full[variant][:ODD_NB_PATH]),
               f"logsv_variants {variant} at {ODD_NB_PATH} paths differs from the full run")
        print(f"[half-block] logsv_variants {variant} {ODD_NB_PATH} paths: equal bit for bit to "
              f"the first {ODD_NB_PATH} paths of the {NB_PATH}-path run", flush=True)
    return err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a GPU",
              file=sys.stderr)
        return 1
    import stochvolmodels_torch as svt
    from stochvolmodels_torch.ops import _build, cuda_mc, mc_variants
    from stochvolmodels_torch.utils.funcs import set_time_grid

    # 1. device
    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = _smi_name_and_power()
    print(f"[device] {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | python {sys.version.split()[0]}", flush=True)
    dev = torch.device(DEVICE)

    # 2. build the kernels from the sources in the checkout, one nvcc each, in parallel
    t0 = time.perf_counter()
    _build.load_libraries(KERNELS)
    build_s = time.perf_counter() - t0
    for name in KERNELS:
        info = _build.BUILD_INFO[name]
        print(f"[build] {name}.cu (nvcc {info.get('seconds', 0.0):.2f} s; all {build_s:.2f} s) "
              f"| ptxas: {_ptxas(info.get('log', ''))}", flush=True)

    # 3. each kernel against its plain version on the card, at 2^20 paths
    P = svt.LOGSV_BTC_PARAMS
    rng = np.random.default_rng(7)
    x0 = torch.as_tensor(rng.normal(0.0, 0.1, NB_PATH).astype(np.float32), device=dev)
    s0 = torch.as_tensor(rng.uniform(0.5, 1.2, NB_PATH).astype(np.float32), device=dev)
    q0 = torch.as_tensor(rng.uniform(0.0, 0.1, NB_PATH).astype(np.float32), device=dev)
    mc_kw = dict(ttm=MAIN_TTM, theta=P.theta, kappa1=P.kappa1, kappa2=P.kappa2,
                 beta=P.beta, volvol=P.volvol)
    main_steps = set_time_grid(MAIN_TTM, MC_STEPS_PER_YEAR)[0]
    # the LogSV and Heston updates use FMA (and LogSV an approximate 1/sigma,
    # as the TPU kernel does), so LogSV is held as rough_mc is: 1e-4 in x and
    # 1e-4 |plain| + 1e-4 in sigma and qvar, path by path
    mc_gate = dict(atol=1e-4)
    # Heston's v is floored at 1e-4, so its absolute term stays far below the
    # floor: 1e-4 in x, 1e-5 |plain| + 1e-6 in v and qvar.  Read on an H100 at
    # these inputs: x 1.2e-6 abs; v 3.3e-6 abs, 1.01e-4 relative only on the
    # floor (where the gap is ~1e-8), and 8.7e-7 relative beside 1e-6 absolute;
    # qvar 5.4e-7 abs
    heston_gate = dict(rtol=1e-5, atol=1e-6)
    logsv_out = cuda_mc.simulate_logsv_terminal_cuda(7, x0, s0, q0, **mc_kw)
    err = {"logsv_mc": _vs_plain(
        "logsv_mc", main_steps, logsv_out,
        cuda_mc.simulate_logsv_terminal_torch(7, x0, s0, q0, **mc_kw), ("x", "sigma", "qvar"),
        **mc_gate)}
    # the inverse measure, with a backbone eta: adj sigma is nonzero
    inverse_kw = dict(mc_kw, is_spot_measure=False, vol_backbone_eta=1.1)
    err["logsv_mc"] = max(err["logsv_mc"], _vs_plain(
        "logsv_mc (inverse measure, eta 1.1)", main_steps,
        cuda_mc.simulate_logsv_terminal_cuda(7, x0, s0, q0, **inverse_kw),
        cuda_mc.simulate_logsv_terminal_torch(7, x0, s0, q0, **inverse_kw),
        ("x", "sigma", "qvar"), **mc_gate))
    H = svt.BTC_HESTON_PARAMS
    v0 = torch.as_tensor(rng.uniform(0.3, 1.2, NB_PATH).astype(np.float32), device=dev)
    heston_kw = dict(ttm=MAIN_TTM, theta=H.theta, kappa=H.kappa, rho=0.3, volvol=H.volvol)
    heston_out = cuda_mc.simulate_heston_terminal_cuda(7, x0, v0, q0, **heston_kw)
    err["heston_mc"] = _vs_plain(
        "heston_mc", main_steps, heston_out,
        cuda_mc.simulate_heston_terminal_torch(7, x0, v0, q0, **heston_kw), ("x", "var", "qvar"),
        **heston_gate)
    nodes, weights = svt.european_rule(ROUGH_H, ROUGH_NODES, ROUGH_T)
    vartheta = float(np.hypot(P.beta, P.volvol))
    rough_kw = dict(ttm=MAIN_TTM, sigma0=P.sigma0, theta=P.theta, kappa1=P.kappa1,
                    kappa2=P.kappa2, rho=P.beta / vartheta, volvol=vartheta, nodes=nodes,
                    weights=weights, device=dev)
    # the drift's FMAs round otherwise than the plain version: where the
    # factors nearly cancel in w.v, an ulp of a factor is ~1e-4 of vw, so vw
    # and y are held as tests/test_torch_rough.py holds them (rtol = atol = 1e-4)
    rough_out = cuda_mc.simulate_rough_terminal_cuda(7, NB_PATH, **rough_kw)
    err["rough_mc"] = _vs_plain("rough_mc", main_steps, rough_out,
                                cuda_mc.simulate_rough_terminal_torch(7, NB_PATH, **rough_kw),
                                ("x", "vw", "y"), atol=1e-4)
    HP = svt.HawkesJDParams()
    hawkes_kw = dict(ttm=HAWKES_MAIN_TTM, **HP.sim_params())
    lp0 = torch.as_tensor((rng.uniform(0.5, 2.0, NB_PATH) * HP.theta_p).astype(np.float32), device=dev)
    lm0 = torch.as_tensor((rng.uniform(0.5, 2.0, NB_PATH) * HP.theta_m).astype(np.float32), device=dev)
    hawkes_steps = set_time_grid(HAWKES_MAIN_TTM, HAWKES_STEPS_PER_YEAR)[0]
    hawkes_out = cuda_mc.simulate_hawkesjd_terminal_cuda(7, x0, lp0, lm0, **hawkes_kw)
    err["hawkes_mc"] = _vs_plain(
        "hawkes_mc", hawkes_steps, hawkes_out,
        cuda_mc.simulate_hawkesjd_terminal_torch(7, x0, lp0, lm0, **hawkes_kw),
        ("x", "lambda_p", "lambda_m"), exact=True)
    # the redesigned kernels with a half-empty last block: against the plain
    # version, and bit for bit against the first ODD_NB_PATH paths of the full run
    odd = [t[:ODD_NB_PATH] for t in (x0, lp0, lm0)]
    odd_logsv = [t[:ODD_NB_PATH] for t in (x0, s0, q0)]
    odd_heston = [t[:ODD_NB_PATH] for t in (x0, v0, q0)]
    odd_runs = {
        "logsv_mc": (cuda_mc.simulate_logsv_terminal_cuda(7, *odd_logsv, **mc_kw),
                     cuda_mc.simulate_logsv_terminal_torch(7, *odd_logsv, **mc_kw),
                     logsv_out, ("x", "sigma", "qvar"), mc_gate, main_steps),
        "heston_mc": (cuda_mc.simulate_heston_terminal_cuda(7, *odd_heston, **heston_kw),
                      cuda_mc.simulate_heston_terminal_torch(7, *odd_heston, **heston_kw),
                      heston_out, ("x", "var", "qvar"), heston_gate, main_steps),
        "rough_mc": (cuda_mc.simulate_rough_terminal_cuda(7, ODD_NB_PATH, **rough_kw),
                     cuda_mc.simulate_rough_terminal_torch(7, ODD_NB_PATH, **rough_kw),
                     rough_out, ("x", "vw", "y"), dict(atol=1e-4), main_steps),
        "hawkes_mc": (cuda_mc.simulate_hawkesjd_terminal_cuda(7, *odd, **hawkes_kw),
                      cuda_mc.simulate_hawkesjd_terminal_torch(7, *odd, **hawkes_kw),
                      hawkes_out, ("x", "lambda_p", "lambda_m"), dict(exact=True), hawkes_steps)}
    for name, (kernel_out, plain_out, full_out, labels, gate, steps) in odd_runs.items():
        err[name] = max(err[name], _vs_plain(name, steps, kernel_out, plain_out, labels, **gate))
        _check(all(torch.equal(k, f[:ODD_NB_PATH]) for k, f in zip(kernel_out, full_out)),
               f"{name} at {ODD_NB_PATH} paths differs from the first paths of the full run")
        print(f"[half-block] {name} {ODD_NB_PATH} paths: equal bit for bit to the first "
              f"{ODD_NB_PATH} paths of the {NB_PATH}-path run", flush=True)
    err["logsv_variants"] = _variants_vs_plain(cuda_mc, mc_variants, x0)
    chain = svt.get_btc_test_chain_data()
    launches = {}

    # 4.-5. LogSV path: analytic pricing and MC through the kernel
    gpu, cpu = svt.LogSVPricer(device=DEVICE), svt.LogSVPricer(device="cpu")
    _reset_counts(cuda_mc, mc_variants)
    prices = gpu.price_chain(chain, P)
    ivols = gpu.compute_model_ivols_for_chain(chain, P)
    mc = gpu.compute_mc_chain_implied_vols(chain, P, engine="cuda", nb_path=NB_PATH, seed=24,
                                           nb_steps=MC_STEPS_PER_YEAR)
    launches["logsv_mc"] = _counts(cuda_mc, mc_variants)["logsv_mc"]
    _check(launches["logsv_mc"] == len(chain.ttms), f"LogSV path launched {launches['logsv_mc']} kernels")
    gap, price_ms, ivol_ms = _gpu_vs_cpu(gpu, cpu, chain, P, prices, ivols, "LogSV")
    for ig in ivols:
        _check(np.all((ig > 0.5) & (ig < 1.5)), f"ivols outside [0.5, 1.5]: {ig}")
    print(f"[analytic] BTC chain {sum(len(s) for s in chain.strikes_ttms)} options: "
          f"GPU vs CPU max |dprice|/fwd {gap:.2e}; warm price_chain {price_ms:.1f} ms, "
          f"warm compute_model_ivols_for_chain {ivol_ms:.1f} ms", flush=True)

    _, _, _, iv_mid, iv_up, iv_down, _ = mc
    worst = 0.0
    for ia, im, iu, idn in zip(ivols, iv_mid, iv_up, iv_down):
        _check(np.all(np.isfinite(im)), f"MC ivols not finite: {im}")
        in_band = (ia >= idn) & (ia <= iu)
        close = np.abs(im - ia) <= 0.01
        _check(np.all(in_band | close), f"MC ivols {im} outside band/0.01 of analytic {ia}")
        worst = max(worst, float(np.max(np.abs(im - ia))))

    from stochvolmodels_torch.ops import payoffs

    def mc_call():
        before = cuda_mc.simulate_logsv_terminal_cuda.launches
        payoff_before = payoffs.mc_vars_payoff_cuda.launches
        gpu.compute_mc_chain_implied_vols(chain, P, engine="cuda", nb_path=NB_PATH, seed=24,
                                          nb_steps=MC_STEPS_PER_YEAR)
        added = cuda_mc.simulate_logsv_terminal_cuda.launches - before
        _check(added == len(chain.ttms), f"one MC chain call made {added} launches")
        launches["mc_payoff"] = payoffs.mc_vars_payoff_cuda.launches - payoff_before
        _check(launches["mc_payoff"] == len(chain.ttms),
               f"one MC chain call ran the payoff kernels {launches['mc_payoff']} times")

    mc_ms = _warm_ms(mc_call, repeats=3)
    print(f"[mc-chain] {NB_PATH} paths, {launches['logsv_mc']} kernel launches for "
          f"{len(chain.ttms)} maturities; max |MC ivol - analytic ivol| {worst:.4f}; "
          f"warm compute_mc_chain_implied_vols {mc_ms:.1f} ms", flush=True)

    # the payoff kernels against the plain panels at the benchmark's path count
    payoff_ms, payoff_plain_ms, payoff_bound_ms, err["mc_payoff"] = _mc_payoff_phase(svt, chain)

    # 6. Heston path: analytic pricing and MC through the kernel
    hgpu, hcpu = svt.HestonPricer(device=DEVICE), svt.HestonPricer(device="cpu")
    _reset_counts(cuda_mc, mc_variants)
    hprices = hgpu.price_chain(chain, H)
    hivols = hgpu.compute_model_ivols_for_chain(chain, H)
    hmc = hgpu.compute_mc_chain_implied_vols(chain, H, engine="cuda", nb_path=NB_PATH, seed=24)
    launches["heston_mc"] = _counts(cuda_mc, mc_variants)["heston_mc"]
    _check(launches["heston_mc"] == len(chain.ttms),
           f"Heston path launched {launches['heston_mc']} kernels")
    gap, price_ms, ivol_ms = _gpu_vs_cpu(hgpu, hcpu, chain, H, hprices, hivols, "Heston")
    print(f"[heston-analytic] GPU vs CPU max |dprice|/fwd {gap:.2e}; warm price_chain "
          f"{price_ms:.1f} ms, warm compute_model_ivols_for_chain {ivol_ms:.1f} ms", flush=True)
    worst = 0.0
    for a, m, s in zip(hprices, hmc[0], hmc[6]):
        _check(np.all(np.isfinite(m)), f"Heston MC prices not finite: {m}")
        ratio = np.abs(a - m) / (4.0 * s + 5e-3 * a)   # tests/test_heston.py's rule
        _check(np.all(ratio < 1.0), f"Heston MC {m} outside 4 stderr + 0.5% of analytic {a}")
        worst = max(worst, float(np.max(ratio)))
    hmc_ms = _warm_ms(lambda: hgpu.compute_mc_chain_implied_vols(
        chain, H, engine="cuda", nb_path=NB_PATH, seed=24), repeats=3)
    print(f"[heston-mc-chain] {NB_PATH} paths, {launches['heston_mc']} kernel launches for "
          f"{len(chain.ttms)} maturities; max |MC - analytic| / (4 stderr + 0.5% price) "
          f"{worst:.3f}; warm compute_mc_chain_implied_vols {hmc_ms:.1f} ms", flush=True)

    # 7. rough LogSV path: the lift's MC through the kernel, H = 0.5 then 0.1
    max_ttm = float(np.max(chain.ttms))
    rough_params = {}
    for h in (0.5, 0.1):
        rough_params[h] = svt.LogSvParams(**{**P.to_dict(), "H": h})
        rough_params[h].approximate_kernel(T=max_ttm)
    rough_call = lambda h: gpu.model_mc_price_chain(chain, rough_params[h], nb_path=NB_PATH,
                                                    use_rough_mc=True, engine="cuda", seed=24)
    _reset_counts(cuda_mc, mc_variants)
    rmc, rstd = rough_call(0.5)
    launches["rough_mc"] = _counts(cuda_mc, mc_variants)["rough_mc"]
    _check(launches["rough_mc"] == len(chain.ttms),
           f"rough path launched {launches['rough_mc']} kernels")
    analytic = cpu.price_chain(chain, rough_params[0.5])
    worst = 0.0
    for a, m, s in zip(analytic, rmc, rstd):
        ratio = np.abs(a - m) / (4.0 * s + 0.02 * a + 2e-4 * chain.forwards[0])
        _check(np.all(ratio < 1.0), f"rough H=0.5 MC {m} outside the band of analytic {a}")
        worst = max(worst, float(np.max(ratio)))
    rough_ivols = chain.compute_model_ivols_from_chain_data(model_prices=rough_call(0.1)[0],
                                                            device=DEVICE)
    finite = []
    for iv in rough_ivols:
        ok = np.isfinite(iv)
        finite.append(float(np.mean(ok)))
        _check(np.mean(ok) > 0.8 and np.all((iv[ok] > 0.3) & (iv[ok] < 2.5)),
               f"rough H=0.1 ivols not sane: {iv}")
    rough_ms = _warm_ms(lambda: rough_call(0.1), repeats=3)
    print(f"[rough-mc-chain] {NB_PATH} paths, {launches['rough_mc']} kernel launches for "
          f"{len(chain.ttms)} maturities; H=0.5 max |MC - analytic| / band {worst:.3f}; "
          f"H=0.1 ({ROUGH_NODES} nodes) finite ivol shares {finite}; warm "
          f"model_mc_price_chain(use_rough_mc=True) {rough_ms:.1f} ms", flush=True)

    # 8. Hawkes JD path: analytic pricing, one risk-premia reprice, MC through the kernel
    kgpu, kcpu = svt.HawkesJDPricer(device=DEVICE), svt.HawkesJDPricer(device="cpu")
    _reset_counts(cuda_mc, mc_variants)
    kprices = kgpu.price_chain(chain, HP)
    kivols = kgpu.compute_model_ivols_for_chain(chain, HP)
    kmc = kgpu.compute_mc_chain_implied_vols(chain, HP, engine="cuda", nb_path=NB_PATH, seed=24)
    launches["hawkes_mc"] = _counts(cuda_mc, mc_variants)["hawkes_mc"]
    _check(launches["hawkes_mc"] == len(chain.ttms),
           f"Hawkes path launched {launches['hawkes_mc']} kernels")
    gap, price_ms, ivol_ms = _gpu_vs_cpu(kgpu, kcpu, chain, HP, kprices, kivols, "Hawkes",
                                         repeats=HAWKES_REPEATS)
    for ig in kivols:
        _check(np.all((ig > 0.2) & (ig < 2.0)), f"Hawkes ivols outside [0.2, 2.0]: {ig}")
    print(f"[hawkes-analytic] GPU vs CPU max |dprice|/fwd {gap:.2e}; warm price_chain "
          f"{price_ms:.1f} ms, warm compute_model_ivols_for_chain {ivol_ms:.1f} ms", flush=True)

    norm_chain = svt.OptionChain.to_forward_normalised_strikes(chain)
    HG = svt.HawkesJDParams(risk_premia_gamma=HAWKES_GAMMA)
    t0 = time.perf_counter()
    gprices, givols = kgpu.compute_chain_prices_with_vols(norm_chain, HG)
    torch.cuda.synchronize()
    gamma_ms = 1e3 * (time.perf_counter() - t0)
    cprices, civols = kcpu.compute_chain_prices_with_vols(norm_chain, HG)
    ggap = 0.0
    for pg, pc, ig, ic in zip(gprices, cprices, givols, civols):
        _check(np.all(np.isfinite(pg)) and np.all(np.isfinite(ig)),
               "Hawkes risk-premia output not finite")
        _check(np.max(np.abs(pg - pc)) <= 1e-10, "Hawkes risk-premia GPU prices differ from CPU")
        _check(np.max(np.abs(ig - ic)) <= 1e-8, "Hawkes risk-premia GPU ivols differ from CPU")
        ggap = max(ggap, float(np.max(np.abs(pg - pc))))
    print(f"[hawkes-risk-premia] gamma {HAWKES_GAMMA} on the forward-normalised chain: GPU vs "
          f"CPU max |dprice| {ggap:.2e}; compute_chain_prices_with_vols {gamma_ms:.1f} ms "
          f"(one call, the graph's capture included)", flush=True)

    worst = 0.0
    for a, m, s, fwd in zip(kprices, kmc[0], kmc[6], chain.forwards):
        _check(np.all(np.isfinite(m)), f"Hawkes MC prices not finite: {m}")
        ratio = np.abs(a - m) / (4.0 * s + 0.02 * a + 2e-4 * fwd)   # tests/test_hawkes.py's rule
        _check(np.all(ratio < 1.0), f"Hawkes MC {m} outside 4 stderr + 2% + 2e-4 fwd of {a}")
        worst = max(worst, float(np.max(ratio)))

    def hawkes_mc_call():
        before = cuda_mc.simulate_hawkesjd_terminal_cuda.launches
        kgpu.compute_mc_chain_implied_vols(chain, HP, engine="cuda", nb_path=NB_PATH, seed=24)
        added = cuda_mc.simulate_hawkesjd_terminal_cuda.launches - before
        _check(added == len(chain.ttms), f"one Hawkes MC chain call made {added} launches")

    kmc_ms = _warm_ms(hawkes_mc_call, repeats=HAWKES_REPEATS)
    print(f"[hawkes-mc-chain] {NB_PATH} paths, {launches['hawkes_mc']} kernel launches for "
          f"{len(chain.ttms)} maturities; max |MC - analytic| / (4 stderr + 2% price + 2e-4 fwd) "
          f"{worst:.3f}; warm compute_mc_chain_implied_vols {kmc_ms:.1f} ms", flush=True)

    # 9. the variant study of the LogSV path loop: each variant once at 2^20 x 360
    zeros = torch.zeros(NB_PATH, dtype=torch.float32, device=dev)
    _reset_counts(cuda_mc, mc_variants)
    sanity = {}
    for variant in mc_variants.VARIANTS:
        before = mc_variants.run_variant_cuda.launches
        out = mc_variants.run_variant_cuda(0, zeros, VARIANT_STEPS, VARIANT_DT, variant)
        _check(mc_variants.run_variant_cuda.launches == before + 1,
               f"one {variant} call made {mc_variants.run_variant_cuda.launches - before} launches")
        finite = torch.isfinite(out)
        sanity[variant] = (float(out[finite].double().mean()), int((~finite).sum()))
    launches["logsv_variants"] = _counts(cuda_mc, mc_variants)["logsv_variants"]
    _check(launches["logsv_variants"] == len(mc_variants.VARIANTS),
           f"the variant study launched {launches['logsv_variants']} kernels")
    variant_ms = {}
    for variant in mc_variants.VARIANTS:
        def run(variant=variant):
            return mc_variants.run_variant_cuda(1, zeros, VARIANT_STEPS, VARIANT_DT, variant)

        run()
        variant_ms[variant] = min(_event_ms(run, 1) for _ in range(5))
    for variant, ms in variant_ms.items():
        bound, _ = _bound_ms("logsv_variants", mc_variants.OPS_PER_STEP[variant], NB_PATH,
                             VARIANT_STEPS)
        mean, bad = sanity[variant]
        # no-exp's kernel also divides exactly where the others take rcp.approx
        piece = "; no exp + IEEE 1/sigma" if variant == "no-exp" else ""
        print(f"[variants] {variant:18s} {NB_PATH} paths x {VARIANT_STEPS} steps, 1 launch per "
              f"call: best of 5 {ms:.4f} ms ({NB_PATH * VARIANT_STEPS / ms * 1e3:.4e} "
              f"path-steps/s; {ms - variant_ms['poly-bm']:+.4f} ms against poly-bm{piece}), bound "
              f"{bound:.4f} ms ({bound / ms:.1%}); sanity mean (x+sig+qvar) {mean:.4f}, {bad} "
              f"non-finite paths", flush=True)
        # no-exp's sigma = |1 + ln sigma| is not the model's and may leave the floats
        _check(bad == 0 or variant == "no-exp", f"variant {variant}: {bad} non-finite paths")

    # 10. throughput at 2^20 paths x 361 steps (360 for the study): plain, kernel, kernel, plain
    nb_steps = set_time_grid(THROUGHPUT_TTM, 360)[0]
    times = {}
    tp_kw = dict(mc_kw, ttm=THROUGHPUT_TTM)
    times["logsv_mc"] = _throughput(
        "logsv_mc", lambda: cuda_mc.simulate_logsv_terminal_cuda(7, x0, s0, q0, **tp_kw),
        lambda: cuda_mc.simulate_logsv_terminal_torch(7, x0, s0, q0, **tp_kw), nb_steps)
    tp_kw = dict(heston_kw, ttm=THROUGHPUT_TTM)
    times["heston_mc"] = _throughput(
        "heston_mc", lambda: cuda_mc.simulate_heston_terminal_cuda(7, x0, v0, q0, **tp_kw),
        lambda: cuda_mc.simulate_heston_terminal_torch(7, x0, v0, q0, **tp_kw), nb_steps)
    tp_kw = dict(rough_kw, ttm=THROUGHPUT_TTM)
    times["rough_mc"] = _throughput(
        f"rough_mc (N={ROUGH_NODES})",
        lambda: cuda_mc.simulate_rough_terminal_cuda(7, NB_PATH, **tp_kw),
        lambda: cuda_mc.simulate_rough_terminal_torch(7, NB_PATH, **tp_kw), nb_steps)
    tp_kw = dict(hawkes_kw, ttm=HAWKES_THROUGHPUT_TTM)
    times["hawkes_mc"] = _throughput(
        "hawkes_mc", lambda: cuda_mc.simulate_hawkesjd_terminal_cuda(7, x0, lp0, lm0, **tp_kw),
        lambda: cuda_mc.simulate_hawkesjd_terminal_torch(7, x0, lp0, lm0, **tp_kw),
        set_time_grid(HAWKES_THROUGHPUT_TTM, HAWKES_STEPS_PER_YEAR)[0])
    times["logsv_variants"] = _throughput(
        "logsv_variants (poly-bm)",
        lambda: mc_variants.run_variant_cuda(7, x0, VARIANT_STEPS, VARIANT_DT, "poly-bm"),
        lambda: mc_variants.run_variant_torch(7, x0, VARIANT_STEPS, VARIANT_DT, "poly-bm"),
        VARIANT_STEPS)

    steps = {name: nb_steps for name in cuda_mc.OPS_PER_STEP}
    steps["hawkes_mc"] = set_time_grid(HAWKES_THROUGHPUT_TTM, HAWKES_STEPS_PER_YEAR)[0]
    steps["logsv_variants"] = VARIANT_STEPS
    ops = dict(cuda_mc.OPS_PER_STEP, logsv_variants=mc_variants.OPS_PER_STEP["poly-bm"])
    # hawkes_mc's branches count at the share of this run's path-steps that take them
    shares = cuda_mc.hawkes_branch_shares(7, x0, lp0, lm0, **tp_kw)
    branch = cuda_mc.HAWKES_BRANCH_OPS
    ops["hawkes_mc"] = tuple(
        common + sum(shares[f"{b}_{side}"] * branch[b][k] for b in branch for side in "pm")
        for k, common in enumerate(ops["hawkes_mc"]))
    print(f"[hawkes-branches] {NB_PATH} paths x {steps['hawkes_mc']} steps, shares of "
          f"path-steps (of 32-path warp-steps): "
          + ", ".join(f"{b} {side} {shares[f'{b}_{side}']:.5f} ({shares[f'warp_{b}_{side}']:.5f})"
                      for b in branch for side in "pm"), flush=True)
    bounds = {name: _bound_ms(name, ops[name], NB_PATH, steps[name]) for name in PATH_KERNELS}
    # the issue floor: SASS instructions on the step loop's common path x
    # warp-steps / (SMs x 4 warp-instructions a clock x the SM clock measured under load)
    sass = _load_script("scripts/sass_step_loops.py")
    # the instances timed above: rough_mc at ROUGH_NODES, the study's poly-bm
    instance = {name: "" for name in PATH_KERNELS}
    instance["rough_mc"] = str(ROUGH_NODES)
    instance["logsv_variants"] = str(mc_variants.VARIANTS.index("poly-bm"))
    steps_per_loop = {name: sass.steps_per_pass(name) for name in PATH_KERNELS}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name in PATH_KERNELS:
        total, common, _ = sass.loop_lengths(sass.disassemble(_build._lib_path(name)))[instance[name]]
        clock = times[name][2]
        floor = (float("nan") if clock is None else 1e3 * common / steps_per_loop[name]
                 * (NB_PATH // 32) * steps[name] / (sms * ISSUE_PER_SM_CLOCK * clock * 1e6))
        print(f"[roofline] {name} {NB_PATH} paths x {steps[name]} steps: {sum(ops[name]):.1f} ops "
              f"per path-step ({ops[name][0]:.1f} float32 + {ops[name][1]:.1f} int32), bound "
              f"{bounds[name][0]:.4f} ms by {bounds[name][1]}, kernel {times[name][0]:.4f} ms: "
              f"{bounds[name][0] / times[name][0]:.1%} of the bound (an FMA counts two ops, as in "
              f"the peak); SASS step loop {total} instructions, {common} on its common path, per "
              f"{steps_per_loop[name]} step(s); issue floor {floor:.4f} ms at {clock} MHz "
              f"({floor / times[name][0]:.1%} of the kernel time)", flush=True)
    walls = {"serving paths, kernels and throughput": time.perf_counter() - t_start}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t0
        return out

    # 11. the rough rules, whose kernel timings, like those above, run before the side process
    from stochvolmodels_torch.ops import graphs
    rough_rules = timed("rough-rules", _rough_rules_phase, svt, cuda_mc, mc_variants, chain)
    err["rough_mc"] = max([err["rough_mc"]] + [e for _, _, e in rough_rules.values()])
    # the path-sharded MC on the device mesh, its shards' kernel times on a quiet card too; its
    # launches are logsv_mc's beside the MC chain call's
    mesh_launches, mesh_err = timed("mesh", _mesh_phase, svt, cuda_mc, mc_variants, chain, prices)
    launches["logsv_mc"] += mesh_launches
    err["logsv_mc"] = max(err["logsv_mc"], mesh_err)
    # 12.-14. the greeks, the terminal models, the LM sweeps (one GPU and the mesh) and the rates
    # cube in a side process, the rates calibration, MC and mesh cube in a second, beside the
    # phases below: all of them are bound by host launch work, not by the card
    side, side_conn = _start_side_phases()
    rates_side, rates_conn = _start_side_phases(RATES_SIDE_PHASES)
    compat_child = _start_compat_phase()
    try:
        # 15.-16. calibration and the CUDA graphs of the launch-bound calls
        timed("calibration", _calibration_phase, svt, gpu, chain)
        timed("graphs", _graph_phase, svt, chain, gpu, hgpu, kgpu, P, H, HP)
        # 17.-19. Heston and Hawkes calibration, the Hawkes reprice as one graph
        timed("heston-calibration", _heston_calibration_phase, svt, hgpu, chain)
        timed("hawkes-graphs", _hawkes_graph_phase, svt, kgpu, chain)
        timed("hawkes-calibration", _hawkes_calibration_phase, svt, kgpu, chain)
        # 20.-24. LogSV beyond LOG_RETURN: Q_VAR, densities, Q_VAR MC through logsv_mc, the MC
        # engines and the MC calibration
        timed("qvar", _qvar_phase, svt, graphs)
        timed("pdfs", _pdfs_phase, svt, graphs)
        err["logsv_mc"] = max(err["logsv_mc"], timed("qvar-mc", _qvar_mc_phase, svt, cuda_mc,
                                                     mc_variants))
        timed("mc-engines", _mc_engines_phase, svt, graphs, chain)
        timed("mc-calibration", _mc_calibration_phase, svt, chain)
        # 25.-26. the exponential-Euler solve and the Heston extras
        timed("analytic-ode", _analytic_ode_phase, svt, graphs, chain)
        timed("heston-extras", _heston_extras_phase, svt, graphs, chain)
        walls.update({f"{k} (side process)": v
                      for k, v in _join_side_phases(side, side_conn).items()})
        walls.update({f"{k} (rates side process)": v
                      for k, v in _join_side_phases(rates_side, rates_conn).items()})
        # 27.-28. a device trace with named regions, on the card alone once the side processes
        # have ended; the compat surface, whose fresh interpreter started with them
        timed("profiling", _profiling_phase, svt, chain, gpu, kgpu)
        timed("compat", _compat_phase, svt, compat_child)
    finally:
        for process in (side, rates_side):
            if process.is_alive():
                process.terminate()
                process.join(30)
        if compat_child.poll() is None:
            compat_child.kill()
            compat_child.communicate()
    print("[phase-walls] s: " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items())
          + f"; total {time.perf_counter() - t_start:.1f}", flush=True)

    replaces = {name: f"stochvolmodels_tpu/ops/pallas_mc.py:{line}" for name, line in
                (("logsv_mc", 142), ("heston_mc", 282), ("rough_mc", 386), ("hawkes_mc", 588))}
    replaces["logsv_variants"] = "scripts/bench_pallas_variants.py:86"
    # the JAX package leaves its payoffs (stochvolmodels_tpu/ops/payoffs.py) to XLA
    replaces["mc_payoff"] = None
    times["mc_payoff"] = (payoff_ms, payoff_plain_ms, None)
    bounds["mc_payoff"] = (payoff_bound_ms, "float64 operations")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"stochvolmodels_torch/csrc/{name}.cu", "replaces": replaces[name],
        "launches": launches[name], "max_abs_err": err[name],
        "ms": times[name][0], "plain_ms": times[name][1], "bound_ms": bounds[name][0],
        "bound_by": bounds[name][1], "library_ms": None} for name in KERNELS]}))
    print(_smi_name_and_power())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
