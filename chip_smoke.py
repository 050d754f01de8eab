#!/usr/bin/env python3
"""On-card smoke check of the PyTorch/CUDA port, ``stochvolmodels_torch``.

Run from the repository root on a machine with one NVIDIA GPU (built for
sm_90a, an H100) and the CUDA toolkit:

    python3 chip_smoke.py

It builds the hand-written LogSV Monte-Carlo kernel from ``csrc/``, holds it
against its plain PyTorch version on the card, drives the port's serving path
on the bundled BTC chain (analytic prices and implied vols, then MC prices
and implied vols through the kernel), and measures kernel throughput.  Each
phase prints one line; any failure raises and exits non-zero.  The last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.
"""
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

DEVICE = "cuda"
NB_PATH = 1 << 20
MAIN_TTM = 0.25           # 91 Euler steps at 360 steps/yr
THROUGHPUT_TTM = 1.0      # 361 Euler steps at 360 steps/yr
# MC chain Euler grid, steps per year.  The pricer's default for the BTC
# chain (int(360 * 0.43) + 1 = 156) gives the 2-week slice 7 steps, whose
# Euler bias moves the far-OTM call ivols by up to 0.014 from the analytic
# ones; at 360 steps/yr the largest gap is 0.007 (plain version, 2^20 paths).
MC_STEPS_PER_YEAR = 360


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def _smi_name_and_power() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a GPU",
              file=sys.stderr)
        return 1
    import stochvolmodels_torch as svt
    from stochvolmodels_torch.ops import _build, cuda_mc

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = _smi_name_and_power()
    print(f"[device] {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | python {sys.version.split()[0]}", flush=True)
    dev = torch.device(DEVICE)

    # 2. build the kernel from the sources in the checkout
    t0 = time.perf_counter()
    _build.load_library("logsv_mc")
    build_s = time.perf_counter() - t0
    info = _build.BUILD_INFO["logsv_mc"]
    ptxas = " ".join(line.strip() for line in info.get("log", "").splitlines()
                     if "registers" in line or "spill" in line)
    print(f"[build] logsv_mc.cu in {build_s:.2f} s (nvcc {info.get('seconds', 0.0):.2f} s) "
          f"| ptxas: {ptxas}", flush=True)

    # 3. kernel against its plain version on the card, at 2^20 paths
    P = svt.LOGSV_BTC_PARAMS
    rng = np.random.default_rng(7)
    x0 = torch.as_tensor(rng.normal(0.0, 0.1, NB_PATH).astype(np.float32), device=dev)
    s0 = torch.as_tensor(rng.uniform(0.5, 1.2, NB_PATH).astype(np.float32), device=dev)
    q0 = torch.as_tensor(rng.uniform(0.0, 0.1, NB_PATH).astype(np.float32), device=dev)
    mc_kw = dict(ttm=MAIN_TTM, theta=P.theta, kappa1=P.kappa1, kappa2=P.kappa2,
                 beta=P.beta, volvol=P.volvol)
    before = cuda_mc.simulate_logsv_terminal_cuda.launches
    xk, sk, qk = cuda_mc.simulate_logsv_terminal_cuda(7, x0, s0, q0, **mc_kw)
    torch.cuda.synchronize()
    _check(cuda_mc.simulate_logsv_terminal_cuda.launches == before + 1, "launch count did not move")
    xp, sp, qp = cuda_mc.simulate_logsv_terminal_torch(7, x0, s0, q0, **mc_kw)
    torch.cuda.synchronize()
    for t in (xk, sk, qk):
        _check(bool(torch.isfinite(t).all()), "kernel output not finite")
    x_abs = float((xk - xp).abs().max())
    s_rel = float(((sk - sp).abs() / sp).max())
    q_rel = float(((qk - qp).abs() / qp).max())
    max_abs_err = max(x_abs, float((sk - sp).abs().max()), float((qk - qp).abs().max()))
    print(f"[kernel-vs-plain] {NB_PATH} paths x 91 steps: x max abs {x_abs:.3e}, "
          f"sigma max rel {s_rel:.3e}, qvar max rel {q_rel:.3e} (limits 1e-4)", flush=True)
    _check(x_abs <= 1e-4 and s_rel <= 1e-4 and q_rel <= 1e-4, "kernel disagrees with plain version")

    # 4.-5. the main path: analytic pricing and MC through the kernel
    chain = svt.get_btc_test_chain_data()
    gpu, cpu = svt.LogSVPricer(device=DEVICE), svt.LogSVPricer(device="cpu")
    cuda_mc.simulate_logsv_terminal_cuda.launches = 0
    prices = gpu.price_chain(chain, P)
    ivols = gpu.compute_model_ivols_for_chain(chain, P)
    mc = gpu.compute_mc_chain_implied_vols(chain, P, engine="cuda", nb_path=NB_PATH, seed=24,
                                           nb_steps=MC_STEPS_PER_YEAR)
    main_launches = cuda_mc.simulate_logsv_terminal_cuda.launches
    _check(main_launches == len(chain.ttms), f"main path launched {main_launches} kernels")

    prices_cpu = cpu.price_chain(chain, P)
    ivols_cpu = cpu.compute_model_ivols_for_chain(chain, P)
    for pg, pc, ig, ic, fwd in zip(prices, prices_cpu, ivols, ivols_cpu, chain.forwards):
        _check(np.all(np.isfinite(pg)) and np.all(np.isfinite(ig)), "analytic output not finite")
        _check(np.all((ig > 0.5) & (ig < 1.5)), f"ivols outside [0.5, 1.5]: {ig}")
        _check(np.max(np.abs(pg - pc)) <= 1e-10 * fwd, "GPU prices differ from CPU prices")
        _check(np.max(np.abs(ig - ic)) <= 1e-8, "GPU ivols differ from CPU ivols")
    price_ms = _warm_ms(lambda: gpu.price_chain(chain, P))
    ivol_ms = _warm_ms(lambda: gpu.compute_model_ivols_for_chain(chain, P))
    gap = max(float(np.max(np.abs(pg - pc) / fwd))
              for pg, pc, fwd in zip(prices, prices_cpu, chain.forwards))
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

    def mc_call():
        before = cuda_mc.simulate_logsv_terminal_cuda.launches
        gpu.compute_mc_chain_implied_vols(chain, P, engine="cuda", nb_path=NB_PATH, seed=24,
                                          nb_steps=MC_STEPS_PER_YEAR)
        added = cuda_mc.simulate_logsv_terminal_cuda.launches - before
        _check(added == len(chain.ttms), f"one MC chain call made {added} launches")

    mc_ms = _warm_ms(mc_call, repeats=3)
    print(f"[mc-chain] {NB_PATH} paths, {main_launches} kernel launches for "
          f"{len(chain.ttms)} maturities; max |MC ivol - analytic ivol| {worst:.4f}; "
          f"warm compute_mc_chain_implied_vols {mc_ms:.1f} ms", flush=True)

    # 6. throughput at 2^20 paths x 361 steps: plain, kernel, kernel, plain
    tp_kw = dict(mc_kw, ttm=THROUGHPUT_TTM)
    nb_steps = svt.set_time_grid(THROUGHPUT_TTM, 360)[0]
    run_k = lambda: cuda_mc.simulate_logsv_terminal_cuda(7, x0, s0, q0, **tp_kw)
    run_p = lambda: cuda_mc.simulate_logsv_terminal_torch(7, x0, s0, q0, **tp_kw)
    run_k(), run_p()
    plain_ms = [_event_ms(run_p, 2)]
    kernel_ms = [_event_ms(run_k, 10), _event_ms(run_k, 10)]
    plain_ms.append(_event_ms(run_p, 2))
    k_ms, p_ms = statistics.mean(kernel_ms), statistics.mean(plain_ms)
    path_steps = NB_PATH * nb_steps
    print(f"[throughput] {NB_PATH} paths x {nb_steps} steps: kernel {k_ms:.3f} ms "
          f"({path_steps / k_ms * 1e3:.4e} path-steps/s), plain {p_ms:.3f} ms "
          f"({path_steps / p_ms * 1e3:.4e} path-steps/s); runs kernel {kernel_ms}, "
          f"plain {plain_ms}", flush=True)

    print(json.dumps({"kernels": [{
        "name": "logsv_mc", "route": "cuda",
        "source": "stochvolmodels_torch/csrc/logsv_mc.cu",
        "replaces": "stochvolmodels_tpu/ops/pallas_mc.py:142",
        "launches": main_launches, "max_abs_err": max_abs_err,
        "ms": k_ms, "plain_ms": p_ms}]}))
    print(_smi_name_and_power())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
