#!/usr/bin/env python3
"""Time the Monte-Carlo kernels of this checkout against another checkout's,
in one process on one card, in turns.

    python3 scripts/compare_kernels.py --other DIR [--kernels NAME ...] [--rounds R]

DIR is the root of another checkout of this repository (for example the
parent commit, unpacked with ``git archive`` into a directory that
``.gitignore`` lists).  Its ``stochvolmodels_torch/csrc/<name>.cu`` are
built with this checkout's nvcc flags into ``<DIR>/build/compare/`` and
launched through the same C entry points and argument layouts as this
checkout's kernels.  For each kernel, at 2^20 paths x 361 steps (the
chip_smoke.py throughput shapes), it prints the two outputs' largest gap
(``equal`` when bit for bit), then R rounds of other, this, this, other,
each the mean of 10 launches by CUDA events, with the SM clock sampled
under each side's load, and the SASS step loop of each build
(``scripts/sass_step_loops.py``).  Needs one CUDA card and the toolkit.
"""
import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

DEVICE = "cuda"
NB_PATH = 1 << 20
REPEATS = 10


def _inputs(name, svt, cuda_mc):
    """(the C entry point's argtypes, the state inputs after x0 (None for the
    rough kernel, which takes none), x0, nb_steps, the 26 float32 host
    arguments) of one kernel at the throughput shape."""
    rng = np.random.default_rng(7)
    dev = torch.device(DEVICE)
    x0 = torch.as_tensor(rng.normal(0.0, 0.1, NB_PATH).astype(np.float32), device=dev)
    P = svt.LOGSV_BTC_PARAMS
    if name == "logsv_mc":
        s0 = torch.as_tensor(rng.uniform(0.5, 1.2, NB_PATH).astype(np.float32), device=dev)
        q0 = torch.as_tensor(rng.uniform(0.0, 0.1, NB_PATH).astype(np.float32), device=dev)
        nb_steps, a = cuda_mc._euler_scalars(1.0, P.theta, P.kappa1, P.kappa2, P.beta, P.volvol,
                                             1.0, True, 360)
        args = np.concatenate([np.asarray(a, dtype=np.float32), cuda_mc.LOG_C])
        return cuda_mc._STATE_LAUNCH_ARGTYPES, (torch.log(s0), q0), x0, nb_steps, args
    if name == "heston_mc":
        H = svt.BTC_HESTON_PARAMS
        v0 = torch.as_tensor(rng.uniform(0.3, 1.2, NB_PATH).astype(np.float32), device=dev)
        q0 = torch.as_tensor(rng.uniform(0.0, 0.1, NB_PATH).astype(np.float32), device=dev)
        nb_steps, a = cuda_mc._heston_scalars(1.0, H.theta, H.kappa, 0.3, H.volvol, 360)
        return (cuda_mc._STATE_LAUNCH_ARGTYPES, (v0, q0), x0, nb_steps,
                np.concatenate([a, cuda_mc.LOG_C]))
    if name == "hawkes_mc":
        HP = svt.HawkesJDParams()
        lp0 = torch.as_tensor((rng.uniform(0.5, 2.0, NB_PATH) * HP.theta_p).astype(np.float32),
                              device=dev)
        lm0 = torch.as_tensor((rng.uniform(0.5, 2.0, NB_PATH) * HP.theta_m).astype(np.float32),
                              device=dev)
        nb_steps, a = cuda_mc._hawkes_args(0.2, nb_steps_per_year=1800, **HP.sim_params())
        return (cuda_mc._STATE_LAUNCH_ARGTYPES, (lp0, lm0), x0, nb_steps,
                np.concatenate([a, cuda_mc.LOG_C]))
    if name == "rough_mc":
        nodes, weights = svt.european_rule(0.1, 3, 0.43)
        vt = float(np.hypot(P.beta, P.volvol))
        nb_steps, args, _ = cuda_mc._rough_args(1.0, P.sigma0, P.theta, P.kappa1, P.kappa2,
                                                P.beta / vt, vt, nodes, weights, 360)
        return cuda_mc._ROUGH_LAUNCH_ARGTYPES, None, None, nb_steps, args
    raise ValueError(f"no comparison set up for {name}")


def _runner(lib, name, argtypes, state, x0, nb_steps, host_args):
    """a function that launches ``name`` from ``lib`` once and returns its
    three outputs."""
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    outs = [torch.empty(NB_PATH, dtype=torch.float32, device=DEVICE) for _ in range(3)]
    stream = lambda: torch.cuda.current_stream().cuda_stream
    if state is None:  # rough_mc: no state in, three factors
        call = lambda: fn(*(o.data_ptr() for o in outs), NB_PATH, 7, nb_steps, 3,
                          host_args.ctypes.data, stream())
    else:
        call = lambda: fn(x0.data_ptr(), *(s.data_ptr() for s in state),
                          *(o.data_ptr() for o in outs), NB_PATH, 7, nb_steps,
                          host_args.ctypes.data, stream())

    def run():
        err = call()
        if err != 0:
            raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
        return outs
    return run


def _build_other(other: Path, names, _build) -> dict:
    """build the other checkout's kernels with this checkout's flags, one nvcc
    each, all started together; {name: library path}."""
    csrc, out_dir = other / "stochvolmodels_torch" / "csrc", other / "build" / "compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    jobs = {name: subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-o", str(out_dir / f"lib{name}.so"),
                                    str(csrc / f"{name}.cu")], stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True) for name in names}
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the other checkout's {name}.cu:\n{log}")
    return {name: out_dir / f"lib{name}.so" for name in names}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", type=Path, required=True)
    parser.add_argument("--kernels", nargs="+",
                        default=["hawkes_mc", "rough_mc", "logsv_mc", "heston_mc"])
    parser.add_argument("--rounds", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    import stochvolmodels_torch as svt
    from stochvolmodels_torch.ops import _build, cuda_mc
    sass = chip_smoke._load_script("scripts/sass_step_loops.py")
    csrc = {"this": sass.CSRC, "other": args.other.resolve() / "stochvolmodels_torch" / "csrc"}

    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: "
          f"{chip_smoke._smi_name_and_power()}", flush=True)
    libs = {"this": {n: _build._lib_path(n) for n in args.kernels}}
    _build.load_libraries(args.kernels)
    libs["other"] = _build_other(args.other.resolve(), args.kernels, _build)
    for name in args.kernels:
        argtypes, state, x0, nb_steps, host_args = _inputs(name, svt, cuda_mc)
        run = {side: _runner(ctypes.CDLL(str(libs[side][name])), name, argtypes, state, x0,
                             nb_steps, host_args) for side in ("other", "this")}
        out = {side: [t.clone() for t in run[side]()] for side in run}
        torch.cuda.synchronize()
        gaps = [float((a - b).abs().max()) for a, b in zip(out["this"], out["other"])]
        same = all(torch.equal(a, b) for a, b in zip(out["this"], out["other"]))
        times = {"other": [], "this": []}
        for _ in range(args.rounds):
            for side in ("other", "this", "this", "other"):
                times[side].append(chip_smoke._event_ms(run[side], REPEATS))
        clocks = {side: chip_smoke._clock_under_load(f"{name} ({side})", run[side],
                                                     statistics.median(times[side]))
                  for side in ("other", "this")}
        loops = {side: sass.loop_lengths(sass.disassemble(libs[side][name])) for side in run}
        med = {side: statistics.median(t) for side, t in times.items()}
        print(f"[compare] {name} {NB_PATH} paths x {nb_steps} steps: other {med['other']:.4f} ms, "
              f"this {med['this']:.4f} ms (medians of {2 * args.rounds} means of {REPEATS} "
              f"launches, in turns other, this, this, other; this / other "
              f"{med['this'] / med['other']:.3f}); SM clock other {clocks['other']} MHz, this "
              f"{clocks['this']} MHz; outputs {'equal bit for bit' if same else f'max gaps {gaps}'}; "
              f"runs other {[round(t, 4) for t in times['other']]}, this "
              f"{[round(t, 4) for t in times['this']]}", flush=True)
        timed = str(chip_smoke.ROUGH_NODES) if name == "rough_mc" else ""
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        per = {side: sass.steps_per_pass(name, csrc[side]) for side in run}
        for inst in loops["this"]:
            loop = {side: loops[side].get(inst, (0, 0, None)) for side in run}
            line = (f"[sass] {name}{'<' + inst + '>' if inst else ''}: step loop other "
                    f"{loop['other'][0]} ({loop['other'][1]} on its common path, {per['other']} "
                    f"step(s) a pass), this {loop['this'][0]} ({loop['this'][1]}, {per['this']})")
            if inst == timed and None not in clocks.values():
                # common-path instructions a step x warp-steps / (SMs x 4 a clock x the SM clock)
                floor = {side: 1e3 * loop[side][1] / per[side] * (NB_PATH // 32) * nb_steps
                         / (sms * chip_smoke.ISSUE_PER_SM_CLOCK * clocks[side] * 1e6)
                         for side in run}
                line += "; issue floor " + ", ".join(
                    f"{side} {floor[side]:.4f} ms ({floor[side] / med[side]:.1%} of its time)"
                    for side in ("other", "this"))
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
