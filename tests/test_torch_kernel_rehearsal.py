"""A rehearsal of the LogSV, Heston and variant-study CUDA kernels on the CPU.

``csrc/logsv_mc.cu``, ``csrc/heston_mc.cu`` and ``csrc/logsv_variants.cu``
are compiled with ``g++
-std=c++20 -ffp-contract=off`` against the stand-in runtime
``tests/cuda_stub/cuda_runtime.h`` (one std::thread per CUDA thread, a
std::barrier for ``__syncthreads``, the blocks one after another), their
launches rewritten into calls, and run through their C entry points on numpy
buffers.  32,896 paths (2^15 + 128) cross a TPU-program boundary and end in
a half-empty block of 256; 131 steps cross a refill of the key ring (step
128) and end on the odd step after the 2-step unroll, and 129 steps refill
the ring on that odd step.  The LogSV kernel runs under both measures, and
Heston at two parameter sets.

The outputs are held against the plain versions on the CPU at rtol = atol =
1e-5: a wrong key, a missed barrier or a lost step shows as O(1) gaps, while
the kernels' FMAs (std::fmaf here) and the host libm's expf and sqrtf round
otherwise than the plain versions by an ulp now and then.  The stand-in
takes 1/sigma by division where the card takes rcp.approx.  Measured at 131
steps: max |gap| 2.4e-6 (LogSV and Heston), at most 1.3e-6 of
max(|plain|, 1).

The variant study runs the same paths and steps.  ``alu-floor`` and
``no-prng`` call no libm function and, on the CPU, no approximate
reciprocal, so the plain version with the kernel's multiply-adds
(``mc_variants._run_abs_sigma_fused``) equals the kernel bit for bit: that holds
the ring's keys (``alu-floor`` draws streams 0 and 1), the update, the
carried sigma^2 dt, the odd last step and the half-empty block exactly.
``poly-bm`` is held at 1e-5 of max(|plain|, 1) (measured 1.3e-6) and
``one-prng`` (the one-slot ring) at 1e-3 (measured 7.4e-5): the host's
logf and cosf round otherwise than torch's, and one-prng's sin from
sqrt(1 - cos^2) amplifies that where its 16-bit uniform puts cos near 1;
a wrong key gives O(1) gaps.  The C entry refuses blocks other than 256
threads and unrolls other than 2.  Skips where g++ is absent; ~35 s.
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from stochvolmodels_torch.ops import cuda_mc, mc_variants

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "stochvolmodels_torch" / "csrc"
STUB = Path(__file__).resolve().parent / "cuda_stub"
NB_PATH = (1 << 15) + 128
# ttm: 131 Euler steps at 360 steps/yr, or 129
TTM = {131: 0.3625, 129: 0.357}
TOL = 1e-5
BTC = dict(theta=1.0413, kappa1=3.1844, kappa2=3.058, beta=0.1514, volvol=1.8458)
HESTON = {"btc_like": dict(theta=1.0, kappa=2.0, rho=0.3, volvol=2.0),
          "equity_like": dict(theta=0.04, kappa=4.0, rho=-0.5, volvol=0.4)}
V0_RANGE = {"btc_like": (0.3, 1.2), "equity_like": (0.01, 0.09)}


@pytest.fixture(scope="module")
def kernels(tmp_path_factory):
    """{name: C entry point} of the two kernels, each compiled once."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel sources for the CPU")
    out_dir = tmp_path_factory.mktemp("rehearsal")
    argtypes = {"logsv_mc": cuda_mc._STATE_LAUNCH_ARGTYPES,
                "heston_mc": cuda_mc._STATE_LAUNCH_ARGTYPES,
                "logsv_variants": mc_variants._LAUNCH_ARGTYPES}
    return {name: compile_kernel(name, out_dir, types) for name, types in argtypes.items()}


def compile_kernel(name: str, out_dir: Path, argtypes):
    """the C entry point of ``csrc/<name>.cu`` built for the CPU against the
    stand-in runtime."""
    src = (CSRC / f"{name}.cu").read_text()
    src, n = re.subn(r"(\w+(?:<\w+>)?)<<<(.*?)>>>\(", r"cuda_stub::launch(\1, \2, ", src,
                     flags=re.S)
    assert n >= 1, f"no kernel launch found in {name}.cu"
    cpp, lib = out_dir / f"{name}.cpp", out_dir / f"lib{name}.so"
    cpp.write_text(src)
    subprocess.run(["g++", "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC", "-shared",
                    "-pthread", f"-I{STUB}", f"-I{CSRC}", "-o", str(lib), str(cpp)],
                   check=True, capture_output=True, text=True, timeout=120)
    fn = getattr(ctypes.CDLL(str(lib)), f"{name}_launch")
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def run(launch, state_in, nb_steps: int, host_args: np.ndarray, seed: int):
    ins = [np.ascontiguousarray(a, dtype=np.float32) for a in state_in]
    outs = [np.full(NB_PATH, np.nan, dtype=np.float32) for _ in range(3)]
    err = launch(*(a.ctypes.data for a in ins), *(o.ctypes.data for o in outs), NB_PATH,
                 seed, nb_steps, host_args.ctypes.data, None)
    assert err == 0
    return outs


def assert_matches(outs, ref):
    for out, plain in zip(outs, ref):
        plain = plain.numpy()
        assert np.all(np.isfinite(out))
        np.testing.assert_allclose(out, plain, rtol=TOL, atol=TOL)


def random_state(v_range, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.normal(0.0, 0.1, NB_PATH).astype(np.float32),
            rng.uniform(*v_range, NB_PATH).astype(np.float32),
            rng.uniform(0.0, 0.1, NB_PATH).astype(np.float32))


@pytest.mark.parametrize("is_spot_measure,steps", [(True, 131), (False, 131), (True, 129)])
def test_logsv_kernel_matches_plain_version(kernels, is_spot_measure, steps):
    launch = kernels["logsv_mc"]
    x0, s0, q0 = random_state((0.5, 1.2))
    kw = dict(BTC, ttm=TTM[steps], is_spot_measure=is_spot_measure,
              vol_backbone_eta=1.0 if is_spot_measure else 1.1)
    nb_steps, a = cuda_mc._euler_scalars(kw["ttm"], BTC["theta"], BTC["kappa1"], BTC["kappa2"],
                                         BTC["beta"], BTC["volvol"], kw["vol_backbone_eta"],
                                         is_spot_measure, 360)
    assert nb_steps == steps
    host_args = np.concatenate([np.asarray(a, dtype=np.float32), cuda_mc.LOG_C])
    lns0 = torch.log(torch.as_tensor(s0)).numpy()
    outs = run(launch, (x0, lns0, q0), nb_steps, host_args, seed=9)
    ref = cuda_mc.simulate_logsv_terminal_torch(9, *map(torch.as_tensor, (x0, s0, q0)), **kw)
    assert_matches(outs, ref)


@pytest.mark.parametrize("name,steps", [("btc_like", 131), ("equity_like", 131),
                                        ("equity_like", 129)])
def test_heston_kernel_matches_plain_version(kernels, name, steps):
    launch = kernels["heston_mc"]
    x0, v0, q0 = random_state(V0_RANGE[name])
    p = HESTON[name]
    nb_steps, a = cuda_mc._heston_scalars(TTM[steps], p["theta"], p["kappa"], p["rho"],
                                          p["volvol"], 360)
    assert nb_steps == steps
    outs = run(launch, (x0, v0, q0), nb_steps, np.concatenate([a, cuda_mc.LOG_C]), seed=9)
    ref = cuda_mc.simulate_heston_terminal_torch(9, *map(torch.as_tensor, (x0, v0, q0)),
                                                 ttm=TTM[steps], **p)
    assert_matches(outs, ref)


# the variant study: (variant, steps, limit of |kernel - plain| / max(|plain|, 1)); 0 is bit for bit
VARIANT_CASES = [("alu-floor", 131, 0.0), ("alu-floor", 129, 0.0), ("no-prng", 131, 0.0),
                 ("poly-bm", 131, TOL), ("poly-bm", 129, TOL), ("one-prng", 131, 1e-3)]


def run_variant(launch, variant: str, nb_steps: int, x0: np.ndarray, threads=256, unroll=2):
    out = np.full(NB_PATH, np.nan, dtype=np.float32)
    host_args = np.concatenate([mc_variants._scalars(1.0 / 360.0), cuda_mc.LOG_C])
    err = launch(x0.ctypes.data, out.ctypes.data, NB_PATH, 9, nb_steps,
                 mc_variants.VARIANTS.index(variant), unroll, threads, host_args.ctypes.data,
                 None)
    return err, out


@pytest.mark.parametrize("variant,steps,limit", VARIANT_CASES)
def test_variant_kernel_matches_plain_version(kernels, variant, steps, limit):
    x0 = random_state((0.5, 1.2))[0]
    err, out = run_variant(kernels["logsv_variants"], variant, steps, x0)
    assert err == 0 and np.all(np.isfinite(out))
    # the stand-in divides exactly, so the kernel's FMAs give its bits
    plain = mc_variants._run_abs_sigma_fused if limit == 0.0 else mc_variants.run_variant_torch
    ref = plain(9, torch.as_tensor(x0), steps, 1.0 / 360.0, variant).numpy()
    if limit == 0.0:
        np.testing.assert_array_equal(out, ref)
    else:
        assert np.max(np.abs(out - ref) / np.maximum(np.abs(ref), 1.0)) <= limit


def test_variant_entry_refuses_what_it_does_not_take(kernels):
    x0 = random_state((0.5, 1.2))[0]
    launch = kernels["logsv_variants"]
    for threads, unroll, variant in ((128, 2, "poly-bm"), (512, 2, "poly-bm"), (256, 1, "poly-bm"),
                                     (256, 4, "poly-bm")):
        err, out = run_variant(launch, variant, 4, x0, threads=threads, unroll=unroll)
        assert err != 0 and np.all(np.isnan(out))
