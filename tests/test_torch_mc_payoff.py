"""The MC payoff kernels (``csrc/mc_payoff.cu``) without a card.

* The wrapper ``mc_vars_payoff_cuda`` refuses what the kernels do not take
  (a CPU tensor, an integer dtype, a non-contiguous view) before it builds
  or launches anything; ``compute_mc_vars_payoff`` on CPU tensors takes the
  plain version ``mc_vars_payoff`` and launches nothing.
* The build key of ``mc_payoff`` follows its source, and editing that
  source leaves the path kernels' keys as they were.
* A rehearsal: the source compiled with ``g++ -std=c++20 -ffp-contract=off``
  against the stand-in runtime ``tests/cuda_stub/cuda_runtime.h`` (one
  std::thread per CUDA thread, a std::barrier per block and per warp, the
  blocks one after another), its launches rewritten into calls, run through
  its C entry point on numpy buffers at small grids (several blocks a pass,
  grid strides, a ragged last pack) and held against ``mc_vars_payoff`` on
  CPU tensors.  The kernels take each element through the same float64
  operations and sum in another order; the host's libm exp and the CPU's
  true division by ttm may differ from torch's by an ulp.  So prices and
  standard errors are held at 1e-12 relative (measured: up to 2e-15, and
  2e-14 on the standard error of 8 replicate means, whose deviations
  cancel), NaN where the plain version gives NaN.  Skips where g++ is
  absent; ~15 s.
"""
import ctypes
import math
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from stochvolmodels_torch.config import VariableType
from stochvolmodels_torch.ops import _build, payoffs

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "stochvolmodels_torch" / "csrc"
STUB = Path(__file__).resolve().parent / "cuda_stub"
PATH_KERNELS = ("logsv_mc", "heston_mc", "rough_mc", "hawkes_mc", "logsv_variants")
RTOL = 1e-12
# blocks a pass in the rehearsal (the card's wrapper asks for two an SM)
TARGET_BLOCKS = 5


def _args(n=256, k=5, dtype=torch.float32):
    x = torch.zeros(n, dtype=dtype)
    return (x, x.clone(), 0.25, 100.0, torch.linspace(80.0, 120.0, k, dtype=torch.float64),
            torch.ones(k, dtype=torch.int8))


def test_wrapper_raises_on_a_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA tensors"):
        payoffs.mc_vars_payoff_cuda(*_args())


def test_wrapper_raises_on_an_integer_dtype():
    x, q, *rest = _args()
    with pytest.raises(TypeError, match="float32 or float64"):
        payoffs.mc_vars_payoff_cuda(x.to(torch.int32), q.to(torch.int32), *rest)


def test_wrapper_raises_on_a_non_contiguous_view():
    x, q, *rest = _args(n=512)
    with pytest.raises(ValueError, match="contiguous"):
        payoffs.mc_vars_payoff_cuda(x[::2], q[::2], *rest)


def test_compute_on_cpu_takes_the_plain_version():
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.normal(0.0, 0.3, 4096).astype(np.float32))
    q = torch.as_tensor(rng.uniform(0.0, 0.2, 4096).astype(np.float32))
    strikes, types = np.array([80.0, 100.0, 120.0]), np.array(["P", "C", "IC"])
    before = payoffs.mc_vars_payoff_cuda.launches
    prices, stds = payoffs.compute_mc_vars_payoff(x, None, q, 0.25, 100.0, strikes, types, 0.99)
    assert payoffs.mc_vars_payoff_cuda.launches == before == 0
    codes = torch.as_tensor([0, 1, 3], dtype=torch.int8)
    ref = payoffs.mc_vars_payoff(x, q, 0.25, 100.0, torch.as_tensor(strikes), codes,
                                 discfactor=0.99)
    np.testing.assert_array_equal(prices, ref[0].numpy())
    np.testing.assert_array_equal(stds, ref[1].numpy())


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, copy)
    monkeypatch.setattr(_build, "CSRC_DIR", copy)
    return copy


def test_digest_follows_the_payoff_source_alone(csrc_copy):
    before = {name: _build.source_digest(name) for name in PATH_KERNELS + ("mc_payoff",)}
    assert len(set(before.values())) == len(before)
    src = csrc_copy / "mc_payoff.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.source_digest("mc_payoff") != before["mc_payoff"]
    assert {name: _build.source_digest(name) for name in PATH_KERNELS} == {
        name: before[name] for name in PATH_KERNELS}


def test_payoff_source_names_no_path_kernel_and_adds_no_header():
    src = (CSRC / "mc_payoff.cu").read_text()
    assert 'extern "C" int mc_payoff_launch(' in src
    assert "#include \"" not in src
    for path_kernel in ("heston_mc_kernel", "logsv_mc_kernel"):
        assert path_kernel not in src


@pytest.mark.parametrize("nb_path,nb_strikes,nb_groups,paired,pack,target", [
    (4_194_304, 15, 1, False, 4, 264), (4_194_304, 40, 1, False, 4, 264),
    (100_000, 13, 8, False, 2, 264), (100_002, 9, 1, True, 2, 264), (300, 12, 1, False, 4, 264),
    (7, 3, 1, False, 4, 5)])
def test_payoff_grid(nb_path, nb_strikes, nb_groups, paired, pack, target):
    bx_spot, bx_pay = payoffs.payoff_grid(nb_path, nb_strikes, nb_groups, paired, pack, target)
    tiles = -(-nb_strikes // payoffs.PAYOFF_TILE)
    assert 1 <= bx_spot and bx_spot * nb_groups <= max(target, nb_groups)
    assert 1 <= bx_pay and bx_pay * nb_groups * tiles <= max(target, nb_groups * tiles)
    per_block = payoffs.PAYOFF_THREADS * pack
    # every block but the first has a whole pack for its first thread
    spot_len = nb_path // nb_groups
    pay_len = nb_path // 2 if paired else spot_len
    assert (bx_spot - 1) * per_block < max(spot_len, 1)
    assert (bx_pay - 1) * per_block < max(pay_len, 1)


# --------------------------------------------------------------------------
# the rehearsal on the CPU
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    """the C entry point of ``csrc/mc_payoff.cu`` built for the CPU against the
    stand-in runtime."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    src, n = re.subn(r"(\w+(?:<\w+>)?)<<<(.*?)>>>\(", r"cuda_stub::launch(\1, \2, ",
                     (CSRC / "mc_payoff.cu").read_text(), flags=re.S)
    assert n == 4
    out_dir = tmp_path_factory.mktemp("payoff_rehearsal")
    cpp, lib = out_dir / "mc_payoff.cpp", out_dir / "libmc_payoff.so"
    cpp.write_text(src)
    subprocess.run(["g++", "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC", "-shared",
                    "-pthread", f"-I{STUB}", f"-I{CSRC}", "-o", str(lib), str(cpp)],
                   check=True, capture_output=True, text=True, timeout=300)
    fn = ctypes.CDLL(str(lib)).mc_payoff_launch
    fn.argtypes, fn.restype = payoffs.PAYOFF_LAUNCH_ARGTYPES, ctypes.c_int
    return fn


def run_kernel(fn, x, q, ttm, forward, strikes, codes, discfactor, variable_type, antithetic,
               nb_replicates, offset=0):
    """the kernel's (prices, stds) on numpy buffers; ``offset`` elements of
    padding in front move x and q off their 16-byte alignment."""
    nb_path, nb_strikes = x.shape[0], strikes.shape[0]
    groups = nb_replicates if nb_replicates > 1 else 1
    bx_spot, bx_pay = payoffs.payoff_grid(nb_path, nb_strikes, groups, antithetic,
                                          16 // x.itemsize, TARGET_BLOCKS)
    nd, ni = payoffs.payoff_scratch_sizes(nb_strikes, groups, bx_spot, bx_pay)
    dscratch, iscratch = np.full(nd, np.nan), np.full(ni, -1, dtype=np.int64)
    prices, stds = np.full(nb_strikes, -1.0), np.full(nb_strikes, -1.0)
    sample = groups if groups > 1 else (nb_path // 2 if antithetic else nb_path)
    host = np.array([forward, 1.0 / ttm, discfactor, 1.0 / math.sqrt(sample)])
    xb, qb = (np.concatenate([np.zeros(offset, dtype=a.dtype), a]) for a in (x, q))
    err = fn(xb.ctypes.data + offset * x.itemsize, qb.ctypes.data + offset * x.itemsize,
             int(x.dtype == np.float64), int(antithetic), int(variable_type == VariableType.Q_VAR),
             strikes.ctypes.data, codes.ctypes.data, prices.ctypes.data, stds.ctypes.data,
             dscratch.ctypes.data, iscratch.ctypes.data, nb_path, nb_strikes, groups, bx_spot,
             bx_pay, host.ctypes.data, None)
    assert err == 0
    return prices, stds


def assert_close_or_both_nan(out, ref):
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    ok = ~np.isnan(ref)
    np.testing.assert_allclose(out[ok], ref[ok], rtol=RTOL, atol=0.0)


# (case, nb_path, nb_strikes, dtype, variable_type, antithetic, replicates, inverse,
#  NaN paths, +inf paths, -inf paths, all NaN, offset)
CASES = {
    "btc_like_f32": (5_003, 13, np.float32, VariableType.LOG_RETURN, False, 0, False, 0, 0, 0,
                     False, 0),
    "f64": (5_003, 13, np.float64, VariableType.LOG_RETURN, False, 0, False, 0, 0, 0, False, 0),
    "qvar": (5_003, 13, np.float32, VariableType.Q_VAR, False, 0, True, 0, 0, 0, False, 0),
    "plain_nan_paths": (5_003, 13, np.float32, VariableType.LOG_RETURN, False, 0, False, 40, 0,
                        3, False, 0),
    "inverse_nan_inf_paths": (5_003, 13, np.float32, VariableType.LOG_RETURN, False, 0, True,
                              40, 0, 5, False, 0),
    "plus_inf_path": (4_099, 7, np.float64, VariableType.LOG_RETURN, False, 0, True, 0, 1, 0,
                      False, 0),
    "all_nan_inverse": (5_003, 13, np.float32, VariableType.LOG_RETURN, False, 0, True, 0, 0, 0,
                        True, 0),
    "all_nan_plain": (5_003, 13, np.float32, VariableType.LOG_RETURN, False, 0, False, 0, 0, 0,
                      True, 0),
    "forty_strikes": (5_003, 40, np.float32, VariableType.LOG_RETURN, False, 0, False, 0, 0, 0,
                      False, 0),
    "antithetic_unaligned": (5_002, 13, np.float64, VariableType.LOG_RETURN, True, 0, True, 20,
                             0, 0, False, 1),
    "antithetic_qvar_f32": (5_006, 9, np.float32, VariableType.Q_VAR, True, 0, False, 0, 0, 0,
                            False, 0),
    "replicates_unaligned": (5_000, 13, np.float32, VariableType.LOG_RETURN, False, 8, False, 0,
                             0, 0, False, 1),
    "replicates_inverse_f64": (5_000, 20, np.float64, VariableType.LOG_RETURN, False, 8, True,
                               30, 0, 0, False, 0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_rehearsal_matches_plain_version(launch, case):
    (nb_path, nb_strikes, dtype, variable_type, antithetic, replicates, inverse, nans, pinfs,
     minfs, all_nan, offset) = CASES[case]
    rng = np.random.default_rng(list(CASES).index(case))
    x = rng.normal(0.0, 0.4, nb_path).astype(dtype)
    q = rng.uniform(0.1, 0.6, nb_path).astype(dtype)
    for count, value in ((nans, np.nan), (pinfs, np.inf), (minfs, -np.inf)):
        x[rng.choice(nb_path, count, replace=False)] = value
    if all_nan:
        x[:] = np.nan
    strikes = (np.linspace(0.05, 1.0, nb_strikes) if variable_type == VariableType.Q_VAR
               else np.linspace(60.0, 150.0, nb_strikes))
    codes = (rng.integers(0, 2, nb_strikes) | (2 if inverse else 0)).astype(np.int8)
    args = (0.37, 100.0, strikes, codes, 0.97, variable_type, antithetic, replicates)
    prices, stds = run_kernel(launch, x, q, *args, offset=offset)
    ref = payoffs.mc_vars_payoff(torch.as_tensor(x), torch.as_tensor(q), 0.37, 100.0,
                                 torch.as_tensor(strikes), torch.as_tensor(codes),
                                 discfactor=0.97, variable_type=variable_type,
                                 antithetic=antithetic, nb_replicates=replicates)
    assert_close_or_both_nan(prices, ref[0].numpy())
    assert_close_or_both_nan(stds, ref[1].numpy())
