"""What the redesigned rough and Hawkes kernels rest on, checked on the CPU.

``csrc/hawkes_mc.cu`` skips work that cannot change its result:

(a) the thinning pre-test: where lambda < ((1 - u) - PRETEST_C) * inv_dt *
    (1 - PRETEST_MARGIN) it skips the logarithm of the exact test
    lambda > -ln(u) * inv_dt.  Over all 2^23 uniforms the stream can draw,
    in the kernel's float32 arithmetic, the pre-test's bound never exceeds
    the exact threshold (so it never rules out a jump that fires, for any
    lambda), for the step sizes of the Hawkes MC grids; the polynomial ln
    keeps -ln(u) >= (1 - u) - 9.54e-7.  Checked directly on a grid of
    lambda with 0, 1e-3, the BTC theta+-, 1e4, inf and NaN (NaN always runs
    the exact test).  The constants equal the kernel's;
(b) the design's premise, from the plain version's draws at the BTC
    defaults (lambda at theta, 2^15 paths x 91 steps at 1800 steps/yr):
    measured, the jump fires in 0.00478 (+) and 0.00628 (-) of path-steps
    and in 0.142 (+) and 0.182 (-) of (32-path warp, step) pairs, so the
    lazy draws run in few warp-steps; the pre-test leaves the exact test to
    0.00480 and 0.00631 of path-steps.  Limits: warp shares under 0.3 on
    each side, path shares of the exact test under 0.01;
(c) scripts/sass_step_loops.py finds the step loop and walks its common path
    (every forward branch inside the loop taken) on a small listing, and
    reads the steps a pass of each kernel's loop holds from the constant
    its source unrolls the loop by.

The levers of ``csrc/logsv_mc.cu`` and ``csrc/heston_mc.cu`` that change no
bit of their plain versions (their FMAs do, and are held to 1e-4 on the card):

(d) the LogSV step written in torch, with sigma^2 dt carried from the qvar
    update to the next step: bit for bit the plain version over 91 steps,
    both measures;
(e) the keyed stream: the keys of streams 0 and 1 as the block's KeyRing
    holds them (filled 128 steps at a time, a row per step), hashed with a
    path's in-block index, give counter_bits for two TPU programs, at the
    ring's first and last rows of each half.
"""
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from stochvolmodels_torch.models.hawkes_jd import HawkesJDParams
from stochvolmodels_torch.ops import cuda_mc
from stochvolmodels_torch.utils.funcs import set_time_grid

ROOT = Path(__file__).resolve().parents[1]
HP = HawkesJDParams()


def all_uniforms() -> torch.Tensor:
    """every float32 uniform of uniform_from_bits, one per 23-bit mantissa."""
    return cuda_mc.uniform_from_bits(torch.arange(1 << 23, dtype=torch.int64) << 9)


def inv_dts():
    """f32(1/dt) of the Hawkes MC grids: the BTC chain's maturities at 1800
    steps/yr (chip_smoke.py's 0.05 and 0.2 among them), 720 and 360 steps/yr."""
    out = []
    for ttm in (0.0192, 0.05, 0.0833, 0.2, 0.25, 0.43, 1.0):
        for per_year in (1800, 720, 360):
            _, dt, _ = set_time_grid(ttm=ttm, nb_steps_per_year=per_year)
            out.append(float(np.float32(1.0 / dt)))
    return out


def test_pretest_constants_equal_the_kernels():
    src = (ROOT / "stochvolmodels_torch" / "csrc" / "hawkes_mc.cu").read_text()
    c = float(re.search(r"kPreC = ([0-9.e+-]+)f;", src).group(1))
    margin = float(re.search(r"kPreMargin = ([0-9.e+-]+)f;", src).group(1))
    assert (c, margin) == (cuda_mc.PRETEST_C, cuda_mc.PRETEST_MARGIN)
    assert cuda_mc.PRETEST_C >= 2e-6


def test_poly_log_lies_above_one_minus_u():
    u = all_uniforms()
    gap = (1.0 - u.double()) - (-cuda_mc.poly_log(u).double())
    assert float(gap.max()) <= 9.54e-7 < cuda_mc.PRETEST_C


@pytest.mark.parametrize("inv_dt", inv_dts())
def test_pretest_bound_never_exceeds_the_exact_threshold(inv_dt):
    """for every uniform: bound(u) <= f32(-ln(u) * inv_dt), so lambda < bound
    implies not lambda > threshold, whatever lambda is."""
    u = all_uniforms()
    threshold = -cuda_mc.poly_log(u) * inv_dt
    # the largest lambda the pre-test rules out at u is the float just below the bound
    below = torch.nextafter(cuda_mc.hawkes_pretest_bound(u, inv_dt), torch.tensor(-np.inf))
    assert not bool((below > threshold).any())


@pytest.mark.parametrize("lam", [0.0, 1e-3, HP.theta_p, HP.theta_m, 1e4, np.inf, np.nan])
def test_pretest_never_rules_out_a_firing_jump(lam):
    u = all_uniforms()
    lam_t = torch.full_like(u, lam)
    for inv_dt in inv_dts():
        fires = lam_t > -cuda_mc.poly_log(u) * inv_dt
        ruled_out = cuda_mc.hawkes_pretest_rules_out(lam_t, u, inv_dt)
        assert not bool((fires & ruled_out).any())
        if np.isnan(lam):
            assert not bool(ruled_out.any())


def test_jump_branches_are_rare_at_the_btc_defaults():
    n = 1 << 15
    kw = dict(HP.sim_params(), ttm=0.05)
    shares = cuda_mc.hawkes_branch_shares(3, torch.zeros(n), torch.full((n,), HP.lambda_p),
                                          torch.full((n,), HP.lambda_m), **kw)
    for side in "pm":
        assert shares[f"warp_jump_{side}"] < 0.3
        assert shares[f"jump_{side}"] <= shares[f"log_{side}"] < 0.01
        assert shares[f"jump_{side}"] <= shares[f"warp_jump_{side}"]
    # the minus side's intensity is higher, so it fires more
    assert shares["jump_p"] < shares["jump_m"]


def test_branch_shares_count_the_plain_versions_jumps():
    """every firing moves lambda by its load, so with no mean reversion the
    count of jumps is in the terminal intensity."""
    n = 1 << 10
    params = dict(HP.sim_params(), kappa_p=0.0, kappa_m=0.0, beta1_p=1.0, beta2_p=0.0,
                  beta1_m=0.0, beta2_m=1.0, shift_p=1.0, mean_p=0.0, shift_m=-1.0, mean_m=0.0)
    kw = dict(params, ttm=0.05)
    state = (torch.zeros(n), torch.full((n,), 20.0), torch.full((n,), 20.0))
    _, lam_p, lam_m = cuda_mc.simulate_hawkesjd_terminal_torch(5, *state, **kw)
    shares = cuda_mc.hawkes_branch_shares(5, *state, **kw)
    path_steps = n * set_time_grid(ttm=0.05, nb_steps_per_year=1800)[0]
    assert round(shares["jump_p"] * path_steps) == round(float((lam_p - 20.0).sum()))
    assert round(shares["jump_m"] * path_steps) == round(float((20.0 - lam_m).sum()))


def _sass_module():
    path = ROOT / "scripts" / "sass_step_loops.py"
    spec = importlib.util.spec_from_file_location("sass_step_loops", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


LISTING = """
        Function : _Z6kernelILi3EEvPf
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   FADD R2, R2, R3 ;
        /*0020*/              @P0  BRA 0x50 ;
        /*0030*/                   FMUL R2, R2, R2 ;
        /*0040*/                   FMUL R2, R2, R2 ;
        /*0050*/                   BSSY B0, 0x90 ;
        /*0060*/             @!P1  BRA 0x80 ;
        /*0070*/                   CALL.REL.NOINC 0xc0 ;
        /*0080*/                   BSYNC B0 ;
        /*0090*/                   FFMA R2, R2, R3, R4 ;
        /*00a0*/              @P2  BRA 0x10 ;
        /*00b0*/                   EXIT ;
        /*00c0*/                   RET.REL.NODEC R20 0x0 ;
"""


def test_sass_step_loop_and_common_path():
    sass = _sass_module()
    loops = sass.loop_lengths(LISTING)
    total, common, ops = loops["3"]
    assert total == 10                 # 0x10 .. 0xa0
    assert common == 7                 # the two FMULs and the CALL skipped
    assert ops["FMUL"] == 2 and ops["BRA"] == 3


def test_steps_per_pass_from_the_kernel_sources():
    sass = _sass_module()
    per = {name: sass.steps_per_pass(name) for name in ("logsv_mc", "heston_mc", "rough_mc",
                                                        "hawkes_mc")}
    assert per == {"logsv_mc": 2, "heston_mc": 2, "rough_mc": 1, "hawkes_mc": 1}
    for name in ("logsv_mc", "heston_mc"):   # the loop steps by the constant it is read from
        src = (ROOT / "stochvolmodels_torch" / "csrc" / f"{name}.cu").read_text()
        assert "step += kStepsPerPass" in src and "j < kStepsPerPass" in src


BTC_LOGSV = dict(theta=1.0413, kappa1=3.1844, kappa2=3.058, beta=0.1514, volvol=1.8458)


def logsv_kernel_step(seed, x0, sigma0, qvar0, ttm, is_spot_measure, vol_backbone_eta):
    """terminal (x, sigma, qvar) by csrc/logsv_mc.cu's step on tensors."""
    p = BTC_LOGSV
    nb_steps, a = cuda_mc._euler_scalars(ttm, p["theta"], p["kappa1"], p["kappa2"], p["beta"],
                                         p["volvol"], vol_backbone_eta, is_spot_measure, 360)
    f32 = np.float32
    eta2 = float(f32(a.eta) * f32(a.eta))
    half_vt2 = float(f32(0.5) * (f32(a.beta) * f32(a.beta) + f32(a.volvol) * f32(a.volvol)))
    alpha_half = float(f32(a.alpha) * f32(0.5))
    k1theta = float(f32(a.kappa1) * f32(a.theta))
    normals = cuda_mc._PathNormals(seed, x0.shape[0], x0.device)
    x, lns, qvar = x0.clone(), torch.log(sigma0), qvar0.clone()
    sigma = torch.exp(lns)
    sig2dt = ((eta2 * sigma) * sigma) * a.dt
    for step in range(nb_steps):
        z0, z1 = normals.step(step)
        w0, w1 = z0 * a.sdt, z1 * a.sdt
        x = (x + alpha_half * sig2dt) + (a.eta * sigma) * w0
        drift = ((k1theta * torch.reciprocal(sigma) - a.kappa1) + a.kappa2 * (a.theta - sigma)
                 + a.adj * sigma)
        lns = ((lns + (drift - half_vt2) * a.dt) + a.beta * w0) + a.volvol * w1
        sigma = torch.exp(lns)
        carried = ((eta2 * sigma) * sigma) * a.dt   # the next step's sigma^2 dt
        qvar = qvar + 0.5 * (sig2dt + carried)
        sig2dt = carried
    return x, sigma, qvar


@pytest.mark.parametrize("is_spot_measure", [True, False])
def test_logsv_kernel_step_equals_the_plain_version(is_spot_measure):
    n = 1 << 12
    rng = np.random.default_rng(3)
    state = [torch.as_tensor(a.astype(np.float32)) for a in
             (rng.normal(0.0, 0.1, n), rng.uniform(0.3, 2.0, n), rng.uniform(0.0, 0.1, n))]
    kw = dict(ttm=0.25, is_spot_measure=is_spot_measure,
              vol_backbone_eta=1.0 if is_spot_measure else 1.1)
    assert set_time_grid(kw["ttm"], 360)[0] == 91
    out = logsv_kernel_step(4, *state, **kw)
    ref = cuda_mc.simulate_logsv_terminal_torch(4, *state, **kw, **BTC_LOGSV)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


RING_CHUNK = 128   # steps per refill of a KeyRing<256, 2>


def ring_keys(seed_term: int, step0: int) -> dict:
    """{ring word: key} after KeyRing<256, 2>::fill(ring, seed_term, step0):
    thread t writes the key of stream t % 2 at step step0 + t // 2 into row
    (step & 255)."""
    out = {}
    for t in range(2 * RING_CHUNK):
        step, stream = step0 + t // 2, t % 2
        word = (seed_term + step * 0x7FEB352D + stream * 0x846CA68B) & 0xFFFFFFFF
        out[(step & (2 * RING_CHUNK - 1)) * 2 + stream] = int(
            cuda_mc.hash_u32(torch.tensor(word, dtype=torch.int64)))
    return out


@pytest.mark.parametrize("step", [0, 127, 128, 255])
def test_keyed_stream_equals_counter_bits(step):
    idx = torch.arange(cuda_mc.BLOCK_PATHS, dtype=torch.int64)
    seed = 11
    for program in (0, 1):
        seed_term = ((seed + program) * 0x9E3779B9) & 0xFFFFFFFF
        ring = ring_keys(seed_term, step & -RING_CHUNK)
        for stream in (0, 1):
            key = ring[(step & (2 * RING_CHUNK - 1)) * 2 + stream]
            keyed = cuda_mc.hash_u32(idx ^ key)
            ref = cuda_mc.counter_bits(torch.tensor(seed + program), step, stream, idx)
            assert torch.equal(keyed, ref)
