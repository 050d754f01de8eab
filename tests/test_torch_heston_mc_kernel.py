"""The Heston Monte-Carlo kernel's plain PyTorch version against the JAX
package's Pallas kernel, and the CUDA kernel against the plain version.

(a) path by path against ``simulate_heston_terminal_pallas(interpret=True)``
    at 2^16 paths (two TPU blocks) and ttm 0.25 (91 steps), from random
    starting states.  Both draw the same counter-hash stream; what differs
    is XLA's FMA contraction on the CPU.  Measured, for the BTC-like and the
    equity-like parameters: median relative gap 6.0e-8 to 3.1e-7 in var and
    qvar and median absolute gap in x at most 6e-8; max absolute gap in x
    2.3e-5, max relative gap 2.9e-3 in var (a path near the 1e-4 floor) and
    7.3e-5 in qvar.  Limits: medians 1e-6, maxima 1e-4 (x), 1e-2 (var) and
    1e-3 (qvar);
(b) moments of the plain version at 2^15 paths, ttm 1, within the
    tolerances of ``tests/test_pallas_mc.py``;
(c) the wrapper refuses CPU, float64 and misaligned input, and the
    dispatch sends CPU tensors to the plain version without a launch;
(d) on a CUDA device only: the kernel against the plain version, path by
    path, as chip_smoke.py holds it (it skips here: the kernel has no CPU mode;
    tests/test_torch_kernel_rehearsal.py runs its source on the CPU).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import cuda_device  # noqa: F401  (fixture)

from stochvolmodels_tpu.ops import pallas_mc
from stochvolmodels_torch.ops import cuda_mc

PARAMS = {
    "btc_like": dict(theta=1.0, kappa=2.0, rho=0.3, volvol=2.0),
    "equity_like": dict(theta=0.04, kappa=4.0, rho=-0.5, volvol=0.4),
}
V0_RANGE = {"btc_like": (0.3, 1.2), "equity_like": (0.01, 0.09)}


def random_state(name, n, seed=11):
    rng = np.random.default_rng(seed)
    return (rng.normal(0.0, 0.05, n).astype(np.float32),
            rng.uniform(*V0_RANGE[name], n).astype(np.float32),
            rng.uniform(0.0, 0.05, n).astype(np.float32))


def path_gaps(name, n=1 << 16, ttm=0.25):
    """(x abs, var rel, qvar rel) gaps of the plain version against the
    interpret-mode Pallas kernel, path by path."""
    x0, v0, q0 = random_state(name, n)
    kw = dict(PARAMS[name], ttm=ttm)
    xj, vj, qj = map(np.asarray, pallas_mc.simulate_heston_terminal_pallas(
        seed=7, x0=jnp.asarray(x0), var0=jnp.asarray(v0), qvar0=jnp.asarray(q0),
        interpret=True, **kw))
    xt, vt, qt = (t.numpy() for t in cuda_mc.simulate_heston_terminal_torch(
        7, torch.as_tensor(x0), torch.as_tensor(v0), torch.as_tensor(q0), **kw))
    return np.abs(xt - xj), np.abs(vt - vj) / vj, np.abs(qt - qj) / qj


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_plain_version_matches_interpret_kernel_path_by_path(name):
    x_abs, v_rel, q_rel = path_gaps(name)
    for gap in (x_abs, v_rel, q_rel):
        assert np.median(gap) <= 1e-6
    assert np.max(x_abs) <= 1e-4
    assert np.max(v_rel) <= 1e-2
    assert np.max(q_rel) <= 1e-3


def test_plain_version_moments():
    n = 1 << 15
    xt, vt, qt = (t.double().numpy() for t in cuda_mc.simulate_heston_terminal_torch(
        3, torch.zeros(n), torch.full((n,), 0.04), torch.zeros(n), ttm=1.0,
        **PARAMS["equity_like"]))
    tol = 0.005
    assert np.all(np.isfinite(xt))
    assert abs(vt.mean() - 0.04) < tol
    assert abs(np.exp(xt).mean() - 1.0) < 4.0 * tol
    assert abs(qt.mean() - 0.04) < tol
    assert vt.min() >= np.float32(1e-4)


def test_cuda_wrapper_refuses_cpu_float64_and_misaligned_input():
    n = 256
    state = (torch.zeros(n), torch.full((n,), 0.04), torch.zeros(n))
    kw = dict(PARAMS["equity_like"], ttm=0.1)
    launches = cuda_mc.simulate_heston_terminal_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_mc.simulate_heston_terminal_cuda(3, *state, **kw)
    with pytest.raises(TypeError, match="float32"):
        cuda_mc.simulate_heston_terminal_cuda(3, *(t.double() for t in state), **kw)
    with pytest.raises(ValueError, match="multiple of 128"):
        cuda_mc.simulate_heston_terminal_cuda(3, *(t[:100] for t in state), **kw)
    with pytest.raises(ValueError, match="one length"):
        cuda_mc.simulate_heston_terminal_kernel(3, state[0], state[1][:128], state[2], **kw)
    out = cuda_mc.simulate_heston_terminal_kernel(3, *state, **kw)
    ref = cuda_mc.simulate_heston_terminal_torch(3, *state, **kw)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0.0, atol=0.0)
    assert cuda_mc.simulate_heston_terminal_cuda.launches == launches


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1 << 18, (1 << 16) + 128])
@pytest.mark.parametrize("name", sorted(PARAMS))
def test_cuda_kernel_matches_plain_version(cuda_device, name, n):  # noqa: F811
    """within 1e-4 in x and 1e-5 |plain| + 1e-6 in v and qvar (the update's
    FMAs, as chip_smoke.py holds it), also with a half-empty last block of
    256 threads.  The kernel's source built for the CPU reads at these inputs
    at most 7.7e-7 in x and 2.4e-6 in v, 5.4e-7 relative beside 1e-6."""
    state = [torch.as_tensor(a, device=cuda_device) for a in random_state(name, n, seed=5)]
    kw = dict(PARAMS[name], ttm=0.25)
    launches = cuda_mc.simulate_heston_terminal_cuda.launches
    out = cuda_mc.simulate_heston_terminal_cuda(9, *state, **kw)
    torch.cuda.synchronize()
    assert cuda_mc.simulate_heston_terminal_cuda.launches == launches + 1
    ref = cuda_mc.simulate_heston_terminal_torch(9, *state, **kw)
    torch.testing.assert_close(out[0], ref[0], rtol=0.0, atol=1e-4)
    for a, b in zip(out[1:], ref[1:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
