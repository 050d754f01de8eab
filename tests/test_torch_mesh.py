"""The device mesh of the PyTorch port (``parallel/mesh.py``), on the CPU.

* On an 8-device CPU mesh (one device listed eight times), the
  path-sharded LogSV MC equals the concatenation of eight plain-version
  calls at the offset seeds ``seed + 1_000_003 i``, bit for bit: shard i
  is exactly that call, gathered in order on the first device.
* Its moments (mean of x, sigma and qvar) match the JAX package's
  ``simulate_logsv_terminal_pallas_sharded`` on the 8-device virtual mesh
  that ``tests/conftest.py`` forces, run in interpret mode at
  ``tests/test_parallel.py``'s size (8 x 128 x 16 paths, ttm 0.5, 120
  steps/yr), within 4 combined stderr: the two draw from different streams
  (the port's counter hash against the interpret kernel's PRNG), so
  agreement is statistical.
* ``round_up_paths``, ``shard_bounds`` and ``shard_paths`` give the right
  shapes and devices; ``make_path_mesh()`` raises without a card; the
  specs name their axis.
"""
import jax
import numpy as np
import pytest
import torch
from _torch_port import svt  # noqa: F401

from stochvolmodels_tpu.models.logsv.pricer import LOGSV_BTC_PARAMS as PP
from stochvolmodels_tpu.parallel.mesh import make_path_mesh as jax_make_path_mesh
from stochvolmodels_tpu.parallel.mesh import simulate_logsv_terminal_pallas_sharded as jax_sharded
from stochvolmodels_torch.ops.cuda_mc import simulate_logsv_terminal_torch
from stochvolmodels_torch.parallel import mesh as tmesh

ARGS = dict(ttm=0.5, theta=PP.theta, kappa1=PP.kappa1, kappa2=PP.kappa2, beta=PP.beta,
            volvol=PP.volvol, nb_steps_per_year=120)


def cpu_mesh(n):
    return tmesh.make_path_mesh(["cpu"] * n)


def test_sharded_mc_is_the_concatenation_of_the_shards_plain_calls():
    mesh = cpu_mesh(8)
    nb_path = 8 * 128 * 2
    args = dict(ARGS, ttm=0.1)
    x, sig, qvar = tmesh.simulate_logsv_terminal_kernel_sharded(mesh, seed=3, nb_path=nb_path,
                                                                sigma0=PP.sigma0, **args)
    local = nb_path // 8
    parts = []
    for i in range(8):
        x0, q0 = torch.zeros(local, dtype=torch.float32), torch.zeros(local, dtype=torch.float32)
        s0 = torch.full((local,), PP.sigma0, dtype=torch.float32)
        parts.append(simulate_logsv_terminal_torch(3 + 1_000_003 * i, x0, s0, q0, **args))
    for k, out in enumerate((x, sig, qvar)):
        assert out.shape == (nb_path,) and out.device == torch.device("cpu")
        assert torch.equal(out, torch.cat([p[k] for p in parts]))
    # the shards draw different numbers
    assert not torch.equal(parts[0][0], parts[1][0])


def test_the_pallas_sharded_name_is_the_same_function():
    assert tmesh.simulate_logsv_terminal_pallas_sharded is \
        tmesh.simulate_logsv_terminal_kernel_sharded


def test_sharded_mc_moments_match_the_jax_sharded_kernel():
    nb_path = 8 * 128 * 16
    mesh = jax_make_path_mesh()
    assert mesh.devices.size == 8
    jx = jax_sharded(mesh, seed=3, nb_path=nb_path, sigma0=PP.sigma0, **ARGS)
    tx = tmesh.simulate_logsv_terminal_kernel_sharded(cpu_mesh(8), seed=3, nb_path=nb_path,
                                                      sigma0=PP.sigma0, **ARGS)
    for j, t, name in zip(jx, tx, ("x", "sigma", "qvar")):
        j = np.asarray(j, dtype=np.float64)
        t = t.numpy().astype(np.float64)
        assert np.all(np.isfinite(j)) and np.all(np.isfinite(t)), name
        stderr = np.sqrt(j.var() / j.size + t.var() / t.size)
        assert abs(j.mean() - t.mean()) <= 4.0 * stderr, (name, j.mean(), t.mean(), stderr)


def test_sharded_mc_refuses_a_path_count_off_the_multiple():
    with pytest.raises(ValueError, match="multiple"):
        tmesh.simulate_logsv_terminal_kernel_sharded(cpu_mesh(3), seed=0, nb_path=3 * 128 + 1,
                                                     sigma0=1.0, **ARGS)


def test_round_up_paths_shard_bounds_and_shard_paths():
    mesh = cpu_mesh(3)
    assert tmesh.round_up_paths(1, mesh) == 384
    assert tmesh.round_up_paths(384, mesh) == 384
    assert tmesh.round_up_paths(4000, mesh) == 4224
    assert tmesh.round_up_paths(4000, cpu_mesh(8)) == 4096
    assert tmesh.shard_bounds(7, mesh) == [(0, 3), (3, 5), (5, 7)]
    assert tmesh.shard_bounds(2, mesh) == [(0, 1), (1, 2), (2, 2)]
    a, b = torch.arange(12.0), torch.arange(24.0).reshape(12, 2)
    pa, pb = tmesh.shard_paths(mesh, a, b)
    assert [p.shape for p in pa] == [(4,), (4,), (4,)]
    assert [p.shape for p in pb] == [(4, 2), (4, 2), (4, 2)]
    assert torch.equal(torch.cat(pb), b) and all(p.device == torch.device("cpu") for p in pa)
    single = tmesh.shard_paths(mesh, torch.arange(5.0))
    assert [p.shape[0] for p in single] == [2, 2, 1]


def test_make_path_mesh_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_path_mesh()
    with pytest.raises(ValueError):
        tmesh.make_path_mesh([])


def test_mesh_and_specs():
    mesh = tmesh.make_path_mesh(["cpu", "cpu"])
    assert mesh.size == 2 and mesh.axis_names == (tmesh.PATH_AXIS,) == ("paths",)
    assert mesh.devices == (torch.device("cpu"),) * 2
    assert tmesh.path_sharding(mesh).axis == "paths" and tmesh.replicated(mesh).axis is None
    assert tmesh.path_sharding(mesh).mesh is mesh
    # the JAX package's mesh, for comparison: one axis of the same name
    assert jax_make_path_mesh(jax.devices()[:2]).axis_names == mesh.axis_names
