"""
Device mesh: the LogSV Monte Carlo, the LM sweeps and the swaption cube on
several GPUs.

PyTorch counterpart of ``stochvolmodels_tpu/parallel/mesh.py``.  A
:class:`PathMesh` is a 1-D tuple of devices with one axis, ``"paths"``.
The work it splits has no cross-device terms: MC paths are i.i.d., the
chains of a sweep are independent fits and the slices of a swaption cube
price independently.  So each device runs its part as an independent
program (the hand-written kernel, or its own captured CUDA graph), every
device is launched before any result is read back, and the results are
gathered on the mesh's first device, where the reductions (payoff means,
the LM's normal equations) run.

The mesh covers the JAX package's explicit entry points: the path-sharded
kernel MC (:func:`simulate_logsv_terminal_kernel_sharded`), ``mesh=`` of the
two LM sweeps (``parallel/sweep.py``) and ``mesh=`` of the swaption cube
pricers and the cube LM (``models/factor_hjm``).  JAX also shards arbitrary
array code by annotation (``jit`` with a ``NamedSharding``); torch has no
counterpart of that, and the port does not emulate it.

A device may appear more than once, so that the shard logic runs on one
card or on the CPU (tests pass ``devices=["cpu"] * 8``).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from stochvolmodels_torch.ops.cuda_mc import LANES, simulate_logsv_terminal_kernel

PATH_AXIS = "paths"
# shard i of the path-sharded MC runs at seed + SEED_STRIDE * i, as the JAX package's does
SEED_STRIDE = 1_000_003


@dataclass(frozen=True)
class PathMesh:
    """a 1-D mesh: the devices in shard order, one axis named ``"paths"``."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (PATH_AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)


@dataclass(frozen=True)
class MeshSpec:
    """how a tensor lies on a mesh: dim 0 split over ``axis``, or
    replicated on every device where ``axis`` is None."""
    mesh: PathMesh
    axis: Optional[str]


def make_path_mesh(devices: Optional[Sequence] = None) -> PathMesh:
    """1-D mesh over ``devices`` (anything ``torch.device`` takes), by
    default every CUDA device; raises without a card, as there is no CPU
    fallback."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_path_mesh: no CUDA device; pass devices=[...] for a CPU mesh")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("make_path_mesh: a mesh needs at least one device")
    return PathMesh(devices)


def check_mesh(mesh) -> PathMesh:
    """``mesh``, which must be a :class:`PathMesh`; raises TypeError else."""
    if not isinstance(mesh, PathMesh):
        raise TypeError(f"mesh must be a PathMesh (make_path_mesh), got {mesh!r}")
    return mesh


def path_sharding(mesh: PathMesh) -> MeshSpec:
    """the spec that splits the leading (path) axis over the mesh."""
    return MeshSpec(mesh, PATH_AXIS)


def replicated(mesh: PathMesh) -> MeshSpec:
    """the spec of a tensor held whole on every device of the mesh."""
    return MeshSpec(mesh, None)


def shard_bounds(n: int, mesh: PathMesh) -> List[Tuple[int, int]]:
    """the [start, stop) rows of each device's contiguous part of ``n``
    rows, the first ``n % size`` parts one row longer; a part may be empty."""
    base, extra = divmod(n, mesh.size)
    bounds, start = [], 0
    for i in range(mesh.size):
        stop = start + base + (i < extra)
        bounds.append((start, stop))
        start = stop
    return bounds


def shard_paths(mesh: PathMesh, *tensors: torch.Tensor):
    """each tensor's dim 0 split into per-device parts (:func:`shard_bounds`),
    part i moved to ``mesh.devices[i]``: a tuple of parts per tensor (just
    that tuple for one tensor)."""
    out = tuple(tuple(t[a:b].to(dev) for (a, b), dev in zip(shard_bounds(t.shape[0], mesh),
                                                           mesh.devices))
                for t in tensors)
    return out if len(out) > 1 else out[0]


def round_up_paths(nb_path: int, mesh: PathMesh) -> int:
    """the path count rounded up to a multiple of the mesh size times the
    kernels' path multiple (128)."""
    m = mesh.size * LANES
    return ((nb_path + m - 1) // m) * m


def on_device(device: torch.device):
    """a context that makes ``device`` current for CUDA work (streams, graph
    captures); nothing for the CPU."""
    device = torch.device(device)
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def gather(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """the parts concatenated along dim 0 on ``device``."""
    return torch.cat([p.to(device) for p in parts])


def simulate_logsv_terminal_kernel_sharded(mesh: PathMesh,
                                           seed: int,
                                           nb_path: int,
                                           ttm: float,
                                           sigma0: float,
                                           theta: float,
                                           kappa1: float,
                                           kappa2: float,
                                           beta: float,
                                           volvol: float,
                                           vol_backbone_eta: float = 1.0,
                                           is_spot_measure: bool = True,
                                           nb_steps_per_year: int = 360
                                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """terminal (x, sigma, qvar) of ``nb_path`` LogSV paths from x = 0,
    sigma = ``sigma0``, qvar = 0, path-sharded over the mesh.

    Shard i holds ``nb_path / size`` paths and runs
    :func:`~stochvolmodels_torch.ops.cuda_mc.simulate_logsv_terminal_kernel`
    on its own device at seed ``seed + 1_000_003 i``: one launch of the
    hand-written kernel (``csrc/logsv_mc.cu``) on a card, the plain version
    on the CPU.  Every shard is launched before any is read back; the three
    terminal tensors are gathered on ``mesh.devices[0]``, shard after shard,
    where the payoff reductions (``compute_mc_vars_payoff``) take them.
    ``nb_path`` must be a multiple of the mesh size times 128
    (:func:`round_up_paths`).
    """
    if nb_path <= 0 or nb_path % (mesh.size * LANES):
        raise ValueError(f"nb_path must be a positive multiple of mesh size * {LANES} = "
                         f"{mesh.size * LANES}, got {nb_path}")
    local = nb_path // mesh.size
    kwargs = dict(ttm=ttm, theta=theta, kappa1=kappa1, kappa2=kappa2, beta=beta, volvol=volvol,
                  vol_backbone_eta=vol_backbone_eta, is_spot_measure=is_spot_measure,
                  nb_steps_per_year=nb_steps_per_year)
    shards = []
    for i, dev in enumerate(mesh.devices):
        with on_device(dev):
            x0 = torch.zeros(local, dtype=torch.float32, device=dev)
            s0 = torch.full((local,), float(sigma0), dtype=torch.float32, device=dev)
            q0 = torch.zeros(local, dtype=torch.float32, device=dev)
            shards.append(simulate_logsv_terminal_kernel(int(seed) + SEED_STRIDE * i, x0, s0, q0,
                                                         **kwargs))
    first = mesh.devices[0]
    return tuple(gather([s[k] for s in shards], first) for k in range(3))


# the JAX package's name of the same entry point
simulate_logsv_terminal_pallas_sharded = simulate_logsv_terminal_kernel_sharded
