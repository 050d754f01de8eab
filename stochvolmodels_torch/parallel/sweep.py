"""
Calibration sweeps: the Levenberg-Marquardt fits of many option chains at
once, over a device mesh.

PyTorch counterpart of ``stochvolmodels_tpu/parallel/sweep.py``.  The chains
are independent, so the sweep is one program: the single-chain LM run of
LogSV (``models/logsv/fast_calibration._lm_run``) or of Heston
(``models/heston._heston_lm_run``), batched over a stacked chain axis with
``torch.func.vmap``, in chunks of at most ``SWEEP_CHUNK`` chains.  On a CUDA
device the whole batched fit of a chunk is one CUDA graph per (chunk size,
panel shape, maturities, ``nb_iters``, solver configuration, device),
captured at its first call; inside ``graphs.eager()`` it runs eagerly, with
the same bits.

The batch axis is split over ``mesh`` (``parallel/mesh.py``; by default every
CUDA device, or the one device the caller names): the batch is padded to a
multiple of the mesh size by repeating the last chain (the padding is
dropped on return), each device fits its contiguous part through its own
graphs, every device is launched before any result is read back, and the
fits are gathered on the first device.

All chains in a sweep share the maturity and strike layout (the same ttms
and padded panel shape), the natural shape of a calibration time series of
one underlying; :func:`pad_chains_to_sweep` groups arbitrary chains.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from stochvolmodels_torch.data.option_chain import OptionChain
from stochvolmodels_torch.models.heston import (
    HESTON_BOUNDS,
    HestonParams,
    _calibration_targets,
    _heston_lm_run,
)
from stochvolmodels_torch.models.logsv.fast_calibration import (
    LOWER,
    UPPER,
    _bounds_vector,
    _chain_targets,
    _fit_params,
    _lm_run,
)
from stochvolmodels_torch.models.logsv.params import LogSvParams
from stochvolmodels_torch.models.logsv.pricer import ConstraintsType
from stochvolmodels_torch.ops import graphs
from stochvolmodels_torch.parallel.mesh import (
    PathMesh,
    check_mesh,
    gather,
    make_path_mesh,
    on_device,
)

HESTON_LOWER = np.array([b[0] for b in HESTON_BOUNDS])
HESTON_UPPER = np.array([b[1] for b in HESTON_BOUNDS])
# the most chains one batched program takes.  On an H100 (NVIDIA H100 80GB
# HBM3, 700 W) the captured 1,000-chain LogSV fit of 16 iterations at 360
# RK4 steps/yr failed on its replay (CUDA error: misaligned address), where
# 512 chains captured and 1,000 chains eagerly, or at 2 iterations, ran; so
# a larger sweep runs in chunks of this size, the last one padded with
# copies of its last chain (dropped on return), one graph for them all.
SWEEP_CHUNK = 512


def _sweep_mesh(mesh: Optional[PathMesh], device) -> PathMesh:
    """``mesh``, or by default every CUDA device for ``device="cuda"`` and
    the one device named otherwise (``"cpu"``, ``"cuda:1"``)."""
    if mesh is not None:
        return check_mesh(mesh)
    device = torch.device(device)
    return make_path_mesh() if device.type == "cuda" and device.index is None \
        else make_path_mesh([device])


def _check_sweep(option_chains, params0, params_type):
    """(the chains, one start point a chain, the shared maturities)."""
    chains = list(option_chains)
    ttms0 = tuple(float(t) for t in chains[0].ttms) if chains else ()
    for c in chains[1:]:
        if tuple(float(t) for t in c.ttms) != ttms0:
            raise ValueError("all chains in a sweep must share ttms; "
                             "use pad_chains_to_sweep to group by layout")
    if isinstance(params0, params_type):
        params0 = [params0] * len(chains)
    elif len(params0) != len(chains):
        raise ValueError(f"params0 has {len(params0)} entries for {len(chains)} chains")
    return chains, list(params0), ttms0


def _run_chunks(name: str, vmapped, batched: Sequence[torch.Tensor], lower: torch.Tensor,
                upper: torch.Tensor, key) -> Tuple[torch.Tensor, torch.Tensor]:
    """``vmapped`` over the rows of ``batched`` (on one device), in chunks of
    at most SWEEP_CHUNK chains, the last padded with copies of its last
    chain; one captured graph per chunk size and ``key`` on a card."""
    n = batched[0].shape[0]
    size = min(n, SWEEP_CHUNK)
    best, cost = [], []
    for start in range(0, n, size):
        part = [x[start:start + size] for x in batched]
        pad = size - part[0].shape[0]
        if pad:
            part = [torch.cat([x, x[-1:].expand(pad, *x.shape[1:])]) for x in part]
        inputs = tuple(part) + (lower, upper)
        if graphs.use_graph(inputs[0]):
            out = graphs.run_captured(name, (size,) + key + (str(inputs[0].device),), vmapped,
                                      inputs)
        else:
            out = vmapped(*inputs)
        best.append(out[0])
        cost.append(out[1])
    return torch.cat(best)[:n], torch.cat(cost)[:n]


def _run_batched(name: str, run, batched: Sequence[torch.Tensor], lower: torch.Tensor,
                 upper: torch.Tensor, key, mesh: PathMesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """``run(p0, ttms, forwards, discfactors, strikes, optioncodes, mask,
    market, sqrtw, lower, upper, vol_scaler)`` vmapped over the leading axis
    of ``batched`` (all but the bounds): the batch padded to a multiple of
    the mesh size with copies of its last chain, each device's contiguous
    part run by :func:`_run_chunks` on that device, all launched before the
    results are gathered on the first device."""
    vmapped = torch.func.vmap(
        lambda p0, ttms, fwd, disc, strikes, codes, mask, market, sqrtw, vs, lo, hi:
        run(p0, ttms, fwd, disc, strikes, codes, mask, market, sqrtw, lo, hi, vs),
        in_dims=(0,) * len(batched) + (None, None))
    n = batched[0].shape[0]
    pad = (-n) % mesh.size
    if pad:
        batched = [torch.cat([x, x[-1:].expand(pad, *x.shape[1:])]) for x in batched]
    per = (n + pad) // mesh.size
    outs = []
    for i, dev in enumerate(mesh.devices):
        with on_device(dev):
            outs.append(_run_chunks(name, vmapped, [x[i * per:(i + 1) * per].to(dev)
                                                    for x in batched],
                                    lower.to(dev), upper.to(dev), key))
    first = mesh.devices[0]
    return (gather([b for b, _ in outs], first)[:n], gather([c for _, c in outs], first)[:n])


def _stack_grids(grids, markets, sqrtws):
    """the chains' panels stacked on a leading batch axis, in ``_lm_run``'s
    argument order (ttms .. mask, market, sqrtw)."""
    fields = ("ttms", "forwards", "discfactors", "strikes", "optioncodes", "mask")
    return ([torch.stack([getattr(g, f) for g in grids]) for f in fields]
            + [torch.stack(markets), torch.stack(sqrtws)])


def calibrate_logsv_lm_sweep(option_chains: Sequence[OptionChain],
                             params0: LogSvParams | Sequence[LogSvParams],
                             constraints_type: ConstraintsType = ConstraintsType.UNCONSTRAINT,
                             nb_iters: int = 16,
                             year_steps: int = 360,
                             use_float32: Optional[bool] = None,
                             is_vega_weighted: bool = True,
                             params_min: Optional[LogSvParams] = None,
                             params_max: Optional[LogSvParams] = None,
                             mesh=None,
                             device="cuda",
                             ) -> List[Tuple[LogSvParams, float]]:
    """the PARAMS5 LM fit of every chain in one batched program; returns
    [(params, cost)], each what ``calibrate_logsv_lm_on_device`` gives for
    its chain alone.

    Chains must share ``ttms`` and the padded (n_ttm, max_strikes) layout.
    The single-chain LM run is vmapped over the chain axis, in chunks of at
    most SWEEP_CHUNK (512) chains; on a CUDA device the whole fit of a chunk
    is one CUDA graph per (chunk size, panel shape, ttms, ``nb_iters``,
    ``year_steps``, constraints type, device), captured at its first call.
    The batch splits over ``mesh`` (default: every CUDA device for
    ``device="cuda"``, else the one device named); ``use_float32`` is
    accepted for signature parity and mapped to float64.
    """
    del use_float32
    chains, params0, ttms0 = _check_sweep(option_chains, params0, LogSvParams)
    if not chains:
        return []
    mesh = _sweep_mesh(mesh, device)
    device = mesh.devices[0]
    f64 = dict(dtype=torch.float64, device=device)
    grids, markets, sqrtws, p0s, scalers = [], [], [], [], []
    for chain, par0 in zip(chains, params0):
        vol_scaler, grid, market, weights = _chain_targets(chain, is_vega_weighted, device)
        grids.append(grid)
        markets.append(torch.as_tensor(market, **f64))
        sqrtws.append(torch.as_tensor(np.sqrt(weights), **f64))
        p0s.append([par0.sigma0, par0.theta, par0.kappa1, par0.beta, par0.volvol])
        scalers.append(vol_scaler)
    batched = ([torch.as_tensor(np.asarray(p0s, dtype=np.float64), **f64)]
               + _stack_grids(grids, markets, sqrtws)
               + [torch.as_tensor(np.asarray(scalers, dtype=np.float64), **f64)])
    static = dict(ttms_static=ttms0, year_steps=int(year_steps), nb_iters=int(nb_iters),
                  constraints_type=constraints_type)
    key = (tuple(grids[0].strikes.shape), ttms0, static["nb_iters"], static["year_steps"],
           constraints_type)
    best, cost = _run_batched("logsv_lm_sweep", lambda *a: _lm_run(*a, **static), batched,
                              torch.as_tensor(_bounds_vector(params_min, LOWER), **f64),
                              torch.as_tensor(_bounds_vector(params_max, UPPER), **f64), key,
                              mesh)
    return [(_fit_params(b), float(c)) for b, c in zip(best.cpu(), cost.cpu().numpy())]


def pad_chains_to_sweep(option_chains: Sequence[OptionChain]):
    """group chains by (ttms, panel shape) into sweep-compatible buckets of
    (index, chain) pairs, in first-seen order."""
    buckets = {}
    for idx, c in enumerate(option_chains):
        key = (tuple(float(t) for t in c.ttms), (len(c.ttms), max(len(k) for k in c.strikes_ttms)))
        buckets.setdefault(key, []).append((idx, c))
    return list(buckets.values())


def calibrate_heston_lm_sweep(option_chains: Sequence[OptionChain],
                              params0,
                              nb_iters: int = 16,
                              use_float32: Optional[bool] = None,
                              is_vega_weighted: bool = True,
                              mesh=None,
                              device="cuda",
                              ) -> List[Tuple[HestonParams, float]]:
    """Heston counterpart of :func:`calibrate_logsv_lm_sweep`: every chain's
    (v0, theta, kappa, rho, volvol) LM fit in one batched program, each
    what ``calibrate_heston_lm`` gives for its chain alone; the transform
    grid of each chain frozen at min(0.3, sqrt(v0 ttm0)) of its start point.
    ``params0`` is one HestonParams or a list; the batch splits over
    ``mesh`` as in :func:`calibrate_logsv_lm_sweep`."""
    del use_float32
    chains, params0, ttms0 = _check_sweep(option_chains, params0, HestonParams)
    if not chains:
        return []
    mesh = _sweep_mesh(mesh, device)
    device = mesh.devices[0]
    f64 = dict(dtype=torch.float64, device=device)
    grids, markets, sqrtws, p0s, scalers = [], [], [], [], []
    for chain, par0 in zip(chains, params0):
        p0 = par0.to_array()
        grid, market, weights, vol_scaler = _calibration_targets(chain, p0, is_vega_weighted,
                                                                 False, device)
        grids.append(grid)
        markets.append(market)
        sqrtws.append(torch.sqrt(weights))
        p0s.append(p0)
        scalers.append(vol_scaler)
    batched = ([torch.as_tensor(np.asarray(p0s, dtype=np.float64), **f64)]
               + _stack_grids(grids, markets, sqrtws)
               + [torch.as_tensor(np.asarray(scalers, dtype=np.float64), **f64)])
    static = dict(ttms_static=ttms0, nb_iters=int(nb_iters))
    key = (tuple(grids[0].strikes.shape), ttms0, static["nb_iters"])
    best, cost = _run_batched("heston_lm_sweep", lambda *a: _heston_lm_run(*a, **static),
                              batched, torch.as_tensor(HESTON_LOWER, **f64),
                              torch.as_tensor(HESTON_UPPER, **f64), key, mesh)
    out = []
    for b, c in zip(best.cpu().numpy().astype(np.float64), cost.cpu().numpy()):
        v0, theta, kappa, rho, volvol = b
        out.append((HestonParams(v0=v0, theta=theta, kappa=kappa, rho=rho, volvol=volvol),
                    float(c)))
    return out
