"""
Randomized quasi-Monte Carlo: Sobol low-discrepancy normals generated on the
device inside the time loop.

PyTorch counterpart of ``stochvolmodels_tpu/ops/qmc.py``.  The direction
numbers are scipy's Joe-Kuo table (``scipy.stats.qmc.Sobol``, 32 bits); path
i is Sobol point i (gray-code order) and one Sobol *column* (all paths, one
dimension) is the XOR of the direction numbers selected by the bits of the
gray codes.  Step t of a simulation consumes dimensions (2t, 2t+1) after the
slice's two stratified totals, and chained maturities continue the
dimension count (``dim_offset``).

Sobol words are held in int64 tensors masked to 32 bits: ``torch.uint32``
has too few operations.  A column is built from a (P, 32) panel of the gray
bits, made once per chain: ``where(bits, v_row, 0)`` and an XOR fold of the
32 words in halves (32 -> 16 -> ... -> 1), a handful of kernels instead of
a 32-term select chain.  The words map to uniforms as the JAX package maps
them, ``(acc + 1/2) 2^-32`` in float64, so equal words give equal bits.

Randomization is a digital shift per dimension (XOR with a 32-bit word), and
per replicate with ``nb_replicates``.  The shift words come from a CPU
``torch.Generator`` seeded with the integer seed: one row of words per
dimension, drawn in order, so any slice of the dimension axis sees the same
words as one long run.  These are different numbers from the JAX package's
threefry shifts; a test feeds both packages the same shift words.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

SOBOL_BITS = 32
_MAX_DIMS = 21201  # scipy's Joe-Kuo direction-number table limit
_MASK32 = (1 << 32) - 1

_dir_lock = threading.Lock()
_dir_cache: Optional[np.ndarray] = None  # (cached_dims, 32) uint32


def sobol_direction_numbers(dims: int) -> np.ndarray:
    """(dims, 32) uint32 Joe-Kuo direction numbers, cached on the host.

    Row d column b is v_b^(d) scaled to 32 bits, so point i of dimension d
    is XOR over the set bits b of gray(i) of v_b^(d), over 2^32.
    """
    if dims > _MAX_DIMS:
        raise ValueError(f"Sobol direction numbers available up to {_MAX_DIMS} dims, "
                         f"requested {dims}")
    global _dir_cache
    with _dir_lock:
        if _dir_cache is None or _dir_cache.shape[0] < dims:
            from scipy.stats import qmc
            n = max(dims, 64)
            eng = qmc.Sobol(d=n, scramble=False, bits=SOBOL_BITS)
            _dir_cache = np.asarray(eng._sv, dtype=np.uint32).reshape(n, SOBOL_BITS)
        return _dir_cache[:dims]


def direction_rows(dim_lo: int, dim_hi: int, device="cuda") -> torch.Tensor:
    """(dim_hi - dim_lo, 32) int64 direction numbers of dims [dim_lo, dim_hi)."""
    v = sobol_direction_numbers(dim_hi)[dim_lo:].astype(np.int64)
    return torch.as_tensor(v, device=device)


def gray_codes(nb_points: int, nb_replicates: int = 0, device="cuda") -> torch.Tensor:
    """int64 gray codes of the point indices; with ``nb_replicates`` R, path p
    is point ``p % (n / R)`` of replicate ``p // (n / R)``."""
    idx = torch.arange(nb_points, dtype=torch.int64, device=device)
    if nb_replicates:
        per = nb_points // nb_replicates
        if per * nb_replicates != nb_points:
            raise ValueError(f"nb_points={nb_points} not divisible by "
                             f"nb_replicates={nb_replicates}")
        idx = idx % per
    return idx ^ (idx >> 1)


def gray_bits(gray: torch.Tensor) -> torch.Tensor:
    """(P, 32) bool panel: bit b of each gray code."""
    bits = torch.arange(SOBOL_BITS, dtype=torch.int64, device=gray.device)
    return ((gray[:, None] >> bits) & 1) != 0


def dimension_shifts(seed: int, dim_lo: int, dim_hi: int, nb_replicates: int = 0,
                     device="cuda") -> torch.Tensor:
    """digital-shift words (int64 in [0, 2^32)) of dims [dim_lo, dim_hi):
    shape (dims,), or (dims, R) with ``nb_replicates`` R.  Row d is the d-th
    row of words drawn from a CPU generator seeded with ``seed``, so slices
    of the dimension axis are consistent."""
    gen = torch.Generator()
    gen.manual_seed(int(seed))
    width = max(int(nb_replicates), 1)
    words = torch.randint(0, 1 << 32, (dim_hi, width), generator=gen, dtype=torch.int64)
    words = words[dim_lo:]
    return (words if nb_replicates else words[:, 0]).to(device)


def _to_unit(acc: torch.Tensor, dtype) -> torch.Tensor:
    """32-bit Sobol words -> (0, 1) uniforms: cell midpoints (acc + 1/2) 2^-32
    in float64; in float32 scaled directly and clamped inside (0, 1)."""
    if dtype == torch.float64:
        return (acc.to(torch.float64) + 0.5) * 2.0 ** -32
    u = acc.to(torch.float32) * np.float32(2.0 ** -32)
    return torch.clamp(u, float(np.float32(2.0 ** -33)), float(np.float32(1.0 - 2.0 ** -24)))


def sobol_words(bits: torch.Tensor, v_row: torch.Tensor, shift) -> torch.Tensor:
    """one column of shifted Sobol words: XOR over the bits of each path's
    gray code of the (32,) direction numbers ``v_row``, XOR ``shift`` (a
    word, or a (P,) tensor of words)."""
    acc = torch.where(bits, v_row, torch.zeros((), dtype=torch.int64, device=bits.device))
    width = SOBOL_BITS
    while width > 1:
        width //= 2
        acc = acc[:, :width] ^ acc[:, width:2 * width]
    return (acc[:, 0] ^ shift) & _MASK32


def sobol_column(bits: torch.Tensor, v_row: torch.Tensor, shift, dtype=torch.float64
                 ) -> torch.Tensor:
    """one randomized Sobol column as uniforms for every path."""
    return _to_unit(sobol_words(bits, v_row, shift), dtype)


def sobol_uniforms(nb_points: int, dims: int, seed: Optional[int] = None, dim_offset: int = 0,
                   dtype=torch.float64, device="cuda") -> torch.Tensor:
    """(nb_points, dims) randomized-Sobol uniform panel; ``seed=None`` gives
    the raw sequence (no shift)."""
    bits = gray_bits(gray_codes(nb_points, device=device))
    v = direction_rows(dim_offset, dim_offset + dims, device=device)
    if seed is None:
        shifts = torch.zeros(dims, dtype=torch.int64, device=device)
    else:
        shifts = dimension_shifts(seed, dim_offset, dim_offset + dims, device=device)
    return torch.stack([sobol_column(bits, v[d], shifts[d], dtype) for d in range(dims)], dim=1)


def sobol_normals(nb_points: int, dims: int, seed: Optional[int] = None, dim_offset: int = 0,
                  dtype=torch.float64, device="cuda") -> torch.Tensor:
    """(nb_points, dims) standard normals by the inverse CDF of the uniforms."""
    return torch.special.ndtri(sobol_uniforms(nb_points, dims, seed=seed, dim_offset=dim_offset,
                                              dtype=dtype, device=device))


def qmc_step_normals(bits: torch.Tensor, v_step: torch.Tensor, shift_step: torch.Tensor,
                     dtype=torch.float64) -> Tuple[torch.Tensor, ...]:
    """the k normals of one step: ``v_step`` (k, 32) direction rows and
    ``shift_step`` (k,) words, or (k, P) per-path words for replicates."""
    return tuple(torch.special.ndtri(sobol_column(bits, v_step[j], shift_step[j], dtype))
                 for j in range(v_step.shape[0]))


def qmc_scan_panels(seed: int, nb_steps: int, per_step: int = 2, dim_offset: int = 0,
                    nb_replicates: int = 0, device="cuda"
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(v_tot, shift_tot, v_steps, shifts) of one slice, int64 tensors.

    The slice consumes dims [dim_offset, dim_offset + per_step (nb_steps+1)):
    the first ``per_step`` drive each stream's total (``v_tot`` (per_step,
    32), ``shift_tot`` (per_step,)), the rest the steps (``v_steps``
    (nb_steps, per_step, 32), ``shifts`` (nb_steps, per_step)).  With
    ``nb_replicates`` R the shift panels take a trailing (R,) axis.
    """
    lo, hi = dim_offset, dim_offset + per_step * (nb_steps + 1)
    v = direction_rows(lo, hi, device=device)
    shifts = dimension_shifts(seed, lo, hi, nb_replicates=nb_replicates, device=device)
    tail = (nb_replicates,) if nb_replicates else ()
    return (v[:per_step], shifts[:per_step],
            v[per_step:].reshape(nb_steps, per_step, SOBOL_BITS),
            shifts[per_step:].reshape((nb_steps, per_step) + tail))


def qmc_dims_per_slice(nb_steps: int, per_step: int = 2) -> int:
    """dimensions a chained slice consumes (totals and per-step draws)."""
    return per_step * (nb_steps + 1)


def expand_replicate_shifts(shift: torch.Tensor, nb_path: int, nb_replicates: int
                            ) -> torch.Tensor:
    """(..., R) replicate shift words as (..., P) per-path words: contiguous
    groups of P/R paths share a replicate's word."""
    if not nb_replicates:
        return shift
    return torch.repeat_interleave(shift, nb_path // nb_replicates, dim=-1)


def stratified_increment_shift(total_z: torch.Tensor, raw_sum: torch.Tensor,
                               nb_steps: int) -> torch.Tensor:
    """per-path constant c with z'_t = z_t + c iid N(0, 1) increments whose
    sum is sqrt(nb_steps) total_z (the level-0 Brownian bridge)."""
    n = float(nb_steps)
    return total_z * float(np.sqrt(1.0 / n)) - raw_sum * (1.0 / n)


def qmc_normal_blocks(seed: int, nb_path: int, nb_steps_list, dtype=torch.float64,
                      device="cuda") -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """materialized Sobol normal blocks with stratified totals, one
    ``(W0 (steps, paths), W1 (steps, paths))`` pair per slice, in the scan
    engine's dimension layout (slices chain one sequence)."""
    blocks, dim_offset = [], 0
    for n in nb_steps_list:
        n = int(n)
        z = sobol_normals(nb_path, 2 * (n + 1), seed=seed, dim_offset=dim_offset, dtype=dtype,
                          device=device)
        t0, t1 = z[:, 0], z[:, 1]
        z0 = z[:, 2::2].T
        z1 = z[:, 3::2].T
        c0 = stratified_increment_shift(t0, torch.sum(z0, dim=0), n)
        c1 = stratified_increment_shift(t1, torch.sum(z1, dim=0), n)
        blocks.append((z0 + c0[None, :], z1 + c1[None, :]))
        dim_offset += qmc_dims_per_slice(n)
    return blocks
