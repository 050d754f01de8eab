"""
The benchmark's frozen yardstick: the card's published peaks, the work of
an MC chain call counted from its shapes, and the roofline arithmetic.

Peaks: NVIDIA H100 SXM5 data sheet, dense, at the 700 W limit: 67 TFLOP/s
float32 and 34 TFLOP/s float64 outside the tensor cores, 3.35 TB/s HBM3.

Operations per path-step of an MC path loop (float32, 32-bit integer) are
the model's: each adapter ``models/<model>.py`` freezes its own count as
``OPS_PER_STEP``, which stays frozen whatever implements the loop, so that a
roofline share compares the same work before and after a change.

Bytes of a path loop: its float32 state (x, sigma or v, qvar) read and
written once a launch, 24 bytes a path.  Payoff work per slice, float64:
4 operations a path (exp, scale, and the recentring's sum and shift) and 6
a path and strike (difference, max, the mean's sum, and the two-pass
deviation's difference, square and sum).
"""
from __future__ import annotations

import subprocess
from typing import Dict, Sequence

import numpy as np

from reference.mc import time_grid

PEAK_F32_OPS = 67e12
PEAK_F64_OPS = 34e12
PEAK_BYTES = 3.35e12
STATE_BYTES_PER_PATH = 24
PAYOFF_OPS_PER_PATH = 4
PAYOFF_OPS_PER_PATH_STRIKE = 6
LANES = 128


def mc_chain_work(ops_per_step: Sequence[int], ttms: Sequence[float],
                  nb_strikes: Sequence[int], nb_path: int, year_steps: int) -> Dict[str, float]:
    """the work of one MC chain call: path loop operations (``ops_per_step``,
    the model's frozen count a path-step) and bytes, and float64 payoff
    operations."""
    nb_pad = ((nb_path + LANES - 1) // LANES) * LANES
    gaps = np.diff(np.concatenate([[0.0], np.asarray(ttms, dtype=np.float64)]))
    path_steps = nb_pad * sum(time_grid(float(dtau), year_steps)[0] for dtau in gaps)
    payoff_ops = sum(nb_path * (PAYOFF_OPS_PER_PATH + PAYOFF_OPS_PER_PATH_STRIKE * k)
                     for k in nb_strikes)
    return dict(path_steps=float(path_steps),
                path_ops=float(path_steps * sum(ops_per_step)),
                path_bytes=float(STATE_BYTES_PER_PATH * nb_pad * len(ttms)),
                payoff_ops=float(payoff_ops))


def path_loop_least_s(work: Dict[str, float]) -> float:
    """the least time the card could take for one call's path loops: the
    larger of its operations over the float32 peak and its bytes over HBM."""
    return max(work["path_ops"] / PEAK_F32_OPS, work["path_bytes"] / PEAK_BYTES)


def chain_call_least_s(work: Dict[str, float]) -> float:
    """the least time of a whole MC chain call at peak: the path loops and
    the float64 payoff operations."""
    return path_loop_least_s(work) + work["payoff_ops"] / PEAK_F64_OPS


def share_percent(least_s: float, measured_s: float):
    """100 least / measured, or None where nothing was measured."""
    if not measured_s or measured_s <= 0.0 or not np.isfinite(measured_s):
        return None
    return 100.0 * least_s / measured_s


def smi_name_and_power() -> str:
    """the card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f"nvidia-smi unavailable ({type(exc).__name__})"
