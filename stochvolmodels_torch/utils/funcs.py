"""
Shared numerical utilities: time grids, timing, ragged-array padding.

PyTorch-package counterpart of ``stochvolmodels_tpu/utils/funcs.py``.  Where
the JAX package returns a pandas Series, the port returns a
:class:`SeriesLike` (the port imports no pandas).
"""
from __future__ import annotations

import functools
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np


def to_flat_np_array(input_list: Sequence[np.ndarray]) -> np.ndarray:
    """concatenate a list of per-maturity arrays into one flat numpy array."""
    return np.concatenate([np.asarray(a) for a in input_list]).ravel()


def set_time_grid(ttm: float, nb_steps_per_year: int = 360) -> Tuple[int, float, np.ndarray]:
    """simulation time grid for one maturity.

    ``nb_steps = int(ttm * nb_steps_per_year) + 1`` and ``grid_t`` has
    ``nb_steps + 1`` points spanning [0, ttm]; ``dt`` is the first spacing of
    that linspace, exactly as the JAX package computes it.
    """
    nb_steps = int(ttm * nb_steps_per_year) + 1
    grid_t = np.linspace(0.0, ttm, nb_steps + 1)
    dt = float(grid_t[1] - grid_t[0])
    return nb_steps, dt, grid_t


def set_seed(value: int) -> None:
    """seed numpy's global RNG (the reference's seeding; the fixed-randoms
    pricers draw their blocks from it, the eager engines take ``seed=``)."""
    np.random.seed(value)


def timer(func):
    """decorator printing the wall-clock runtime of the wrapped call."""
    @functools.wraps(func)
    def wrapper_timer(*args, **kwargs):
        start_time = time.perf_counter()
        value = func(*args, **kwargs)
        end_time = time.perf_counter()
        print(f"Finished {func.__name__!r} in {end_time - start_time:.4f} secs")
        return value
    return wrapper_timer


def update_kwargs(kwargs: Dict[Any, Any],
                  new_kwargs: Optional[Dict[Any, Any]]
                  ) -> Dict[Any, Any]:
    """merge two kwargs dicts without mutating the first."""
    local_kwargs = kwargs.copy()
    if new_kwargs:
        local_kwargs.update(new_kwargs)
    return local_kwargs


def compute_histogram_data(data: np.ndarray,
                           x_grid: np.ndarray,
                           name: str = 'Histogram'
                           ) -> "SeriesLike":
    """histogram of simulated values on a fixed grid, as frequencies indexed
    by the bin edges (the first entry is ``x_grid[0]`` over the count, as in
    the reference)."""
    hist_data, bin_edges = np.histogram(a=np.asarray(data), bins=len(x_grid) - 1,
                                        range=(x_grid[0], x_grid[-1]))
    hist_data = np.append(np.array(x_grid[0]), hist_data)
    hist_data = hist_data / len(data)
    return SeriesLike(values=hist_data, index=bin_edges, name=name)


def find_nearest(a: np.ndarray,
                 value: float,
                 is_sorted: bool = True,
                 is_equal_or_largest: bool = False
                 ) -> float:
    """element of ``a`` closest to ``value`` (binary search when sorted)."""
    a = np.asarray(a)
    if is_sorted:
        idx = np.searchsorted(a, value, side="left")
        if is_equal_or_largest:
            return a[min(idx, len(a) - 1)]
        if idx > 0 and (idx == len(a) or np.abs(value - a[idx - 1]) < np.abs(value - a[idx])):
            return a[idx - 1]
        return a[idx]
    idx = int(np.abs(a - value).argmin())
    return a[idx]


def npad(arrays: Sequence[np.ndarray], pad_value: float = np.nan) -> Tuple[np.ndarray, np.ndarray]:
    """pad a ragged list of 1-D arrays into a dense (n, max_len) array + bool mask."""
    n = len(arrays)
    k = max((len(np.asarray(a)) for a in arrays), default=0)
    out = np.full((n, k), pad_value, dtype=np.result_type(*(np.asarray(a).dtype for a in arrays)))
    mask = np.zeros((n, k), dtype=bool)
    for i, a in enumerate(arrays):
        a = np.asarray(a)
        out[i, :len(a)] = a
        mask[i, :len(a)] = True
    return out, mask


def unpad(dense: np.ndarray, mask: np.ndarray) -> list:
    """inverse of :func:`npad`: recover the ragged list of 1-D numpy arrays."""
    dense = np.asarray(dense)
    mask = np.asarray(mask)
    return [dense[i][mask[i]] for i in range(dense.shape[0])]


@dataclass
class SeriesLike:
    """values indexed by maturity, read as a pandas Series is read
    (``.index``, ``.to_numpy()``), without pandas: what the port returns
    where the JAX package returns a ``pd.Series``."""
    values: np.ndarray
    index: np.ndarray
    name: Optional[str] = None

    def __post_init__(self):
        self.values = np.asarray(self.values, dtype=float)
        self.index = np.asarray(self.index, dtype=float)

    def to_numpy(self) -> np.ndarray:
        return self.values

    def __len__(self) -> int:
        return len(self.values)
