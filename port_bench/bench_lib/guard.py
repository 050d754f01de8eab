"""
What a run may not load, and where its caches go.

The benchmark measures the PyTorch/CUDA port only: no module whose
top-level name (the part before the first dot, compared whole) is one of
``FORBIDDEN`` may be loaded in the process that prints the result.  The port
``stochvolmodels_torch`` passes, although its name begins with the JAX
package's.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "stochvolmodels_tpu", "stochvolmodels")


def forbidden_loaded(names: Iterable[str] = None) -> List[str]:
    """the loaded modules (of ``names``, default ``sys.modules``) whose
    top-level name is forbidden."""
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def pin_caches(root: Path) -> None:
    """point every compiler and kernel cache that torch may open at fixed
    directories inside the checkout, so that the first run of a cell
    builds and later runs find what it built; nothing goes to a fixed path
    outside the checkout."""
    cache = Path(root) / ".bench_cache"
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_compute_cache")):
        os.environ[var] = str(cache / sub)
