"""
Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C entry point, loaded with ``ctypes``.  The build happens at first use,
from the sources in the package only, into ``_build/<digest>/`` beside the
package (listed in ``.gitignore``).  The digest (:func:`source_digest`) covers
the ``.cu`` file, every ``csrc/*.cuh`` header it may include and the flags,
so an edited source or header rebuilds and an unchanged one loads.  A
missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

# -fmad=false: no contraction of a*b+c into one FMA, so that a kernel rounds
# as its plain PyTorch version (one rounding per tensor op) does
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# per kernel source: {"seconds": build wall-clock, "log": nvcc/ptxas output};
# empty for a library that was found already built
BUILD_INFO: Dict[str, dict] = {}


def find_nvcc() -> str:
    """path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def source_digest(name: str) -> str:
    """build key of ``csrc/<name>.cu``: its bytes, the name and bytes of every
    ``csrc/*.cuh`` header, and the nvcc flags."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / source_digest(name) / f"lib{name}.so"


def _start_build(name: str, nvcc: str, lib_path: Path) -> Tuple[subprocess.Popen, Path, float]:
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    tmp_path = lib_path.with_name(f"lib{name}.{os.getpid()}.tmp.so")
    proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp_path), str(CSRC_DIR / f"{name}.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp_path, time.perf_counter()


def _finish_build(name: str, job: Tuple[subprocess.Popen, Path, float], lib_path: Path) -> str:
    """wait for one nvcc; returns its failure message, or "" once the library
    is in place."""
    proc, tmp_path, t0 = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        return f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}"
    os.replace(tmp_path, lib_path)
    BUILD_INFO[name] = {"seconds": time.perf_counter() - t0, "log": log.strip()}
    return ""


def load_libraries(names: Iterable[str]) -> Dict[str, ctypes.CDLL]:
    """build every library of ``names`` that is not built yet, one nvcc per
    source, all started together, then load them all.  Every nvcc is waited
    for before a failure raises."""
    names = list(names)
    paths = {name: _lib_path(name) for name in names if name not in _LIBS}
    missing = [name for name, path in paths.items() if not path.is_file()]
    jobs = {}
    if missing:
        nvcc = find_nvcc()
        jobs = {name: _start_build(name, nvcc, paths[name]) for name in missing}
    failures = [msg for msg in (_finish_build(name, job, paths[name])
                                for name, job in jobs.items()) if msg]
    if failures:
        raise RuntimeError("\n".join(failures))
    for name, path in paths.items():
        BUILD_INFO.setdefault(name, {})
        _LIBS[name] = ctypes.CDLL(str(path))
    return {name: _LIBS[name] for name in names}


def load_library(name: str) -> ctypes.CDLL:
    """build (if needed) and load ``csrc/<name>.cu`` as a ctypes library."""
    return load_libraries([name])[name]
