"""
Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C entry point, loaded with ``ctypes``.  The build happens at first use,
from the sources in the package only, into ``_build/<hash>/`` beside the
package (listed in ``.gitignore``), keyed by a hash of the source and the
flags, so an edited source rebuilds and an unchanged one loads.  A missing
``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

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


def load_library(name: str) -> ctypes.CDLL:
    """build (if needed) and load ``csrc/<name>.cu`` as a ctypes library."""
    if name in _LIBS:
        return _LIBS[name]
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = BUILD_DIR / digest
    lib_path = out_dir / f"lib{name}.so"
    if not lib_path.is_file():
        nvcc = find_nvcc()
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp_path = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp_path), str(src)],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp_path, lib_path)
        BUILD_INFO[name] = {"seconds": time.perf_counter() - t0,
                            "log": (proc.stdout + proc.stderr).strip()}
    else:
        BUILD_INFO[name] = {}
    _LIBS[name] = ctypes.CDLL(str(lib_path))
    return _LIBS[name]
