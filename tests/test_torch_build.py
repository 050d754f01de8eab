"""The build key of the hand-written CUDA kernels (``ops/_build.py``).

A cached library is keyed on ``source_digest(name)``: the ``.cu`` file, every
``csrc/*.cuh`` header and the nvcc flags.  These tests run on a copy of
``csrc/`` and need no nvcc.
"""
import shutil
from pathlib import Path

import pytest

from stochvolmodels_torch.ops import _build

KERNELS = ("logsv_mc", "heston_mc", "rough_mc", "hawkes_mc", "logsv_variants")


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, copy)
    monkeypatch.setattr(_build, "CSRC_DIR", copy)
    return copy


def test_every_kernel_source_and_the_shared_header_are_in_the_package():
    assert (_build.CSRC_DIR / "counter_rng.cuh").is_file()
    for name in KERNELS:
        src = (_build.CSRC_DIR / f"{name}.cu").read_text()
        assert '#include "counter_rng.cuh"' in src
        assert f'extern "C" int {name}_launch(' in src


@pytest.mark.parametrize("name", KERNELS)
def test_digest_changes_when_a_header_changes(csrc_copy, name):
    before = _build.source_digest(name)
    assert _build.source_digest(name) == before
    header = csrc_copy / "counter_rng.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    assert _build.source_digest(name) != before


@pytest.mark.parametrize("name", KERNELS)
def test_digest_changes_with_a_new_header_the_source_and_the_flags(csrc_copy, monkeypatch, name):
    before = _build.source_digest(name)
    (csrc_copy / "extra.cuh").write_text("#pragma once\n")
    with_header = _build.source_digest(name)
    assert with_header != before
    src = csrc_copy / f"{name}.cu"
    src.write_text(src.read_text() + "\n")
    with_source = _build.source_digest(name)
    assert with_source != with_header
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.source_digest(name) != with_source


def test_each_kernel_has_its_own_digest():
    assert len({_build.source_digest(name) for name in KERNELS}) == len(KERNELS)


def test_build_without_nvcc_raises(csrc_copy, tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("this machine has the CUDA toolkit")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library("heston_mc")
