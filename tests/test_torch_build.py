"""The kernel build's cache key (svd_xtend_tpu_torch/ops/kernels/_build.py):
the shared library's name is a hash of the nvcc flags, the CUDA sources and
the headers they include, so an edit to any of them rebuilds instead of
reusing a stale library. Runs on the CPU: it hashes files and compiles
nothing."""

import shutil

import pytest

from svd_xtend_tpu_torch.ops.kernels import _build


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


@pytest.mark.parametrize("pattern", ["*.cu", "*.cuh"])
def test_editing_a_source_or_header_changes_the_library(csrc_copy, pattern):
    before = _build.library_path()
    assert before == _build.library_path()
    path = sorted(csrc_copy.glob(pattern))[0]
    path.write_bytes(path.read_bytes() + b"\n// edited\n")
    assert _build.library_path() != before


def test_a_new_header_changes_the_library(csrc_copy):
    before = _build.library_path()
    (csrc_copy / "extra.cuh").write_text("#pragma once\n")
    assert _build.library_path() != before


def test_other_files_leave_the_library(csrc_copy):
    before = _build.library_path()
    (csrc_copy / "notes.txt").write_text("not a source\n")
    assert _build.library_path() == before


def test_other_flags_change_the_library(monkeypatch):
    before = _build.library_path()
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.library_path() != before
