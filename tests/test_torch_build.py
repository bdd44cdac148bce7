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


SPILL = ("ptxas warning : Registers are spilled to local memory in function "
         "'_Z6kernelv', 8 bytes spill stores, 8 bytes spill loads")
INFO = "ptxas info    : Used 55 registers, used 2 barriers\n0 bytes spill stores"


def test_ptxas_warnings_reads_spills_not_infos():
    assert _build.ptxas_warnings(INFO) == []
    assert _build.ptxas_warnings(f"{INFO}\n{SPILL}\n") == [SPILL]


class _FakeNvcc:
    """Stands in for an nvcc process: writes its -o target, reports `err`
    for sources named in `warn`, records its command."""

    commands = []
    warn = set()

    def __init__(self, cmd, **_):
        self.commands.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb") as fh:
            fh.write(b"")
        self.returncode = 0
        self.src = cmd[-1].rsplit("/", 1)[-1]

    def communicate(self):
        return "", SPILL if self.src in self.warn else INFO


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.subprocess, "Popen", _FakeNvcc)
    _FakeNvcc.commands, _FakeNvcc.warn = [], set()
    return _FakeNvcc


def test_every_compile_asks_ptxas_for_spill_warnings(fake_nvcc):
    _build.build()
    compiles = [c for c in fake_nvcc.commands if "-c" in c]
    assert len(compiles) == len(list(_build.CSRC.glob("*.cu")))
    assert all("-warn-spills" in c for c in compiles)
    assert _build.library_path().exists()


@pytest.mark.parametrize("source", ["temporal_attention.cu", "group_norm.cu", "geglu.cu"])
def test_a_spill_fails_the_build(fake_nvcc, source):
    fake_nvcc.warn = {source}
    with pytest.raises(RuntimeError, match=f"{source} warned"):
        _build.build()
    assert not _build.library_path().exists()
