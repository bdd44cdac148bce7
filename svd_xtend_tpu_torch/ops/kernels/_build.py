"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source compiles in its own ``nvcc`` process, all started together, and
one more ``nvcc`` links the objects into one shared library with a plain C
interface, loaded with ctypes. The build runs at first use, into
``svd_xtend_tpu_torch/_build/``, and is keyed by a hash of the nvcc flags,
the sources and the headers they include (csrc/*.cuh), so a fresh checkout
builds everything on its first kernel launch, an edit to any of them
rebuilds, and an unchanged tree reuses the library. A failed build raises.
The library needs no -lcuda: the TMA kernels take the driver's
``cuTensorMapEncodeTiled`` and ``cuTensorMapEncodeIm2col`` through the
runtime's entry-point query (csrc/sm90.cuh, csrc/sm90_gemm.cuh).

The kernels keep their products' operands and accumulators in registers by
design (the frame attention's P and O, the wgmma accumulators of the GEMM
and flash mainloops); ptxas is asked to warn of spills (``-warn-spills``),
and any ptxas warning fails the build, so a spill, or a wgmma that ptxas
serialises, no longer slows or (next to wgmma) breaks a kernel unseen.
Every source builds without one.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_ROOT = Path(__file__).resolve().parents[2]
CSRC = PACKAGE_ROOT / "csrc"
BUILD_DIR = PACKAGE_ROOT / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# each source's compile adds these; a warning of ptxas fails the build
PTXAS_FLAGS = ("-Xptxas", "-warn-spills")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name -> argtypes of every exported C function (each returns a cudaError_t)
_SIGNATURES = {
    "svdx_flash_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "svdx_flash_attention_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "svdx_flash_attention_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                                     _P],
    "svdx_ln_geglu_residual": [_P] * 11 + [_I] * 7 + [_P],
    "svdx_frame_attention_fwd": [_P, _P, _P, _P] + [_I] * 7 + [_F, _P],
    "svdx_temporal_resnet_conv": [_P] * 12 + [_I] * 8 + [_P],
    "svdx_group_norm_fold": [_P] * 7 + [_I] * 4 + [_F, _P],
    "svdx_group_norm_silu": [_P] * 8 + [_I] * 7 + [_F, _P],
    "svdx_affine_silu": [_P] * 4 + [_I] * 3 + [_P],
    "svdx_conv3x3": [_P] * 10 + [_I] * 10 + [_P],
    "svdx_flash_variant_fwd": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    "svdx_chain_bf16": [_P, _P, _P, _P, _I, _I, _I, _F, _P],
    "svdx_chain_int8_qd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "svdx_sm90_selftest": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "svdx_sm90_gemm_selftest": [_P, _P, _P, _I, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def ptxas_warnings(output: str) -> list:
    """The warning lines of a compile's output (with PTXAS_FLAGS, registers
    spilled to local memory are one)."""
    return [line.strip() for line in output.splitlines() if "warning" in line.lower()]


def library_path() -> Path:
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *PTXAS_FLAGS)).encode())
    for p in sorted([*_sources(), *CSRC.glob("*.cuh")]):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libsvdx_kernels_{h.hexdigest()[:16]}.so"


def _run(procs, warnings_fail: bool = True) -> None:
    """Wait for every nvcc process; raise with the output of those that
    failed or, with warnings_fail, warned."""
    failed = []
    for name, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} ({proc.returncode}):\n{err}")
        elif warnings_fail and ptxas_warnings(f"{out}\n{err}"):
            failed.append(f"{name} warned:\n" + "\n".join(ptxas_warnings(f"{out}\n{err}")))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))


def build() -> None:
    """Compile the sources unless the library for this tree exists."""
    so = library_path()
    if so.exists():
        return
    work = BUILD_DIR / f"{so.stem}.{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    objs, procs = [], []
    for src in _sources():
        obj = work / f"{src.stem}.o"
        objs.append(str(obj))
        procs.append((src.name, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, *PTXAS_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    _run(procs)
    tmp = work / so.name
    _run([("link", subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *objs],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))], warnings_fail=False)
    os.replace(tmp, so)
    shutil.rmtree(work, ignore_errors=True)


@functools.cache
def library() -> ctypes.CDLL:
    build()
    lib = ctypes.CDLL(str(library_path()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
