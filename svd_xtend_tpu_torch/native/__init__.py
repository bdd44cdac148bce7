"""ctypes bindings for the port's native frame loader (frame_loader.cpp).

The port's copy of ``svd_xtend_tpu/native/__init__.py``. The library builds
at first use with the JAX package's g++ flags, into
``svd_xtend_tpu_torch/_build/native/`` (never beside the source), named by a
hash of the source and the flags, so an edit rebuilds. Two builds of the one
source:
  - ``libjpeg``: the JAX package's, where g++ finds ``jpeglib.h`` and
    ``libjpeg``;
  - ``builtin``: the source's own baseline decoder (libjpeg's integer IDCT,
    upsampling and colour conversion), for a machine without libjpeg; it
    takes baseline 8-bit single-scan JPEGs and gives None for others, as a
    failed decode does.
The first that compiles is used. Where neither does, ``library()`` raises
with the compilers' messages: unlike the JAX package, the port does not
quietly take the PIL path when the library is missing (``use_native=False``
is the way there). ctypes releases the GIL for the call, so loader threads
decode in parallel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_SRC = Path(__file__).resolve().parent / "frame_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build" / "native"
# the JAX package's flags (svd_xtend_tpu/native/__init__.py::_build)
GXX_FLAGS = ("-O3", "-march=native", "-funroll-loops", "-fPIC", "-shared")
DECODERS = ("libjpeg", "builtin")


def _flags(decoder: str):
    """(flags before the source, libraries after it) of a build."""
    if decoder == "libjpeg":
        return (), ("-ljpeg", "-pthread")
    return ("-DSVDX_BUILTIN_JPEG",), ("-pthread",)


def _path(decoder: str, pre, post) -> Path:
    h = hashlib.sha256(" ".join((*GXX_FLAGS, *pre, *post)).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libframe_loader_{decoder}_{h.hexdigest()[:16]}.so"


def _compile(out: Path, pre, post) -> Optional[str]:
    """Build `out`; None on success, else the compiler's message."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}")
    cmd = ["g++", *GXX_FLAGS, *pre, "-o", str(tmp), str(_SRC), *post]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{' '.join(cmd)}: {e}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"{' '.join(cmd)}:\n{proc.stderr.strip()}"
    os.replace(tmp, out)
    return None


@functools.cache
def library(decoder: Optional[str] = None) -> ctypes.CDLL:
    """The built library, building it on first use: the first of DECODERS
    that builds, or the one named (the tests hold each against the JAX
    package's loader). Raises RuntimeError with the compilers' messages
    when none builds or loads."""
    if shutil.which("g++") is None:
        raise RuntimeError("native frame loader: no g++ on PATH")
    errors = []
    for name in ((decoder,) if decoder else DECODERS):
        pre, post = _flags(name)
        so = _path(name, pre, post)
        if not so.exists():
            err = _compile(so, pre, post)
            if err is not None:
                errors.append(f"[{name}] {err}")
                continue
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            errors.append(f"[{name}] {so}: {e}")
            continue
        lib.fl_load_clip.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_float)]
        lib.fl_load_clip.restype = ctypes.c_int
        lib.fl_version.restype = ctypes.c_char_p
        return lib
    raise RuntimeError("native frame loader: no decoder builds or loads "
                       "(use_native=False takes the PIL path):\n" + "\n".join(errors))


def version() -> str:
    return library().fl_version().decode()


def decoder() -> str:
    """'libjpeg' or 'builtin': the decode the built library runs."""
    return "builtin" if "builtin" in version() else "libjpeg"


def load_clip(paths: Sequence[str], width: int, height: int, num_threads: int = 8,
              decoder: Optional[str] = None) -> Optional[np.ndarray]:
    """Decode JPEG frames concurrently -> (N, height, width, 3) float32 in
    [-1, 1] (HWC, bilinear resize), through library(decoder). None if any
    frame fails to decode, as in the JAX package; raises if the library
    does not build."""
    lib = library(decoder)
    n = len(paths)
    out = np.empty((n, height, width, 3), dtype=np.float32)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    ok = lib.fl_load_clip(arr, n, width, height, num_threads,
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out if ok == n else None
