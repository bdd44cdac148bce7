"""Probe: does nvJPEG decode the frame fixture as libjpeg does?

The frame loader (``native/``) needs a JPEG decoder on a machine without
libjpeg, and its output is held to the JAX package's libjpeg loader. This
probe decodes every committed fixture frame (``data/fixtures/frames``,
1280x720, 4:4:4) with nvJPEG from the CUDA toolkit (``nvjpeg_probe.cpp``,
built here with g++), in two modes: nvJPEG's own RGB (``rgb``), and its
stored planes through libjpeg's upsampling and colour conversion
(``planes``). Against the built-in decoder, which gives libjpeg's pixels
(tests/test_torch_port_harness.py holds it bit for bit to the JAX
package's loader), it prints the histogram of the decoded values'
differences at full size, and the largest difference on the committed
reference window at 128x80 against the JAX package's output beside it,
with the loader's bound of one 8-bit step there (1/127.5).

    python -m svd_xtend_tpu_torch.scripts.probe_nvjpeg
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

from svd_xtend_tpu_torch import native
from svd_xtend_tpu_torch.data import make_fixtures as fx
from svd_xtend_tpu_torch.scripts import card

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "nvjpeg_probe.cpp")
MODES = {"rgb": 0, "planes": 1}


def build(out_dir: str) -> ctypes.CDLL:
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    so = os.path.join(out_dir, "libnvjpeg_probe.so")
    subprocess.run(["g++", *native.GXX_FLAGS, f"-I{cuda}/include", "-o", so, SRC,
                    f"-L{cuda}/lib64", f"-Wl,-rpath,{cuda}/lib64", "-lnvjpeg", "-lcudart",
                    "-pthread"], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    lib.probe_decode_resize.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int, ctypes.POINTER(ctypes.c_float)]
    return lib


def decode(lib, path: str, mode: int, w: int, h: int) -> np.ndarray:
    out = np.empty((h, w, 3), np.float32)
    err = lib.probe_decode_resize(path.encode(), mode, w, h,
                                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if err:
        raise RuntimeError(f"nvJPEG probe: error {err} on {path}")
    return out


def main() -> None:
    print(card())
    frames = sorted(os.path.join(fx.FRAMES, v, f) for v in os.listdir(fx.FRAMES)
                    for f in os.listdir(os.path.join(fx.FRAMES, v)))
    ref = np.load(fx.REFERENCE)
    native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=native.BUILD_DIR) as tmp:
        lib = build(tmp)
        for name, mode in MODES.items():
            diffs = []
            for path in frames:
                want = native.load_clip([path], fx.WIDTH, fx.HEIGHT, decoder="builtin")[0]
                got = decode(lib, path, mode, fx.WIDTH, fx.HEIGHT)
                diffs.append(np.rint((got - want) * 127.5).astype(np.int64).ravel())
            values, counts = np.unique(np.concatenate(diffs), return_counts=True)
            window = np.stack([decode(lib, p, mode, fx.REF_WIDTH, fx.REF_HEIGHT)
                               for p in fx.reference_paths()])
            err = float(np.abs(window - ref).max())
            print(f"nvJPEG {name}: {len(frames)} frames of {fx.WIDTH}x{fx.HEIGHT}, decoded value "
                  f"minus libjpeg's: {dict(zip(values.tolist(), counts.tolist()))}; the "
                  f"reference window at {fx.REF_WIDTH}x{fx.REF_HEIGHT}: max abs error "
                  f"{err:.6g} against the JAX package's output (bound {1 / 127.5:.6g})")


if __name__ == "__main__":
    main()
