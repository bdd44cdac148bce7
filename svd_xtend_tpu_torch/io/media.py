"""Video and GIF export.

Port of ``svd_xtend_tpu/io/media.py`` (reference train_svd.py:251-280): an
mp4 through cv2, else imageio (raising ImportError naming both where
neither imports); a GIF at 500 ms a frame by default, looping, a ``.mp4``
path renamed to ``.gif``, as validation writes them (train_svd.py:1150).

The GIF encoder is the port's own (GIF89a, LZW), so a machine without PIL
writes one too. Its palette is fixed: 6 levels of red, 7 of green and 6 of
blue (252 colours), each channel rounded to its nearest level, so a decoded
value is within half a level's step of its source: 25.5 of 255 in red and
blue, 21.25 in green (``PALETTE_ERROR``).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

_LEVELS = (6, 7, 6)
PALETTE_ERROR = tuple(255.0 / (n - 1) / 2 for n in _LEVELS)


def _to_uint8(frames: Sequence) -> List[np.ndarray]:
    out = []
    for f in frames:
        arr = np.asarray(f)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
        out.append(arr)
    return out


def export_to_video(frames: Sequence, path: str, fps: int = 7) -> str:
    """Write RGB frames to an mp4 (cv2 if present, else imageio)."""
    frames = _to_uint8(frames)
    try:
        import cv2
    except ImportError:
        try:
            import imageio
        except ImportError:
            raise ImportError("export_to_video needs cv2 or imageio; neither imports") from None
        imageio.mimwrite(path, frames, fps=fps)
        return path
    h, w, _ = frames[0].shape
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()
    return path


def _palette() -> np.ndarray:
    """(256, 3) uint8: the 252 level colours, red slowest, then black."""
    axes = [np.round(np.arange(n) * (255.0 / (n - 1))) for n in _LEVELS]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    pal = np.zeros((256, 3), np.uint8)
    pal[:len(grid)] = grid
    return pal


def _indices(frame: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> palette indices, row-major."""
    q = [np.rint(frame[..., c].astype(np.float32) * ((n - 1) / 255.0)).astype(np.int32)
         for c, n in enumerate(_LEVELS)]
    return ((q[0] * _LEVELS[1] + q[1]) * _LEVELS[2] + q[2]).astype(np.uint8).tobytes()


def _lzw(data: bytes, min_size: int = 8) -> bytes:
    """GIF's variable-width LZW, as giflib codes it: a clear code first, the
    code width grown when the next code needs it, the table cleared before
    it would reach 4095 codes, the end code last; LSB-first bit packing."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    out = bytearray()
    acc = nbits = 0
    width, nxt, table = min_size + 1, end + 1, {}

    def emit(code):
        nonlocal acc, nbits, width
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8
        if nxt >= (1 << width) and width < 12:
            width += 1

    emit(clear)
    prefix = data[0]
    for px in data[1:]:
        key = (prefix << 8) | px
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        if nxt >= 4095:
            emit(clear)
            width, nxt, table = min_size + 1, end + 1, {}
        else:
            table[key] = nxt
            nxt += 1
        prefix = px
    emit(prefix)
    emit(end)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def _blocks(data: bytes) -> bytes:
    """GIF data sub-blocks (at most 255 bytes each) and the terminator."""
    parts = bytearray()
    for i in range(0, len(data), 255):
        chunk = data[i:i + 255]
        parts.append(len(chunk))
        parts += chunk
    parts.append(0)
    return bytes(parts)


def export_to_gif(frames: Sequence, path: str, duration_ms: int = 500) -> str:
    """Write frames (uint8, or floats in [0, 1]) as a looping GIF89a with
    `duration_ms` per frame (GIF counts hundredths of a second)."""
    frames = _to_uint8(frames)
    if path.endswith(".mp4"):
        path = path[:-4] + ".gif"
    h, w = frames[0].shape[:2]
    le = lambda v: int(v).to_bytes(2, "little")
    out = bytearray(b"GIF89a" + le(w) + le(h) + bytes([0xF7, 0, 0]))
    out += _palette().tobytes()
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + le(0) + b"\x00"     # loop forever
    for f in frames:
        if f.shape[:2] != (h, w):
            raise ValueError(f"frame {f.shape[:2]} differs from the first {(h, w)}")
        out += b"\x21\xf9\x04\x00" + le(round(duration_ms / 10)) + b"\x00\x00"
        out += b"\x2c" + le(0) + le(0) + le(w) + le(h) + b"\x00"
        out += b"\x08" + _blocks(_lzw(_indices(f)))
    out += b"\x3b"
    with open(path, "wb") as fh:
        fh.write(out)
    return path
