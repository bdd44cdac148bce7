"""Write the frame-folder fixture: 2 videos x 16 JPEG frames at 1280x720
(BDD100K's frame size) under ``data/fixtures/frames/``.

    python -m svd_xtend_tpu_torch.data.make_fixtures [--out DIR]

Each video is a seeded numpy pattern that moves from frame to frame: a
sky-to-road gradient with a drifting horizon, lane stripes flowing toward
the viewer and soft discs crossing the frame. JPEG quality 90, 4:4:4
chroma; the 32 frames stay under 2 MB. Needs PIL. The reference window the card
checks its decode against (``REFERENCE``) is the JAX
package's native loader's output, written by
``python tests/test_torch_port_harness.py``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
FRAMES = os.path.join(FIXTURES, "frames")
WIDTH, HEIGHT, VIDEOS, FRAMES_PER_VIDEO = 1280, 720, 2, 16
# the reference window: video_0's frames 1-14, decoded and resized to 128x80
REFERENCE = os.path.join(FIXTURES, "jax_native_window.npy")
REF_VIDEO, REF_START, REF_FRAMES, REF_WIDTH, REF_HEIGHT = 0, 1, 14, 128, 80


def reference_paths():
    """The reference window's frame files, in order."""
    folder = os.path.join(FRAMES, f"video_{REF_VIDEO}")
    names = sorted(os.listdir(folder))[REF_START:REF_START + REF_FRAMES]
    return [os.path.join(folder, f) for f in names]


def frame(seed: int, t: int, width: int = WIDTH, height: int = HEIGHT) -> np.ndarray:
    """(H, W, 3) uint8: frame t of video `seed`."""
    rs = np.random.RandomState(seed)
    sky, road = rs.uniform(60, 200, 3), rs.uniform(40, 120, 3)
    discs = rs.uniform(0, 1, (4, 6))          # x0, y0, vx, vy, radius, hue
    y = np.linspace(0.0, 1.0, height, dtype=np.float32)[:, None, None]
    x = np.linspace(0.0, 1.0, width, dtype=np.float32)[None, :, None]
    horizon = 0.45 + 0.03 * np.sin(0.4 * t + seed)
    w = np.clip((y - horizon) / 0.08 + 0.5, 0.0, 1.0)
    img = (1 - w) * (sky * (1.0 - 0.4 * y)) + w * road * (0.8 + 0.4 * x)
    below = np.clip((y - horizon) / (1.0 - horizon), 0.0, 1.0)
    for lane in (-0.6, 0.0, 0.6):
        cx = 0.5 + lane * below
        stripe = np.exp(-((x - cx) / (0.004 + 0.01 * below)) ** 2)
        dash = 0.5 + 0.5 * np.cos(2 * np.pi * (4.0 / (below + 0.15) + 0.35 * t))
        img = img + 120.0 * stripe * dash * (below > 0)
    for x0, y0, vx, vy, rad, hue in discs:
        cx, cy = (x0 + 0.02 * (vx - 0.5) * t) % 1.0, 0.2 + 0.6 * ((y0 + 0.01 * (vy - 0.5) * t) % 1.0)
        r = np.sqrt(((x - cx) * width / height) ** 2 + (y - cy) ** 2) / (0.04 + 0.08 * rad)
        colour = 255.0 * np.array([hue, 1 - hue, 0.5 + 0.5 * np.sin(6 * hue)])
        a = np.clip(1.5 - r, 0.0, 1.0)
        img = (1 - a) * img + a * colour
    return np.clip(img, 0, 255).astype(np.uint8)


def write_frame(video: int, t: int, path: str) -> None:
    from PIL import Image
    Image.fromarray(frame(video, t)).save(path, quality=90, subsampling=0)


def write(out: str = FRAMES) -> None:
    for v in range(VIDEOS):
        folder = os.path.join(out, f"video_{v}")
        os.makedirs(folder, exist_ok=True)
        for t in range(FRAMES_PER_VIDEO):
            write_frame(v, t, os.path.join(folder, f"{t:05d}.jpg"))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=FRAMES)
    write(parser.parse_args().out)
