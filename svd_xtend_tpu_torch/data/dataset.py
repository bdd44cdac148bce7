"""Frame-folder video dataset with deterministic, shardable sampling.

Port of ``svd_xtend_tpu/data/dataset.py`` (the reference's DummyDataset,
train_svd.py:70-136; layout README.md:30-39): base_folder/<video>/<frame>,
a random video, a random contiguous window of `sample_frames`, resized to
(W, H), pixels in [-1, 1]; an error if a video has fewer frames than the
window; virtual length `num_samples`.

The same semantics as the JAX package:
  - a sample is a pure function of (seed, step, position) through the same
    numpy SeedSequence, so the loader's only state is the integer step and
    a resume is exact;
  - each process loads its slice of the global batch;
  - a window of JPEGs decodes through the native loader (``native/``, a
    bilinear resize) when `use_native`, anything else through PIL bicubic;
  - a thread pool decodes, a producer thread prefetches.
One difference: where `use_native` is set and the window is all JPEG, a
native library that does not build or load raises (with the compiler's
message) instead of switching to PIL. A frame the library cannot decode
takes the PIL path, as in the JAX package, with a warning. The loader
threads touch no torch state: batches are numpy arrays. Tracklet2Video box
annotations (``max_boxes > 0``, ``load_boxes_window``) are not ported
(ROADMAP A9).
"""

from __future__ import annotations

import concurrent.futures as cf
import logging
import os
import queue
import threading
import time
from typing import Iterator, List, Tuple

import numpy as np

_log = logging.getLogger("svd_xtend_tpu_torch")
_JPEG = (".jpg", ".jpeg")


class FrameFolderDataset:
    def __init__(self, base_folder: str, width: int = 512, height: int = 320,
                 sample_frames: int = 14, num_samples: int = 100_000,
                 use_native: bool = True, max_boxes: int = 0):
        if max_boxes > 0:
            raise ValueError("not ported yet: max_boxes > 0 (Tracklet2Video box "
                             "annotations, ROADMAP A9)")
        self.base_folder = base_folder
        self.width, self.height = width, height
        self.sample_frames = sample_frames
        self.num_samples = num_samples
        self.use_native = use_native
        self.videos: List[Tuple[str, List[str]]] = []
        img_exts = (".jpg", ".jpeg", ".png", ".bmp", ".webp")
        for name in sorted(os.listdir(base_folder)):
            folder = os.path.join(base_folder, name)
            if not os.path.isdir(folder):
                continue
            frames = sorted(f for f in os.listdir(folder)
                            if f.lower().endswith(img_exts))
            if len(frames) < sample_frames:
                raise ValueError(
                    f"video folder {name!r} has {len(frames)} < "
                    f"{sample_frames} frames")
            self.videos.append((folder, frames))
        if not self.videos:
            raise ValueError(f"no video folders under {base_folder!r}")
        self.decoder = "PIL bicubic"
        if use_native:
            from .. import native
            self.decoder = f"native {native.decoder()} + bilinear (PIL bicubic for non-JPEG)"
        _log.info("frame folder %s: %d videos, decoder %s", base_folder, len(self.videos),
                  self.decoder)

    def __len__(self) -> int:
        return self.num_samples

    def sample_spec(self, seed: int, step: int, position: int) -> Tuple[int, int]:
        """(video_index, start_frame) — pure function of its arguments."""
        rng = np.random.default_rng(np.random.SeedSequence([seed, step, position]))
        vid = int(rng.integers(len(self.videos)))
        n = len(self.videos[vid][1])
        start = int(rng.integers(n - self.sample_frames + 1))
        return vid, start

    def load_window(self, vid: int, start: int) -> np.ndarray:
        """(F, H, W, 3) float32 in [-1, 1]."""
        folder, frames = self.videos[vid]
        window = frames[start:start + self.sample_frames]
        if self.use_native and all(f.lower().endswith(_JPEG) for f in window):
            from .. import native
            clip = native.load_clip([os.path.join(folder, f) for f in window],
                                    self.width, self.height)
            if clip is not None:
                return clip
            _log.warning("native decode failed in %s[%d:%d]; PIL decodes it", folder, start,
                         start + self.sample_frames)
        from PIL import Image
        out = np.empty((self.sample_frames, self.height, self.width, 3), np.float32)
        for i, fname in enumerate(window):
            with Image.open(os.path.join(folder, fname)) as img:
                img = img.convert("RGB").resize((self.width, self.height),
                                                Image.Resampling.BICUBIC)
                out[i] = np.asarray(img, np.float32) / 127.5 - 1.0
        return out

    def get(self, seed: int, step: int, position: int) -> np.ndarray:
        vid, start = self.sample_spec(seed, step, position)
        return self.load_window(vid, start)


class ShardedLoader:
    """Deterministic prefetching loader over a FrameFolderDataset.

    Yields (B_local, F, H, W, 3) float32 batches; global batch position p of
    step s maps to dataset.get(seed, s, p) with this process owning
    positions [process_index * B_local, (process_index + 1) * B_local).
    `batch_seconds` holds the producer's host seconds per batch and
    `wait_seconds` the time each ``next()`` blocked its caller.
    """

    def __init__(self, dataset: FrameFolderDataset, local_batch_size: int,
                 seed: int = 0, start_step: int = 0, num_workers: int = 8,
                 process_index: int = 0, process_count: int = 1,
                 prefetch: int = 2):
        self.ds = dataset
        self.local_bs = local_batch_size
        self.seed = seed
        self.step = start_step
        self.offset = process_index * local_batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.batch_seconds: List[float] = []
        self.wait_seconds: List[float] = []
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _make_batch(self, step: int, pool: cf.ThreadPoolExecutor) -> np.ndarray:
        futs = [pool.submit(self.ds.get, self.seed, step, self.offset + i)
                for i in range(self.local_bs)]
        return np.stack([f.result() for f in futs])

    def _producer(self):
        step = self.step
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            while not self._stop.is_set():
                t0 = time.perf_counter()
                try:
                    batch = self._make_batch(step, pool)
                except Exception as e:       # handed to the consumer's next()
                    batch = e
                self.batch_seconds.append(time.perf_counter() - t0)
                while not self._stop.is_set():
                    try:
                        self._q.put((step, batch), timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if isinstance(batch, Exception):
                    return
                step += 1

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        t0 = time.perf_counter()
        step, batch = self._q.get()
        self.wait_seconds.append(time.perf_counter() - t0)
        if isinstance(batch, Exception):
            raise batch
        self.step = step + 1          # checkpointable iterator state
        return batch

    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def close(self):
        self._stop.set()
        self._thread.join()
