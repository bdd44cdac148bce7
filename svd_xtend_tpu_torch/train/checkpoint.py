"""Resume checkpoints, and finetunes and LoRA adapters in the reference's
file formats.

Port of ``svd_xtend_tpu/train/checkpoint.py``:
  - ``checkpoint-{step}/`` directories under output_dir, each with
    ``state/`` (the train state), ``config.json`` (the TrainConfig) and
    ``data_state.json`` (the loader's step and seed); rotation keeps the
    newest ``checkpoints_total_limit`` complete ones (train_svd.py:
    1064-1086); a resume takes a path or 'latest' (:902-909).
  - The state is a torch file of CPU tensors (``TrainState.state_dict``:
    the step, f32 masters or adapter, EMA, optimizer state), written into
    ``state.tmp/`` and renamed to ``state/`` when complete. The rename
    stands in for Orbax's finalize: a directory without ``state/`` is
    incomplete, and neither 'latest' nor the rotation counts it.
  - Saves are asynchronous by default, as the JAX package's (Orbax's):
    ``save`` fences the previous save, snapshots the state to host memory
    and returns; a writer thread writes the file, renames it into place and
    rotates. On the card the snapshot is device-to-host copies into pinned
    buffers (kept for the next save) on a side stream: the training stream
    waits on their event before its next in-place update, the host does
    not. ``blocking=True`` (the final and the preemption saves) and
    ``wait()`` wait for the writer; an exception in the writer is raised
    again by the next ``save``, ``wait`` or ``restore``.
  - The diffusers-format exports (:132-155): the UNet as ``save_pretrained``
    writes it (train_svd.py:698-706), without the Tracklet2Video branch,
    and a LoRA adapter as ``save_lora_weights`` does
    (train_svd_lora.py:1070-1074), safetensors with ``{"format": "pt"}``;
    the branch alone as ``tracklet_weights.safetensors`` in the JAX
    package's flax paths and layouts (its cli.py:406-415).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Mapping, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn

from ..core.config import TrainConfig
from ..io.convert import is_branch_key, lora_state_dict, tracklet_branch_to_flat
from ..io.safetensors_io import save_file
from ..models.lora import Adapter

CKPT_PREFIX = "checkpoint-"
STATE_FILE = "train_state.pt"
TRACKLET_FILE = "tracklet_weights.safetensors"


def _ckpt_steps(output_dir: str, complete_only: bool = False):
    """Checkpoint step numbers under output_dir; complete_only skips the
    directories whose ``state/`` has not been renamed into place (a save
    cut short) — resume-from-latest must never pick those."""
    if not os.path.isdir(output_dir):
        return []
    steps = []
    for name in os.listdir(output_dir):
        m = re.fullmatch(rf"{CKPT_PREFIX}(\d+)", name)
        if not m:
            continue
        if complete_only and not os.path.isdir(os.path.join(output_dir, name, "state")):
            continue
        steps.append(int(m.group(1)))
    return sorted(steps)


def latest_checkpoint(output_dir: str) -> Optional[str]:
    steps = _ckpt_steps(output_dir, complete_only=True)
    return os.path.join(output_dir, f"{CKPT_PREFIX}{steps[-1]}") if steps else None


def _write_state(sd: dict, path: str) -> None:
    """The writer's torch.save of a snapshot."""
    torch.save(sd, path)


class CheckpointManager:
    """save/restore a TrainState + config + data-iterator state with
    rotation; saves are asynchronous unless asked to block. ``saves`` holds
    one record per save that wrote: its step, the seconds ``save`` held the
    caller (``hold_seconds``), the snapshot's copies took (``copy_seconds``:
    on the card the device time of the device-to-host copies, which the
    next step's work waits for on the device although ``save`` has
    returned; on the CPU the host time of the copies) and the writer took
    (``write_seconds``), the snapshot's bytes in host memory and the state
    file's bytes."""

    def __init__(self, output_dir: str, total_limit: int = 2, world=None):
        self.output_dir = os.path.abspath(output_dir)
        self.total_limit = max(1, total_limit)
        self.world = world        # data-parallel ranks that save together: rank 0 writes
        self.write = world is None or world.main
        if self.write:
            os.makedirs(self.output_dir, exist_ok=True)
        self.saves = []
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pinned = []          # host buffers of the last snapshot, reused
        self._stream = None        # the side stream of the device-to-host copies

    def save(self, step: int, state, cfg: TrainConfig,
             data_state: Optional[dict] = None, blocking: bool = False) -> str:
        """Fence the previous save, snapshot `state` to host memory, and
        write checkpoint-{step} on the writer thread (waiting for it with
        `blocking`). A step whose state is already complete is skipped (a
        preemption right after a periodic save, or on the step just resumed:
        the state at a step boundary is the same). A manager that does not
        write (a data-parallel rank other than 0) takes part in gathering a
        partitioned state and writes nothing."""
        t0 = time.perf_counter()
        self._fence()
        path = os.path.join(self.output_dir, f"{CKPT_PREFIX}{step}")
        done = [os.path.isdir(os.path.join(path, "state"))]
        if self.world is not None and self.world.size > 1:
            dist.broadcast_object_list(done, src=0)       # the writer's view
        if done[0]:
            return path
        if not self.write:
            state.state_dict(copy=lambda t: t)
            return path
        t1 = time.perf_counter()
        sd, events = self._snapshot(state)
        record = {"step": step, "hold_seconds": None,
                  "copy_seconds": time.perf_counter() - t1 if events is None else None,
                  "write_seconds": None, "snapshot_bytes": _tensor_bytes(sd), "bytes": None}
        self.saves.append(record)
        self._writer = threading.Thread(
            target=self._write, args=(path, sd, events, cfg.to_json(), dict(data_state or {}),
                                      record), name=f"checkpoint-{step}")
        self._writer.start()
        if blocking:
            self._fence()
        record["hold_seconds"] = time.perf_counter() - t0
        return path

    def wait(self):
        """Block until the in-flight save is durable (before the process
        exits, and before a restore-from-latest in the same process), raise
        its error if it failed, and rotate."""
        self._fence()
        self._rotate()

    def _fence(self):
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("the asynchronous checkpoint write failed") from err

    def _snapshot(self, state):
        """(the state dict in host memory, the events the copies start and
        complete on, or None): CUDA tensors by asynchronous copies into
        pinned buffers on a side stream ordered after the work queued so
        far, which the current stream then waits on; CPU tensors copied at
        once."""
        pinned, index, device = self._pinned, [0], []
        start = torch.cuda.Event(enable_timing=True) if torch.cuda.is_available() else None

        def copy(t: torch.Tensor) -> torch.Tensor:
            if not t.is_cuda:
                return t.to("cpu", copy=True)
            if not device:
                device.append(t.device)
                if self._stream is None or self._stream.device != t.device:
                    self._stream = torch.cuda.Stream(t.device)
                self._stream.wait_stream(torch.cuda.current_stream(t.device))
                start.record(self._stream)
            i = index[0]
            index[0] += 1
            if i == len(pinned) or pinned[i].shape != t.shape or pinned[i].dtype != t.dtype:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                pinned[i:i + 1] = [buf]
            with torch.cuda.stream(self._stream):
                pinned[i].copy_(t, non_blocking=True)
            return pinned[i]

        sd = state.state_dict(copy=copy)
        del pinned[index[0]:]
        if not device:
            return sd, None
        ready = torch.cuda.Event(enable_timing=True)
        ready.record(self._stream)
        # the next step's in-place updates come after the copies
        torch.cuda.current_stream(device[0]).wait_event(ready)
        return sd, (start, ready)

    def _write(self, path, sd, events, config_json, data_state, record):
        try:
            t0 = time.perf_counter()
            if events is not None:
                events[1].synchronize()
                record["copy_seconds"] = events[0].elapsed_time(events[1]) / 1e3
            tmp = os.path.join(path, "state.tmp")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            _write_state(sd, os.path.join(tmp, STATE_FILE))
            with open(os.path.join(path, "config.json"), "w") as f:
                f.write(config_json)
            with open(os.path.join(path, "data_state.json"), "w") as f:
                json.dump(data_state, f)
            os.rename(tmp, os.path.join(path, "state"))
            record["bytes"] = os.path.getsize(os.path.join(path, "state", STATE_FILE))
            record["write_seconds"] = time.perf_counter() - t0
            self._rotate()
        except BaseException as e:  # raised again by the next save / wait / restore
            self._error = e

    def _rotate(self):
        if not self.write:
            return
        # among COMPLETE checkpoints only: one cut short counts for nothing
        steps = _ckpt_steps(self.output_dir, complete_only=True)
        for s in steps[: max(0, len(steps) - self.total_limit)]:
            shutil.rmtree(os.path.join(self.output_dir, f"{CKPT_PREFIX}{s}"),
                          ignore_errors=True)

    def restore(self, path: str, state) -> Tuple[object, TrainConfig, dict]:
        """Load checkpoint `path` (or the latest complete one for 'latest')
        into `state` in place; returns (state, its TrainConfig, its data
        state). Fences an in-flight save first, as the JAX package does."""
        self._fence()
        if path == "latest":
            resolved = latest_checkpoint(self.output_dir)
            if resolved is None:
                raise FileNotFoundError(f"no {CKPT_PREFIX}* under {self.output_dir}")
            path = resolved
        sd = torch.load(os.path.join(path, "state", STATE_FILE), map_location="cpu",
                        weights_only=True)
        state.load_state_dict(sd)
        del sd
        with open(os.path.join(path, "config.json")) as f:
            cfg = TrainConfig.from_json(f.read())
        data_state = {}
        ds_path = os.path.join(path, "data_state.json")
        if os.path.exists(ds_path):
            with open(ds_path) as f:
                data_state = json.load(f)
        return state, cfg, data_state


def _tensor_bytes(obj) -> int:
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(_tensor_bytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_tensor_bytes(v) for v in obj)
    return 0


# ------------------------------------------------- diffusers-format export --

def export_unet_diffusers(unet: Union[nn.Module, Mapping[str, torch.Tensor]], path: str,
                          config_json: str = "") -> str:
    """Write ``<path>/diffusion_pytorch_model.safetensors`` (the UNet's state
    dict, or the state dict given, in its own dtypes, without the
    Tracklet2Video branch; the port's names are diffusers') and, given
    `config_json`, ``<path>/config.json``. Returns the weights file."""
    os.makedirs(path, exist_ok=True)
    sd = unet.state_dict() if isinstance(unet, nn.Module) else unet
    sd = {k: v for k, v in sd.items() if not is_branch_key(k)}
    out = save_file(sd, os.path.join(path, "diffusion_pytorch_model.safetensors"),
                    metadata={"format": "pt"})
    if config_json:
        with open(os.path.join(path, "config.json"), "w") as f:
            f.write(config_json)
    return out


def export_lora_diffusers(lora: Adapter, path: str) -> str:
    """Write ``<path>/pytorch_lora_weights.safetensors`` with peft's keys.
    Returns the file."""
    os.makedirs(path, exist_ok=True)
    return save_file(lora_state_dict(lora), os.path.join(path, "pytorch_lora_weights.safetensors"),
                     metadata={"format": "pt"})


def export_tracklet(unet: Union[nn.Module, Mapping[str, torch.Tensor]], path: str) -> str:
    """Write ``<path>/tracklet_weights.safetensors``: the UNet's (or the
    state dict's) Tracklet2Video branch as f32 in the JAX package's flat
    flax paths and layouts, the file its CLI writes. Returns the file."""
    os.makedirs(path, exist_ok=True)
    flat = {k: torch.from_numpy(v) for k, v in tracklet_branch_to_flat(unet).items()}
    return save_file(flat, os.path.join(path, TRACKLET_FILE))
