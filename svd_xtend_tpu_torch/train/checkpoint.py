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
    incomplete, and neither 'latest' nor the rotation counts it. Saves are
    synchronous; ``wait()`` only rotates.
  - The diffusers-format exports (:132-155): the UNet as ``save_pretrained``
    writes it (train_svd.py:698-706) and a LoRA adapter as
    ``save_lora_weights`` does (train_svd_lora.py:1070-1074), safetensors
    with ``{"format": "pt"}``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Mapping, Optional, Tuple, Union

import torch
from torch import nn

from ..core.config import TrainConfig
from ..io.convert import lora_state_dict
from ..io.safetensors_io import save_file
from ..models.lora import Adapter

CKPT_PREFIX = "checkpoint-"
STATE_FILE = "train_state.pt"


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


class CheckpointManager:
    """save/restore a TrainState + config + data-iterator state with rotation."""

    def __init__(self, output_dir: str, total_limit: int = 2):
        self.output_dir = os.path.abspath(output_dir)
        self.total_limit = max(1, total_limit)
        os.makedirs(self.output_dir, exist_ok=True)

    def save(self, step: int, state, cfg: TrainConfig,
             data_state: Optional[dict] = None) -> str:
        """Write checkpoint-{step} and rotate, before returning. A step whose
        state is already complete is skipped (a preemption right after a
        periodic save, or on the step just resumed: the state at a step
        boundary is the same)."""
        path = os.path.join(self.output_dir, f"{CKPT_PREFIX}{step}")
        state_dir = os.path.join(path, "state")
        if os.path.isdir(state_dir):
            return path
        tmp = os.path.join(path, "state.tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state.state_dict(), os.path.join(tmp, STATE_FILE))
        with open(os.path.join(path, "config.json"), "w") as f:
            f.write(cfg.to_json())
        with open(os.path.join(path, "data_state.json"), "w") as f:
            json.dump(data_state or {}, f)
        os.rename(tmp, state_dir)
        self._rotate()
        return path

    def wait(self):
        """Saves are synchronous: only rotates (the JAX package fences an
        in-flight asynchronous save here)."""
        self._rotate()

    def _rotate(self):
        # among COMPLETE checkpoints only: one cut short counts for nothing
        steps = _ckpt_steps(self.output_dir, complete_only=True)
        for s in steps[: max(0, len(steps) - self.total_limit)]:
            shutil.rmtree(os.path.join(self.output_dir, f"{CKPT_PREFIX}{s}"),
                          ignore_errors=True)

    def restore(self, path: str, state) -> Tuple[object, TrainConfig, dict]:
        """Load checkpoint `path` (or the latest complete one for 'latest')
        into `state` in place; returns (state, its TrainConfig, its data
        state)."""
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


# ------------------------------------------------- diffusers-format export --

def export_unet_diffusers(unet: Union[nn.Module, Mapping[str, torch.Tensor]], path: str,
                          config_json: str = "") -> str:
    """Write ``<path>/diffusion_pytorch_model.safetensors`` (the UNet's state
    dict, or the state dict given, in its own dtypes; the port's names are
    diffusers') and, given `config_json`, ``<path>/config.json``. Returns
    the weights file."""
    os.makedirs(path, exist_ok=True)
    sd = unet.state_dict() if isinstance(unet, nn.Module) else unet
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
