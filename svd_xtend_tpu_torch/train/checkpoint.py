"""Finetunes and LoRA adapters written in the reference's file formats.

Port of the diffusers-format export of ``svd_xtend_tpu/train/checkpoint.py``
(:132-155): the UNet as ``save_pretrained`` writes it (train_svd.py:698-706)
and a LoRA adapter as ``save_lora_weights`` does (train_svd_lora.py:
1070-1074), both safetensors with ``{"format": "pt"}``. Resume checkpoints
are not ported yet.
"""

from __future__ import annotations

import os

from torch import nn

from ..io.convert import lora_state_dict
from ..io.safetensors_io import save_file
from ..models.lora import Adapter


def export_unet_diffusers(unet: nn.Module, path: str, config_json: str = "") -> str:
    """Write ``<path>/diffusion_pytorch_model.safetensors`` (the UNet's state
    dict in its own dtype; the port's names are diffusers') and, given
    `config_json`, ``<path>/config.json``. Returns the weights file."""
    os.makedirs(path, exist_ok=True)
    out = save_file(unet.state_dict(), os.path.join(path, "diffusion_pytorch_model.safetensors"),
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
