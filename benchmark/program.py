"""The program under test, as the benchmark builds it: the port's configs
from a configuration file's published groups, and its networks holding the
seeded weights of ``weights.py``."""

from __future__ import annotations

import torch

from svd_xtend_tpu_torch.core import config as port_config
from svd_xtend_tpu_torch.diffusion import pipeline

from . import weights


def port_configs(cfg: dict):
    """(UNetConfig, VAEConfig, CLIPVisionConfig, SchedulerConfig) of a
    configuration file."""
    unet = dict(cfg["unet"])
    n = len(unet["block_out_channels"])
    for key in ("transformer_layers_per_block", "num_attention_heads"):
        if isinstance(unet[key], int):
            unet[key] = [unet[key]] * n
    enc, fx = cfg["image_encoder"], cfg["feature_extractor"]
    clip = dict(enc, num_layers=enc["num_hidden_layers"], num_heads=enc["num_attention_heads"],
                image_mean=fx["image_mean"], image_std=fx["image_std"])
    return (port_config.UNetConfig.from_dict(unet), port_config.VAEConfig.from_dict(cfg["vae"]),
            port_config.CLIPVisionConfig.from_dict(clip),
            port_config.SchedulerConfig.from_dict(cfg["scheduler"]))


def build_models(cfg: dict, device, dtype: torch.dtype, seed: int) -> pipeline.SVDModels:
    """The port's networks in `dtype` on `device`, every leaf by the weight law
    from `seed` (made on the device, not by the networks' own init)."""
    unet, vae, clip, sched = port_configs(cfg)
    models = pipeline.SVDModels.create(unet, vae, clip, sched, device="meta", dtype=dtype)
    nets = {"unet": models.unet, "vae": models.vae, "clip": models.clip}
    for net in nets.values():
        net.to_empty(device=device)
    weights.fill_(weights.named_leaves(nets), seed)
    return models
