"""Model and pipeline configuration dataclasses.

A field-for-field copy of the configs of ``svd_xtend_tpu/core/config.py``
(UNetConfig, VAEConfig, CLIPVisionConfig, SchedulerConfig, PipelineConfig,
MeshConfig, TrainConfig and the TINY_* test configs), with the JSON
round trip of ``_JsonMixin`` (a checkpoint's ``config.json``, the exported
UNet's). The port keeps its own copy because the JAX package's
``core/__init__.py`` imports modules that import jax;
``tests/test_torch_port_basics.py`` holds this copy equal to the JAX
dataclasses. Defaults reproduce the SVD checkpoint config.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


class _JsonMixin:
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict):
        names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in d.items():
            if k not in names:
                continue
            if isinstance(v, list):
                v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
            kwargs[k] = v
        return cls(**kwargs)

    @classmethod
    def from_json(cls, s: str):
        return cls.from_dict(json.loads(s))


@dataclasses.dataclass(frozen=True)
class UNetConfig(_JsonMixin):
    """Spatio-temporal conditional UNet (SVD architecture)."""

    sample_size: int = 96
    in_channels: int = 8          # 4 noisy latent + 4 concat first-frame cond
    out_channels: int = 4
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlockSpatioTemporal",
        "CrossAttnDownBlockSpatioTemporal",
        "CrossAttnDownBlockSpatioTemporal",
        "DownBlockSpatioTemporal",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlockSpatioTemporal",
        "CrossAttnUpBlockSpatioTemporal",
        "CrossAttnUpBlockSpatioTemporal",
        "CrossAttnUpBlockSpatioTemporal",
    )
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 768  # 3 * 256
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    transformer_layers_per_block: Tuple[int, ...] = (1, 1, 1, 1)
    num_attention_heads: Tuple[int, ...] = (5, 10, 20, 20)
    num_frames: int = 25
    resnet_eps: float = 1e-5
    norm_eps: float = 1e-6        # GroupNorm inside transformer models
    dropout: float = 0.0
    ff_chunk_size: int = 0        # not ported: the port runs unchunked
    # Tracklet2Video (bbox-conditioned) branch, models/tracklet.py: 0
    # disables; tracklet_gate_init 0.0 makes each gated injection an exact
    # no-op at init
    tracklet_dim: int = 0
    tracklet_heads: int = 8
    tracklet_gate_init: float = 0.0

    def __post_init__(self):
        n = len(self.block_out_channels)
        if not (len(self.down_block_types) == len(self.up_block_types) == n
                == len(self.num_attention_heads)
                == len(self.transformer_layers_per_block)):
            raise ValueError(
                "down/up_block_types, block_out_channels, num_attention_heads "
                "and transformer_layers_per_block must all have equal length")
        if self.projection_class_embeddings_input_dim != 3 * self.addition_time_embed_dim:
            raise ValueError(
                "projection_class_embeddings_input_dim must equal "
                "3 * addition_time_embed_dim ([fps, motion_bucket, noise_aug])")

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


TINY_UNET = UNetConfig(
    sample_size=8,
    block_out_channels=(32, 64),
    down_block_types=("CrossAttnDownBlockSpatioTemporal", "DownBlockSpatioTemporal"),
    up_block_types=("UpBlockSpatioTemporal", "CrossAttnUpBlockSpatioTemporal"),
    layers_per_block=1,
    transformer_layers_per_block=(1, 1),
    num_attention_heads=(2, 4),
    cross_attention_dim=32,
    addition_time_embed_dim=8,
    projection_class_embeddings_input_dim=24,
    num_frames=2,
)


@dataclasses.dataclass(frozen=True)
class VAEConfig(_JsonMixin):
    """KL autoencoder: per-frame 2D encoder, temporal decoder."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    scaling_factor: float = 0.18215
    norm_eps: float = 1e-6
    sample_size: int = 768

    @property
    def downsample_factor(self) -> int:
        """Spatial pixels per latent (8 for the SVD VAE's 4 stages)."""
        return 2 ** (len(self.block_out_channels) - 1)


TINY_VAE = VAEConfig(block_out_channels=(32, 64), layers_per_block=1)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig(_JsonMixin):
    """CLIP ViT vision tower with projection (CLIP-ViT-H/14 defaults)."""

    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1280
    num_layers: int = 32
    num_heads: int = 16
    intermediate_size: int = 5120
    projection_dim: int = 1024
    layer_norm_eps: float = 1e-5
    hidden_act: str = "gelu"
    image_mean: Tuple[float, float, float] = (0.48145466, 0.4578275, 0.40821073)
    image_std: Tuple[float, float, float] = (0.26862954, 0.26130258, 0.27577711)


TINY_CLIP = CLIPVisionConfig(
    image_size=28, patch_size=14, hidden_size=32, num_layers=2, num_heads=2,
    intermediate_size=64, projection_dim=32,
)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig(_JsonMixin):
    """EulerDiscreteScheduler in EDM/Karras mode."""

    num_train_timesteps: int = 1000
    sigma_min: float = 0.002
    sigma_max: float = 700.0
    rho: float = 7.0


@dataclasses.dataclass(frozen=True)
class PipelineConfig(_JsonMixin):
    """Operating point of the img2vid pipeline.

    ``uncond_reuse_interval`` (the CFG cache) and ``deep_cache_interval`` /
    ``deep_cache_depth`` (DeepCache) run as in the JAX package
    (``diffusion/pipeline.py::generate``), and so do the opt-in int8 W8A8
    modes: ``unet_quant="int8"`` quantises every Conv3x3 and QLinear of the
    UNet, ``vae_quant="int8"`` every Conv3x3 of the VAE decoder
    (``ops/quant.py``); None is exact."""

    height: int = 320
    width: int = 512
    num_frames: int = 14
    num_inference_steps: int = 25
    min_guidance_scale: float = 1.0
    max_guidance_scale: float = 3.0
    fps: int = 7
    fps_offset: int = 1           # upstream pipeline embeds fps-1; training fed raw fps
    motion_bucket_id: int = 127
    noise_aug_strength: float = 0.02
    decode_chunk_size: int = 8
    uncond_reuse_interval: int = 1
    unet_quant: Optional[str] = None
    vae_quant: Optional[str] = None
    deep_cache_interval: int = 1
    deep_cache_depth: int = 1


@dataclasses.dataclass(frozen=True)
class MeshConfig(_JsonMixin):
    """Device-mesh layout. axis sizes of -1 mean "fill with what's left".
    The port runs the 'data' axis (data-parallel ranks) and the 'frames'
    axis (sequence parallelism: each rank of a frames group holds
    num_frames / frames of every video) and a 'model' axis (tensor
    parallelism: each rank of a model group holds its part of the UNet's
    transformer matrices), laid out data outer, model in the middle, frames
    inner (``parallel.mesh_world``)."""

    data: int = -1
    model: int = 1
    frames: int = 1


@dataclasses.dataclass(frozen=True)
class TrainConfig(_JsonMixin):
    """Training hyperparameters (the reference's flag surface).

    The port runs the 'temporal', 'full', 'lora' and 'tracklet' scopes,
    AdamW with f32 masters (or 8-bit moments, ``use_8bit_adam``), f32 or
    bf16 gradients (``grad_dtype``), gradient accumulation, EMA, remat.
    ``vae_encode_in_loop`` is accepted and not read, as in the JAX package.
    ZeRO-1 and host offload run over the ranks of the 'data' and 'frames'
    mesh axes (``parallel/``; the frames axis must divide ``num_frames``,
    as the JAX package's ``shard_batch`` needs: generate alone takes an
    uneven split), ZeRO-1 over those of each model index under a 'model'
    axis, which takes every scope ('lora' included), 8-bit AdamW (the
    whole tensors' blocks) and host offload.
    ``encode_chunk_size`` chunks the
    frozen VAE encode (0 = unchunked); the posterior noise is drawn per
    chunk, as in the JAX package."""

    # data
    base_folder: str = ""
    width: int = 512
    height: int = 320
    num_frames: int = 14
    per_device_batch_size: int = 1
    num_workers: int = 8
    encode_chunk_size: int = 8
    # optimization
    learning_rate: float = 1e-4
    scale_lr: bool = False
    lr_scheduler: str = "constant"      # linear|cosine|cosine_with_restarts|polynomial|constant|constant_with_warmup
    lr_warmup_steps: int = 500
    max_train_steps: int = 50000
    gradient_accumulation_steps: int = 1
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    use_8bit_adam: bool = False
    zero1: bool = False
    host_offload: str = "none"
    # EDM
    p_mean: float = 0.7
    p_std: float = 1.6
    cond_aug_loc: float = -3.0
    cond_aug_std: float = 0.5
    conditioning_dropout_prob: float = 0.1
    # trainable scope: 'full' | 'temporal' | 'lora' | 'tracklet'
    train_mode: str = "temporal"
    lora_rank: int = 4
    lora_alpha: int = 4
    tracklet_dim: int = 0
    tracklet_gate_init: float = 0.0
    max_boxes: int = 16
    # EMA
    use_ema: bool = False
    ema_decay: float = 0.9999
    # precision
    mixed_precision: str = "bf16"       # no|bf16
    grad_dtype: str = "fp32"            # fp32|bf16
    # checkpointing
    output_dir: str = "./outputs"
    checkpointing_steps: int = 500
    checkpoints_total_limit: int = 2
    resume_from_checkpoint: str = ""
    validation_steps: int = 500
    num_validation_images: int = 1
    # misc
    seed: int = 123
    report_to: str = "tensorboard"
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    # performance
    remat_policy: str = "block"         # none|block|outer (models/unet.py)
    vae_encode_in_loop: bool = True

    @classmethod
    def from_dict(cls, d: dict):
        d = dict(d)
        if isinstance(d.get("mesh"), dict):
            d["mesh"] = MeshConfig.from_dict(d["mesh"])
        return super().from_dict(d)

    def check_ported(self) -> None:
        """Raise ValueError for an option the port does not run yet, or an
        unknown one."""
        if self.mesh.model < 1:
            raise ValueError(f"a 'model' mesh axis of {self.mesh.model}")
        if self.mesh.frames < 1 or self.num_frames % self.mesh.frames:
            raise ValueError(f"num_frames {self.num_frames} over a frames axis of "
                             f"{self.mesh.frames}: a train batch takes an even split only, as "
                             "the JAX package's shard_batch places it (generate takes an "
                             "uneven one)")
        if self.host_offload not in ("none", "masters", "masters+moments"):
            raise ValueError(f"unknown host_offload mode {self.host_offload!r}")
        if self.train_mode not in ("temporal", "full", "lora", "tracklet"):
            raise ValueError(f"unknown train_mode {self.train_mode!r}")
        if self.grad_dtype not in ("fp32", "bf16"):
            raise ValueError(f"unknown grad_dtype {self.grad_dtype!r}")
        if self.remat_policy not in ("none", "block", "outer"):
            raise ValueError(f"unknown remat policy {self.remat_policy!r}")
