"""CLIP ViT vision tower with projection — the image conditioner.

Port of ``svd_xtend_tpu/models/clip.py``: transformers'
CLIPVisionModelWithProjection (pre-LN layers, exact-erf GELU, projected
class-token output) with transformers' state-dict names, and the
blur + bicubic + mean/std preprocessing. Inputs are channels-last.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import CLIPVisionConfig
from ..ops.attention import dot_product_attention
from ..ops.resize import resize_antialiased


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        w = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.q_proj, self.k_proj = nn.Linear(w, w), nn.Linear(w, w)
        self.v_proj, self.out_proj = nn.Linear(w, w), nn.Linear(w, w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, s, w = x.shape
        split = lambda y: y.reshape(n, s, self.num_heads, w // self.num_heads)
        o = dot_product_attention(split(self.q_proj(x)), split(self.k_proj(x)),
                                  split(self.v_proj(x)), impl="plain")
        return self.out_proj(o.reshape(n, s, w))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        if cfg.hidden_act != "gelu":
            raise ValueError(f"unsupported CLIP activation {cfg.hidden_act!r}")
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))      # exact (erf) GELU


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        p = cfg.patch_size
        self.patch_size = p
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, p, stride=p, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size))
        grid = (cfg.image_size // p) ** 2
        self.position_embedding = nn.Embedding(grid + 1, cfg.hidden_size)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """(N, S, S, 3) -> (N, 1 + grid, width); patches in row-major order."""
        x = self.patch_embedding(pixels.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        return torch.cat([cls, x], dim=1) + self.position_embedding.weight[None]


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList([CLIPEncoderLayer(cfg)
                                             for _ in range(cfg.num_layers)])
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        x = self.pre_layrnorm(self.embeddings(pixels))
        for layer in self.encoder.layers:
            x = layer(x)
        return self.post_layernorm(x[:, 0])


class CLIPVisionModelWithProjection(nn.Module):
    def __init__(self, config: CLIPVisionConfig):
        super().__init__()
        self.config = config
        self.vision_model = CLIPVisionTransformer(config)
        self.visual_projection = nn.Linear(config.hidden_size, config.projection_dim,
                                           bias=False)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(N, image_size, image_size, 3) normalized pixels -> (N, projection_dim)."""
        x = pixel_values.to(self.visual_projection.weight.dtype)
        return self.visual_projection(self.vision_model(x))


def preprocess_for_clip(images: torch.Tensor, cfg: CLIPVisionConfig) -> torch.Tensor:
    """[-1, 1] (N, H, W, 3) images -> normalized (N, S, S, 3) f32: antialiased
    resize in [-1, 1] space, then [0, 1] and CLIP mean/std."""
    x = resize_antialiased(images.float(), (cfg.image_size, cfg.image_size))
    x = (x + 1.0) / 2.0
    mean = torch.tensor(cfg.image_mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(cfg.image_std, dtype=torch.float32, device=x.device)
    return (x - mean) / std
