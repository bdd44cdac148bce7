"""Training-loss assembly: frozen encoders, conditioning dropout, EDM loss.

Port of ``svd_xtend_tpu/diffusion/training.py``:
  - video -> per-frame VAE posterior samples x scaling_factor, encoded in
    chunks of ``encode_chunk_size`` frames (the last one ragged);
  - the first frame noise-augmented with σ ~ LogNormal(cond_aug_loc,
    cond_aug_std), encoded, a posterior sample as the UNSCALED conditioning
    latent; the CLIP embedding of the CLEAN first frame;
  - InstructPix2Pix conditioning dropout from one uniform draw r per sample:
    CLIP zeroed for r < 2p, the image latent for p <= r < 3p;
  - σ ~ LogNormal(p_mean, p_std), noisy = x0 + n·σ, the UNet on
    [noisy·c_in, cond latent] with added_time_ids [7, 127, noise_aug], EDM
    denoise and the λ(σ)-weighted f32 MSE to the clean latents;
  - Tracklet2Video batches (``boxes`` (B, F, N, 4), ``box_mask`` (B, F, N),
    all ones when not given): a sample's whole mask is zeroed when its own
    uniform draw is below conditioning_dropout_prob (training.py:165-174 in
    the JAX package), so the model also trains on the all-null tokens the
    uncond half gets at inference.
The VAE and CLIP run under ``torch.no_grad`` (the JAX package's
stop_gradient).

Sequence parallelism (``shard=``, a ``parallel.FrameShard``): the pixels
(and boxes) hold every frame of the rank's rows, the draws the rank's
frames (``parallel.local_draws``); the rank encodes its frames, takes the
conditioning from frame 0, which it holds, runs the UNet on its frames and
weights its part of the loss by the global frame count, so that the sum
over the frames group is the one-rank loss.

Randomness: every draw is an explicit tensor in ``TrainDraws``, so the tests
feed the JAX package's draws; ``sample_train_draws`` draws them from a
``torch.Generator`` in production.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import edm
from ..core.config import TrainConfig
from ..models.clip import preprocess_for_clip
from ..parallel.frames import FrameShard
from ..utils.profiling import span
from .pipeline import SVDModels, get_add_time_ids


class TrainDraws(NamedTuple):
    """The random draws of one micro-batch (B samples of F frames at H x W,
    latents h x w x c)."""

    latent_noise: torch.Tensor       # (B*F, h, w, c) posterior noise, frame order
    cond_sigma: torch.Tensor         # (B,) noise-augmentation σ
    cond_pixel_noise: torch.Tensor   # (B, H, W, 3)
    cond_latent_noise: torch.Tensor  # (B, h, w, c) conditioning posterior noise
    dropout_u: torch.Tensor          # (B,) uniform in [0, 1)
    sigma: torch.Tensor              # (B,) EDM σ
    noise: torch.Tensor              # (B, F, h, w, c)
    box_dropout_u: Optional[torch.Tensor] = None   # (B,) uniform, read with boxes only


def sample_train_draws(models: SVDModels, pixel_shape, cfg: TrainConfig,
                       generator: Optional[torch.Generator] = None,
                       device=None) -> TrainDraws:
    """Draw a micro-batch's randomness for pixels of `pixel_shape`
    (B, F, H, W, 3), on `device` (by default the UNet's); the box-dropout
    uniform last, so the draws before it are those of a batch without
    boxes."""
    if device is None:
        device = next(models.unet.parameters()).device
    b, f, h, w, _ = pixel_shape
    ds = models.vae.config.downsample_factor
    lat = (h // ds, w // ds, models.vae.config.latent_channels)
    randn = lambda *s: torch.randn(s, generator=generator, device=device)
    return TrainDraws(
        latent_noise=randn(b * f, *lat),
        cond_sigma=edm.rand_log_normal((b,), cfg.cond_aug_loc, cfg.cond_aug_std,
                                       generator=generator, device=device),
        cond_pixel_noise=randn(b, h, w, 3),
        cond_latent_noise=randn(b, *lat),
        dropout_u=torch.rand((b,), generator=generator, device=device),
        sigma=edm.rand_log_normal((b,), cfg.p_mean, cfg.p_std, generator=generator,
                                  device=device),
        noise=randn(b, f, *lat),
        box_dropout_u=torch.rand((b,), generator=generator, device=device))


class TrainBatchEncodings(NamedTuple):
    latents: torch.Tensor        # (B, F, h, w, 4) scaled clean latents, f32
    cond_latents: torch.Tensor   # (B, h, w, 4) unscaled, noise-augmented, f32
    image_embeds: torch.Tensor   # (B, 1, D) f32
    noise_aug: torch.Tensor      # (B,)


@torch.no_grad()
def encode_batch(models: SVDModels, pixel_values: torch.Tensor, cfg: TrainConfig,
                 draws: TrainDraws, shard: Optional[FrameShard] = None) -> TrainBatchEncodings:
    """Frozen-encoder stage on (B, F, H, W, 3) pixels in [-1, 1]; with a
    frames `shard`, the latents of this rank's frames."""
    clip = pixel_values if shard is None else shard.own(pixel_values)
    b, f, h, w, _ = clip.shape
    models.check_resolution(h, w)
    vae, dt = models.vae, models.dtype
    frames = clip.reshape(b * f, h, w, 3).to(dt)
    sampled = vae.encode_sample_chunked(frames, cfg.encode_chunk_size, draws.latent_noise)
    latents = sampled.reshape(b, f, *sampled.shape[1:]) * vae.config.scaling_factor

    first = pixel_values[:, 0].float()
    noisy_first = first + draws.cond_sigma.float()[:, None, None, None] * draws.cond_pixel_noise
    cond_latents = vae.encode(noisy_first.to(dt)).sample(draws.cond_latent_noise)
    image_embeds = models.clip(preprocess_for_clip(first, models.clip.config).to(dt))
    return TrainBatchEncodings(latents.float(), cond_latents.float(),
                               image_embeds[:, None, :].float(), draws.cond_sigma)


def conditioning_dropout(enc: TrainBatchEncodings, u: torch.Tensor,
                         prob: float) -> TrainBatchEncodings:
    """InstructPix2Pix §3.2.1 bands from one uniform `u` per sample: CLIP
    alone dropped for u < p, both for [p, 2p), the image latent alone for
    [2p, 3p)."""
    if prob <= 0.0:
        return enc
    keep_clip = (u >= 2.0 * prob).float()[:, None, None]
    keep_image = 1.0 - ((u >= prob) & (u < 3.0 * prob)).float()
    return enc._replace(image_embeds=enc.image_embeds * keep_clip,
                        cond_latents=enc.cond_latents * keep_image[:, None, None, None])


def box_dropout(boxes: torch.Tensor, box_mask: Optional[torch.Tensor], u: torch.Tensor,
                prob: float) -> torch.Tensor:
    """The box mask (all ones when not given) with every sample whose
    uniform `u` is below `prob` zeroed whole."""
    if box_mask is None:
        box_mask = torch.ones(boxes.shape[:3], device=boxes.device)
    if prob <= 0.0:
        return box_mask
    keep = (u >= prob).to(box_mask.dtype)
    return box_mask * keep[:, None, None]


def edm_denoising_loss(models: SVDModels, enc: TrainBatchEncodings, cfg: TrainConfig,
                       sigma: torch.Tensor, noise: torch.Tensor,
                       boxes: Optional[torch.Tensor] = None,
                       box_mask: Optional[torch.Tensor] = None,
                       shard: Optional[FrameShard] = None) -> torch.Tensor:
    """The differentiable tail: UNet forward at σ with `noise`, weighted MSE
    (with a frames `shard`, this rank's part of it)."""
    latents = enc.latents
    b = latents.shape[0]
    sigmas_b = sigma.float().reshape(b, 1, 1, 1, 1)
    noisy = latents + noise.float() * sigmas_b
    model_in = edm.precondition_inputs(noisy, sigmas_b)
    cond = enc.cond_latents[:, None].expand(*latents.shape[:4], enc.cond_latents.shape[-1])
    model_in = torch.cat([model_in, cond], dim=-1)
    add_ids = get_add_time_ids(7.0, 127.0, 0.0, b, latents.device)
    add_ids[:, 2] = enc.noise_aug.float()
    dt = models.dtype
    pred = models.unet(model_in.to(dt), edm.sigma_to_t(sigma), enc.image_embeds.to(dt),
                       add_ids, remat=cfg.remat_policy, boxes=boxes, box_mask=box_mask,
                       shard=shard)
    denoised = edm.denoise(pred, noisy, sigmas_b)
    loss = edm.weighted_denoising_loss(denoised, latents, sigmas_b)
    return loss if shard is None else loss * (shard.count / shard.total)


def training_loss(models: SVDModels, pixel_values: torch.Tensor, cfg: TrainConfig,
                  draws: TrainDraws, boxes: Optional[torch.Tensor] = None,
                  box_mask: Optional[torch.Tensor] = None,
                  shard: Optional[FrameShard] = None) -> torch.Tensor:
    """Full loss for one micro-batch of (B, F, H, W, 3) pixels in [-1, 1],
    with the micro-batch's boxes where it has them; with a frames `shard`,
    this rank's part of it. The two stages run under the spans
    ``train.encode`` and ``train.unet_loss`` (``utils/profiling.py``)."""
    with span("train.encode"):
        enc = encode_batch(models, pixel_values, cfg, draws, shard)
        enc = conditioning_dropout(enc, draws.dropout_u, cfg.conditioning_dropout_prob)
        if boxes is not None and cfg.conditioning_dropout_prob > 0:
            if draws.box_dropout_u is None:
                raise ValueError("boxes with conditioning dropout need draws.box_dropout_u")
            box_mask = box_dropout(boxes, box_mask, draws.box_dropout_u,
                                   cfg.conditioning_dropout_prob)
    with span("train.unet_loss"):
        return edm_denoising_loss(models, enc, cfg, draws.sigma, draws.noise, boxes, box_mask,
                                  shard)
