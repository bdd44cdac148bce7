"""Video quality metrics (evaluation utilities).

Port of ``svd_xtend_tpu/utils/metrics.py``, on the port's CLIP tower
(``models/clip.py``), which each function takes in place of the JAX
package's (clip_params, cfg) pair:

  - clip_frame_similarity: cosine(CLIP(cond image), CLIP(frame_t)), subject
    fidelity over time;
  - temporal_consistency: the mean cosine of consecutive frame embeddings;
  - psnr, flicker: pixel-level statistics; video_report gathers them;
  - gaussian_stats, frechet_distance, clip_video_features, clip_fvd: a
    Fréchet video distance over CLIP features;
  - estimate_motion_bucket: a motion_bucket_id from the mean inter-frame
    change.

Videos are (B, F, H, W, 3) in [-1, 1]. The arithmetic is JAX's: embeddings
compared in f32, the Fréchet distance through ``eigh`` / ``eigvalsh`` of
the symmetrised product in f32 with its eps.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..models.clip import CLIPVisionModelWithProjection, preprocess_for_clip


def _embed_frames(clip: CLIPVisionModelWithProjection, frames: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) in [-1, 1] -> (N, D) L2-normalized f32 CLIP embeddings."""
    emb = clip(preprocess_for_clip(frames, clip.config)).float()
    return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)


def clip_frame_similarity(clip: CLIPVisionModelWithProjection, cond_image: torch.Tensor,
                          video: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3), (B, F, H, W, 3) -> (B, F) cosine similarities."""
    b, f = video.shape[:2]
    ref = _embed_frames(clip, cond_image)
    frames = _embed_frames(clip, video.reshape((b * f,) + video.shape[2:])).reshape(b, f, -1)
    return torch.einsum("bd,bfd->bf", ref, frames)


def temporal_consistency(clip: CLIPVisionModelWithProjection,
                         video: torch.Tensor) -> torch.Tensor:
    """(B, F, H, W, 3) -> (B,) mean consecutive-frame embedding cosine."""
    b, f = video.shape[:2]
    emb = _embed_frames(clip, video.reshape((b * f,) + video.shape[2:])).reshape(b, f, -1)
    return (emb[:, 1:] * emb[:, :-1]).sum(-1).mean(1)


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 2.0) -> torch.Tensor:
    """Per-sample PSNR over all trailing dims; inputs in [-1, 1]."""
    mse = ((a.float() - b.float()) ** 2).mean(dim=tuple(range(1, a.dim())))
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-12))


def flicker(video: torch.Tensor) -> torch.Tensor:
    """(B, F, H, W, 3) -> (B,) mean absolute inter-frame pixel change."""
    return torch.diff(video.float(), dim=1).abs().mean(dim=(1, 2, 3, 4))


def video_report(clip: CLIPVisionModelWithProjection, cond_image: torch.Tensor,
                 video: torch.Tensor) -> Dict[str, torch.Tensor]:
    sim = clip_frame_similarity(clip, cond_image, video)
    return {
        "clip_sim_mean": sim.mean(),
        "clip_sim_last": sim[:, -1].mean(),
        "temporal_consistency": temporal_consistency(clip, video).mean(),
        "flicker": flicker(video).mean(),
    }


# ---------------------------------------------------------- FVD machinery --

def gaussian_stats(features: torch.Tensor):
    """(N, D) features -> (mean (D,), covariance (D, D)) in f32."""
    x = features.float()
    mu = x.mean(0)
    xc = x - mu
    cov = (xc.T @ xc) / max(x.shape[0] - 1, 1)
    return mu, cov


def frechet_distance(mu1: torch.Tensor, cov1: torch.Tensor, mu2: torch.Tensor,
                     cov2: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Fréchet distance between two Gaussians, the FVD / FID statistic:
    tr(c1 + c2 - 2 (c1 c2)^{1/2}) through the eigendecomposition of the
    symmetrised product sqrt(c1) c2 sqrt(c1), which is PSD and similar to
    c1 c2 (no matrix square root of a non-symmetric matrix)."""
    d2 = ((mu1 - mu2) ** 2).sum()
    eye = torch.eye(cov1.shape[0], dtype=cov1.dtype, device=cov1.device)
    e1, v1 = torch.linalg.eigh(cov1 + eps * eye)
    sqrt1 = (v1 * torch.sqrt(torch.clamp(e1, min=0.0))) @ v1.T
    inner = sqrt1 @ cov2 @ sqrt1
    ev = torch.linalg.eigvalsh(inner + eps * eye)
    tr_sqrt = torch.sqrt(torch.clamp(ev, min=0.0)).sum()
    return d2 + torch.trace(cov1) + torch.trace(cov2) - 2.0 * tr_sqrt


def clip_video_features(clip: CLIPVisionModelWithProjection,
                        videos: torch.Tensor) -> torch.Tensor:
    """(B, F, H, W, 3) -> (B, 2D) per-video features: the mean frame
    embedding beside the mean absolute consecutive-frame difference, a
    CLIP-based stand-in for the I3D features of the reference FVD."""
    b, f = videos.shape[:2]
    emb = _embed_frames(clip, videos.reshape((b * f,) + videos.shape[2:])).reshape(b, f, -1)
    return torch.cat([emb.mean(1), torch.diff(emb, dim=1).abs().mean(1)], dim=-1)


def clip_fvd(clip: CLIPVisionModelWithProjection, real: torch.Tensor,
             fake: torch.Tensor) -> torch.Tensor:
    """CLIP-feature Fréchet video distance between two (B, F, H, W, 3) sets."""
    fr = clip_video_features(clip, real)
    ff = clip_video_features(clip, fake)
    return frechet_distance(*gaussian_stats(fr), *gaussian_stats(ff))


# ------------------------------------------------- motion-bucket estimate --

def estimate_motion_bucket(video: torch.Tensor, max_bucket: int = 255,
                           scale: float = 2400.0) -> torch.Tensor:
    """(B, F, H, W, 3) in [-1, 1] -> (B,) int32 motion_bucket_id estimate:
    the mean absolute inter-frame change (a flow-magnitude proxy) times
    `scale`, clipped to [0, max_bucket] (the reference hardcodes 127; the
    SVD authors never published their motion score)."""
    score = flicker(video) * scale
    return torch.clamp(score, 0, max_bucket).to(torch.int32)
