"""Quantitative video-quality metrics.

Port of ``svd_xtend_tpu/utils/eval.py`` (the reference only eyeballs its
validation GIFs, train_svd.py:1092-1157):
  - CLIP frame score: the cosine between each frame's CLIP embedding and the
    conditioning image's (the pipeline's own frozen tower);
  - temporal consistency: the mean CLIP cosine of consecutive frames;
  - pixel dynamics: mean |frame_t+1 - frame_t| (a static video scores high
    on consistency and ~0 here, so the two are read together).
Videos are [-1, 1] (B, F, H, W, 3); embeddings are taken in the tower's
dtype and compared in f32.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..models.clip import preprocess_for_clip


def _clip_embed_frames(models, frames: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) in [-1, 1] -> L2-normalized (N, D) f32 CLIP embeddings."""
    emb = models.clip(preprocess_for_clip(frames, models.clip.config)).float()
    return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True).clamp(min=1e-8)


@torch.no_grad()
def video_metrics(models, video: torch.Tensor,
                  cond_image: torch.Tensor) -> Dict[str, torch.Tensor]:
    """All metrics for (B, F, H, W, 3) videos against (B, H, W, 3) images:
    f32 scalars clip_frame_score (mean over B, F), clip_temporal_consistency
    (mean over B, F-1) and pixel_dynamics."""
    b, f = video.shape[:2]
    video = video.float()
    emb = _clip_embed_frames(models, video.reshape((b * f,) + video.shape[2:])).reshape(b, f, -1)
    cond = _clip_embed_frames(models, cond_image)
    frame_score = (emb * cond[:, None]).sum(-1).mean()
    if f > 1:
        consistency = (emb[:, 1:] * emb[:, :-1]).sum(-1).mean()
        dynamics = (video[:, 1:] - video[:, :-1]).abs().mean()
    else:
        consistency = torch.tensor(1.0, device=video.device)
        dynamics = torch.tensor(0.0, device=video.device)
    return {"clip_frame_score": frame_score,
            "clip_temporal_consistency": consistency,
            "pixel_dynamics": dynamics}
