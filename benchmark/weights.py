"""Seeded random weights, made on the device in a few large draws.

Every leaf of every network gets its values from one stream of unit
normals, drawn on the device with one ``torch.Generator`` in chunks of
CHUNK values, and handed out to the leaves in the order of their sorted
names. The same seed and the same names give the same values on both sides
of a comparison, whatever the module classes, dtypes or memory formats:
the program's networks and the reference's are filled by the same law,
each leaf through ``copy_`` by logical index.

The law (the flax initialisation the repo's own ``init_random_`` follows,
with small random biases and norm scales so that no affine term is a no-op):
  - matrices and kernels: normal, std 1/sqrt(fan_in), fan_in = all but the
    output axis;
  - biases: normal, std 0.02; norm scales (other 1-D leaves): 1 + normal·0.02;
  - CLIP's class and position embeddings: normal, std 0.02;
  - ``mix_factor`` (the AlphaBlenders): in the VAE's temporal decoder, unit
    normal (its constructor's 0.0 would make every blend there an even mix,
    under which the spatial and the temporal branch can be swapped unseen);
    in the UNet the constructors' 0.5, whose blends are uneven already.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

CHUNK = 1 << 27


def law(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(mean, std) of the leaf `name` (a network prefix such as ``unet.``
    included); std 0 means the constant mean."""
    if name.endswith("mix_factor"):
        return (0.0, 1.0) if name.startswith("vae.decoder.") else (0.5, 0.0)
    if name.endswith(("class_embedding", "position_embedding.weight")):
        return 0.0, 0.02
    if name.endswith("bias"):
        return 0.0, 0.02
    if len(shape) == 1:
        return 1.0, 0.02
    fan_in = math.prod(shape[1:])
    return 0.0, fan_in ** -0.5


class _Normals:
    """Consecutive unit normals from one generator, CHUNK at a time."""

    def __init__(self, seed: int, device):
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.device = device
        self.buf = torch.empty(0, device=device)
        self.pos = 0

    def take(self, n: int) -> torch.Tensor:
        parts = []
        while n > 0:
            if self.pos == self.buf.numel():
                self.buf = torch.randn(CHUNK, generator=self.gen, device=self.device)
                self.pos = 0
            k = min(n, self.buf.numel() - self.pos)
            parts.append(self.buf[self.pos:self.pos + k])
            self.pos += k
            n -= k
        return parts[0] if len(parts) == 1 else torch.cat(parts)


def named_leaves(nets: Dict[str, torch.nn.Module]) -> Dict[str, torch.Tensor]:
    """{prefix.name: parameter} over the networks, e.g. {"unet": ..., "vae": ...}."""
    return {f"{prefix}.{n}": p for prefix, net in nets.items()
            for n, p in net.named_parameters()}


@torch.no_grad()
def fill_(leaves: Dict[str, torch.Tensor], seed: int,
          round_to: Optional[torch.dtype] = None) -> None:
    """Fill `leaves` in place by the law from `seed`. `round_to`: round every
    value to that dtype first (a reference in f32 holding the weights the
    program serves in bf16)."""
    device = next(iter(leaves.values())).device
    normals = _Normals(seed, device)
    for name in sorted(leaves):
        p = leaves[name]
        shape = tuple(p.shape)
        mean, std = law(name, shape)
        z = normals.take(p.numel())
        v = z.view(shape) * std + mean if std else torch.full(shape, mean, device=device)
        if round_to is not None:
            v = v.to(round_to)
        p.copy_(v)
