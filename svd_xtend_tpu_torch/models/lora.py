"""LoRA on the UNet's attention projections, as a transform of their weights.

Port of ``svd_xtend_tpu/models/lora.py``. Behaviour (reference
train_svd_lora.py:659-671): an adapter on every ``nn.Linear`` named
to_q/to_k/to_v/to_out.0, W' = W + (alpha/r)·B·A, A gaussian / r, B zero,
rank = alpha = 4 by default; only the adapters train.

An adapter is ``{module name: {"a": A (r, in), "b": B (out, r)}}`` in f32:
A and B are peft's ``lora_A.weight`` / ``lora_B.weight``, so the file keys
map one to one (``io/convert.py::lora_state_dict``). No module is wrapped:
``merge`` returns the merged weights, ``merged`` puts them in place of the
base weights while a forward and its backward run (training), and
``merge_`` writes them into the UNet (serving: merge once, run the base
model).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

Adapter = Dict[str, Dict[str, torch.Tensor]]

# the reference's target_modules (train_svd_lora.py:663)
TARGETS = ("to_q", "to_k", "to_v", "to_out.0")


def _jax_order(name: str) -> Tuple[str, ...]:
    """Sort key of a module name in the JAX package's order: its flax path
    ('down_blocks_0/attentions_0/...'), whose segments flax's tree sorts."""
    segs: List[str] = []
    for seg in name.split("."):
        if seg.isdigit() and segs:
            segs[-1] += "_" + seg
        else:
            segs.append(seg)
    return tuple(segs)


def targets(unet: nn.Module) -> List[Tuple[str, Tuple[int, int]]]:
    """(module name, (out, in)) of every nn.Linear whose name ends in one of
    TARGETS, in the JAX package's order (``target_paths``)."""
    found = [(n, tuple(m.weight.shape)) for n, m in unet.named_modules()
             if isinstance(m, nn.Linear) and any(n == t or n.endswith("." + t)
                                                 for t in TARGETS)]
    if not found:
        raise ValueError(f"no LoRA targets {TARGETS} found in the module")
    return sorted(found, key=lambda e: _jax_order(e[0]))


def init(unet: nn.Module, rank: int = 4,
         generator: Optional[torch.Generator] = None) -> Adapter:
    """One adapter per target, on the UNet's device: A (r, in) a unit normal / r
    in f32, drawn from `generator` target by target; B (out, r) zeros."""
    device = next(unet.parameters()).device
    out: Adapter = {}
    for name, (d_out, d_in) in targets(unet):
        a = torch.randn((rank, d_in), generator=generator, device=device,
                        dtype=torch.float32) / rank
        out[name] = {"a": a, "b": torch.zeros((d_out, rank), device=device,
                                              dtype=torch.float32)}
    return out


def merge(unet: nn.Module, lora: Adapter, alpha: float = 4.0) -> Dict[str, torch.Tensor]:
    """{module name: (W.float() + (alpha/r)·B·A).to(W.dtype)} for every
    adapter, r from A's shape; differentiable in A and B, W never written."""
    modules = dict(unet.named_modules())
    merged_w = {}
    for name, ab in lora.items():
        w = modules[name].weight
        delta = (ab["b"] @ ab["a"]) * (alpha / ab["a"].shape[0])
        merged_w[name] = (w.float() + delta).to(w.dtype)
    return merged_w


@contextlib.contextmanager
def merged(unet: nn.Module, lora: Adapter, alpha: float = 4.0):
    """The merged weights stand in for the targets' base weights inside the
    block. Keep it open across ``autograd.grad``: remat recomputes the
    checkpointed blocks in the backward, and they must see the same
    weights as the forward did."""
    modules = dict(unet.named_modules())
    base = {}
    try:
        for name, w in merge(unet, lora, alpha).items():
            base[name] = modules[name]._parameters["weight"]
            modules[name]._parameters["weight"] = w
        yield
    finally:
        for name, p in base.items():
            modules[name]._parameters["weight"] = p


@torch.no_grad()
def merge_(unet: nn.Module, lora: Adapter, alpha: float = 4.0) -> nn.Module:
    """Write the merged weights into the UNet, in place (for serving)."""
    modules = dict(unet.named_modules())
    for name, w in merge(unet, lora, alpha).items():
        modules[name].weight.copy_(w)
    return unet


def num_params(lora: Adapter) -> int:
    return sum(t.numel() for ab in lora.values() for t in ab.values())
