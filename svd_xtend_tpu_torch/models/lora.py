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

On a UNet built for a 'model' rank's part (``SVDModels.create(..., tp=)``)
the adapter is the whole one (``targets`` reads the whole shapes from
``parallel.tensor.layout``): each rank merges its slice of it into its
part of a target, B's rows for a column-parallel one (to_q, to_k, to_v),
A's columns for a row-parallel one (to_out.0).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..parallel.tensor import Layout, layout

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


def _layout(unet: nn.Module, name: str) -> Optional[Layout]:
    """How target `name`'s weight splits over the UNet's model axis (None:
    whole)."""
    tp = getattr(unet, "tp", None)
    return None if tp is None else layout(f"{name}.weight", unet.config, tp.size)


def targets(unet: nn.Module) -> List[Tuple[str, Tuple[int, int]]]:
    """(module name, (out, in)) of every nn.Linear whose name ends in one of
    TARGETS, in the JAX package's order (``target_paths``); the whole
    target's shape on a model rank's UNet."""
    def shape(n, m):
        lay = _layout(unet, n)
        return tuple(m.weight.shape) if lay is None else lay.whole_shape(m.weight.shape)
    found = [(n, shape(n, m)) for n, m in unet.named_modules()
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
    adapter, r from A's shape; differentiable in A and B, W never written.
    On a model rank, W is its part and B·A its slice of the whole delta."""
    modules = dict(unet.named_modules())
    index = getattr(getattr(unet, "tp", None), "index", 0)
    merged_w = {}
    for name, ab in lora.items():
        w = modules[name].weight
        a, b = ab["a"], ab["b"]
        lay = _layout(unet, name)
        if lay is not None:
            start, count = lay.bounds(index)
            if lay.dim == 0:
                b = b.narrow(0, start, count)
            else:
                a = a.narrow(1, start, count)
        delta = (b @ a) * (alpha / a.shape[0])
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
