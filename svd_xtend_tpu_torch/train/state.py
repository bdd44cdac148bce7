"""Train state, trainable scopes, EMA, and the train step.

Port of ``svd_xtend_tpu/train/state.py`` for the 'temporal', 'full' and
'lora' scopes:
  - trainable scopes: 'full' (every UNet parameter), 'temporal' (the
    parameters whose name contains ``temporal_transformer_block``, the JAX
    package's rule on its flax paths; not the temporal resnets, not
    ``time_pos_embed`` / ``time_mixer``) and 'lora' (an adapter on every
    attention projection over the frozen UNet, models/lora.py;
    train_svd_lora.py:744-751);
  - EMA with the (1+step)/(10+step) warmup clamped at the max decay, stepped
    after each update (full scope, ``use_ema``);
  - gradient accumulation: the batch gets a leading (accum,) axis, the
    micro-batch gradients are summed in f32 and divided by accum.

Mixed precision: the networks hold their weights in the compute dtype (bf16)
and compute in it, without autocast; the state holds f32 master copies of
the trainable weights, which the optimizer steps and which are copied back
(rounded) into the networks after each update. Each micro-batch's gradient
is taken with respect to the compute copies and accumulated in f32, as JAX
differentiates f32 masters that are cast to bf16 at use. Frozen weights
(the other UNet leaves, VAE, CLIP) exist only in the compute dtype
(``cast_frozen_to_compute``, state.py:149-171 in the JAX package).

The 'lora' scope differentiates the loss with respect to the f32 adapter
itself: its merge into the compute-dtype base weights is part of the
forward, so there is no compute copy to write back. The merged weights stay
in place across the backward, where remat recomputes the checkpointed
blocks (``lora.merged``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..core.config import TrainConfig
from ..diffusion.pipeline import SVDModels
from ..diffusion.training import TrainDraws, sample_train_draws, training_loss
from ..io.convert import lora_state_dict
from ..models import lora as lora_lib
from .optim import ClippedAdamW, make_optimizer

TEMPORAL_SCOPE = "temporal_transformer_block"


def trainable_mask(unet: nn.Module, mode: str) -> Dict[str, bool]:
    """Parameter name -> trainable, for the 'full' or 'temporal' scope."""
    names = [n for n, _ in unet.named_parameters()]
    if mode == "full":
        return {n: True for n in names}
    if mode == "temporal":
        return {n: TEMPORAL_SCOPE in n for n in names}
    raise ValueError(f"trainable_mask undefined for mode {mode!r}")


def param_audit(mask: Dict[str, bool]) -> Tuple[List[str], List[str]]:
    """(frozen names, trainable names): the reference's params_freeze.txt /
    params_train.txt dump."""
    return ([n for n, m in mask.items() if not m], [n for n, m in mask.items() if m])


def ema_decay_schedule(step: int, max_decay: float = 0.9999) -> torch.Tensor:
    s = torch.tensor(float(step), dtype=torch.float32)
    return torch.minimum(torch.tensor(max_decay, dtype=torch.float32), (1.0 + s) / (10.0 + s))


@torch.no_grad()
def ema_update_(ema: Sequence[torch.Tensor], params: Sequence[torch.Tensor], step: int,
                max_decay: float = 0.9999) -> None:
    """In place: e <- e·d + p·(1 - d), d = ema_decay_schedule(step)."""
    d = ema_decay_schedule(step, max_decay).item()
    for e, p in zip(ema, params):
        e.mul_(d).add_(p.to(e.dtype), alpha=1.0 - d)


@dataclasses.dataclass
class TrainState:
    step: int
    names: List[str]                  # the trainable UNet parameters, in module order
    params: List[torch.Tensor]        # their f32 masters
    optimizer: ClippedAdamW
    ema_params: Optional[List[torch.Tensor]] = None   # full scope with use_ema
    lora: Optional[lora_lib.Adapter] = None           # 'lora' scope: `params`, by target

    def state_dict(self) -> dict:
        """Everything a resume needs, as a snapshot in CPU tensors (copies,
        also of CPU tensors): the step, the f32 masters (in the 'lora' scope
        the adapter's A and B, by peft key), the EMA copies and the
        optimizer's state."""
        snap = lambda t: t.detach().to("cpu", copy=True)
        cpu = lambda ts: {n: snap(t) for n, t in zip(self.names, ts)}
        opt = self.optimizer.state_dict()
        adamw = {"param_groups": opt["adamw"]["param_groups"],
                 "state": {i: {k: snap(v) for k, v in s.items()}
                           for i, s in opt["adamw"]["state"].items()}}
        return {"step": self.step, "params": cpu(self.params),
                "ema_params": None if self.ema_params is None else cpu(self.ema_params),
                "optimizer": {"count": opt["count"], "adamw": adamw}}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """In place, onto this state's tensors and devices; raises where the
        names, shapes or the EMA's presence differ. The networks' compute
        copies are the caller's to refresh."""
        if list(sd["params"]) != self.names:
            raise ValueError("checkpoint holds other trainable tensors than this state")
        if (sd["ema_params"] is None) != (self.ema_params is None):
            raise ValueError("checkpoint and state differ in holding an EMA")
        pairs = list(zip(self.params, sd["params"].values()))
        if self.ema_params is not None:
            pairs += zip(self.ema_params, sd["ema_params"].values())
        for dst, src in pairs:
            if dst.shape != src.shape:
                raise ValueError(f"shape {tuple(src.shape)} in the checkpoint, "
                                 f"{tuple(dst.shape)} in the state")
            dst.copy_(src)
        self.optimizer.load_state_dict(sd["optimizer"])
        self.step = int(sd["step"])


def create_train_state(cfg: TrainConfig, models: SVDModels,
                       generator: Optional[torch.Generator] = None) -> TrainState:
    """f32 masters of the scope's UNet parameters (from the networks' current
    weights), the optimizer over them, the EMA copies; the networks' own
    parameters require grad exactly where the scope trains. The 'lora'
    scope instead draws an adapter from `generator` (seed 0 by default, as
    the JAX package's key): `params` are its f32 A and B, `names` their peft
    keys, and no network parameter requires grad."""
    if cfg.train_mode == "lora":
        for net in (models.unet, models.vae, models.clip):
            net.requires_grad_(False)
        if generator is None:
            generator = torch.Generator(models.unet.conv_in.weight.device).manual_seed(0)
        adapter = lora_lib.init(models.unet, cfg.lora_rank, generator)
        sd = lora_state_dict(adapter)
        params = [p.requires_grad_(True) for p in sd.values()]
        return TrainState(0, list(sd), params, make_optimizer(cfg, params), lora=adapter)
    mask = trainable_mask(models.unet, cfg.train_mode)
    named = dict(models.unet.named_parameters())
    names = [n for n, m in mask.items() if m]
    masters = [named[n].detach().float().clone() for n in names]
    for n, p in named.items():
        p.requires_grad_(mask[n])
    models.vae.requires_grad_(False)
    models.clip.requires_grad_(False)
    ema = ([m.clone() for m in masters]
           if cfg.use_ema and cfg.train_mode == "full" else None)
    return TrainState(0, names, masters, make_optimizer(cfg, masters), ema)


def cast_frozen_to_compute(models: SVDModels, dtype: torch.dtype) -> SVDModels:
    """Store every network's weights in the compute dtype, in place (the
    parameters stay the same objects, so the state's names and the
    requires_grad flags hold). The frozen ones are cast at every use anyway
    (a bf16 copy of an f32 weight equals a bf16 weight), so f32 storage buys
    nothing; the trainable ones keep their f32 masters in the TrainState."""
    for net in (models.unet, models.vae, models.clip):
        net.to(dtype)
    return models


def loss_and_grads(models: SVDModels, cfg: TrainConfig, state: TrainState,
                   pixels: torch.Tensor, draws: TrainDraws):
    """One micro-batch's loss and its gradients with respect to the tensors
    the scope trains: the UNet's compute copies of the masters, or the
    adapter itself. Unused tensors (the q/k projections of the single-token
    cross-attentions and their adapters) get zero gradients, as under
    jax.grad. The backward runs under the profiler label ``train.backward``."""
    if state.lora is None:
        named = dict(models.unet.named_parameters())
        wrt, scope = [named[n] for n in state.names], contextlib.nullcontext()
    else:
        wrt, scope = state.params, lora_lib.merged(models.unet, state.lora, cfg.lora_alpha)
    with scope:
        loss = training_loss(models, pixels, cfg, draws)
        with torch.profiler.record_function("train.backward"):
            grads = torch.autograd.grad(loss, wrt, materialize_grads=True)
    return loss, grads


def make_train_step(models: SVDModels, cfg: TrainConfig):
    """Build ``step(state, batch, *, generator=None, draws=None) -> (state,
    metrics)``. `batch` is (accum, B, F, H, W, 3) pixels in [-1, 1] when
    gradient_accumulation_steps > 1, else (B, F, H, W, 3). `draws` (one
    TrainDraws, or a list of one per micro-batch) replaces the draws from
    `generator`. Metrics: loss, grad_norm (before clipping), lr (applied).
    The backward and the update run under the profiler labels
    ``train.backward`` and ``train.optimizer``."""
    cfg.check_ported()
    accum = cfg.gradient_accumulation_steps

    def step(state: TrainState, batch: torch.Tensor, *,
             generator: Optional[torch.Generator] = None, draws=None):
        micro = batch if accum > 1 else batch[None]
        if draws is None:
            draws = [sample_train_draws(models, micro.shape[1:], cfg, generator,
                                        batch.device) for _ in range(accum)]
        elif isinstance(draws, TrainDraws):
            draws = [draws]
        grads, loss_sum = None, 0.0
        for pixels, d in zip(micro, draws):
            loss, g = loss_and_grads(models, cfg, state, pixels, d)
            if grads is None:
                grads = [x.float() for x in g]
            else:
                for acc, x in zip(grads, g):
                    acc.add_(x.float())
            loss_sum = loss_sum + loss.detach()
            del loss, g
        with torch.profiler.record_function("train.optimizer"):
            if accum > 1:
                for acc in grads:
                    acc.div_(accum)
            lr, grad_norm = state.optimizer.step(grads)
            del grads
            if state.lora is None:
                named = dict(models.unet.named_parameters())
                with torch.no_grad():
                    for n, m in zip(state.names, state.params):
                        named[n].copy_(m)
            state.step += 1
            if state.ema_params is not None:
                ema_update_(state.ema_params, state.params, state.step, cfg.ema_decay)
        metrics = {"loss": (loss_sum / accum).item(), "grad_norm": grad_norm.item(),
                   "lr": lr}
        return state, metrics

    return step
