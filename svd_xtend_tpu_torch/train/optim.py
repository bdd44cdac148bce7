"""LR schedules, the f32 global-norm clip and AdamW.

Port of ``svd_xtend_tpu/train/optim.py``: the six named schedules of
diffusers' ``get_scheduler`` (linear, cosine, cosine_with_restarts,
polynomial, constant, constant_with_warmup, each with linear warmup), the
``scale_lr`` rule, ``global_norm_f32`` and the clip of
``clip_by_global_norm_f32`` (keep the gradients when the norm is below
max_norm, else scale them by max_norm / norm, all in f32; unlike
``torch.nn.utils.clip_grad_norm_``, which adds 1e-6 and always multiplies),
then ``torch.optim.AdamW`` (decoupled decay, eps outside the square root:
``optax.adamw``), or with ``use_8bit_adam`` the int8-moment AdamW of
``train/quant.py`` (the JAX package's ``adamw_8bit``). The schedule value
applied at an update is the one at the count of updates before it, as in
optax. Gradients may be bf16 (``grad_dtype="bf16"``): the clip scales them
in f32 and rounds back, and AdamW reads them as f32 against the f32
masters.
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence, Tuple

import torch

from ..core.config import TrainConfig
from .quant import AdamW8bit

Schedule = Callable[[int], float]


def get_schedule(name: str, base_lr: float, warmup_steps: int, total_steps: int,
                 num_cycles: float = 0.5, power: float = 1.0) -> Schedule:
    warmup_steps = max(0, warmup_steps)
    decay_steps = max(1, total_steps - warmup_steps)

    def warmup(step):
        return 1.0 if warmup_steps == 0 else min(1.0, step / warmup_steps)

    def progress(step):
        return min(max((step - warmup_steps) / decay_steps, 0.0), 1.0)

    if name == "constant":
        return lambda step: base_lr
    if name == "constant_with_warmup":
        return lambda step: base_lr * warmup(step)
    if name == "linear":
        return lambda step: base_lr * warmup(step) * (1.0 - progress(step))
    if name == "cosine":
        return lambda step: base_lr * warmup(step) * 0.5 * (
            1.0 + math.cos(math.pi * 2.0 * num_cycles * progress(step)))
    if name == "cosine_with_restarts":
        cycles = max(1, int(num_cycles) if num_cycles >= 1 else 1)

        def sched(step):
            p = progress(step)
            alive = 1.0 if p < 1.0 else 0.0
            return base_lr * warmup(step) * alive * 0.5 * (
                1.0 + math.cos(math.pi * ((p * cycles) % 1.0)))
        return sched
    if name == "polynomial":
        lr_end = 1e-7
        return lambda step: ((base_lr - lr_end) * (1.0 - progress(step)) ** power
                             * warmup(step) + lr_end)
    raise ValueError(f"unknown lr_scheduler {name!r}")


def training_schedule(cfg: TrainConfig, num_processes: int = 1) -> Schedule:
    """The schedule the optimizer applies (and the one to report)."""
    lr = cfg.learning_rate
    if cfg.scale_lr:
        lr = lr * cfg.gradient_accumulation_steps * cfg.per_device_batch_size * num_processes
    return get_schedule(cfg.lr_scheduler, lr, cfg.lr_warmup_steps * num_processes,
                        cfg.max_train_steps * num_processes)


def global_norm_f32(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, accumulated in f32."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def clip_by_global_norm_f32_(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """In place: when the f32 global norm is not below max_norm, scale every
    gradient by max_norm / norm. Returns the norm before clipping."""
    norm = global_norm_f32(grads)
    if norm.item() >= max_norm:
        for g in grads:
            g.copy_(g.float() / norm * max_norm)
    return norm


class ClippedAdamW:
    """The optimizer chain of ``make_optimizer``: the f32 global-norm clip
    (when max_grad_norm > 0), then AdamW at the schedule's learning rate
    (``torch.optim.AdamW``, or ``AdamW8bit`` with ``use_8bit_adam``).
    Steps f32 `params` (the masters) with gradients given per step."""

    CHUNK = 32      # parameters whose bf16 gradients are copied to f32 at once

    def __init__(self, params: List[torch.Tensor], schedule: Schedule, cfg: TrainConfig):
        self.params, self.schedule = params, schedule
        self.max_grad_norm = cfg.max_grad_norm
        self.count = 0
        self.adamw = self.adamw8 = None
        if cfg.use_8bit_adam:
            self.adamw8 = AdamW8bit(params, cfg.adam_beta1, cfg.adam_beta2, cfg.adam_epsilon,
                                    cfg.adam_weight_decay)
        else:
            self.adamw = torch.optim.AdamW(
                params, lr=schedule(0), betas=(cfg.adam_beta1, cfg.adam_beta2),
                eps=cfg.adam_epsilon, weight_decay=cfg.adam_weight_decay)

    def step(self, grads: List[torch.Tensor]) -> Tuple[float, torch.Tensor]:
        """One update with `grads` (f32 or bf16, aligned with params;
        clipped in place). Returns the learning rate it applied and the f32
        global norm of the gradients before clipping."""
        if self.max_grad_norm and self.max_grad_norm > 0:
            norm = clip_by_global_norm_f32_(grads, self.max_grad_norm)
        else:
            norm = global_norm_f32(grads)
        lr = float(self.schedule(self.count))
        if self.adamw8 is not None:
            self.adamw8.step(grads, lr)
        else:
            for group in self.adamw.param_groups:
                group["lr"] = lr
            # AdamW reads gradients of the masters' dtype: bf16 ones are
            # copied to f32 CHUNK tensors at a time (AdamW skips a parameter
            # without a gradient), so the f32 copies never all exist at once
            n = len(self.params)
            same = all(g.dtype == p.dtype for p, g in zip(self.params, grads))
            for i in range(0, n, n if same else self.CHUNK):
                part = self.params[i:i + (n if same else self.CHUNK)]
                for p, g in zip(part, grads[i:i + len(part)]):
                    p.grad = g.to(p.dtype)
                self.adamw.step()
                for p in part:
                    p.grad = None
        self.count += 1
        return lr, norm

    def state_dict(self) -> dict:
        """The update count and the optimizer's state by position in
        `params`: AdamW's (its step and both moments per parameter) under
        "adamw", or the 8-bit one's under "adamw8". The tensors are the
        live ones."""
        if self.adamw8 is not None:
            return {"count": self.count, "adamw8": self.adamw8.state_dict()}
        return {"count": self.count, "adamw": self.adamw.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        """Restore what state_dict gave onto the parameters' devices; raises
        for the state of the other optimizer."""
        key = "adamw8" if self.adamw8 is not None else "adamw"
        if key not in sd:
            raise ValueError(f"checkpoint holds {', '.join(k for k in sd if k != 'count')} "
                             f"optimizer state, this run's optimizer is {key}")
        self.count = int(sd["count"])
        if self.adamw8 is not None:
            self.adamw8.load_state_dict(sd["adamw8"])
        else:
            self.adamw.load_state_dict(sd["adamw"])


def make_optimizer(cfg: TrainConfig, params: List[torch.Tensor],
                   num_processes: int = 1) -> ClippedAdamW:
    cfg.check_ported()
    return ClippedAdamW(params, training_schedule(cfg, num_processes), cfg)
