"""Blockwise int8 Adam moments: the 8-bit AdamW (reference --use_8bit_adam,
bitsandbytes' AdamW8bit, train_svd.py:414-417, 746-756).

Port of ``svd_xtend_tpu/train/quant.py``. Both moments are stored as int8
with one f32 absmax scale per ``block_size`` values of the flattened tensor
(the last block zero-padded): the first moment linearly signed, the second
(non-negative) through its square root. Tensors under ``min_quant_size``
values keep f32 moments, as bitsandbytes' min_8bit_size does. At the full
scope's 1.52e9 values the two moments take 3.0 GB instead of 12.2 GB.

The update is ``optax.adamw``'s, chained as in the JAX package's
``adamw_8bit``: the moments are dequantized, updated in f32
(m = b1·m + (1 - b1)·g, v = b2·v + (1 - b2)·g·g), quantized again, and
u = (m / c1) / (sqrt(v / c2) + eps) with the bias corrections c1, c2 of
the update count, rounded to the gradient's dtype; then u + wd·p, times
-lr. The codes round half to even, the scales are absmax · f32(1/127), as
XLA compiles the JAX package's ``absmax / 127.0`` under jit, and the square
roots are correctly rounded, so the codes equal the jitted JAX functions'
bit for bit on the same values. Plain torch (elementwise work that
the JAX package also leaves to XLA): no kernel here.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

_INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()


class Quantized(NamedTuple):
    """Blockwise int8 tensor: q (nblocks, block) int8, scale (nblocks, 1) f32.
    The shape is not stored: dequantize takes it from the caller."""

    q: torch.Tensor
    scale: torch.Tensor


Moment = Union[Quantized, torch.Tensor]


def quantize_blockwise(x: torch.Tensor, block_size: int = 2048) -> Quantized:
    """Linear signed-int8 absmax quantization over flat blocks."""
    flat = x.reshape(-1).float()
    n = flat.numel()
    nb = -(-n // block_size)
    blocks = F.pad(flat, (0, nb * block_size - n)).reshape(nb, block_size)
    scale = blocks.abs().amax(dim=1, keepdim=True) * _INV_127
    q = torch.round(blocks / scale.clamp_min(1e-30))
    return Quantized(q.to(torch.int8), scale)


def dequantize_blockwise(qt: Quantized, shape) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    return (qt.q.float() * qt.scale).reshape(-1)[:n].reshape(shape)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root (XLA's and the card's): torch's
    vectorised CPU kernel is off by an ulp in ~0.7 % of values, so the CPU
    rounds the f64 root (exact: 53 >= 2·24 + 2 bits)."""
    return torch.sqrt(x.double()).float() if x.device.type == "cpu" else torch.sqrt(x)


def quantize_sqrt(x: torch.Tensor, block_size: int = 2048) -> Quantized:
    """For non-negative tensors (the second moment): quantize sqrt(x)."""
    return quantize_blockwise(_sqrt(x), block_size)


def dequantize_sqrt(qt: Quantized, shape) -> torch.Tensor:
    s = dequantize_blockwise(qt, shape)
    return s * s


class AdamW8bit:
    """AdamW over f32 `params` with blockwise-int8 moments (f32 for tensors
    under min_quant_size values). ``step(grads, lr)`` applies one update
    in place; the update count is the optimizer's own."""

    def __init__(self, params: Sequence[torch.Tensor], b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-2, block_size: int = 2048,
                 min_quant_size: int = 4096):
        self.params = list(params)
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.block_size, self.min_quant_size = block_size, min_quant_size
        self.count = 0
        self.mu: List[Moment] = [self._zeros(p, quantize_blockwise) for p in self.params]
        self.nu: List[Moment] = [self._zeros(p, quantize_sqrt) for p in self.params]

    def _zeros(self, p: torch.Tensor, quantize) -> Moment:
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return quantize(z, self.block_size) if p.numel() >= self.min_quant_size else z

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], lr: float) -> None:
        corrections = self.begin_step()
        for i, g in enumerate(grads):
            self.update(i, g, lr, corrections)

    def begin_step(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Count one update; its bias corrections (c1, c2), for ``update``."""
        self.count += 1
        count = torch.tensor(float(self.count), dtype=torch.float32)
        return (1.0 - torch.tensor(self.b1, dtype=torch.float32) ** count,
                1.0 - torch.tensor(self.b2, dtype=torch.float32) ** count)

    @torch.no_grad()
    def update(self, i: int, g: torch.Tensor, lr: float, corrections) -> None:
        """Update tensor `i` of `params` with its gradient `g` (the moments
        and the parameter on g's device), within the step ``begin_step``
        counted."""
        p = self.params[i]
        c1d, c2d = (c.to(p.device) for c in corrections)
        g32 = g.float()
        mq, nq = self.mu[i], self.nu[i]
        m = dequantize_blockwise(mq, g.shape) if isinstance(mq, Quantized) else mq
        v = dequantize_sqrt(nq, g.shape) if isinstance(nq, Quantized) else nq
        m = self.b1 * m + (1.0 - self.b1) * g32
        v = self.b2 * v + (1.0 - self.b2) * g32 * g32
        u = ((m / c1d) / (_sqrt(v / c2d) + self.eps)).to(g.dtype)
        self.mu[i] = quantize_blockwise(m, self.block_size) if isinstance(mq, Quantized) else m
        self.nu[i] = quantize_sqrt(v, self.block_size) if isinstance(nq, Quantized) else v
        p.add_((u + self.weight_decay * p) * -lr)

    def state_dict(self) -> dict:
        """The count and both moments by position in `params` (a quantized
        moment as its codes and scales); tensors are the live ones."""
        pack = lambda m: {"q": m.q, "scale": m.scale} if isinstance(m, Quantized) else m
        return {"count": self.count, "mu": [pack(m) for m in self.mu],
                "nu": [pack(m) for m in self.nu]}

    def load_state_dict(self, sd: dict) -> None:
        """Restore what state_dict gave onto the parameters' devices; raises
        where a moment's form or shape differs."""
        if len(sd["mu"]) != len(self.params) or len(sd["nu"]) != len(self.params):
            raise ValueError("8-bit Adam state for another number of tensors")

        def unpack(src, like: Moment) -> Moment:
            if isinstance(like, Quantized) != isinstance(src, dict):
                raise ValueError("8-bit Adam moment stored in another form")
            if isinstance(like, Quantized):
                out = Quantized(src["q"].to(like.q.device, copy=True),
                                src["scale"].to(like.scale.device, copy=True))
                shapes: Tuple = ((out.q.shape, like.q.shape), (out.scale.shape,
                                                               like.scale.shape))
            else:
                out = src.to(like.device, copy=True)
                shapes = ((out.shape, like.shape),)
            if any(a != b for a, b in shapes):
                raise ValueError(f"8-bit Adam moment of shape {shapes}")
            return out
        self.mu = [unpack(s, m) for s, m in zip(sd["mu"], self.mu)]
        self.nu = [unpack(s, m) for s, m in zip(sd["nu"], self.nu)]
        self.count = int(sd["count"])

    def moment_bytes(self) -> int:
        """Bytes the two moments hold (codes, scales and f32 moments)."""
        size = lambda t: t.numel() * t.element_size()
        return sum(size(m.q) + size(m.scale) if isinstance(m, Quantized) else size(m)
                   for m in self.mu + self.nu)
