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

The blocks are cut in the flattening order of the JAX leaf each tensor
maps to (``io/convert.py::flax_axes``: a Linear's (out, in) as (in, out), a
conv's (out, in, kh, kw) as (kh, kw, in, out)), so the codes and scales are
JAX's; a state dict carries that order's mark (``BLOCK_ORDER``), and one
without it, whose blocks were cut in torch's order, is refused.

Under a 'model' mesh axis a tensor may be a model rank's part of a whole
one (``Part``). The codes and scales are then the whole tensor's, as JAX's
GSPMD computes them: each rank keeps the codes of its own values and the
scale of every block of the whole tensor; an update first takes each
rank's absmax of its values of every block (``sync_scales``), one MAX
all-reduce over the model group joins them for every tensor at once, and
then each rank quantises its values with the whole blocks' scales.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ..parallel.frames import all_reduce_max_
from ..parallel.tensor import Layout

_INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()

# the state dict's mark of the blocks' order: the JAX leaves' flattening
BLOCK_ORDER = "jax"

Axes = Optional[Tuple[int, ...]]


class Quantized(NamedTuple):
    """Blockwise int8 tensor: q (nblocks, block) int8, scale (nblocks, 1) f32.
    The shape is not stored: dequantize takes it from the caller. A model
    rank's part (``Part``) holds q (values,) of its own values and the
    scale of every block of the whole tensor."""

    q: torch.Tensor
    scale: torch.Tensor


Moment = Union[Quantized, torch.Tensor]


def _inverse(axes: Sequence[int]) -> Tuple[int, ...]:
    out = [0] * len(axes)
    for i, a in enumerate(axes):
        out[a] = i
    return tuple(out)


def jax_order(x: torch.Tensor, axes: Axes = None) -> torch.Tensor:
    """x's values flattened in its JAX leaf's order (``flax_axes``)."""
    return (x if axes is None else x.permute(axes)).reshape(-1)


def from_jax_order(flat: torch.Tensor, shape: Sequence[int], axes: Axes = None) -> torch.Tensor:
    """``jax_order``'s inverse: the tensor of torch `shape` (a strided view)."""
    if axes is None:
        return flat.reshape(shape)
    return flat.reshape([shape[a] for a in axes]).permute(_inverse(axes))


def quantize_blockwise(x: torch.Tensor, block_size: int = 2048, axes: Axes = None) -> Quantized:
    """Linear signed-int8 absmax quantization over flat blocks of x in its
    JAX order."""
    flat = jax_order(x, axes).float()
    n = flat.numel()
    nb = -(-n // block_size)
    blocks = F.pad(flat, (0, nb * block_size - n)).reshape(nb, block_size)
    scale = blocks.abs().amax(dim=1, keepdim=True) * _INV_127
    q = torch.round(blocks / scale.clamp_min(1e-30))
    return Quantized(q.to(torch.int8), scale)


def dequantize_blockwise(qt: Quantized, shape, axes: Axes = None) -> torch.Tensor:
    n = math.prod(shape)
    return from_jax_order((qt.q.float() * qt.scale).reshape(-1)[:n], shape, axes)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root (XLA's and the card's): torch's
    vectorised CPU kernel is off by an ulp in ~0.7 % of values, so the CPU
    rounds the f64 root (exact: 53 >= 2·24 + 2 bits)."""
    return torch.sqrt(x.double()).float() if x.device.type == "cpu" else torch.sqrt(x)


def quantize_sqrt(x: torch.Tensor, block_size: int = 2048, axes: Axes = None) -> Quantized:
    """For non-negative tensors (the second moment): quantize sqrt(x)."""
    return quantize_blockwise(_sqrt(x), block_size, axes)


def dequantize_sqrt(qt: Quantized, shape, axes: Axes = None) -> torch.Tensor:
    s = dequantize_blockwise(qt, shape, axes)
    return s * s


class Part(NamedTuple):
    """A model rank's part of a whole tensor (``parallel/tensor.py``): how
    the whole splits (`layout`), the rank's `index`, the whole's torch
    `shape`."""

    layout: Layout
    index: int
    shape: Tuple[int, ...]

    def positions(self, axes: Axes, device) -> torch.Tensor:
        """Where each of the part's values, taken in the part's own JAX
        order, stands in the whole tensor's JAX order (int64)."""
        whole = from_jax_order(torch.arange(math.prod(self.shape), device=device), self.shape,
                               axes)
        return jax_order(self.layout.shard(whole, self.index), axes)


def join_parts(pieces: Sequence[dict], parts: Sequence[Part], axes: Axes,
               block_size: int = 2048) -> dict:
    """The whole tensor's quantized moment ``{"q", "scale"}`` from every
    model rank's (its `pieces`, CPU tensors, in model order)."""
    scale = pieces[0]["scale"]
    q = torch.zeros(scale.shape[0] * block_size, dtype=torch.int8)
    for piece, part in zip(pieces, parts):
        q[part.positions(axes, "cpu")] = piece["q"]
    return {"q": q.reshape(-1, block_size), "scale": scale}


def part_of(whole: dict, part: Part, axes: Axes) -> dict:
    """``join_parts``'s inverse: `part`'s piece of a whole quantized moment."""
    q = whole["q"].reshape(-1)[part.positions(axes, whole["q"].device)]
    return {"q": q, "scale": whole["scale"].clone()}


class AdamW8bit:
    """AdamW over f32 `params` with blockwise-int8 moments (f32 for tensors
    under min_quant_size values). ``step(grads, lr)`` applies one update
    in place; the update count is the optimizer's own. `axes`: each
    tensor's ``flax_axes`` (None: flattened as it is). `parts`: each
    tensor's ``Part`` where it is a model rank's part of a whole one (None
    elsewhere), whose block absmaxes are joined over the process `group`."""

    def __init__(self, params: Sequence[torch.Tensor], b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-2, block_size: int = 2048,
                 min_quant_size: int = 4096, axes: Optional[Sequence[Axes]] = None,
                 parts: Optional[Sequence[Optional[Part]]] = None, group=None):
        self.params = list(params)
        n = len(self.params)
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.block_size, self.min_quant_size = block_size, min_quant_size
        self.axes: List[Axes] = list(axes) if axes is not None else [None] * n
        self.parts: List[Optional[Part]] = list(parts) if parts is not None else [None] * n
        self.group = group
        self.count = 0
        self._scales: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.mu: List[Moment] = [self._zeros(i) for i in range(n)]
        self.nu: List[Moment] = [self._zeros(i) for i in range(n)]

    def quantized(self, i: int) -> bool:
        """Whether tensor i's moments are int8: its whole tensor's size."""
        part = self.parts[i]
        n = math.prod(part.shape) if part is not None else self.params[i].numel()
        return n >= self.min_quant_size

    def _zeros(self, i: int) -> Moment:
        p, part = self.params[i], self.parts[i]
        z = lambda shape, dtype: torch.zeros(shape, dtype=dtype, device=p.device)
        if not self.quantized(i):
            return z(p.shape, torch.float32)
        if part is None:
            return quantize_blockwise(z(p.shape, torch.float32), self.block_size)
        nb = -(-math.prod(part.shape) // self.block_size)
        return Quantized(z((p.numel(),), torch.int8), z((nb, 1), torch.float32))

    def _split(self, i: int) -> bool:
        """Whether tensor i is a model rank's part with int8 moments."""
        return self.parts[i] is not None and self.quantized(i)

    def _blocks(self, i: int, device) -> Optional[torch.Tensor]:
        """The whole tensor's block of each of a quantized part's values."""
        if not self._split(i):
            return None
        return self.parts[i].positions(self.axes[i], device) // self.block_size

    def _dequantize(self, i: int, qt: Moment, g: torch.Tensor, blocks, sqrt: bool):
        if not isinstance(qt, Quantized):
            return qt.to(g.device)
        qt = Quantized(qt.q.to(g.device), qt.scale.to(g.device))
        if blocks is None:
            return (dequantize_sqrt if sqrt else dequantize_blockwise)(qt, g.shape, self.axes[i])
        s = from_jax_order(qt.q.float() * qt.scale.reshape(-1)[blocks], g.shape, self.axes[i])
        return s * s if sqrt else s

    def _moments(self, i: int, g: torch.Tensor, blocks):
        """Tensor i's f32 moments updated with its gradient g (torch-shaped)."""
        g32 = g.float()
        m = self._dequantize(i, self.mu[i], g, blocks, False)
        v = self._dequantize(i, self.nu[i], g, blocks, True)
        return (self.b1 * m + (1.0 - self.b1) * g32,
                self.b2 * v + (1.0 - self.b2) * g32 * g32)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], lr: float) -> None:
        corrections = self.begin_step()
        self.sync_scales(list(enumerate(grads)))
        for i, g in enumerate(grads):
            self.update(i, g, lr, corrections)

    def begin_step(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Count one update; its bias corrections (c1, c2), for ``update``."""
        self.count += 1
        count = torch.tensor(float(self.count), dtype=torch.float32)
        return (1.0 - torch.tensor(self.b1, dtype=torch.float32) ** count,
                1.0 - torch.tensor(self.b2, dtype=torch.float32) ** count)

    @torch.no_grad()
    def sync_scales(self, items: Sequence[Tuple[int, torch.Tensor]]) -> None:
        """Before the ``update``s of a step, for the quantized parts among
        `items` ((i, gradient) pairs): the block absmaxes of their updated
        moments, the largest over the model group (one all-reduce), kept as
        the scales ``update`` quantizes them with. Every rank of the group
        calls it with the same tensors."""
        todo = [(i, g) for i, g in items if self._split(i)]
        if not todo:
            return
        amaxes = []
        for i, g in todo:
            blocks = self._blocks(i, g.device)
            nb = self.mu[i].scale.shape[0]
            m, v = self._moments(i, g, blocks)
            for x in (m, _sqrt(v)):
                amaxes.append(torch.zeros(nb, device=g.device).scatter_reduce_(
                    0, blocks, jax_order(x, self.axes[i]).abs(), "amax"))
        flat = all_reduce_max_(torch.cat(amaxes), self.group) * _INV_127
        scales = flat.split([a.numel() for a in amaxes])
        self._scales = {i: (scales[2 * k].reshape(-1, 1), scales[2 * k + 1].reshape(-1, 1))
                        for k, (i, _) in enumerate(todo)}

    @torch.no_grad()
    def update(self, i: int, g: torch.Tensor, lr: float, corrections) -> None:
        """Update tensor `i` of `params` with its gradient `g` (the moments
        and the parameter on g's device), within the step ``begin_step``
        counted (and, for a quantized part, ``sync_scales`` joined)."""
        p = self.params[i]
        c1d, c2d = (c.to(p.device) for c in corrections)
        axes, blocks = self.axes[i], self._blocks(i, g.device)
        m, v = self._moments(i, g, blocks)
        u = ((m / c1d) / (_sqrt(v / c2d) + self.eps)).to(g.dtype)
        if not self.quantized(i):
            self.mu[i], self.nu[i] = m, v
        elif blocks is None:
            self.mu[i] = quantize_blockwise(m, self.block_size, axes)
            self.nu[i] = quantize_sqrt(v, self.block_size, axes)
        else:
            if i not in self._scales:
                raise RuntimeError(f"8-bit Adam: the part {i} updated before sync_scales")
            for lst, x, scale in zip((self.mu, self.nu), (m, _sqrt(v)), self._scales.pop(i)):
                flat = jax_order(x, axes)
                q = torch.round(flat / scale.reshape(-1)[blocks].clamp_min(1e-30))
                lst[i] = Quantized(q.to(torch.int8), scale)
        p.add_((u + self.weight_decay * p) * -lr)

    def state_dict(self) -> dict:
        """The count, the blocks' order and both moments by position in
        `params` (a quantized moment as its codes and scales); tensors are
        the live ones."""
        pack = lambda m: {"q": m.q, "scale": m.scale} if isinstance(m, Quantized) else m
        return {"count": self.count, "block_order": BLOCK_ORDER,
                "mu": [pack(m) for m in self.mu], "nu": [pack(m) for m in self.nu]}

    def load_state_dict(self, sd: dict) -> None:
        """Restore what state_dict gave onto the parameters' devices; raises
        where a moment's form or shape differs, and for moments blocked in
        another order."""
        _check_block_order(sd)
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


def _check_block_order(sd: dict) -> None:
    """Raise for an 8-bit Adam state dict whose blocks were cut in another
    order than ``BLOCK_ORDER`` (one without the mark: torch's flattening)."""
    order = sd.get("block_order", "torch")
    if order != BLOCK_ORDER:
        raise ValueError(f"8-bit Adam moments blocked in {order!r} order (a checkpoint written "
                         f"before the moments took the JAX package's block order, "
                         f"{BLOCK_ORDER!r}): its codes and scales belong to other blocks and "
                         "are not loaded")
