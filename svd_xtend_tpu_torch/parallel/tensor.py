"""Tensor parallelism over the 'model' mesh axis.

Port of the 'model' half of ``svd_xtend_tpu/core/mesh.py`` and
``parallel/sharding.py``. There the name rules of ``core/mesh.py:57-58``
shard the UNet's attention and feed-forward matrices column- or row-wise
over the axis and GSPMD inserts the collectives; here each rank of a model
group holds its part of those matrices as built (``SVDModels.create(...,
tp=)``; ``TensorShard`` is the part) and the collectives are explicit, each
an autograd ``Function`` whose backward is exact (Megatron's pair):

  - ``enter``: the identity forward, an all-reduce of the gradients in the
    backward, before the inputs of every column-parallel product (and the
    LayerNorm weights the fused GEGLU kernel applies after it), so the
    replicated layers before it get the whole gradient;
  - ``reduce``: an all-reduce forward, the identity backward, after every
    row-parallel product, before its bias;
  - ``gather_channels`` / ``scatter_channels``: ``proj_in`` and
    ``proj_out`` have a whole transformer between them whose LayerNorms
    need every channel, so they are not a pair: ``proj_in`` runs
    column-parallel and its channels are gathered; ``proj_out`` runs
    row-parallel on this rank's channels of the replicated tokens (the
    backward of that slice gathers the gradient) and is reduced.

The rules (``COLUMN_PARALLEL``, ``ROW_PARALLEL``: JAX's, in the diffusers
names) apply to 2-D weights; the bias of a row-parallel product stays whole
and is added once, after the all-reduce; that of a column-parallel one is
split with its rows. How each tensor splits (``layout``):

  - attention (``to_q``/``to_k``/``to_v`` rows, ``to_out.0`` columns): by
    whole heads, as evenly as they go, the lower ranks one more
    (``split``): at 5 heads over 2 ranks 3 and 2. JAX's even column split
    would cut a head in two. A rank without a head runs the projections
    empty and adds a zero partial;
  - the feed-forward (``net.0.proj`` rows, ``net.2`` columns): the inner
    width in blocks of 64 (the GEGLU kernel's W1 packing), as evenly as
    they go, and ``net.0.proj``'s value rows and gate rows alike (the
    rank takes rows [a, b) of each half, not one half: ``paired``);
  - ``proj_in`` rows and ``proj_out`` columns: the channels, as evenly as
    they go.

Only the UNet's transformers are split. The Tracklet2Video branch (whose
names the JAX rules match too), CLIP's ``fc1``/``fc2`` and the VAE's
attention stay replicated: the math is the same either way, and they run
once a video or a step. ``shard_state_dict`` slices a whole state dict
(``state_dict_from_jax``'s, a checkpoint's) for a rank; ``unshard`` joins
the ranks' parts again (a checkpoint, the export).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .frames import STAGED, comm_device

# core/mesh.py:57-58 in the diffusers names (net_0_proj is net.0.proj, to_out
# is to_out.0, net_2 is net.2)
COLUMN_PARALLEL = re.compile(r"(to_q|to_k|to_v|net\.0\.proj|fc1|proj_in)$")
ROW_PARALLEL = re.compile(r"(to_out\.0|net\.2|fc2|proj_out)$")
FF_UNIT = 64        # ops/kernels/geglu.py's PAIR_ROWS: W1 is packed in blocks of 64 rows
_LEVEL = re.compile(r"^(?:down_blocks\.(\d+)|(mid_block)|up_blocks\.(\d+))\.attentions\.")


def split(total: int, n: int, unit: int = 1) -> List[int]:
    """`total` (a multiple of `unit`) over n ranks in units of `unit`, as
    evenly as it goes, the lower ranks one unit more."""
    if total % unit:
        raise ValueError(f"{total} does not split in units of {unit}")
    units = total // unit
    return [(units // n + (1 if r < units % n else 0)) * unit for r in range(n)]


def ff_split(inner: int, n: int) -> List[int]:
    """The feed-forward's inner width over n ranks: in blocks of FF_UNIT
    where it is a multiple of them."""
    return split(inner, n, FF_UNIT if inner % FF_UNIT == 0 else 1)


@dataclasses.dataclass(frozen=True)
class TensorShard:
    """This rank's part of the model axis: index `index` of the model group
    `group` of global ranks `ranks` (in model order)."""

    group: object
    ranks: Tuple[int, ...]
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)

    def heads(self, num_heads: int) -> int:
        """This rank's heads of `num_heads`."""
        return split(num_heads, self.size)[self.index]

    def ff(self, inner: int) -> int:
        """This rank's feed-forward width of `inner`."""
        return ff_split(inner, self.size)[self.index]

    def channels(self, c: int) -> List[int]:
        """Every rank's channels of `c` (proj_in's outputs, proj_out's inputs)."""
        return split(c, self.size)


@dataclasses.dataclass(frozen=True)
class Layout:
    """How a tensor splits over the model axis: along `dim` in `sizes` (one
    per rank); `paired`: each half of `dim` splits alike (GEGLU's W1 and
    b1: value rows, then gate rows)."""

    dim: int
    sizes: Tuple[int, ...]
    paired: bool = False

    def bounds(self, index: int) -> Tuple[int, int]:
        """(start, count) of rank `index`'s part along `dim` (of each half
        where `paired`)."""
        return sum(self.sizes[:index]), self.sizes[index]

    def shard(self, t: torch.Tensor, index: int) -> torch.Tensor:
        """Rank `index`'s part of the whole `t` (a copy)."""
        start, count = self.bounds(index)
        halves = t.chunk(2, self.dim) if self.paired else (t,)
        return torch.cat([h.narrow(self.dim, start, count) for h in halves], self.dim).clone()

    def whole_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The whole tensor's shape, from the shape of a part."""
        out = list(shape)
        out[self.dim] = sum(self.sizes) * (2 if self.paired else 1)
        return tuple(out)

    def unshard(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The whole tensor from every rank's part, in rank order."""
        if not self.paired:
            return torch.cat(list(parts), self.dim)
        half = lambda p, i: p.narrow(self.dim, i * (p.shape[self.dim] // 2),
                                     p.shape[self.dim] // 2)
        return torch.cat([half(p, 0) for p in parts] + [half(p, 1) for p in parts], self.dim)


def _branch(key: str) -> bool:
    # the Tracklet2Video branch (io/convert.py::is_branch_key): replicated
    return key.startswith("tracklet_conditioner.") or ".gated_attentions." in key


def layout(key: str, config, n: int) -> Optional[Layout]:
    """How UNet state-dict entry `key` of a UNet of `config` splits over n
    model ranks, or None where it is replicated."""
    if n == 1 or _branch(key):
        return None
    module, _, leaf = key.rpartition(".")
    col, row = COLUMN_PARALLEL.search(module), ROW_PARALLEL.search(module)
    if not (col or row) or (row and leaf != "weight"):
        return None
    m = _LEVEL.match(key)
    if m is None:
        raise ValueError(f"{key}: a tensor-parallel rule outside the UNet's transformers")
    levels = len(config.block_out_channels)
    level = (int(m.group(1)) if m.group(1) is not None
             else levels - 1 if m.group(2) else levels - 1 - int(m.group(3)))
    c, heads = config.block_out_channels[level], config.num_attention_heads[level]
    name = (col or row).group(1)
    if name in ("to_q", "to_k", "to_v", "to_out.0"):
        sizes = [h * (c // heads) for h in split(heads, n)]
    elif name in ("net.0.proj", "net.2"):
        sizes = ff_split(4 * c, n)
    else:
        sizes = split(c, n)
    return Layout(0 if col else 1, tuple(sizes), name == "net.0.proj")


def shard_state_dict(sd: Mapping[str, torch.Tensor], tp: Optional[TensorShard],
                     config) -> Dict[str, torch.Tensor]:
    """A whole UNet state dict sliced for the model rank `tp` (as it is
    without one), for ``load_state_dict(strict=True)`` into a UNet built
    with `tp`."""
    if tp is None:
        return dict(sd)
    out = {}
    for k, v in sd.items():
        lay = layout(k, config, tp.size)
        out[k] = v if lay is None else lay.shard(v, tp.index)
    return out


# ------------------------------------------------------------ collectives --

def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's `t` over `group`, as a new tensor."""
    dev = comm_device(t.device)
    staged = STAGED.to(t.contiguous(), dev, copy=True)
    dist.all_reduce(staged, group=group)
    return STAGED.to(staged, t.device)


def _all_gather_last(x: torch.Tensor, tp: TensorShard, sizes: Sequence[int]) -> torch.Tensor:
    """Every rank's `x` (its sizes[r] entries of the last axis) joined along
    the last axis; the parts are padded to the largest for the gather."""
    width = max(sizes)
    dev = comm_device(x.device)
    part = x.new_zeros(x.shape[:-1] + (width,))
    part[..., :x.shape[-1]] = x
    part = STAGED.to(part, dev)
    parts = [torch.empty_like(part) for _ in range(tp.size)]
    dist.all_gather(parts, part, group=tp.group)
    whole = torch.cat([p[..., :n] for p, n in zip(parts, sizes)], dim=-1)
    return STAGED.to(whole, x.device)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tp, *xs):
        ctx.tp = tp
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        out = list(grads)
        for dtype in {g.dtype for g in grads}:
            idx = [i for i, g in enumerate(grads) if g.dtype == dtype]
            flat = _all_reduce(torch.cat([grads[i].reshape(-1) for i in idx]), ctx.tp.group)
            for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
                out[i] = part.view_as(grads[i])
        return (None, *out)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x, tp.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, sizes):
        ctx.start, ctx.count = sum(sizes[:tp.index]), sizes[tp.index]
        return _all_gather_last(x, tp, sizes)

    @staticmethod
    def backward(ctx, g):
        # downstream of the gather every rank computes the same: its
        # gradient is the whole one on every rank
        return g.narrow(-1, ctx.start, ctx.count).contiguous(), None, None


class _ScatterChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, sizes):
        ctx.tp, ctx.sizes = tp, sizes
        return x.narrow(-1, sum(sizes[:tp.index]), sizes[tp.index]).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather_last(g.contiguous(), ctx.tp, ctx.sizes), None, None


def enter(tp: TensorShard, *xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """`xs` as they are; in the backward their gradients are summed over the
    model group (every rank's column-parallel part adds its share)."""
    return _Enter.apply(tp, *xs)


def reduce(x: torch.Tensor, tp: TensorShard) -> torch.Tensor:
    """The sum of every model rank's partial `x` (a row-parallel product)."""
    return _Reduce.apply(x, tp)


def gather_channels(x: torch.Tensor, tp: TensorShard, sizes: Sequence[int]) -> torch.Tensor:
    """(..., sizes[r]) this rank's channels -> (..., Σ sizes) every rank's."""
    return _GatherChannels.apply(x, tp, tuple(sizes))


def scatter_channels(x: torch.Tensor, tp: TensorShard, sizes: Sequence[int]) -> torch.Tensor:
    """(..., Σ sizes) replicated -> (..., sizes[r]) this rank's channels."""
    return _ScatterChannels.apply(x, tp, tuple(sizes))


@torch.no_grad()
def all_reduce_sum_(t: torch.Tensor, group) -> torch.Tensor:
    """In place: the sum of every rank's `t` over `group` (no gradient)."""
    t.copy_(_all_reduce(t, group))
    return t
