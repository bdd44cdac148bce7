"""Sequence parallelism over the frame axis: the 'frames' mesh axis.

Port of the 'frames' half of ``svd_xtend_tpu/core/mesh.py`` and
``parallel/sharding.py``. There GSPMD shards a video's F axis over the
axis and inserts the collectives the temporal layers need; here each rank
of a frames group holds its frames of every video (``FrameShard``: F / n,
or where n does not divide F, as evenly as they go), the
spatial layers run on those frames alone, and the temporal layers reach the
other frames through explicit collectives, each an autograd ``Function``
whose backward is exact:

  - ``frames_to_tokens`` / ``tokens_to_frames``: an all-to-all that swaps
    the frames shard (B, F/n, S, C) for a token shard (B, F, S_r, C) and
    back (the temporal transformer block runs whole on the token shard).
    S_r may differ between ranks (``token_splits``: S need not divide by
    n). Each is a permutation of the values, so each one's backward is the
    other;
  - ``gather_frames``: every rank's frames, (B, F/n, ...) -> (B, F, ...)
    (the temporal resnet's gather form; uneven parts are padded to the
    largest for the all-gather). Its backward sums the gradient over the
    group with an all-reduce and keeps this rank's frames; it is not built
    on reduce_scatter, which several torch versions of gloo lack.

The collectives run on NCCL with the tensors where they are, or on gloo
with the buffers staged through host memory (``comm_device``): gloo is the
CPU's backend, and the one that runs two ranks on one card (NCCL refuses
two ranks on one device). ``STAGED`` counts the bytes staged through the
host by these collectives and by the 'model' axis's (``tensor.py``). A
collective that fails raises; nothing falls back to one rank.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist


def comm_device(device: torch.device) -> torch.device:
    """Where the collectives' buffers live: the card for NCCL, else the CPU."""
    return device if dist.get_backend() == "nccl" else torch.device("cpu")


class _Staged:
    """The bytes the frames collectives copied between a card and the host
    (both ways), since the last ``reset``."""

    def __init__(self):
        self.bytes = 0

    def reset(self) -> None:
        self.bytes = 0

    def to(self, t: torch.Tensor, device: torch.device, copy: bool = False) -> torch.Tensor:
        if t.device != device:
            self.bytes += t.numel() * t.element_size()
        return t.to(device, copy=copy)


STAGED = _Staged()


def balanced(total: int, n: int) -> List[int]:
    """`total` over n ranks as evenly as it goes, the first total mod n
    ranks one more."""
    return [total // n + (1 if r < total % n else 0) for r in range(n)]


@dataclasses.dataclass(frozen=True)
class FrameShard:
    """This rank's frames of every video: frames [start, start + count) of
    `total`, over the frames group `group` of global ranks `ranks` (in
    frames order; this rank is `ranks[index]`). The frames split as evenly
    as they go, the first total mod n ranks one more (``counts``: 14 over 4
    as 4, 4, 3, 3), where JAX's GSPMD pads the axis to a multiple of n; a
    rank holds at least one frame. The train step takes an even split only
    (``TrainConfig.check_ported``), as the JAX package's ``shard_batch``."""

    group: object
    ranks: Tuple[int, ...]
    index: int
    total: int

    def __post_init__(self):
        if self.total < self.size:
            raise ValueError(f"{self.total} frames over a frames axis of {self.size}: a rank "
                             "would hold none")

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def counts(self) -> List[int]:
        """Every rank's count of frames."""
        return balanced(self.total, self.size)

    @property
    def count(self) -> int:
        return self.counts[self.index]

    @property
    def start(self) -> int:
        return sum(self.counts[:self.index])

    @property
    def frames(self) -> slice:
        return slice(self.start, self.start + self.count)

    def token_splits(self, s: int) -> List[int]:
        """The tokens of each rank's token shard: S split as evenly as it
        goes, the first S mod n ranks one more."""
        if s < self.size:
            raise ValueError(f"{s} tokens over a frames axis of {self.size}")
        return balanced(s, self.size)

    def own(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's frames of `x`, whose axis `dim` holds all of them."""
        if x.shape[dim] != self.total:
            raise ValueError(f"axis {dim} of {tuple(x.shape)} is not the {self.total} frames")
        return x.narrow(dim, self.start, self.count)


def _all_to_all(send: Sequence[torch.Tensor], shapes: Sequence[torch.Size],
                shard: FrameShard) -> List[torch.Tensor]:
    """send[j] to rank j of the group; returns what each rank sent here, of
    `shapes[j]`, on the senders' device."""
    device, dtype = send[0].device, send[0].dtype
    dev = comm_device(device)
    flat = STAGED.to(torch.cat([t.reshape(-1) for t in send]), dev)
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    out = torch.empty(sum(sizes), dtype=dtype, device=dev)
    dist.all_to_all_single(out, flat, sizes, [t.numel() for t in send], group=shard.group)
    out = STAGED.to(out, device)
    return [part.view(s) for part, s in zip(out.split(sizes), shapes)]


def _to_tokens(x: torch.Tensor, shard: FrameShard) -> torch.Tensor:
    b, _, s, c = x.shape
    splits = shard.token_splits(s)
    mine = splits[shard.index]
    got = _all_to_all(list(x.split(splits, dim=2)), [(b, f, mine, c) for f in shard.counts],
                      shard)
    return torch.cat(got, dim=1)


def _to_frames(y: torch.Tensor, shard: FrameShard, s: int) -> torch.Tensor:
    b, _, _, c = y.shape
    splits = shard.token_splits(s)
    got = _all_to_all(list(y.split(shard.counts, dim=1)),
                      [(b, shard.count, n, c) for n in splits], shard)
    return torch.cat(got, dim=2)


class _FramesToTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard, ctx.s = shard, x.shape[2]
        return _to_tokens(x, shard)

    @staticmethod
    def backward(ctx, g):
        return _to_frames(g.contiguous(), ctx.shard, ctx.s), None


class _TokensToFrames(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, shard, s):
        ctx.shard = shard
        return _to_frames(y, shard, s)

    @staticmethod
    def backward(ctx, g):
        return _to_tokens(g.contiguous(), ctx.shard), None, None


class _GatherFrames(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        dev = comm_device(x.device)
        counts = shard.counts
        part = x.contiguous()
        if x.shape[1] < max(counts):
            part = x.new_zeros((x.shape[0], max(counts)) + x.shape[2:])
            part[:, :x.shape[1]] = x
        part = STAGED.to(part, dev)
        parts = [torch.empty_like(part) for _ in range(shard.size)]
        dist.all_gather(parts, part, group=shard.group)
        whole = torch.cat([p[:, :n] for p, n in zip(parts, counts)], dim=1)
        return STAGED.to(whole, x.device)

    @staticmethod
    def backward(ctx, g):
        shard = ctx.shard
        dev = comm_device(g.device)
        total = STAGED.to(g, dev, copy=True)
        dist.all_reduce(total, group=shard.group)
        return STAGED.to(shard.own(total).contiguous(), g.device), None


def frames_to_tokens(x: torch.Tensor, shard: FrameShard) -> torch.Tensor:
    """(B, F/n, S, C) this rank's frames -> (B, F, S_r, C) its tokens of
    every frame (``token_splits``)."""
    return _FramesToTokens.apply(x.contiguous(), shard)


def tokens_to_frames(y: torch.Tensor, shard: FrameShard, s: int) -> torch.Tensor:
    """The inverse of ``frames_to_tokens`` for S = `s` tokens."""
    return _TokensToFrames.apply(y.contiguous(), shard, s)


def gather_frames(x: torch.Tensor, shard: FrameShard) -> torch.Tensor:
    """(B, F/n, ...) -> (B, F, ...): every rank's frames in order."""
    return _GatherFrames.apply(x, shard)


def all_reduce_max_(t: torch.Tensor, group) -> torch.Tensor:
    """In place: the largest of every rank's `t` over the process group
    `group`, elementwise (no gradient)."""
    dev = comm_device(t.device)
    staged = STAGED.to(t, dev)
    dist.all_reduce(staged, op=dist.ReduceOp.MAX, group=group)
    if staged is not t:
        t.copy_(STAGED.to(staged, t.device))
    return t


@torch.no_grad()
def broadcast_from(t: torch.Tensor, index: int, shard: FrameShard) -> torch.Tensor:
    """`t` as rank `index` of the frames group holds it, on every rank of
    the group (the others' `t` gives the shape and dtype)."""
    dev = comm_device(t.device)
    staged = STAGED.to(t, dev, copy=True)
    dist.broadcast(staged, src=shard.ranks[index], group=shard.group)
    return STAGED.to(staged, t.device)
