"""Data parallelism, ZeRO-1 and host offload on ``torch.distributed``.

Port of ``svd_xtend_tpu/parallel/sharding.py`` for the batch ('data') axis.
The JAX package lays the train state and the batch out on a device mesh and
lets GSPMD insert the collectives; here each card is a process (started by
``torchrun``, or one process for one card), and the collectives are explicit:

  - data parallelism: each rank takes its rows of the global batch
    (``rows``, by its data index); every rank draws the global batch's noise, sigmas and
    dropout from the step's generator and keeps its rows (``local_draws``),
    so a step over N ranks is the one-rank step over the same global batch;
    the trainable gradients are all-reduced as a mean, in buckets, before
    the global-norm clip (``all_reduce_mean_``), and each rank clips the same
    replicated gradient;
  - ZeRO-1 (sharding.py:42-47, 75-85): the optimizer moments and the EMA
    are partitioned over the ranks by whole tensors (``owners``; whole
    tensors keep the 8-bit AdamW's 2048-value blocks whole); each rank
    updates its tensors and the owners broadcast the updated f32 masters
    (``broadcast_from_owners_``), so the masters stay replicated. The update
    is elementwise, so the result is the unpartitioned one bit for bit;
  - host offload (sharding.py:49-68): "masters" keeps the f32 masters in
    pinned host memory, "masters+moments" the optimizer moments too; the
    update streams them through the card in chunks (``train/optim.py``).
    The networks' bf16 compute copies, the EMA, the frozen weights and the
    step counter stay on the card.

A checkpoint holds the same files whatever the world size: the partitioned
state is gathered to rank 0 for a save (``gather_to_main``), and every rank
reads the full file on restore and keeps its part, so a run resumes at
another world size and layout. NCCL on cards, gloo on the CPU.

The 'frames' axis (sequence parallelism, ``frames.py``) and the 'model'
axis (tensor parallelism, ``tensor.py``): ``mesh_world`` lays
``MeshConfig(data, model, frames)`` over the ranks as the JAX package's
``create_mesh`` reshapes its devices (core/mesh.py:34-47): data outer,
model in the middle, frames inner, so rank = (data index · model + model
index) · frames + frames index. A ``World`` then holds its frames group
(the ranks of its data row and model index), its model group (those of its
data row and frames index) and its replica group (every rank of its model
index: they hold the same parameters). Each rank holds F / frames of every
video of its rows (``World.frame_shard``) and its part of the UNet's
transformer matrices (``World.tensor_shard``); every model rank of a data
index takes the same rows and draws; the draws are the global batch's, of
which ``local_draws`` keeps this rank's rows and frames; the gradients are
summed over the frames group and averaged over the data axis, over the
replica group (``all_reduce_mean_``); ZeRO-1 partitions over the replica
group. ``generate_rows`` is the counterpart of ``make_sharded_generate``
(sharding.py:173-203) for the three axes; under int8 an activation's amax
is the largest over every rank that holds part of the same global tensor
(``World.amax_groups``), as GSPMD's global max is.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .frames import FrameShard, comm_device
from .tensor import TensorShard

# an all-reduce or broadcast bucket holds at most this many values
BUCKET_VALUES = 1 << 25


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place among the ranks: `size` ranks in a (data,
    model, frames) layout (data outer, frames inner) with `frames` ranks a
    frames group and `model` a model group; a group is None where its axis
    is 1, the replica group None where it is the whole world."""

    rank: int = 0
    size: int = 1
    local_rank: int = 0
    frames: int = 1
    frames_group: Optional[object] = None
    model: int = 1
    model_group: Optional[object] = None
    replica_group: Optional[object] = None
    chunk_group: Optional[object] = None

    @property
    def main(self) -> bool:
        """Rank 0: the rank that logs, validates and writes."""
        return self.rank == 0

    @property
    def collective(self) -> bool:
        """Whether a process group is up (a world of one included)."""
        return dist.is_available() and dist.is_initialized()

    @property
    def data(self) -> int:
        """The size of the data axis."""
        return self.size // (self.frames * self.model)

    @property
    def data_index(self) -> int:
        return self.rank // (self.frames * self.model)

    @property
    def model_index(self) -> int:
        return self.rank // self.frames % self.model

    @property
    def frames_index(self) -> int:
        return self.rank % self.frames

    def _rank_of(self, d: int, m: int, f: int) -> int:
        return (d * self.model + m) * self.frames + f

    @property
    def replicas(self) -> List[int]:
        """The global ranks of this rank's model index (data outer, frames
        inner): they hold the same parameters."""
        return [self._rank_of(d, self.model_index, f)
                for d in range(self.data) for f in range(self.frames)]

    @property
    def replica_index(self) -> int:
        """This rank's place in ``replicas``."""
        return self.data_index * self.frames + self.frames_index

    def frame_shard(self, num_frames: int) -> Optional[FrameShard]:
        """This rank's frames of a video of `num_frames` (None on a frames
        axis of 1; an uneven split as ``FrameShard`` lays it out)."""
        if self.frames == 1:
            return None
        first = self._rank_of(self.data_index, self.model_index, 0)
        return FrameShard(self.frames_group, tuple(range(first, first + self.frames)),
                          self.frames_index, num_frames)

    def frames_of(self, num_frames: int) -> slice:
        """This rank's frames of a video of `num_frames`."""
        shard = self.frame_shard(num_frames)
        return slice(0, num_frames) if shard is None else shard.frames

    def tensor_shard(self) -> Optional[TensorShard]:
        """This rank's part of the 'model' axis (None on an axis of 1)."""
        if self.model == 1:
            return None
        return TensorShard(self.model_group,
                           tuple(self._rank_of(self.data_index, m, self.frames_index)
                                 for m in range(self.model)), self.model_index)

    def amax_groups(self) -> Tuple[Optional[object], Optional[object]]:
        """The process groups over which an int8 activation's amax is the
        largest (None: this rank alone): the UNet's, every rank (each holds
        part of the global batch's tensor at every site, or the same values
        at a site replicated over the model axis); the decoder's, the ranks
        that decode the same chunks (every rank, or on a frames axis those of
        this frames index)."""
        if self.size == 1:
            return None, None
        return dist.group.WORLD, (dist.group.WORLD if self.frames == 1 else self.chunk_group)


SINGLE = World()


def env_world() -> World:
    """The world torchrun's RANK / WORLD_SIZE / LOCAL_RANK describe (one
    rank without them)."""
    env = os.environ
    return World(int(env.get("RANK", 0)), int(env.get("WORLD_SIZE", 1)),
                 int(env.get("LOCAL_RANK", 0)))


def init_world(device_type: str, mesh=None) -> World:
    """The world of this process: torchrun's environment, its process group
    started through it (``env://``: MASTER_ADDR, MASTER_PORT) on NCCL for
    cards and gloo for the CPU when WORLD_SIZE is set, else one rank without
    a group. A group already up is left as it is (a caller may start one
    itself, e.g. gloo for two ranks on one card). With a `mesh`
    (``MeshConfig``), laid out by ``mesh_world``."""
    world = env_world()
    if "WORLD_SIZE" in os.environ and not (dist.is_available() and dist.is_initialized()):
        if device_type == "cuda":
            torch.cuda.set_device(world.local_rank)
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                init_method="env://", rank=world.rank, world_size=world.size)
    return world if mesh is None else mesh_world(world, mesh)


def mesh_world(world: World, mesh) -> World:
    """`world` laid out as ``MeshConfig(data, model, frames)``: data outer,
    frames inner (the JAX package's ``create_mesh``); a data axis of -1
    takes the ranks the other axes leave. Every rank must call it (each
    creates every group, in the same order). Raises ValueError for a layout
    the world does not hold, and RuntimeError for a frames or model axis
    without a process group."""
    frames, model = mesh.frames, mesh.model
    if frames < 1 or model < 1 or world.size % (frames * model):
        raise ValueError(f"a model axis of {model} x frames axis of {frames}: the world has "
                         f"{world.size} rank(s)")
    data = world.size // (frames * model)
    if mesh.data not in (-1, data):
        raise ValueError(f"mesh data {mesh.data} x model {model} x frames {frames}: the world "
                         f"has {world.size} rank(s)")
    out = dataclasses.replace(world, frames=frames, frames_group=None, model=model,
                              model_group=None, replica_group=None, chunk_group=None)
    if frames == 1 and model == 1:
        return out
    if not world.collective:
        raise RuntimeError(f"a model axis of {model} and frames axis of {frames} need a "
                           "process group")
    at = out._rank_of
    groups = {}
    if frames > 1:
        for d in range(data):
            for m in range(model):
                g = dist.new_group([at(d, m, f) for f in range(frames)])
                if (d, m) == (out.data_index, out.model_index):
                    groups["frames_group"] = g
        if data * model > 1:
            for f in range(frames):
                g = dist.new_group([at(d, m, f) for d in range(data) for m in range(model)])
                if f == out.frames_index:
                    groups["chunk_group"] = g
    if model > 1:
        for d in range(data):
            for f in range(frames):
                g = dist.new_group([at(d, m, f) for m in range(model)])
                if (d, f) == (out.data_index, out.frames_index):
                    groups["model_group"] = g
        for m in range(model):
            g = dist.new_group([at(d, m, f) for d in range(data) for f in range(frames)])
            if m == out.model_index:
                groups["replica_group"] = g
    return dataclasses.replace(out, **groups)


def close_world(world: World) -> None:
    if world.collective:
        dist.destroy_process_group()


def rows(n_local: int, world: World) -> slice:
    """This rank's rows of a global batch of n_local · data rows (the rows
    of its data index, the same on every model and frames rank of it)."""
    return slice(world.data_index * n_local, (world.data_index + 1) * n_local)


def local_draws(draws, world: World, batch: int):
    """This rank's part of the global batch's draws (a TrainDraws of data ·
    batch samples of F frames): its `batch` rows, and of the per-frame
    draws its frames (``latent_noise``, a row per frame in frame order, and
    ``noise``, (B, F, ...)); every other draw is per sample."""
    if world.size == 1:
        return draws
    frames = draws.latent_noise.shape[0] // draws.sigma.shape[0]
    mine = world.frames_of(frames)
    out = []
    for name, t in zip(draws._fields, draws):
        if t is not None:
            if name == "latent_noise":
                t = t.reshape((-1, frames) + t.shape[1:])[rows(batch, world), mine]
                t = t.reshape((-1,) + t.shape[2:])
            else:
                t = t[rows(batch, world)]
                if name == "noise":
                    t = t[:, mine]
        out.append(t)
    return type(draws)(*out)


def _buckets(indices: Sequence[int], tensors: Sequence[torch.Tensor]):
    """Runs of `indices` of one dtype with at most BUCKET_VALUES values (a
    larger tensor alone)."""
    run, count = [], 0
    for i in indices:
        t = tensors[i]
        if run and (count + t.numel() > BUCKET_VALUES or t.dtype != tensors[run[0]].dtype):
            yield run
            run, count = [], 0
        run.append(i)
        count += t.numel()
    if run:
        yield run


@torch.no_grad()
def all_reduce_mean_(tensors: List[torch.Tensor], world: World) -> None:
    """In place: every tensor the mean over the data axis of its sum over
    the frames axis (each rank of a frames group holds a part of its rows'
    sum), summed over the replica group in buckets of one dtype and divided
    by the data axis's size (a no-op without a process group). On a model
    axis each model index does this apart: its ranks' tensors are its parts
    (or replicated ones, whose gradients every model rank holds whole)."""
    if not world.collective:
        return
    dev = comm_device(tensors[0].device) if tensors else None
    for run in _buckets(range(len(tensors)), tensors):
        flat = torch.cat([tensors[i].reshape(-1).to(dev) for i in run])
        dist.all_reduce(flat, group=world.replica_group)
        flat.div_(world.data)
        offset = 0
        for i in run:
            t = tensors[i]
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def owners(sizes: Sequence[int], world: World) -> List[int]:
    """The rank that owns each tensor under ZeRO-1, as its place in
    ``world.replicas`` (the world's ranks on a model axis of 1): whole
    tensors, largest first to the least loaded rank (the lowest on a tie);
    the same on every rank of the replica group."""
    n = len(world.replicas)
    load, owner = [0] * n, [0] * len(sizes)
    for i in sorted(range(len(sizes)), key=lambda i: (-sizes[i], i)):
        r = min(range(n), key=lambda r: (load[r], r))
        owner[i] = r
        load[r] += sizes[i]
    return owner


@torch.no_grad()
def broadcast_from_owners_(tensors: List[torch.Tensor], owner: Sequence[int], world: World,
                           device: torch.device,
                           received: Optional[Callable] = None) -> int:
    """Each tensor from its owner (``owners``: a place in the replica
    group) to every rank of the replica group, in buckets staged on the
    collectives' device (`tensors` may live in host memory); `received(i,
    staged)` sees each tensor a rank did not own as staged on `device`.
    Returns the bytes this rank staged from or to host memory."""
    if not world.collective:
        return 0
    dev = comm_device(device)
    moved = 0
    ranks = world.replicas
    for src in range(len(ranks)):
        mine = [i for i in range(len(tensors)) if owner[i] == src]
        for run in _buckets(mine, tensors):
            if world.replica_index == src:
                flat = torch.cat([tensors[i].reshape(-1).to(dev, non_blocking=True)
                                  for i in run])
            else:
                flat = torch.empty(sum(tensors[i].numel() for i in run),
                                   dtype=tensors[run[0]].dtype, device=dev)
            dist.broadcast(flat, src=ranks[src], group=world.replica_group)
            offset = 0
            for i in run:
                t = tensors[i]
                part = flat[offset:offset + t.numel()].view_as(t)
                offset += t.numel()
                if t.device != dev:
                    moved += part.numel() * part.element_size()
                if world.replica_index != src:
                    t.copy_(part)
                    if received is not None:
                        received(i, part.to(device))
    return moved


def gather_to_main(obj, world: World):
    """Every rank's `obj` (CPU tensors) as a list on rank 0, None elsewhere;
    [obj] without a process group."""
    if not world.collective:
        return [obj]
    out = [None] * world.size if world.main else None
    dist.gather_object(obj, out, dst=0)
    return out


def merge_indexed(parts: Sequence[Dict[int, object]], n: int) -> List[object]:
    """The per-tensor entries of every rank's {index: entry} as one list of
    n (the owner's entry at each index)."""
    merged: List[object] = [None] * n
    for part in parts:
        for i, v in part.items():
            merged[i] = v
    return merged


def generate_rows(models, images: torch.Tensor, config, world: World, *,
                  generator: Optional[torch.Generator] = None,
                  image_noise: Optional[torch.Tensor] = None,
                  latent_noise: Optional[torch.Tensor] = None, **kw) -> torch.Tensor:
    """``generate`` over the ranks: `images` (B, H, W, 3) is the global
    batch, each rank draws the global noise (from `generator`, or takes it
    as given) and generates the B / data rows of its data index, over its
    frames group's frames shards where the world has a frames axis (uneven
    where the axis does not divide the frames, ``FrameShard``), with
    `models` built for its model rank where it has a model axis
    (``SVDModels.create(..., tp=world.tensor_shard())``); under int8 the
    amaxes span ``world.amax_groups()``. Returns this rank's rows of the
    whole video (B / data, F, H, W, 3), the same on every rank of a data
    index. With one rank, ``generate``."""
    from ..diffusion.pipeline import generate

    b = images.shape[0]
    if b % world.data:
        raise ValueError(f"a batch of {b} over a data axis of {world.data}")
    if world.size == 1:
        return generate(models, images, config, generator=generator, image_noise=image_noise,
                        latent_noise=latent_noise, **kw)
    tp = world.tensor_shard()
    if getattr(models.unet, "tp", None) != tp:
        raise ValueError(f"a UNet built for {getattr(models.unet, 'tp', None)} on the model "
                         f"rank {tp}")
    ds = models.vae.config.downsample_factor
    lat = (b, config.num_frames, config.height // ds, config.width // ds,
           models.vae.config.latent_channels)
    if image_noise is None:
        image_noise = torch.randn(images.shape, generator=generator, device=images.device)
    if latent_noise is None:
        latent_noise = torch.randn(lat, generator=generator, device=images.device)
    mine = rows(b // world.data, world)
    boxes = {k: v[mine] for k, v in kw.items() if k in ("boxes", "box_mask") and v is not None}
    return generate(models, images[mine], config, image_noise=image_noise[mine],
                    latent_noise=latent_noise[mine], **{**kw, **boxes},
                    shard=world.frame_shard(config.num_frames),
                    amax_groups=world.amax_groups())
