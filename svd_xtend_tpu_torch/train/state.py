"""Train state, trainable scopes, EMA, and the train step.

Port of ``svd_xtend_tpu/train/state.py``:
  - trainable scopes: 'full' (every UNet parameter), 'temporal' (the
    parameters whose name contains ``temporal_transformer_block``, the JAX
    package's rule on its flax paths; not the temporal resnets, not
    ``time_pos_embed`` / ``time_mixer``), 'tracklet' (the Tracklet2Video
    branch alone: ``tracklet_conditioner.*`` and every ``gated_attentions``
    parameter, over the frozen UNet) and 'lora' (an adapter on every
    attention projection over the frozen UNet, models/lora.py;
    train_svd_lora.py:744-751);
  - a batch is (B, F, H, W, 3) pixels, or for Tracklet2Video a dict of
    ``pixel_values``, ``boxes`` (B, F, N, 4) and ``box_mask`` (B, F, N);
  - EMA with the (1+step)/(10+step) warmup clamped at the max decay, stepped
    after each update (full scope, ``use_ema``);
  - gradient accumulation: the batch gets a leading (accum,) axis, the
    micro-batch gradients are summed in f32 (bf16 with ``grad_dtype="bf16"``)
    and divided by accum;
  - data parallelism, ZeRO-1 and host offload (``parallel/``): a rank's
    batch is its rows of the global batch, its draws the same rows of the
    global batch's draws, its gradients averaged over the ranks before the
    clip; under ZeRO-1 the EMA, like the moments, is held by each tensor's
    owner alone (None elsewhere); with host offload the masters live in
    host memory and the EMA on the card;
  - sequence parallelism (a 'frames' mesh axis): a rank's batch holds every
    frame of its rows and it keeps its frames; the gradients are summed
    over the frames group and averaged over the data axis, so every rank
    clips and applies the one-rank gradient; ZeRO-1 partitions over every
    rank of the world;
  - tensor parallelism (a 'model' axis, ``parallel/tensor.py``): the UNet
    is built for the rank's part (``SVDModels.create(..., tp=)``), so the
    masters, moments and EMA of the sharded tensors are the rank's parts
    (``TrainState.layouts``); the sharded gradients are the rank's own,
    the replicated ones come out whole on every model rank; the mean runs
    over each model index's ranks, the global norm counts each part once,
    and ZeRO-1 partitions over each model index's ranks; the 8-bit
    moments are the whole tensors' blocks (``train/quant.py``). A state
    dict (a checkpoint) holds the whole tensors, the same files as one
    rank's (the 8-bit codes and scales too): gathered to rank 0 for a
    save, sliced on every rank at a restore. In the 'lora' scope the
    adapter is the whole one on every model rank (drawn at the targets'
    whole shapes, replicated as JAX's ``param_pspec`` leaves it); each
    rank merges its slice of it into its part of a target, so its
    gradients are partial and are summed over the model group before the
    mean over the data axis.

Mixed precision: the networks hold their weights in the compute dtype (bf16)
and compute in it, without autocast; the state holds f32 master copies of
the trainable weights, which the optimizer steps and which are copied back
(rounded) into the networks after each update. Each micro-batch's gradient
is taken with respect to the compute copies and accumulated in f32, as JAX
differentiates f32 masters that are cast to bf16 at use. With
``grad_dtype="bf16"`` (state.py:228-233 in the JAX package) the gradient is
taken with respect to bf16 copies, stored and accumulated in bf16 and
applied to the f32 masters: the compute copies then hold the masters
rounded to bf16 whatever the networks' dtype, and the 'lora' scope
differentiates a bf16 copy of the adapter. Frozen weights (the other UNet
leaves, VAE, CLIP) exist only in the compute dtype
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
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..core.config import TrainConfig
from ..diffusion.pipeline import SVDModels
from ..diffusion.training import TrainDraws, sample_train_draws, training_loss
from ..io.convert import flax_axes, is_branch_key, lora_state_dict
from ..models import lora as lora_lib
from ..parallel import (SINGLE, World, all_reduce_mean_, gather_to_main, local_draws,
                        merge_indexed)
from ..parallel.tensor import Layout, all_reduce_sum_, layout
from .optim import ClippedAdamW, make_optimizer
from .quant import BLOCK_ORDER, Part, join_parts, part_of

TEMPORAL_SCOPE = "temporal_transformer_block"


def trainable_mask(unet: nn.Module, mode: str) -> Dict[str, bool]:
    """Parameter name -> trainable, for the 'full', 'temporal' or 'tracklet'
    scope."""
    names = [n for n, _ in unet.named_parameters()]
    if mode == "full":
        return {n: True for n in names}
    if mode == "temporal":
        return {n: TEMPORAL_SCOPE in n for n in names}
    if mode == "tracklet":
        return {n: is_branch_key(n) for n in names}
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
    # on a 'model' axis: how each tensor splits (None: replicated)
    layouts: Optional[List[Optional[Layout]]] = None

    def state_dict(self, copy: Optional[Callable] = None) -> dict:
        """Everything a resume needs, as a snapshot in CPU tensors (copies,
        also of CPU tensors): the step, the f32 masters (in the 'lora' scope
        the adapter's A and B, by peft key), the EMA copies and the
        optimizer's state (the 8-bit one's int8 codes and scales as they
        are). `copy` takes each tensor to its snapshot in place of the CPU
        copy (the checkpoint manager's asynchronous copies into pinned
        buffers). Under ZeRO-1 over several ranks every rank must call it:
        the partitioned EMA and moments are gathered to rank 0, which gets
        the whole state (the other ranks None); so it is on a 'model' axis,
        where the sharded tensors are joined whole."""
        if self.layouts is not None:
            sd = self._gathered()
            return None if sd is None else _snapshot(sd, copy)
        optimizer = self.optimizer.state_dict()
        ema = self.whole_ema()
        if optimizer is None:
            return None
        cpu = lambda ts: {n: _snapshot(t, copy) for n, t in zip(self.names, ts)}
        return {"step": self.step, "params": cpu(self.params),
                "ema_params": None if ema is None else cpu(ema),
                "optimizer": _snapshot(optimizer, copy)}

    def whole_ema(self) -> Optional[List[torch.Tensor]]:
        """Every trainable tensor's EMA copy: the state's own, or under
        ZeRO-1 over several ranks gathered from the owners to rank 0 (in
        CPU tensors; None on the other ranks, and every rank must call it)."""
        if self.ema_params is None or not self.optimizer.gathers:
            return self.ema_params
        parts = gather_to_main({i: e.detach().cpu() for i, e in enumerate(self.ema_params)
                                if e is not None}, self.optimizer.world)
        return None if parts is None else merge_indexed(parts, len(self.names))

    def _gathered(self) -> Optional[dict]:
        """On a 'model' axis: every rank's parts (masters, EMA, moments, of
        the tensors it owns under ZeRO-1) to rank 0, which joins them into
        the whole state; None on the other ranks."""
        opt = self.optimizer
        world = opt.world
        cpu = lambda t: t.detach().to("cpu", copy=True)
        first = world.data_index == 0 and world.frames_index == 0
        mine = {"model": world.model_index,
                "params": [cpu(p) for p in self.params] if first else None,
                "ema": {i: cpu(e) for i, e in enumerate(self.ema_params or []) if e is not None},
                "moments": opt._local_entries()}
        parts = gather_to_main(mine, world)
        if parts is None:
            return None
        by_model = [[p for p in parts if p["model"] == m] for m in range(world.model)]

        def whole(i, pieces):
            lay = self.layouts[i]
            return pieces[0] if lay is None or pieces[0].dim() == 0 else lay.unshard(pieces)

        def held(key, i):
            """Each model index's piece of entry i under `key` (from the
            rank that holds it), or None where one has none."""
            pieces = []
            for ps in by_model:
                tables = [p[key] for p in ps if p[key] is not None]
                found = [t[i] for t in tables if key == "params" or i in t]
                if not found:
                    return None
                pieces.append(found[0])
            return pieces

        n = len(self.names)
        params = {name: whole(i, held("params", i)) for i, name in enumerate(self.names)}
        ema = None
        if self.ema_params is not None:
            ema = {name: whole(i, held("ema", i)) for i, name in enumerate(self.names)}
        state = {}
        for i in range(n):
            entries = held("moments", i)
            if entries is None:
                continue
            if opt.adamw8 is not None:
                state[i] = [self._whole_moment(i, [e[k] for e in entries]) for k in (0, 1)]
            else:
                state[i] = {k: whole(i, [e[k] for e in entries]) for k in entries[0]}
        if opt.adamw8 is not None:
            optimizer = {"count": opt.adamw8.count, "block_order": BLOCK_ORDER,
                         "mu": [state[i][0] for i in range(n)],
                         "nu": [state[i][1] for i in range(n)]}
        else:
            group = dict(opt.adamw.state_dict()["param_groups"][0])
            group["params"] = list(range(n))
            optimizer = {"state": state, "param_groups": [group]}
        return {"step": self.step, "params": params, "ema_params": ema,
                "optimizer": {"count": opt.count,
                              "adamw8" if opt.adamw8 is not None else "adamw": optimizer}}

    def _parts_of(self, i: int) -> Optional[List[Part]]:
        """Every model index's ``Part`` of tensor i (None where replicated)."""
        part = self.optimizer.parts[i]
        return None if part is None else [part._replace(index=m)
                                          for m in range(self.optimizer.world.model)]

    def _whole_moment(self, i: int, pieces):
        """Tensor i's whole 8-bit moment (codes and scales, or f32) from
        every model index's piece."""
        parts = self._parts_of(i)
        if parts is None:
            return pieces[0]
        if isinstance(pieces[0], dict):
            return join_parts(pieces, parts, self.optimizer.axes[i])
        return parts[0].layout.unshard(pieces)

    def _local_of(self, sd: dict) -> dict:
        """On a 'model' axis: this rank's parts of a whole state dict."""
        index = self.optimizer.world.model_index
        part = lambda i, t: (t if self.layouts[i] is None or t.dim() == 0
                             else self.layouts[i].shard(t, index))
        out = dict(sd)
        out["params"] = {n: part(i, t) for i, (n, t) in enumerate(sd["params"].items())}
        if sd["ema_params"] is not None:
            out["ema_params"] = {n: part(i, t)
                                 for i, (n, t) in enumerate(sd["ema_params"].items())}
        if "adamw8" in sd["optimizer"]:
            whole = sd["optimizer"]["adamw8"]

            def moment(i, m):
                if self.layouts[i] is None or not isinstance(m, dict):
                    return part(i, m)
                return part_of(m, self._parts_of(i)[index], self.optimizer.axes[i])
            out["optimizer"] = {**sd["optimizer"], "adamw8": {
                **whole, **{k: [moment(i, m) for i, m in enumerate(whole[k])]
                            for k in ("mu", "nu")}}}
            return out
        whole = sd["optimizer"]["adamw"]
        out["optimizer"] = {**sd["optimizer"], "adamw": {
            **whole, "state": {i: {k: part(i, v) for k, v in st.items()}
                               for i, st in whole["state"].items()}}}
        return out

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """In place, onto this state's tensors and devices; raises where the
        names, shapes or the EMA's presence differ. The networks' compute
        copies are the caller's to refresh. On a 'model' axis `sd` is the
        whole state, of which this rank keeps its parts."""
        if self.layouts is not None:
            sd = self._local_of(sd)
        if list(sd["params"]) != self.names:
            raise ValueError("checkpoint holds other trainable tensors than this state")
        if (sd["ema_params"] is None) != (self.ema_params is None):
            raise ValueError("checkpoint and state differ in holding an EMA")
        pairs = list(zip(self.params, sd["params"].values()))
        if self.ema_params is not None:
            pairs += [(e, s) for e, s in zip(self.ema_params, sd["ema_params"].values())
                      if e is not None]
        for dst, src in pairs:
            if dst.shape != src.shape:
                raise ValueError(f"shape {tuple(src.shape)} in the checkpoint, "
                                 f"{tuple(dst.shape)} in the state")
            dst.copy_(src)
        self.optimizer.load_state_dict(sd["optimizer"])
        self.step = int(sd["step"])


def _snapshot(obj, copy: Optional[Callable] = None):
    """`obj` with every tensor in it (through dicts, lists and tuples)
    copied to the CPU, or by `copy`: torch's optimizer state_dict and
    ``.cpu()`` of a CPU tensor alias the live ones."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True) if copy is None else copy(obj.detach())
    if isinstance(obj, dict):
        return {k: _snapshot(v, copy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_snapshot(v, copy) for v in obj)
    return obj


def create_train_state(cfg: TrainConfig, models: SVDModels,
                       generator: Optional[torch.Generator] = None,
                       world: World = SINGLE) -> TrainState:
    """f32 masters of the scope's UNet parameters (from the networks' current
    weights), the optimizer over them, the EMA copies; the networks' own
    parameters require grad exactly where the scope trains. The 'lora'
    scope instead draws an adapter from `generator` (seed 0 by default, as
    the JAX package's key): `params` are its f32 A and B, `names` their peft
    keys, and no network parameter requires grad. `world`: the optimizer's
    data-parallel ranks (ZeRO-1 partitions over them); with host offload
    the masters go to host memory (pinned where there is a card), the EMA
    and the adapter's compute copy stay with the networks. On a 'model'
    axis `models` is built for the rank's part (``SVDModels.create(...,
    tp=world.tensor_shard())``); the adapter is the whole one."""
    if world.model > 1:
        _check_model_rank(models, world)
    if cfg.train_mode == "lora":
        for net in (models.unet, models.vae, models.clip):
            net.requires_grad_(False)
        if generator is None:
            generator = torch.Generator(models.unet.conv_in.weight.device).manual_seed(0)
        adapter = lora_lib.init(models.unet, cfg.lora_rank, generator)
        sd = lora_state_dict(adapter)
        params = [p.requires_grad_(True) for p in sd.values()]
        # the adapter is its own master, or with host offload the compute
        # copy of masters in host memory
        masters = _offloaded(cfg, [p.detach() for p in params]) or params
        axes = [flax_axes(n, p.dim()) for n, p in sd.items()]
        return TrainState(0, list(sd), masters,
                          make_optimizer(cfg, masters, world=world, device=params[0].device,
                                         axes=axes),
                          lora=adapter)
    if cfg.train_mode == "tracklet" and models.unet.tracklet_conditioner is None:
        raise ValueError("the 'tracklet' scope needs a UNet with the Tracklet2Video branch "
                         "(SVDModels.with_tracklet, UNetConfig.tracklet_dim > 0)")
    mask = trainable_mask(models.unet, cfg.train_mode)
    named = dict(models.unet.named_parameters())
    names = [n for n, m in mask.items() if m]
    masters = [named[n].detach().float().clone() for n in names]
    for n, p in named.items():
        p.requires_grad_(mask[n])
    models.vae.requires_grad_(False)
    models.clip.requires_grad_(False)
    device = masters[0].device if masters else torch.device("cpu")
    ema = ([m.clone() for m in masters]
           if cfg.use_ema and cfg.train_mode == "full" else None)
    masters = _offloaded(cfg, masters) or masters
    layouts = parts = None
    if world.model > 1:
        layouts = [layout(n, models.unet.config, world.model) for n in names]
        parts = [None if lay is None else Part(lay, world.model_index, lay.whole_shape(m.shape))
                 for lay, m in zip(layouts, masters)]
    optimizer = make_optimizer(cfg, masters, world=world, device=device, parts=parts,
                               axes=[flax_axes(n, m.dim()) for n, m in zip(names, masters)])
    if ema is not None and cfg.zero1:
        ema = [e if owner == world.replica_index else None
               for e, owner in zip(ema, optimizer.owner)]
    state = TrainState(0, names, masters, optimizer, ema, layouts=layouts)
    write_back(models, cfg, state)
    return state


def _check_model_rank(models: SVDModels, world: World) -> None:
    if models.tp != world.tensor_shard():
        raise ValueError(f"a UNet built for {models.tp} on the model rank "
                         f"{world.tensor_shard()} (SVDModels.create(..., "
                         "tp=world.tensor_shard()))")


def _offloaded(cfg: TrainConfig, masters: List[torch.Tensor]) -> Optional[List[torch.Tensor]]:
    """Host copies of `masters` (pinned where there is a card) under host
    offload, else None."""
    if cfg.host_offload == "none":
        return None
    pin = torch.cuda.is_available()
    return [m.to("cpu", copy=True).pin_memory() if pin else m.to("cpu", copy=True)
            for m in masters]


@torch.no_grad()
def write_back(models: SVDModels, cfg: TrainConfig, state: TrainState, tensors=None,
               indices=None) -> None:
    """Copy the state's f32 masters (or `tensors`, aligned with them, or
    with `indices` of them) into the UNet's compute copies, rounded to its
    dtype, and to bf16 first with ``grad_dtype="bf16"``. In the 'lora' scope
    the compute copies are the adapter's f32 tensors, which are the masters
    themselves unless they are offloaded."""
    if state.lora is not None:
        named = lora_state_dict(state.lora)
    else:
        named = dict(models.unet.named_parameters())
    names = state.names if indices is None else [state.names[i] for i in indices]
    for n, t in zip(names, state.params if tensors is None else tensors):
        if named[n] is t:
            continue
        if state.lora is None and cfg.grad_dtype == "bf16":
            t = t.to(torch.bfloat16)
        named[n].copy_(t, non_blocking=t.is_pinned())


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
                   batch, draws: TrainDraws, shard=None):
    """One micro-batch's loss and its gradients with respect to the tensors
    the scope trains: the UNet's compute copies of the masters, or the
    adapter itself (a bf16 copy of it with ``grad_dtype="bf16"``). Unused
    tensors (the q/k projections of the single-token cross-attentions and
    their adapters) get zero gradients, as under jax.grad. `batch` is the
    micro-batch's pixels or its Tracklet2Video dict; with a frames `shard`,
    the loss and gradients are this rank's parts. The backward runs under
    the profiler label ``train.backward``."""
    if state.lora is None:
        named = dict(models.unet.named_parameters())
        wrt, scope = [named[n] for n in state.names], contextlib.nullcontext()
    else:
        adapter = state.lora
        if cfg.grad_dtype == "bf16":
            adapter = {n: {k: t.detach().to(torch.bfloat16).requires_grad_(True)
                           for k, t in ab.items()} for n, ab in state.lora.items()}
        wrt = list(lora_state_dict(adapter).values())
        scope = lora_lib.merged(models.unet, adapter, cfg.lora_alpha)
    if isinstance(batch, dict):
        pixels, boxes = batch["pixel_values"], dict(boxes=batch.get("boxes"),
                                                    box_mask=batch.get("box_mask"))
    else:
        pixels, boxes = batch, {}
    with scope:
        loss = training_loss(models, pixels, cfg, draws, **boxes, shard=shard)
        with torch.profiler.record_function("train.backward"):
            grads = torch.autograd.grad(loss, wrt, materialize_grads=True)
    if cfg.grad_dtype == "bf16":
        grads = tuple(g.to(torch.bfloat16) for g in grads)
    return loss, grads


def make_train_step(models: SVDModels, cfg: TrainConfig, world: World = SINGLE):
    """Build ``step(state, batch, *, generator=None, draws=None) -> (state,
    metrics)``. `batch` is (accum, B, F, H, W, 3) pixels in [-1, 1] when
    gradient_accumulation_steps > 1, else (B, F, H, W, 3); or a
    Tracklet2Video dict of such pixels (``pixel_values``) with ``boxes`` and
    ``box_mask`` of the same leading axes. `draws` (one TrainDraws, or a
    list of one per micro-batch) replaces the draws from `generator`.
    Metrics: loss, grad_norm (before clipping), lr (applied). The backward
    and the update run under the profiler labels ``train.backward`` and
    ``train.optimizer``. Over a data-parallel `world`, `batch` is this
    rank's rows of the global batch, the draws from `generator` are its rows
    of the global batch's, the gradients are averaged over the ranks before
    the clip, and the metrics are the global batch's (the loss averaged).
    Over a frames axis (``cfg.mesh.frames``, which must be the world's),
    `batch` holds every frame of the rank's rows, the rank keeps its frames
    of them and of the draws, and the loss and gradients are summed over the
    frames group (and averaged over the data axis): the metrics and the
    update are the one-rank step's. Over a model axis (``cfg.mesh.model``,
    the world's, with `models` built for the rank) every model rank takes
    the same rows and frames and keeps the metrics of the one-rank step."""
    cfg.check_ported()
    if cfg.mesh.frames != world.frames or cfg.mesh.model != world.model:
        raise ValueError(f"a (model, frames) axis of ({cfg.mesh.model}, {cfg.mesh.frames}) in "
                         f"the config and ({world.model}, {world.frames}) in the world")
    _check_model_rank(models, world)
    accum = cfg.gradient_accumulation_steps
    gdt = torch.bfloat16 if cfg.grad_dtype == "bf16" else torch.float32

    def step(state: TrainState, batch, *,
             generator: Optional[torch.Generator] = None, draws=None):
        pixels = batch["pixel_values"] if isinstance(batch, dict) else batch
        shard = world.frame_shard(pixels.shape[-4])
        if shard is not None and shard.total % shard.size:
            raise ValueError(f"{shard.total} frames over a frames axis of {shard.size}: a "
                             "train batch takes an even split only, as the JAX package's "
                             "shard_batch places it")
        if accum == 1:
            micro = [batch]
        elif isinstance(batch, dict):
            micro = [{k: v[i] for k, v in batch.items() if v is not None} for i in range(accum)]
        else:
            micro = list(batch)
        if draws is None:
            shape = pixels.shape[1:] if accum > 1 else pixels.shape
            whole = (shape[0] * world.data,) + tuple(shape[1:])
            draws = [local_draws(sample_train_draws(models, whole, cfg, generator,
                                                    pixels.device), world, shape[0])
                     for _ in range(accum)]
        elif isinstance(draws, TrainDraws):
            draws = [draws]
        grads, loss_sum = None, 0.0
        for mb, d in zip(micro, draws):
            loss, g = loss_and_grads(models, cfg, state, mb, d, shard)
            if grads is None:
                grads = [x.to(gdt) for x in g]
            else:
                for acc, x in zip(grads, g):
                    acc.add_(x.to(gdt))
            loss_sum = loss_sum + loss.detach()
            del loss, g
        with torch.profiler.record_function("train.optimizer"):
            if accum > 1:
                for acc in grads:
                    acc.div_(accum)
            if state.lora is not None and world.model > 1:
                # each model rank's partial gradient of the whole adapter
                flat = all_reduce_sum_(torch.cat([g.reshape(-1) for g in grads]),
                                       world.model_group)
                for acc, part in zip(grads, flat.split([g.numel() for g in grads])):
                    acc.copy_(part.view_as(acc))
            all_reduce_mean_(grads, world)
            loss = loss_sum.reshape(1) / accum
            all_reduce_mean_([loss], world)
            step_after = state.step + 1

            def updated(indices, tensors):
                # the new masters into the compute copies, then the EMA
                write_back(models, cfg, state, tensors, indices)
                if state.ema_params is not None:
                    ema_update_([state.ema_params[i] for i in indices], tensors, step_after,
                                cfg.ema_decay)

            lr, grad_norm = state.optimizer.step(
                grads, on_update=updated,
                on_receive=lambda i, t: write_back(models, cfg, state, [t], [i]))
            del grads
            state.step = step_after
        metrics = {"loss": loss.item(), "grad_norm": grad_norm.item(), "lr": lr}
        return state, metrics

    return step
