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
masters. ZeRO-1 and host offload are ``ClippedAdamW``'s (with
``parallel/``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..core.config import TrainConfig
from ..parallel import (SINGLE, World, broadcast_from_owners_, gather_to_main, merge_indexed,
                        owners)
from ..parallel.tensor import all_reduce_sum_
from ..utils.profiling import read
from .quant import BLOCK_ORDER, AdamW8bit, Axes, Part

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


def global_norm_f32(tensors: Sequence[torch.Tensor], sharded: Optional[Sequence[bool]] = None,
                    group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, accumulated in f32.
    Under tensor parallelism the tensors marked `sharded` are this rank's
    parts: their sum of squares is summed over the model `group`, the
    replicated ones counted once."""
    if not sharded or not any(sharded):
        return torch.sqrt(sum(t.float().square().sum() for t in tensors))
    square = lambda ts: sum((t.float().square().sum() for t in ts),
                            torch.zeros((), device=tensors[0].device))
    parts = square([t for t, s in zip(tensors, sharded) if s])
    all_reduce_sum_(parts, group)
    return torch.sqrt(parts + square([t for t, s in zip(tensors, sharded) if not s]))


def clip_by_global_norm_f32_(grads: Sequence[torch.Tensor], max_norm: float,
                             norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """In place: when the f32 global norm (`norm`, else ``global_norm_f32``
    of the gradients) is not below max_norm, scale every gradient by
    max_norm / norm. Returns the norm before clipping. The decision reads
    the norm on the host (the span ``sync.clip``)."""
    if norm is None:
        norm = global_norm_f32(grads)
    if read("sync.clip", norm) >= max_norm:
        for g in grads:
            g.copy_(g.float() / norm * max_norm)
    return norm


class ClippedAdamW:
    """The optimizer chain of ``make_optimizer``: the f32 global-norm clip
    (when max_grad_norm > 0), then AdamW at the schedule's learning rate
    (``torch.optim.AdamW``, or ``AdamW8bit`` with ``use_8bit_adam``).
    Steps f32 `params` (the masters) with gradients given per step.

    Over several data-parallel ranks (``parallel.World``) the gradients
    come in already averaged, and every rank clips the same ones. With
    ``zero1`` each rank holds the moments of its own tensors only
    (``parallel.owners``: whole tensors, over the ranks of its model index)
    and updates those; the owners then broadcast the updated masters. Under
    tensor parallelism the tensors with a `parts` entry (``quant.Part``)
    are this model rank's parts: the global norm counts each part once,
    ZeRO-1 assigns owners by the whole tensors' sizes (so every model rank
    of a data index owns the same tensors), and the 8-bit moments are the
    whole tensors' (``AdamW8bit.sync_scales``). `axes`: each tensor's JAX
    layout (``io/convert.py::flax_axes``), in whose order the 8-bit moments
    are blocked. With ``host_offload`` the masters (and
    with "masters+moments" the moments) live in host memory, pinned where
    there is a card, and the update streams them through `device` in chunks
    of at most OFFLOAD_CHUNK_VALUES values: each chunk's copies in on a side
    stream while the previous chunk updates, the update on the card (the
    same arithmetic as without offload: bit for bit the same masters), the
    copies back on the side stream. ``streamed_bytes`` counts the bytes the
    last step moved between host and card."""

    CHUNK = 32      # parameters whose bf16 gradients are copied to f32 at once
    OFFLOAD_CHUNK_VALUES = 1 << 26
    MOMENTS = ("exp_avg", "exp_avg_sq")

    def __init__(self, params: List[torch.Tensor], schedule: Schedule, cfg: TrainConfig,
                 world: World = SINGLE, device: Optional[torch.device] = None,
                 parts: Optional[Sequence[Optional[Part]]] = None,
                 axes: Optional[Sequence[Axes]] = None):
        self.params, self.schedule = params, schedule
        n = len(params)
        self.parts = list(parts) if parts is not None else [None] * n
        self.axes = list(axes) if axes is not None else [None] * n
        self.sharded = [p is not None for p in self.parts]
        self.max_grad_norm = cfg.max_grad_norm
        self.count = 0
        self.world = world
        self.offload = cfg.host_offload
        self.device = torch.device(device) if device is not None else (
            params[0].device if params else torch.device("cpu"))
        self.zero1 = cfg.zero1
        sizes = [p.numel() if part is None else math.prod(part.shape)
                 for p, part in zip(params, self.parts)]
        self.owner = owners(sizes, world) if self.zero1 else [world.replica_index] * n
        self.local = [i for i in range(n) if self.owner[i] == world.replica_index]
        self.pos = {i: k for k, i in enumerate(self.local)}
        mine = [params[i] for i in self.local]
        if n and not mine:
            raise ValueError(f"ZeRO-1 over {len(world.replicas)} ranks and {n} trainable "
                             f"tensors leaves rank {world.rank} none")
        self.streamed_bytes = 0
        self._host_moments: Dict = {}
        self.adamw = self.adamw8 = None
        if cfg.use_8bit_adam:
            self.adamw8 = AdamW8bit(mine, cfg.adam_beta1, cfg.adam_beta2, cfg.adam_epsilon,
                                    cfg.adam_weight_decay,
                                    axes=[self.axes[i] for i in self.local],
                                    parts=[self.parts[i] for i in self.local],
                                    group=world.model_group)
        else:
            self.adamw = torch.optim.AdamW(
                mine, lr=schedule(0), betas=(cfg.adam_beta1, cfg.adam_beta2),
                eps=cfg.adam_epsilon, weight_decay=cfg.adam_weight_decay)
        self._place_moments()

    # -- the update --

    def step(self, grads: List[torch.Tensor], on_update: Optional[Callable] = None,
             on_receive: Optional[Callable] = None) -> Tuple[float, torch.Tensor]:
        """One update with `grads` (f32 or bf16, aligned with params;
        clipped in place). `on_update(indices, tensors)` sees the masters this
        rank updated right after their update (on the card, also when they
        are offloaded), `on_receive(i, tensor)` each master a ZeRO-1 owner
        sent it. Returns the learning rate it applied and the f32 global norm
        of the gradients before clipping."""
        norm = global_norm_f32(grads, self.sharded, self.world.model_group)
        if self.max_grad_norm and self.max_grad_norm > 0:
            clip_by_global_norm_f32_(grads, self.max_grad_norm, norm)
        lr = float(self.schedule(self.count))
        corrections = self.adamw8.begin_step() if self.adamw8 is not None else None
        if self.adamw is not None:
            for group in self.adamw.param_groups:
                group["lr"] = lr
        self.streamed_bytes = 0
        if self.adamw8 is not None:
            self._sync_scales(grads)
        if self.offload == "none":
            self._update(self.local, grads, lr, corrections)
            if on_update is not None:
                on_update(self.local, [self.params[i] for i in self.local])
        else:
            self._streamed_update(grads, lr, corrections, on_update)
        if self.zero1:
            self.streamed_bytes += broadcast_from_owners_(self.params, self.owner, self.world,
                                                          self.device, on_receive)
        self.count += 1
        return lr, norm

    def _sync_scales(self, grads) -> None:
        """The 8-bit parts' whole-block scales (``AdamW8bit.sync_scales``),
        their offloaded moments read through the card."""
        items = [(self.pos[i], grads[i]) for i in self.local]
        if self.offload == "masters+moments":
            self.streamed_bytes += sum(t.numel() * t.element_size() for i in self.local
                                       if self.adamw8._split(self.pos[i])
                                       for t in self._moments(i))
        self.adamw8.sync_scales(items)

    def _update(self, indices, grads, lr, corrections) -> None:
        """AdamW on the masters at `indices` (where they are now)."""
        if self.adamw8 is not None:
            for i in indices:
                self.adamw8.update(self.pos[i], grads[i], lr, corrections)
            return
        # AdamW reads gradients of the masters' dtype: bf16 ones are copied
        # to f32 CHUNK tensors at a time (AdamW skips a parameter without a
        # gradient), so the f32 copies never all exist at once
        same = all(grads[i].dtype == self.params[i].dtype for i in indices)
        step = max(1, len(indices)) if same else self.CHUNK
        for k in range(0, len(indices), step):
            part = indices[k:k + step]
            for i in part:
                self.params[i].grad = grads[i].to(self.params[i].dtype)
            self.adamw.step()
            for i in part:
                self.params[i].grad = None

    def _moments(self, i: int) -> List[torch.Tensor]:
        """Tensor `i`'s moment tensors (the 8-bit ones' codes and scales;
        none before AdamW's first step made them)."""
        if self.adamw8 is not None:
            k = self.pos[i]
            return [t for m in (self.adamw8.mu[k], self.adamw8.nu[k])
                    for t in (m if isinstance(m, tuple) else (m,))]
        st = self.adamw.state.get(self.params[i], {})
        return [st[key] for key in self.MOMENTS if key in st]

    def _set_moments(self, i: int, tensors: List[torch.Tensor]) -> None:
        """Put `tensors` (as ``_moments`` lists them) in place of tensor `i`'s."""
        if self.adamw8 is not None:
            k, it = self.pos[i], iter(tensors)
            for lst in (self.adamw8.mu, self.adamw8.nu):
                m = lst[k]
                lst[k] = type(m)(*(next(it) for _ in m)) if isinstance(m, tuple) else next(it)
            return
        st = self.adamw.state[self.params[i]]
        for key, t in zip([key for key in self.MOMENTS if key in st], tensors):
            st[key] = t

    def _to_host(self, key, t: torch.Tensor) -> torch.Tensor:
        """A host copy of t in a buffer kept per `key` (pinned with a card)."""
        buf = self._host_moments.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                              pin_memory=torch.cuda.is_available())
            self._host_moments[key] = buf
        buf.copy_(t, non_blocking=t.is_cuda)
        return buf

    def _place_moments(self) -> None:
        """The moments where the offload mode keeps them: on `device`, or in
        host memory with "masters+moments"."""
        host = self.offload == "masters+moments"
        for i in self.local:
            moments = self._moments(i)
            if host:
                self._set_moments(i, [self._to_host((i, n), t) for n, t in enumerate(moments)])
            elif any(t.device != self.device for t in moments):
                self._set_moments(i, [t.to(self.device) for t in moments])
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def _chunks(self):
        run, count = [], 0
        for i in self.local:
            if run and count + self.params[i].numel() > self.OFFLOAD_CHUNK_VALUES:
                yield run
                run, count = [], 0
            run.append(i)
            count += self.params[i].numel()
        if run:
            yield run

    def _streamed_update(self, grads, lr, corrections, on_update) -> None:
        """The update of the offloaded state, a chunk at a time through the
        card: the copies in of the next chunk on a side stream while this
        one updates, the copies back on the side stream after it."""
        dev = self.device
        cuda = dev.type == "cuda"
        side = torch.cuda.Stream(dev) if cuda else None
        moments = self.offload == "masters+moments"
        main = torch.cuda.current_stream(dev) if cuda else None

        def fetch(chunk):
            """{i: (device master, [device moments])} and the event they are in by."""
            ctx = torch.cuda.stream(side) if cuda else contextlib.nullcontext()
            with ctx:
                out = {}
                for i in chunk:
                    ms = [t.to(dev, non_blocking=True, copy=True)
                          for t in (self._moments(i) if moments else [])]
                    out[i] = (self.params[i].data.to(dev, non_blocking=True, copy=True), ms)
                    self.streamed_bytes += sum(t.numel() * t.element_size()
                                               for t in (out[i][0], *ms))
                ready = side.record_event() if cuda else None
            return out, ready

        chunks = list(self._chunks())
        nxt = fetch(chunks[0]) if chunks else None
        for c, chunk in enumerate(chunks):
            staged, ready = nxt
            if cuda:
                main.wait_event(ready)
                for master, ms in staged.values():
                    for t in (master, *ms):
                        t.record_stream(main)
            nxt = fetch(chunks[c + 1]) if c + 1 < len(chunks) else None
            hosts = {}
            for i, (master, ms) in staged.items():
                hosts[i] = self.params[i].data
                self.params[i].data = master
                if ms:
                    self._set_moments(i, ms)
            self._update(chunk, grads, lr, corrections)
            if on_update is not None:
                on_update(chunk, [self.params[i] for i in chunk])
            done = main.record_event() if cuda else None
            ctx = torch.cuda.stream(side) if cuda else contextlib.nullcontext()
            with ctx:
                if cuda:
                    side.wait_event(done)
                for i in chunk:
                    master = self.params[i].data
                    hosts[i].copy_(master, non_blocking=cuda)
                    self.params[i].data = hosts[i]
                    moved = [master]
                    if moments:
                        ms = self._moments(i)
                        self._set_moments(i, [self._to_host((i, n), t)
                                              for n, t in enumerate(ms)])
                        moved += ms
                    for t in moved:
                        self.streamed_bytes += t.numel() * t.element_size()
                        if cuda:
                            t.record_stream(side)
        if cuda:
            main.wait_stream(side)

    # -- the state --

    @property
    def gathers(self) -> bool:
        """Whether the state is partitioned over several ranks, so that a
        whole state (a checkpoint) must be gathered from them."""
        return self.zero1 and self.world.collective and len(self.world.replicas) > 1

    def _local_entries(self) -> Dict[int, object]:
        """{index in params: its moments} of this rank's tensors, on the CPU."""
        cpu = lambda t: t.detach().to("cpu", copy=True)
        if self.adamw8 is not None:
            sd = self.adamw8.state_dict()
            pack = lambda m: {k: cpu(v) for k, v in m.items()} if isinstance(m, dict) else cpu(m)
            return {i: (pack(sd["mu"][k]), pack(sd["nu"][k])) for k, i in enumerate(self.local)}
        sd = self.adamw.state_dict()
        return {self.local[k]: {n: cpu(v) for n, v in st.items()}
                for k, st in sd["state"].items()}

    def state_dict(self) -> dict:
        """The update count and the optimizer's state by position in
        `params`: AdamW's (its step and both moments per parameter) under
        "adamw", or the 8-bit one's under "adamw8". Unpartitioned, the
        tensors are the live ones; under ZeRO-1 over several ranks every
        rank must call it: the owners' moments are gathered to rank 0, which
        gets the whole state (the other ranks None)."""
        if not self.gathers:
            if self.adamw8 is not None:
                return {"count": self.count, "adamw8": self.adamw8.state_dict()}
            return {"count": self.count, "adamw": self.adamw.state_dict()}
        parts = gather_to_main(self._local_entries(), self.world)
        if parts is None:
            return None
        merged = merge_indexed(parts, len(self.params))
        if self.adamw8 is not None:
            return {"count": self.count, "adamw8": {
                "count": self.adamw8.count, "block_order": BLOCK_ORDER,
                "mu": [m for m, _ in merged], "nu": [v for _, v in merged]}}
        group = {k: v for k, v in self.adamw.state_dict()["param_groups"][0].items()}
        group["params"] = list(range(len(self.params)))
        return {"count": self.count, "adamw": {
            "state": {i: st for i, st in enumerate(merged) if st is not None},
            "param_groups": [group]}}

    def load_state_dict(self, sd: dict) -> None:
        """Restore what state_dict gave (the whole state, from any world
        size) onto this rank's tensors where the offload mode keeps them;
        raises for the state of the other optimizer."""
        key = "adamw8" if self.adamw8 is not None else "adamw"
        if key not in sd:
            raise ValueError(f"checkpoint holds {', '.join(k for k in sd if k != 'count')} "
                             f"optimizer state, this run's optimizer is {key}")
        self.count = int(sd["count"])
        if self.adamw8 is not None:
            whole = sd["adamw8"]
            if len(whole["mu"]) != len(self.params):
                raise ValueError("8-bit Adam state for another number of tensors")
            self.adamw8.load_state_dict({**whole, "mu": [whole["mu"][i] for i in self.local],
                                         "nu": [whole["nu"][i] for i in self.local]})
        else:
            whole = sd["adamw"]
            group = dict(whole["param_groups"][0])
            group["params"] = list(range(len(self.local)))
            self.adamw.load_state_dict({
                "state": {k: whole["state"][i] for k, i in enumerate(self.local)
                          if i in whole["state"]},
                "param_groups": [group]})
        self._place_moments()

    def moment_bytes(self) -> int:
        """Bytes this rank's moments hold."""
        size = lambda t: t.numel() * t.element_size()
        return sum(size(t) for i in self.local for t in self._moments(i))


def make_optimizer(cfg: TrainConfig, params: List[torch.Tensor], num_processes: int = 1,
                   world: World = SINGLE, device=None,
                   parts: Optional[Sequence[Optional[Part]]] = None,
                   axes: Optional[Sequence[Axes]] = None) -> ClippedAdamW:
    cfg.check_ported()
    return ClippedAdamW(params, training_schedule(cfg, num_processes), cfg, world, device,
                        parts, axes)
