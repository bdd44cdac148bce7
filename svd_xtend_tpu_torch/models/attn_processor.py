"""Attention-processor registry: the reference's pluggable-attention API.

Port of ``svd_xtend_tpu/models/attn_processor.py``. The reference UNet has
``attn_processors`` / ``set_attn_processor`` / ``set_default_attn_processor``
(src/unet_spatio_temporal_condition.py:247-321). Here, as in the JAX
package, ``Attention`` and ``FrameAxisAttention`` consult a thread-local
registry in ``forward``, keyed by their site: the module name in the UNet
(e.g. "down_blocks.0.attentions.0.transformer_blocks.0.attn1"), which the
UNet gives each attention when it is built.

A processor is a callable

    proc(q, k, v, *, num_heads, scale, site) -> out

on the (rows, tokens, H*D) projections after to_q/to_k/to_v; its output
goes through to_out. With no processor at a site the default computation
runs (the flash and frame-attention kernels on the card, and the exact
one-token cross-attention shortcut, which a site with a processor does not
take). A frame site hands its processor the reference's temporal-token view
(B·S, F, C). A UNet block that remat recomputes in the backward (on the
autograd engine's thread, for CUDA tensors) runs with the registry its
forward ran with (models/unet.py).

    from svd_xtend_tpu_torch.models import attn_processor as AP
    AP.set_attn_processor(my_proc)              # every site
    AP.set_attn_processor({site: my_proc})      # per site (others default)
    AP.set_default_attn_processor()             # reset
    with AP.processors(my_proc): ...            # scoped
    sites = AP.collect_attn_sites(f, *args)     # enumerate (≙ attn_processors)
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Optional, Sequence, Union

import torch

Processor = Callable[..., torch.Tensor]
_state = threading.local()


def current() -> Optional[Union[Processor, Dict[str, Processor]]]:
    """The installed registry: a processor, a per-site dict, or None."""
    return getattr(_state, "proc", None)


def set_attn_processor(proc: Union[Processor, Dict[str, Processor]],
                       sites: Optional[Sequence[str]] = None) -> None:
    """Install `proc` at every attention site (a callable) or per site (a
    dict keyed by site; unlisted sites keep the default computation).

    With `sites` given (from ``collect_attn_sites``) a dict is validated as
    the reference validates it (unet_spatio_temporal_condition.py:289-294):
    every key must name a site, and every site must be covered."""
    if isinstance(proc, dict) and sites is not None:
        missing, unknown = set(sites) - set(proc), set(proc) - set(sites)
        if missing or unknown:
            raise ValueError(f"processor dict does not match the model's attention sites: "
                             f"missing {sorted(missing)[:3]}, unknown {sorted(unknown)[:3]}")
    _state.proc = proc


def set_default_attn_processor() -> None:
    """Reset every site to the default computation."""
    _state.proc = None


@contextlib.contextmanager
def processors(proc: Union[Processor, Dict[str, Processor]]):
    """Scoped ``set_attn_processor`` (the previous registry is restored)."""
    prev = current()
    _state.proc = proc
    try:
        yield
    finally:
        _state.proc = prev


def get_processor(site: str) -> Optional[Processor]:
    """The processor installed at `site`, or None for the default path.
    While ``collect_attn_sites`` runs it records the site instead."""
    sink = getattr(_state, "collect", None)
    if sink is not None:
        sink.append(site)
        return None
    proc = current()
    if isinstance(proc, dict):
        return proc.get(site)
    return proc


def collect_attn_sites(fn: Callable, *args, **kwargs) -> list[str]:
    """The attention sites `fn(*args, **kwargs)` runs through, in first-visit
    order (the reference's ``attn_processors`` keys). Runs `fn` once, without
    autograd, on the default computation."""
    sink: list[str] = []
    _state.collect = sink
    try:
        with torch.no_grad():
            fn(*args, **kwargs)
    finally:
        _state.collect = None
    return list(dict.fromkeys(sink))


def attn_processors(fn: Callable, *args, **kwargs) -> Dict[str, Optional[Processor]]:
    """{site: installed processor or None} for every attention site of
    `fn(*args, **kwargs)`: the reference's property, as a function."""
    proc = current()
    sites = collect_attn_sites(fn, *args, **kwargs)
    if isinstance(proc, dict):
        return {s: proc.get(s) for s in sites}
    return {s: proc for s in sites}
