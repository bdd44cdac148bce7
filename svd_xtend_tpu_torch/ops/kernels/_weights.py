"""Weights prepared for a kernel once per parameter version.

A kernel that reads a parameter in another layout or type (GEGLU's packed
W1, the temporal resnet's packed frame taps and f32 biases) would copy it on
every launch. ``per_version(make)`` returns a function that memoizes
``make(*tensors)`` while each tensor, or the tensor it is a view of (a
module's parameter), is the same object on the same storage at the same
in-place version, which an optimizer step bumps, and the view has the same
geometry. Entries whose parameter is gone are dropped at the next miss.
"""

from __future__ import annotations

import weakref
from typing import Callable

import torch


def _base(t: torch.Tensor) -> torch.Tensor:
    return t if t._base is None else t._base


def _state(t: torch.Tensor) -> tuple:
    return (_base(t).data_ptr(), t._version, t.storage_offset(), tuple(t.shape), t.stride(),
            t.dtype)


def per_version(make: Callable) -> Callable:
    """make(*tensors), made again only when one of the tensors changed."""
    cache: dict = {}

    def get(*tensors: torch.Tensor):
        key = tuple(id(_base(t)) for t in tensors)
        state = tuple(_state(t) for t in tensors)
        hit = cache.get(key)
        if (hit is not None and hit[1] == state
                and all(ref() is _base(t) for ref, t in zip(hit[0], tensors))):
            return hit[2]
        for k in [k for k, v in cache.items() if any(ref() is None for ref in v[0])]:
            del cache[k]
        value = make(*(t.detach() for t in tensors))
        cache[key] = (tuple(weakref.ref(_base(t)) for t in tensors), state, value)
        return value

    return get
