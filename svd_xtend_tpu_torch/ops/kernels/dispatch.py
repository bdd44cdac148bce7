"""Whether the models' kernel sites take the kernels on CUDA.

By default every site a kernel's ``supports`` admits launches the kernel.
``plain_versions()`` turns that off inside a ``with`` block, so the same
model runs its plain PyTorch versions on the card: chip_smoke.py measures
the bf16 plain path against which the kernels' whole-UNet gradient is held.
The kernel wrappers themselves never give way to a plain version on CUDA.

The sites whose kernels take bf16 alone and no other structural test (the
GroupNorm fold, the two-source conv3x3, the upsample) route by
``bf16_site``: an f32 or f64 network on the card runs their plain
versions there, as its other sites do where their ``supports`` say no.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_local = threading.local()


def kernels_enabled() -> bool:
    return not getattr(_local, "plain", False)


@contextlib.contextmanager
def plain_versions(on: bool = True):
    """Inside the block the sites run their plain versions (with on=False,
    the kernels again)."""
    prev = getattr(_local, "plain", False)
    _local.plain = on
    try:
        yield
    finally:
        _local.plain = prev


def bf16_site(x: torch.Tensor) -> bool:
    """Whether a site whose kernel takes bf16 alone sends `x` to its kernel
    wrapper: with the kernels on, a CPU tensor (the wrapper runs the plain
    version there) or a bf16 one (the wrapper launches the kernel or
    raises); another dtype on the card runs the site's plain version."""
    return kernels_enabled() and (not x.is_cuda or x.dtype == torch.bfloat16)
