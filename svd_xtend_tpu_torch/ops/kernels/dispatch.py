"""Whether the models' kernel sites take the kernels on CUDA.

By default every site a kernel's ``supports`` admits launches the kernel.
``plain_versions()`` turns that off inside a ``with`` block, so the same
model runs its plain PyTorch versions on the card: chip_smoke.py measures
the bf16 plain path against which the kernels' whole-UNet gradient is held.
The kernel wrappers themselves never give way to a plain version on CUDA.
"""

from __future__ import annotations

import contextlib
import threading

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
