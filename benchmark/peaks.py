"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its
700 W limit): the yardstick of every roofline share and of the mfu metrics."""

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations at
    the bf16 peak and the bytes at the memory bandwidth."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
