"""Model operations of the window's completed units (benchmark/flops.py) over
the window's wall time at the card's bf16 peak, in percent."""
from benchmark.peaks import BF16_FLOPS


def read(rec):
    if rec.kind != "train" or not rec.units or rec.window_s <= 0:
        return None
    return 100.0 * rec.units * rec.unit_flops / (rec.window_s * BF16_FLOPS)
