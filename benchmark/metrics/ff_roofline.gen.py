"""Share of its roofline of the ff module over the traced run:
the sum over its calls of the bound (benchmark/flops.py at each call's
shapes, benchmark/peaks.py) over the sum of their device time (CUDA events
at the module's entry and return)."""
from benchmark.peaks import bound_s


def read(rec):
    if rec.spans is None:
        return None
    ms = rec.spans.device_ms("bench.ff")
    if not ms:
        return None
    bound = sum(bound_s(f, b) for f, b in rec.spans.cost["bench.ff"])
    return 100.0 * bound / (sum(ms) / 1e3)
