"""Median host milliseconds from a UNet call's entry to its return in the
generate cells: the time the host takes to issue one CFG pair pass."""
import statistics


def read(rec):
    ms = rec.spans.host_ms.get("unet.pass") if rec.spans is not None else None
    return statistics.median(ms) if ms else None
