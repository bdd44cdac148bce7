"""Median host milliseconds from the UNet forward's entry to its return in
the train step (the forward that builds the backward's graph)."""
import statistics


def read(rec):
    ms = rec.spans.host_ms.get("unet.forward") if rec.spans is not None else None
    return statistics.median(ms) if ms else None
