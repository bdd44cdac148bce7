"""Mean device milliseconds of one CFG pair pass of the UNet: CUDA events at
the UNet's forward pre- and post-hooks."""
import statistics


def read(rec):
    ms = rec.spans.device_ms("unet.pass") if rec.spans is not None else None
    return statistics.fmean(ms) if ms else None
