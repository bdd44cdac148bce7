"""Device milliseconds of the temporal decoder a video: CUDA events at the
decoder's hooks, every chunk, over the videos the spans covered."""


def read(rec):
    ms = rec.spans.device_ms("vae.decode") if rec.spans is not None else None
    return sum(ms) / rec.span_units if ms and rec.span_units else None
