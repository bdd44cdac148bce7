"""Share of the profiled span with no kernel or copy on the card: the trace of
the device alone (no host activity traced, so the host runs at nearly its
own speed) over the steps run under the profiler after the window."""


def read(rec):
    p = rec.profile
    if rec.kind != "train" or not p or p.get("window_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
