"""Share of the profiled slice in which the device ran nothing.

Layer: device (the H100).  1 - busy / wall over the slice run with the
program's tracer off (its spans synchronize), from torch.profiler's
device trace, in %.  It should move `window_ingest_events_per_s`.
"""


def read(ctx):
    prof = ctx["profile"]
    if prof["busy_s"] <= 0:          # no device in the trace
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
