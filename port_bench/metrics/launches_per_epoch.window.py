"""Kernel launches a flush epoch of the windowed ingest cell (rotations and boundary flushes included).

Layer: API and host control (`stream/service.py`).  The host side of
the profiled slice's trace counts `cudaLaunchKernel` calls (and the
driver API's launches); divided by the epochs of the slice.  Fewer
launches an epoch leave the host less to do between the card's work,
so it should move `window_ingest_events_per_s`.
"""


def read(ctx):
    n = ctx["profile"]["launches"]
    return n / ctx["units"] if n else None
